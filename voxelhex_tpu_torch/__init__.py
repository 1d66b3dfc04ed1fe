"""voxelhex_tpu_torch: the BitGrid voxel raytracer in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The port of ``voxelhex_tpu`` (JAX on a TPU), which stays the reference.
It imports neither JAX nor the reference package.  Layout:

* :mod:`.scene` — the benchmark scene as a BitGrid or a BoxTree, and the
  large terrain's voxels;
* :mod:`.spatial`, :mod:`.tree`, :mod:`.io` — the scene model on the host:
  the boxtree (edits, MIP maps, bulk build, flat arrays), ``.vox`` import,
  the bencode format and versioned checkpoints; :mod:`.native` builds and
  binds its host libraries (``host/rasterize.cpp``, ``host/tree_edit.cpp``);
* :mod:`.render` — camera and rays, the BitGrid and its plain tracer,
  plain shading, the renderer (:func:`.render.fastest_renderer`), the
  streaming view over a world larger than the card's window and its far
  field (:mod:`.render.streaming`);
* :mod:`.diff` — differentiable rendering: the soft-occupancy renderer,
  the albedo renderer and their offline trainers;
* :mod:`.ops` — the CUDA kernels' wrappers (the frame, the batched
  frames, traversal, shading, the training steps' kernels, the streaming
  window's updates and its far-field frame) and the ``nvcc`` build of
  ``csrc/``;
* :mod:`.convert` — a reference BitGrid's or FlatTree's fields, params and
  Adam state to the port's;
* :mod:`.serve` — the render/edit server (``RenderService``, its HTTP
  server and CLI, ``python -m voxelhex_tpu_torch.serve``), with
  :mod:`.utils.png`'s encoder;
* :mod:`.tree.native_edit` — the native edit engine (``NativeEditTree``,
  over the host library ``host/tree_edit.cpp``).

The reference's top-level names load lazily::

    from voxelhex_tpu_torch import BoxTree, Albedo, RenderService, fastest_renderer
"""

__version__ = "0.1.0"

from voxelhex_tpu_torch.constants import (  # noqa: F401
    BOX_NODE_CHILDREN_COUNT,
    BOX_NODE_DIMENSION,
    EMPTY_U16,
    EMPTY_U32,
    EMPTY_VOXEL,
)


def __getattr__(name):
    # lazy, as the reference's: importing the package loads no renderer
    import importlib

    if name in ("BoxTree", "Albedo", "Entry"):
        return getattr(importlib.import_module("voxelhex_tpu_torch.tree.boxtree"), name)
    if name == "flatten":
        return importlib.import_module("voxelhex_tpu_torch.tree.flat").flatten
    if name == "fastest_renderer":
        return importlib.import_module("voxelhex_tpu_torch.render").fastest_renderer
    if name in ("Camera", "orbit_camera"):
        return getattr(importlib.import_module("voxelhex_tpu_torch.render.camera"), name)
    if name in ("load_vox_tree", "load_vox_tree_cached", "load_vox_scene"):
        return getattr(importlib.import_module("voxelhex_tpu_torch.io.vox"), name)
    if name in ("save_tree", "load_tree", "save_flat", "load_flat"):
        return getattr(importlib.import_module("voxelhex_tpu_torch.io.checkpoint"), name)
    if name == "bencode":
        return importlib.import_module("voxelhex_tpu_torch.io.bencode")
    if name == "StreamingView":
        return importlib.import_module("voxelhex_tpu_torch.render.streaming").StreamingView
    if name == "SoftRenderer":
        return importlib.import_module("voxelhex_tpu_torch.diff.soft").SoftRenderer
    if name == "NativeEditTree":
        return importlib.import_module("voxelhex_tpu_torch.tree.native_edit").NativeEditTree
    if name == "RenderService":
        return importlib.import_module("voxelhex_tpu_torch.serve").RenderService
    raise AttributeError(f"module 'voxelhex_tpu_torch' has no attribute '{name}'")


__all__ = [
    "Albedo",
    "BOX_NODE_CHILDREN_COUNT",
    "BOX_NODE_DIMENSION",
    "bencode",
    "BoxTree",
    "Camera",
    "EMPTY_U16",
    "EMPTY_U32",
    "EMPTY_VOXEL",
    "Entry",
    "fastest_renderer",
    "flatten",
    "load_flat",
    "load_tree",
    "load_vox_scene",
    "load_vox_tree",
    "load_vox_tree_cached",
    "NativeEditTree",
    "orbit_camera",
    "RenderService",
    "save_flat",
    "save_tree",
    "SoftRenderer",
    "StreamingView",
    "__version__",
]
