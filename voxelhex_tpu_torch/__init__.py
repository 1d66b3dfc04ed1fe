"""voxelhex_tpu_torch: the BitGrid voxel raytracer in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The port of ``voxelhex_tpu`` (JAX on a TPU), which stays the reference.
It imports neither JAX nor the reference package.  Layout:

* :mod:`.scene` — the benchmark scene as a BitGrid or a BoxTree, and the
  large terrain's voxels;
* :mod:`.spatial`, :mod:`.tree`, :mod:`.io` — the scene model on the host:
  the boxtree (edits, MIP maps, bulk build, flat arrays), ``.vox`` import
  and the bencode format; :mod:`.native` builds and binds its host library
  (``host/rasterize.cpp``);
* :mod:`.render` — camera and rays, the BitGrid and its plain tracer,
  plain shading, the renderer (:func:`.render.fastest_renderer`);
* :mod:`.ops` — the CUDA kernels' wrappers (the frame, the batched
  frames, traversal, shading, the training step's kernels) and the
  ``nvcc`` build of ``csrc/``;
* :mod:`.convert` — a reference BitGrid's or FlatTree's fields, soft
  params and Adam state to the port's.
"""
