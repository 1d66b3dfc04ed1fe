"""Renderers.

* :mod:`voxelhex_tpu_torch.render.camera` — pinhole camera and ray generation.
* :mod:`voxelhex_tpu_torch.render.bitgrid` — the occupancy pyramid and the
  plain tracer.
* :mod:`voxelhex_tpu_torch.render.renderer` — the whole-frame renderer.
"""


def fastest_renderer(bitgrid, device="cuda"):
    """The BitGrid renderer on ``device`` (the CUDA kernels by default;
    ``device="cpu"`` runs their plain PyTorch versions)."""
    from voxelhex_tpu_torch.render.renderer import BitGridRenderer

    return BitGridRenderer(bitgrid, device=device)
