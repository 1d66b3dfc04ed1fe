"""Renderers.

* :mod:`voxelhex_tpu_torch.render.camera` — pinhole camera and ray generation.
* :mod:`voxelhex_tpu_torch.render.bitgrid` — the occupancy pyramid and the
  plain tracer.
* :mod:`voxelhex_tpu_torch.render.renderer` — the whole-frame renderer:
  single frames, batches, and batches that fetch only what changed.
* :mod:`voxelhex_tpu_torch.render.pipeline` — ``FramePipeline``, frames
  whose copies to the host overlap the next frames' rendering.
"""


def fastest_renderer(source, device="cuda", **kwargs):
    """The BitGrid renderer of ``source`` (a BitGrid, BoxTree or FlatTree)
    on ``device`` (the CUDA kernels by default; ``device="cpu"`` runs their
    plain PyTorch versions).  The reference ``BitGridRenderer``'s keywords
    pass through
    (:class:`~voxelhex_tpu_torch.render.renderer.BitGridRenderer`)."""
    from voxelhex_tpu_torch.render.renderer import BitGridRenderer

    return BitGridRenderer(source, device=device, **kwargs)
