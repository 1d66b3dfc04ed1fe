"""voxelhex_tpu_torch: the BitGrid voxel raytracer in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The port of ``voxelhex_tpu`` (JAX on a TPU), which stays the reference.
It imports neither JAX nor the reference package.  Layout:

* :mod:`.scene` — the benchmark scene as a BitGrid;
* :mod:`.render` — camera and rays, the BitGrid and its plain tracer,
  plain shading, the renderer (:func:`.render.fastest_renderer`);
* :mod:`.ops` — the CUDA kernels' wrappers (the frame, the batched
  frames, traversal, shading, the training step's kernels) and the
  ``nvcc`` build of ``csrc/``;
* :mod:`.convert` — a reference BitGrid's fields to the port's BitGrid.
"""
