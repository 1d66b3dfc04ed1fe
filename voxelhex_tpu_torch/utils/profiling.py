"""Observability: frame timing, rays/sec meters and device traces (the
reference's ``utils/profiling.py``).

``FrameStats`` and ``timed_frame`` meter frames by the host clock, as the
reference's do: wrap a call that waits for its frame (``render`` returns a
host array, so it does).  ``device_trace`` records a ``torch.profiler``
trace of the CPU and, where there is one, the CUDA card, and exports it to
a directory as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time


class FrameStats:
    """Rolling rays/sec and frame-time statistics over the last ``window``
    frames."""

    def __init__(self, window: int = 60):
        self.window = window
        self.times: list[float] = []
        self.rays: list[int] = []

    def record(self, seconds: float, n_rays: int):
        self.times.append(seconds)
        self.rays.append(n_rays)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.rays.pop(0)

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    @property
    def rays_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return sum(self.rays) / sum(self.times)

    def summary(self) -> str:
        if not self.times:
            return "no frames recorded"
        avg = sum(self.times) / len(self.times)
        return (
            f"{avg*1000:.1f} ms/frame ({self.fps:.2f} FPS, "
            f"{self.rays_per_sec/1e6:.2f} Mrays/s over {len(self.times)} frames)"
        )


@contextlib.contextmanager
def timed_frame(stats: FrameStats, n_rays: int):
    """Record the host time of the ``with`` block as one frame of
    ``n_rays`` rays into ``stats``."""
    t0 = time.time()
    yield
    stats.record(time.time() - t0, n_rays)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the ``with`` block with ``torch.profiler`` (the CPU, and the
    CUDA card where there is one) and write its Chrome trace into
    ``log_dir`` as ``trace.json``; yields the profiler, whose
    ``key_averages()`` sum the time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
