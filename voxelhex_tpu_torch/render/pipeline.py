"""Frame pipelining: overlap each frame's copy to the host with the next
frames' rendering (the reference's ``render/pipeline.py``), on CUDA streams.

    pipe = FramePipeline(renderer)
    futs = [pipe.render(cam_i, out_u8=True) for cam_i in cams]
    frames = [f.result() for f in futs]

``render`` launches the frame on the current stream and returns a future at
once.  The frame's copy to pinned host memory runs on a copy stream of its
own, after an event that marks the frame done, so the next frame's kernel
can run while it copies; the future resolves when the copy's event has
completed.  On a CPU renderer the frame is ready when ``render`` returns.
Each frame is the renderer's ``render``, so a renderer with the automaton's
options or u8 colors launches their instances here too.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import torch


class FramePipeline:
    """Pipelined frames over a renderer whose ``render`` takes
    ``out_device=True`` (:class:`~voxelhex_tpu_torch.render.renderer.
    BitGridRenderer`).  At most ``max_in_flight`` frames are rendered and
    not yet copied: ``render`` waits for the oldest first."""

    def __init__(self, renderer, max_in_flight: int = 2):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be at least 1")
        self.renderer = renderer
        self._max_in_flight = int(max_in_flight)
        self._in_flight: list[Future] = []
        dev = getattr(renderer, "device", torch.device("cpu"))
        self._cuda = torch.device(dev).type == "cuda"
        # one thread waits on the copies' events, in order
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._copy_stream = torch.cuda.Stream(device=dev) if self._cuda else None

    def render(self, camera, **kwargs) -> Future:
        """Render a frame of ``camera`` (``renderer.render``'s keywords);
        returns a future of the frame as a NumPy array."""
        while len(self._in_flight) >= self._max_in_flight:
            self._in_flight.pop(0).result()
        kwargs["out_device"] = True
        frame = self.renderer.render(camera, **kwargs)
        if not self._cuda:
            fut: Future = Future()
            fut.set_result(frame.numpy())
        else:
            fut = self._pool.submit(self._wait, *self._copy(frame))
        self._in_flight.append(fut)
        return fut

    def _copy(self, frame):
        """Queue the frame's copy to a pinned buffer on the copy stream,
        after the frame: ``(host buffer, event of the copy)``.  Each frame
        has a buffer of its own, which the future hands out, so no result
        shares memory with a later frame; freed buffers return to PyTorch's
        pinned-memory cache."""
        rendered = torch.cuda.Event()
        rendered.record(torch.cuda.current_stream(frame.device))
        host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(rendered)
            host.copy_(frame, non_blocking=True)
            # the frame is read on the copy stream: keep the caching
            # allocator from handing its memory to a later frame before then
            frame.record_stream(self._copy_stream)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        return host, copied

    @staticmethod
    def _wait(host, copied):
        copied.synchronize()
        return host.numpy()

    def drain(self):
        """Wait for every frame in flight."""
        while self._in_flight:
            self._in_flight.pop(0).result()

    def close(self):
        self.drain()
        self._pool.shutdown()
