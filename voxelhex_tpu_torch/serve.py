"""Headless render/edit server of the port: the serving runtime around the
renderer, on one CUDA card.

One process owns the card; clients post camera poses and edits over HTTP
and get PNG frames back.  The server serializes device work onto a single
lock.  A dense request is one launch of the batched kernel
(``BitGridRenderer.render_delta_many``, ``csrc/frames.cu``), which fetches
only the rows that changed since the frame before; a streamed one is one
far frame (``StreamingView``, ``csrc/far.cu``) with the window's paging
kernels (``csrc/stream.cu``) when it moves, or nothing when the view has
settled and the pose repeats (the idle-pose cache).

Endpoints
---------
- ``GET /`` — the interactive viewer UI (``viewer.html``: drag-to-orbit
  camera, fov and resolution sliders, view distance, FPS graph, drag-drop
  .vox upload).
- ``GET /frame?ox=&oy=&oz=&tx=&ty=&tz=&w=&h=[&fov=]`` — a frame for the
  given origin/target camera, as ``image/png``.
- ``POST /edit`` — JSON ``{"op": "insert"|"clear", "pos": [x,y,z],
  "color": [r,g,b,a], "size": n}`` (or a list of such ops), applied to the
  live tree.
- ``POST /load?name=`` — the body is a .vox file; parses it (with a bencode
  disk cache), builds and swaps the served scene.
- ``POST /view`` — JSON ``{"view_size": n}``: streams an n^3 window with
  its far-field rings; 0 or null renders the whole scene dense.
- ``GET /stats`` — JSON: the scene, the counters and the last batch's
  stats.

An error answers 500 with its message.  Usage::

    python -m voxelhex_tpu_torch.serve model.vox --port 8745          # serve
    curl 'localhost:8745/frame?ox=-40&oy=90&oz=-40&tx=64&ty=20&tz=64&w=640&h=360' > f.png
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from voxelhex_tpu_torch.io import bencode
from voxelhex_tpu_torch.render.bitgrid import build_bitgrid, device_bitgrid
from voxelhex_tpu_torch.render.camera import Camera
from voxelhex_tpu_torch.render.renderer import BitGridRenderer, resolve_device
from voxelhex_tpu_torch.render.streaming import REGION, StreamingView
from voxelhex_tpu_torch.tree.boxtree import Albedo
from voxelhex_tpu_torch.tree.flat import flatten
from voxelhex_tpu_torch.utils.png import encode_png


class RenderService:
    """The device-owning render/edit core shared by the HTTP layer and tests.

    Takes the reference's parameters in its order, then ``device``
    (keyword-only, ``"cuda"`` by default; ``"cpu"`` runs the kernels' plain
    versions).  ``fuse_plan`` changes no frame here; ``async_far`` builds
    the far-field rings on a worker thread."""

    def __init__(self, tree, view_size: int | None = None, fuse_plan: bool = False,
                 async_far: bool = True, *, device="cuda"):
        self.device = resolve_device(device)
        self.tree = tree
        self._lock = threading.Lock()
        self.frames_served = 0
        # frames that rode a validated fast path: a delta batch whose pose
        # token equals the batch before's, or an idle-pose cache hit
        self.pose_validated_frames = 0
        self.stream_cache_hits = 0  # idle-pose cache hits (streaming)
        self._stream_cache = None  # (key, content_version, frame)
        self.fuse_plan = bool(fuse_plan)
        self.async_far = bool(async_far)
        self.view, self.renderer = self._render_path(tree, view_size)

    def _render_path(self, tree, view_size):
        """``(view, renderer)``: a streaming view when ``view_size`` is below
        the scene's size, else a whole-scene renderer."""
        if view_size is not None and view_size < tree.size:
            return StreamingView(tree, view_size=view_size, fuse_plan=self.fuse_plan,
                                 async_far=self.async_far, device=self.device), None
        return None, BitGridRenderer(flatten(tree), fuse_plan=self.fuse_plan,
                                     device=self.device)

    def render(self, origin, target, resolution, fov_y_deg=50.0, bg=(0, 0, 0)):
        """The u8 ``[h, w, 3]`` frame of the camera at ``origin`` looking at
        ``target``: always a copy the caller may write into."""
        cam = Camera(origin=np.asarray(origin, dtype=np.float64),
                     target=np.asarray(target, dtype=np.float64),
                     resolution=tuple(resolution), fov_y_deg=float(fov_y_deg))
        with self._lock:
            if self.view is not None:
                # the idle-pose cache: once the view has settled (nothing left
                # to page or build), a repeated pose at the same content
                # version is the same frame, served with no launch; while it
                # has not, every request renders, so that paging goes on
                key = (tuple(np.asarray(origin, dtype=np.float32)),
                       tuple(np.asarray(target, dtype=np.float32)),
                       tuple(resolution), float(fov_y_deg), tuple(bg))
                cache = self._stream_cache
                if (cache is not None and cache[0] == key and self.view.settled()
                        and self.view.content_version() == cache[1]):
                    self.pose_validated_frames += 1
                    self.stream_cache_hits += 1
                    self.frames_served += 1
                    return cache[2].copy()
                rgb = self.view.render(cam, bg=bg, out_u8=True)
                self._stream_cache = ((key, self.view.content_version(), rgb)
                                      if self.view.settled() else None)
            else:
                # one launch of the batched kernel; only the rows that moved
                # since the frame before cross to the host
                frames = self.renderer.render_delta_many([cam], bg=bg)
                if frames is None:
                    raise RuntimeError("render_delta_many returned no frame for one camera")
                rgb = frames[0]
                if self.renderer.last_stats.get("pose_validated"):
                    self.pose_validated_frames += 1
            self.frames_served += 1
            # a copy: the delta path hands out its host baseline, and the
            # cache keeps its frame
            return np.array(rgb, copy=True)

    def apply_edits(self, ops) -> int:
        """Apply an edit dict or a list of them to the live tree; returns
        the number applied.  A streaming view picks them up through its
        tree trigger; the whole-scene renderer's BitGrid is rebuilt and
        uploaded in place (the renderer and its delta baseline stay, so the
        next frame fetches only the rows the edit moved)."""
        if isinstance(ops, dict):
            ops = [ops]
        n = 0
        with self._lock:
            for op in ops:
                pos = tuple(int(v) for v in op["pos"])
                kind = op.get("op", "insert")
                size = int(op.get("size", 1))
                if kind == "insert":
                    albedo = Albedo(*(int(v) for v in op.get("color", [255, 255, 255, 255])))
                    if size > 1:
                        self.tree.insert_at_lod(pos, size, albedo)
                    else:
                        self.tree.insert(pos, albedo)
                elif kind == "clear":
                    if size > 1:
                        self.tree.clear_at_lod(pos, size)
                    else:
                        self.tree.clear(pos)
                else:
                    raise ValueError(f"unknown op {kind!r}")
                n += 1
            if self.view is None:
                r = self.renderer
                r.bitgrid = build_bitgrid(flatten(self.tree))
                r.tree = device_bitgrid(r.bitgrid, r.device)
                r.invalidate_beam()
        return n

    def load_scene(self, tree, view_size: int | None = None) -> None:
        """Swap the served scene; the view it replaces is closed."""
        with self._lock:
            view, renderer = self._render_path(tree, view_size)
            if self.view is not None:
                self.view.close()
            self.tree, self.view, self.renderer = tree, view, renderer
            self._stream_cache = None

    def set_view_size(self, view_size: int | None) -> None:
        """The view distance: ``None``, 0 or a size at least the scene's
        renders the whole scene dense; a smaller multiple of ``REGION``
        streams a camera-following window with far-field rings."""
        if view_size is not None:
            view_size = int(view_size)
            if view_size <= 0 or view_size >= int(self.tree.size):
                view_size = None
            elif view_size % REGION:
                raise ValueError(f"view_size must be a multiple of {REGION}")
        self.load_scene(self.tree, view_size=view_size)

    def load_vox_bytes(self, data: bytes, name: str = "model.vox", brick_dim: int = 4,
                       cache_dir=None) -> None:
        """Load an uploaded .vox, with a bencode disk cache keyed on the
        file's bytes: a cache that the bencode reader refuses (its version
        or format, ``ValueError``) is parsed again from the source; a cache
        that cannot be written is skipped."""
        from voxelhex_tpu_torch.io.vox import load_vox_tree

        safe = "".join(c for c in name if c.isalnum() or c in "._-")
        digest = hashlib.sha1(data).hexdigest()[:16]
        cache = os.path.join(cache_dir or tempfile.gettempdir(), f".vhx_cache_{safe}_{digest}")
        tree = None
        if os.path.exists(cache):
            try:
                tree = bencode.load(cache)
            except ValueError:
                tree = None  # another version or a damaged file: parse the source
        if tree is None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "upload.vox")
                with open(path, "wb") as f:
                    f.write(data)
                tree = load_vox_tree(path, brick_dim=brick_dim)
            try:
                bencode.save(tree, cache)
            except OSError:
                pass  # the cache is best-effort
        self.load_scene(tree)

    def stats(self) -> dict:
        r = self.view.renderer if self.view is not None else self.renderer
        out = {
            "size": int(self.tree.size),
            "brick_dim": int(self.tree.brick_dim),
            "node_count": int(self.tree.node_count),
            "frames_served": self.frames_served,
            "pose_validated_frames": self.pose_validated_frames,
            "stream_cache_hits": self.stream_cache_hits,
            "streaming": self.view is not None,
            "view_size": int(self.view.view_size) if self.view is not None else None,
        }
        if self.view is not None and self.view.far is not None:
            out["far_tiers"] = [{"factor": t.factor, "cells": t.cells}
                                for t in self.view.far.tiers]
        if r is not None and r.last_stats:
            out["last_trace"] = r.last_stats
        return out


def make_server(service: RenderService, host: str = "127.0.0.1",
                port: int = 8745) -> ThreadingHTTPServer:
    """The HTTP server over ``service`` (``port=0``: any free port)."""
    page_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "viewer.html")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            return self.rfile.read(int(self.headers.get("Content-Length", 0)))

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path in ("/", "/viewer"):
                    with open(page_path, "rb") as f:
                        self._send(200, f.read(), "text/html; charset=utf-8")
                elif url.path == "/frame":
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    origin = [float(q["ox"]), float(q["oy"]), float(q["oz"])]
                    target = [float(q["tx"]), float(q["ty"]), float(q["tz"])]
                    res = (int(q.get("w", 640)), int(q.get("h", 360)))
                    rgb = service.render(origin, target, res, float(q.get("fov", 50.0)))
                    self._send(200, encode_png(rgb), "image/png")
                elif url.path == "/stats":
                    self._send(200, json.dumps(service.stats()).encode(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(500, str(e).encode(), "text/plain")

        def do_POST(self):
            url = urlparse(self.path)
            try:
                if url.path == "/edit":
                    applied = service.apply_edits(json.loads(self._body() or b"{}"))
                    self._send(200, json.dumps({"applied": applied}).encode(),
                               "application/json")
                elif url.path == "/load":
                    data = self._body()
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    service.load_vox_bytes(data, name=q.get("name", "model.vox"))
                    self._send(200, json.dumps({"loaded": True,
                                                "size": int(service.tree.size)}).encode(),
                               "application/json")
                elif url.path == "/view":
                    body = json.loads(self._body() or b"{}")
                    service.set_view_size(body.get("view_size"))
                    self._send(200, json.dumps(service.stats()).encode(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(500, str(e).encode(), "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def demo_tree():
    """The served scene when no model is given: a 64^3 tree of 500 random
    voxels."""
    from voxelhex_tpu_torch.tree.boxtree import BoxTree

    tree = BoxTree(64, 4)
    rng = np.random.default_rng(0)
    for _ in range(500):
        p = tuple(int(v) for v in rng.integers(0, 64, 3))
        tree.insert(p, Albedo(*(int(v) for v in rng.integers(64, 255, 3)), 255))
    return tree


def terrain_tree(world: int, brick_dim: int = 4):
    """The procedural ``world``^3 terrain (:func:`~voxelhex_tpu_torch.scene.
    terrain_points`) as a BoxTree."""
    from voxelhex_tpu_torch.scene import terrain_points
    from voxelhex_tpu_torch.tree.build import from_voxels

    pts, cols = terrain_points(int(world))
    return from_voxels(pts, cols, size=int(world), brick_dim=brick_dim, simplify=True)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model", nargs="?", help=".vox file (a demo scene if omitted)")
    ap.add_argument("--port", type=int, default=8745)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--view", type=int, default=None,
                    help="streaming window size (scenes larger than the window)")
    ap.add_argument("--terrain", type=int, default=0, metavar="WORLD",
                    help="serve a procedural WORLD^3 terrain through a streaming window "
                         "(default window 256 unless --view is given)")
    ap.add_argument("--brick", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); without it the "
                         "server needs a CUDA card")
    ap.add_argument("--fuse-plan", action="store_true",
                    help="the reference's option; changes no frame here")
    args = ap.parse_args(argv)

    if args.terrain:
        tree = terrain_tree(args.terrain, brick_dim=args.brick)
        if args.view is None:
            args.view = min(256, int(args.terrain))
    elif args.model:
        from voxelhex_tpu_torch.io.vox import load_vox_tree_cached

        tree = load_vox_tree_cached(args.model, brick_dim=args.brick)
    else:
        tree = demo_tree()

    service = RenderService(tree, view_size=args.view, fuse_plan=args.fuse_plan,
                            device="cpu" if args.cpu else "cuda")
    srv = make_server(service, args.host, args.port)
    print(f"serving {tree.size}^3 scene on http://{args.host}:{args.port} "
          f"(streaming={service.view is not None}, device={service.device})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
