"""The albedo backward against another tree's.

    python3 tools/albedo_ab.py --parent DIR [--rounds N]

Sets up the albedo backward's inputs as phase 11 of ``chip_smoke.py`` does:
``DiffRenderer`` of the bench tree over two 1080p poses (4,147,200 rays),
dL/drgb drawn as there.  Prints the rays that hit, the rows they add into
and the atomic adds each kernel issues, counted from the data
(``backward_adds``; one a channel and contributing ray for a kernel that
adds every ray on its own).

``--parent DIR``: ``DIR``'s ``csrc/albedo.cu`` (another commit's tree, e.g.
unpacked with ``git archive`` under ``build/parent``) is built with this
tree's nvcc flags; both kernels are held to ``albedo_backward_plain``
(``chip_smoke.py``'s tolerance and zero pattern) and timed by device time
as each tree's wrapper calls them (the parent: ``torch.zeros``, then its
kernel; this tree: ``albedo_backward``) in turns parent, change, change,
parent, ``--rounds`` times, with ``index_add_`` of the pre-multiplied rows
(``chip_smoke.py``'s yardstick) in the same rounds.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 20  # launches a timed turn


def build_so(build, source, out):
    """``source`` built with the kernels' nvcc flags into ``out``."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    run = subprocess.run([build._nvcc(), *build.FLAGS, "-o", out, source], capture_output=True,
                         text=True, timeout=build.BUILD_TIMEOUT_S)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc {source} failed:\n{run.stdout}{run.stderr}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of another tree's copy")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("albedo_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from voxelhex_tpu_torch.diff.render import DiffRenderer
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.albedo import (CHUNK, albedo_backward, albedo_backward_plain,
                                               backward_adds, lambert)
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.scene import build_scene_tree
    from voxelhex_tpu_torch.tree.flat import flatten

    chip_smoke.faulthandler.cancel_dump_traceback_later()
    card = chip_smoke.card_line()
    tag = f"[{card}]"
    print(f"card: {card}", flush=True)
    t0 = time.time()
    _build.library()
    path = os.path.join(ROOT, "build", "albedo_ab", "libalbedo_parent.so")
    build_so(_build, os.path.join(os.path.abspath(args.parent), "voxelhex_tpu_torch", "csrc",
                                  "albedo.cu"), path)
    fn = ctypes.CDLL(path).vhx_albedo_backward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [p, p, p, p, p, i, i, i, p, i, p], i
    print(f"built in {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    diff = DiffRenderer(flatten(build_scene_tree(4)), device=dev)
    rays = [device_rays(orbit_camera(128.0, yaw_deg=y, resolution=chip_smoke.RES), dev)
            for y in chip_smoke.ALBEDO_YAWS]
    o = torch.cat([r[0].reshape(-1, 3) for r in rays])
    d = torch.cat([r[1].reshape(-1, 3) for r in rays])
    R = o.shape[0]
    shape = tuple(diff.init_params().shape[:2])
    hit, _voxel, brick, cell, _point, normal = diff.trace_rays(o, d)
    gen = torch.Generator(device=dev).manual_seed(11)
    g_rgb = torch.randn((R, 3), generator=gen, device=dev) * 1e-3
    ok = hit & (brick >= 0)
    rows = brick[ok].long() * shape[1] + cell[ok].long()
    n_ok = int(ok.sum())
    adds, runs = backward_adds(hit, brick, cell, shape)
    print(f"{R} rays, {int(hit.sum())} hits, {n_ok} on {int(torch.unique(rows).numel())} rows; "
          f"adds: {3 * n_ok} one a channel and ray; this tree's kernel (chunks of {CHUNK}) "
          f"{adds} in {runs} runs", flush=True)
    n_params = shape[0] * shape[1] * 3
    gp = albedo_backward_plain(g_rgb, hit, brick, cell, normal, shape).reshape(-1)
    scale = float(gp.abs().max())

    def check(name, g):
        g = g.reshape(-1)
        torch.cuda.synchronize()
        err = float((g - gp).abs().max())
        zeros = int(((g == 0) != (gp == 0)).sum())
        close = bool(((g - gp).abs() <= chip_smoke.GRAD_RTOL * gp.abs()
                      + chip_smoke.GRAD_ATOL_SHARE * scale).all())
        print(f"  {name}: max abs err {err} (largest element {scale}), {zeros} zero in one only",
              flush=True)
        if not close or zeros:
            raise AssertionError(f"{name} differs from albedo_backward_plain")

    stream = torch.cuda.current_stream(dev).cuda_stream

    def parent():
        g = torch.zeros(n_params, device=dev)
        _build.check(fn(g_rgb.data_ptr(), hit.data_ptr(), brick.data_ptr(), cell.data_ptr(),
                        normal.data_ptr(), R, shape[0], shape[1], g.data_ptr(), 0, stream),
                     "parent backward")
        return g

    pre = (g_rgb[ok] * lambert(normal[ok])[:, None]).reshape(-1)
    flat_idx = (rows[:, None] * 3 + torch.arange(3, device=dev)).reshape(-1)
    grad_out = torch.zeros(n_params, device=dev)
    timers = {"parent": parent,
              "change": lambda: albedo_backward(g_rgb, hit, brick, cell, normal, shape),
              "index_add_": lambda: grad_out.zero_().index_add_(0, flat_idx, pre)}
    check("change", timers["change"]())
    check("parent", parent())
    for timer in timers.values():
        for _ in range(2):
            timer()
    got = {name: [] for name in timers}
    print("as each tree's wrapper calls it, device time, turns parent, change, index_add_, "
          "index_add_, change, parent:")
    for _ in range(args.rounds):
        for name in ("parent", "change", "index_add_", "index_add_", "change", "parent"):
            got[name].append(chip_smoke.device_ms(timers[name], REPS))
    for name, t in got.items():
        print(f"  {name}: turns " + ", ".join(f"{x:.4f}" for x in t)
              + f" ms; mean {sum(t) / len(t):.4f} ms {tag}", flush=True)
    ms = {name: sum(t) / len(t) for name, t in got.items()}
    print(f"change / parent {ms['change'] / ms['parent']:.4f}, change / index_add_ "
          f"{ms['change'] / ms['index_add_']:.4f} {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
