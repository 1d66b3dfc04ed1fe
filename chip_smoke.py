"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``voxelhex_tpu_torch/csrc`` with nvcc (one
process per source, in parallel), holds each kernel against its plain
PyTorch version on the card (the traversal and shading kernels on every ray
of the benchmark pose, the frame kernel on every pixel of three poses),
renders three 1920x1080 frames of the benchmark scene through
``fastest_renderer(...).render`` (one frame-kernel launch each) and through
the two-kernel path (``device_rays``, ``trace``, ``shade``), checks both
against the digests of the reference package's frames, then times the two
paths in turns and each kernel alone.  The last line is ``{"ok": true,
"device": {...}}``; any failure exits non-zero before it.  Needs one CUDA
card; there is no CPU fallback.
"""

import faulthandler
import sys

# a hang anywhere (a kernel that never returns, a stuck build) becomes a
# traceback and a non-zero exit instead of a run that never ends
faulthandler.dump_traceback_later(600, exit=True)

import ctypes  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

RES = (1920, 1080)
YAWS = (40.0, 130.0, 250.0)  # 40 is the benchmark pose
# sha256 of the reference package's u8 frames of the benchmark scene, made
# on the CPU with
#   fastest_renderer(flatten(bench.build_scene()), fuse_plan=True).render(
#       orbit_camera(128.0, yaw_deg=yaw, resolution=(1920, 1080)), out_u8=True)
REFERENCE_SHA256 = {
    40.0: "d91c061522544beaaef401931cfee12625ddee1e3771ce0d108ac062208fca62",
    130.0: "b933d0f8e3dfcb57e3d6ffb57202ff0072b4d910e71a4d71b196d91c7431f284",
    250.0: "cf097ce2e22639c02195c8f26d48322e53ee6d5fb70503074342fba27ec410e9",
}
TIMED_FRAMES = 10
BG = (0.25, 0.5, 0.75)  # a non-zero background for the f32 frame check
# the frame kernel's warp covers WARP_TILE pixels (columns, rows), frame.cu
WARP_TILE = (4, 8)
# a GPU-side wait queued before timed launches, so that the host has
# enqueued them all before the first one runs: the events then time the
# device alone (about 25 ms at the H100's clock)
SPACER_CYCLES = 50_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
# f32 and int32 operations in one automaton step of the traversal kernel,
# counted low from its source (an ADVANCE substep alone takes ~85)
TRAVERSE_OPS_PER_STEP = 100
# f32 operations per pixel of the frame kernel's ray generation (prologue)
# and shading with the u8 step (epilogue), counted low from frame.cu
FRAME_OPS_PER_PIXEL = 40


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def same(a, b):
    """Elementwise bit-equality that counts NaN == NaN."""
    if a.dtype.is_floating_point:
        return (a == b) | (torch.isnan(a) & torch.isnan(b))
    return a == b


def max_abs_err(a, b):
    if a.dtype == torch.bool:
        return float((a != b).any())
    d = (a.double() - b.double()).abs()
    d = torch.where(same(a, b), torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def bound(n_bytes, n_ops):
    """``(ms, what bounds it)``: the larger of the bytes over the memory rate
    and the operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timed(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events around the
    calls as the host issues them (host gaps included)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Mean device ms of ``fn()`` over ``reps`` back-to-back launches: the
    launches queue behind a GPU-side wait, so host time between them does
    not count.  Fails if the wait ended before the host had enqueued them
    all (the number would then hold host gaps)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPACER_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    behind = start.query()
    torch.cuda.synchronize()
    if behind:
        raise AssertionError(f"the GPU-side wait ended before {reps} launches were enqueued: "
                             "raise SPACER_CYCLES")
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Mean host-clock ms of ``fn()`` followed by a synchronize."""
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / reps * 1e3


def working_share(iters, tw, th):
    """Share of lane-steps that do work when warps cover tw x th pixels of
    the [h, w] per-ray step counts ``iters``: the steps taken over 32 times
    the sum of each warp's largest count."""
    h, w = iters.shape
    x = torch.zeros(-(-h // th) * th, -(-w // tw) * tw, dtype=torch.float64, device=iters.device)
    x[:h, :w] = iters
    tiles = x.reshape(x.shape[0] // th, th, x.shape[1] // tw, tw).permute(0, 2, 1, 3)
    tiles = tiles.reshape(-1, tw * th)
    return float(tiles.sum() / (32 * tiles.max(dim=1).values.sum()))


def ptxas_lines(log):
    """The lines of an ``nvcc -Xptxas -v`` log that say what each kernel uses."""
    keys = ("Compiling entry", "registers", "spill", "smem")
    return [line.strip() for line in log.splitlines() if any(k in line for k in keys)]


def main():
    t_all = time.time()
    # ---- phase 0: device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a GPU", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    tag = f"[{card}]"
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frame import render_frame, render_frame_plain
    from voxelhex_tpu_torch.ops.shade import shade, shade_plain
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS, traverse
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid, make_bitgrid_tracer
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.scene import build_scene

    # ---- phase 1: build
    t0 = time.time()
    _build.library()
    log(f"phase 1 build: {time.time() - t0:.1f} s -> {_build.library_dir()}")
    for source in _build.SOURCES:
        for line in ptxas_lines(_build.build_log(source)):
            log(f"  ptxas {source}: {line}")
    stack = re.search(r"(\d+) bytes stack frame", _build.build_log("frame.cu"))
    log(f"  frame kernel stack frame: {stack.group(1) + ' bytes' if stack else 'not reported'}")

    # ---- phase 2: each kernel against its plain version, bench pose
    t0 = time.time()
    scene = build_scene()
    tree = device_bitgrid(scene, dev)
    log(f"scene: size {scene.size}, {scene.n_levels} levels, {len(scene.occ_lo)} word pairs, "
        f"{scene.palette.shape[0]} colors ({time.time() - t0:.1f} s)")
    o, d = device_rays(orbit_camera(128.0, resolution=RES), dev)
    R = o.shape[0]

    k_out = traverse(tree, o, d)
    torch.cuda.synchronize()
    plain = make_bitgrid_tracer(len(tree["bases"]), tree["size"], max_iters=MAX_ITERS,
                                **KERNEL_CONFIG)
    t1 = time.time()
    st = plain.run(tree, plain.init(tree, o, d), MAX_ITERS)
    p_out = (st["hit"], plain.resolve_color(tree, st["hit"], st["hvox"]), st["hvox"],
             st["point"], st["hnormal"])
    torch.cuda.synchronize()
    plain_trace_ms = (time.time() - t1) * 1e3
    steps = int(st["iters"].sum())
    still_active = int(st["active"].sum())
    errs = {}
    for name, a, b in zip(("hit", "voxel", "hvox", "point", "hnormal"), k_out, p_out):
        n_bad = int((~same(a, b)).reshape(R, -1).any(dim=1).sum())
        errs[name] = max_abs_err(a, b)
        log(f"  traverse {name}: {n_bad} rays differ, max abs err {errs[name]}")
        if n_bad:
            raise AssertionError(f"traverse kernel differs from the plain tracer on {name}")
    trav_err = max(errs.values())
    n_hit = int(k_out[0].sum())
    log(f"  traverse == plain on all {R} rays ({n_hit} hits, {steps} automaton steps, "
        f"max {int(st['iters'].max())} per ray, {still_active} still active at max_iters)")
    iters_hw = st["iters"].reshape(RES[1], RES[0])
    for tw, th in ((32, 1), (16, 2), (8, 4), (4, 8)):
        chosen = " (the frame kernel's warp)" if (tw, th) == WARP_TILE else ""
        log(f"  working lane-steps, warps of {tw} columns x {th} rows: "
            f"{working_share(iters_hw, tw, th):.4f}{chosen}")

    hit, voxel, _hv, _pt, hn = k_out
    s_k = shade(hit, voxel, hn, tree["palette"])
    torch.cuda.synchronize()
    s_p = shade_plain(hit, voxel, hn, tree["palette"])
    torch.cuda.synchronize()
    n_bad = int((s_k != s_p).any(dim=1).sum())
    shade_err = max_abs_err(s_k, s_p)
    log(f"  shade: {n_bad} pixels differ, max abs err {shade_err}")
    if n_bad:
        raise AssertionError("shade kernel differs from the plain shade")

    frame_err, frame_plain_ms = 0.0, None
    for yaw, bg, out_u8 in [(yaw, (0.0, 0.0, 0.0), True) for yaw in YAWS] + [(YAWS[0], BG, False)]:
        cam = orbit_camera(128.0, yaw_deg=yaw, resolution=RES)
        k = render_frame(tree, cam, bg, out_u8)
        torch.cuda.synchronize()
        t1 = time.time()
        p = render_frame_plain(tree, cam, bg, out_u8)
        torch.cuda.synchronize()
        if yaw == YAWS[0] and out_u8:
            frame_plain_ms = (time.time() - t1) * 1e3
        if k.shape != p.shape or k.dtype != p.dtype:
            raise AssertionError(f"frame kernel gives {k.dtype} {tuple(k.shape)}, "
                                 f"the plain frame {p.dtype} {tuple(p.shape)}")
        n_bad = int((~same(k, p)).any(dim=-1).sum())
        err = max_abs_err(k, p)
        frame_err = max(frame_err, err)
        log(f"  frame yaw {yaw} {'u8' if out_u8 else 'f32'} bg {bg}: {n_bad} pixels differ, "
            f"max abs err {err}")
        if n_bad:
            raise AssertionError("frame kernel differs from the plain frame")
    log(f"phase 2 kernels == plain versions: {time.time() - t0:.1f} s")

    # ---- phase 3: the main path, three poses
    t0 = time.time()
    renderer = fastest_renderer(scene, device="cuda")

    def two_kernel_frame(cam):
        """The frame through the traversal and shading kernels, from rays
        made by ``device_rays``."""
        w, h = cam.resolution
        hit, voxel, _hv, _pt, hn = renderer.trace(*device_rays(cam, dev))
        return shade(hit, voxel, hn, renderer.tree["palette"]).reshape(h, w, 3)

    launches = {}
    for path, draw, want in (
        ("main path (render)", renderer.render, {"frame": len(YAWS), "traverse": 0, "shade": 0}),
        ("two-kernel path", two_kernel_frame, {"frame": 0, "traverse": len(YAWS),
                                               "shade": len(YAWS)}),
    ):
        render_frame.launches = traverse.launches = shade.launches = 0
        frames = {yaw: draw(orbit_camera(128.0, yaw_deg=yaw, resolution=RES)) for yaw in YAWS}
        torch.cuda.synchronize()
        counts = {"frame": render_frame.launches, "traverse": traverse.launches,
                  "shade": shade.launches}
        log(f"{path} launches: {counts}")
        if counts != want:
            raise AssertionError(f"{path}: launches {counts}, want {want}")
        launches.update({k: n for k, n in counts.items() if want[k]})
        bad = []
        for yaw, frame in frames.items():
            if tuple(frame.shape) != (RES[1], RES[0], 3) or frame.dtype != torch.uint8:
                raise AssertionError(f"frame {yaw}: {frame.dtype} {tuple(frame.shape)}")
            host = frame.cpu().contiguous().numpy()
            digest = hashlib.sha256(host.tobytes()).hexdigest()
            ok = digest == REFERENCE_SHA256[yaw]
            log(f"  frame yaw {yaw}: sha256 {digest} {'== reference' if ok else '!= reference'}")
            if not ok:
                bad.append(yaw)
        if bad:
            for yaw in bad:  # locate the difference against the plain versions
                cam = orbit_camera(128.0, yaw_deg=yaw, resolution=RES)
                ref = render_frame_plain(tree, cam)
                diff = (frames[yaw].int() - ref.int()).abs()
                log(f"  frame yaw {yaw}: {int((diff > 0).any(dim=-1).sum())} pixels differ from "
                    f"the plain versions, largest difference {int(diff.max())}")
            raise AssertionError(f"{path}: frames {bad} differ from the reference digests")
    log(f"phase 3 main path and two-kernel path: {time.time() - t0:.1f} s")

    # ---- phase 4: timing
    t0 = time.time()
    cam = orbit_camera(128.0, resolution=RES)
    paths = {"two-kernel": lambda: two_kernel_frame(cam), "frame kernel": lambda: renderer.render(cam)}
    for fn in paths.values():
        for _ in range(2):
            fn()
    turns = {name: {"event": [], "host": []} for name in paths}
    for name in ("two-kernel", "frame kernel", "frame kernel", "two-kernel"):
        ev = timed(paths[name], TIMED_FRAMES)
        ho = host_ms(paths[name], TIMED_FRAMES)
        turns[name]["event"].append(ev)
        turns[name]["host"].append(ho)
        log(f"  turn {name}: {ev:.4f} ms/frame by CUDA events, {ho:.4f} ms per render() "
            f"by host clock {tag}")
    for name, t in turns.items():
        ev, ho = sum(t["event"]) / 2, sum(t["host"]) / 2
        log(f"frame 1920x1080, {name} path: {ev:.4f} ms by CUDA events ({R / ev * 1e3:.0f} "
            f"rays/s), {ho:.4f} ms per render() by host clock {tag}")
    frame_ms = device_ms(lambda: render_frame(tree, cam), TIMED_FRAMES)
    frame_f32_ms = device_ms(lambda: render_frame(tree, cam, BG, False), TIMED_FRAMES)
    raygen_ms = timed(lambda: device_rays(cam, dev), TIMED_FRAMES)
    trav_ms = device_ms(lambda: traverse(tree, o, d), TIMED_FRAMES)
    shade_ms = device_ms(lambda: shade(hit, voxel, hn, tree["palette"]), TIMED_FRAMES)
    trav_event_ms = timed(lambda: traverse(tree, o, d), TIMED_FRAMES)
    shade_event_ms = timed(lambda: shade(hit, voxel, hn, tree["palette"]), TIMED_FRAMES)
    shade_plain_ms = timed(lambda: shade_plain(hit, voxel, hn, tree["palette"]), 3)
    log(f"frame kernel: {frame_ms:.4f} ms/launch device time (u8), {frame_f32_ms:.4f} ms (f32), "
        f"1 launch/frame {tag}")
    ev, ho = (sum(turns["frame kernel"][k]) / 2 for k in ("event", "host"))
    log(f"card busy on the frame path: {frame_ms / ev:.3f} of back-to-back frames, "
        f"{frame_ms / ho:.3f} of render() calls that each wait for their frame {tag}")
    log(f"raygen (plain PyTorch, two-kernel path): {raygen_ms:.3f} ms/frame by CUDA events {tag}")
    log(f"traverse kernel: {trav_ms:.4f} ms/launch device time, {trav_event_ms:.4f} ms by "
        f"CUDA events around the calls {tag}")
    log(f"shade kernel: {shade_ms:.4f} ms/launch device time, {shade_event_ms:.4f} ms by "
        f"CUDA events around the calls {tag}")
    log(f"plain tracer: {plain_trace_ms:.1f} ms (host clock, one run); "
        f"plain shade: {shade_plain_ms:.3f} ms; plain frame: {frame_plain_ms:.1f} ms "
        f"(host clock, one run) {tag}")

    # least time the card could take for the same work
    n_pairs = tree["occ_pairs"].shape[0]
    trav_bytes = R * (12 + 12) + n_pairs * 8 + n_hit * 2 + R * (1 + 4 + 12 + 12 + 12)
    trav_ops = steps * TRAVERSE_OPS_PER_STEP
    trav_bound, trav_by = bound(trav_bytes, trav_ops)
    shade_bytes = R * (1 + 4 + 12 + 3) + tree["palette"].shape[0] * 16
    shade_bound, shade_by = bound(shade_bytes, R * 12)
    # the frame reads the pyramid, 2 B of color per hit, the palette and its
    # launch parameters, and writes 3 B per pixel
    frame_bytes = (n_pairs * 8 + n_hit * 2 + tree["palette"].shape[0] * 16
                   + ctypes.sizeof(_build.FrameParams) + R * 3)
    frame_ops = steps * TRAVERSE_OPS_PER_STEP + R * FRAME_OPS_PER_PIXEL
    frame_bound, frame_by = bound(frame_bytes, frame_ops)
    log(f"bounds: traverse {trav_bound:.4f} ms ({trav_bytes} B, {trav_ops} ops), "
        f"shade {shade_bound:.4f} ms ({shade_bytes} B), "
        f"frame {frame_bound:.4f} ms ({frame_bytes} B, {frame_ops} ops) {tag}")
    log(f"phase 4 timing: {time.time() - t0:.1f} s")

    kernels = [
        {"name": "frame", "route": "cuda", "source": "voxelhex_tpu_torch/csrc/frame.cu",
         "replaces": "voxelhex_tpu/ops/traverse_pallas.py:79", "launches": launches["frame"],
         "max_abs_err": frame_err, "ms": frame_ms, "plain_ms": frame_plain_ms,
         "bound_ms": frame_bound, "bound_by": frame_by, "library_ms": None},
        {"name": "traverse", "route": "cuda", "source": "voxelhex_tpu_torch/csrc/traverse.cu",
         "replaces": "voxelhex_tpu/ops/traverse_pallas.py:79", "launches": launches["traverse"],
         "max_abs_err": trav_err, "ms": trav_ms, "plain_ms": plain_trace_ms,
         "bound_ms": trav_bound, "bound_by": trav_by, "library_ms": None},
        {"name": "shade", "route": "cuda", "source": "voxelhex_tpu_torch/csrc/shade.cu",
         "replaces": "voxelhex_tpu/ops/shade_pallas.py:40", "launches": launches["shade"],
         "max_abs_err": shade_err, "ms": shade_ms, "plain_ms": shade_plain_ms,
         "bound_ms": shade_bound, "bound_by": shade_by, "library_ms": None},
    ]
    log(f"total: {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
