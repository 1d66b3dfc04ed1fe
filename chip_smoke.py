"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``voxelhex_tpu_torch/csrc`` with nvcc, holds
each kernel against its plain PyTorch version on the card at the benchmark
pose, renders three 1920x1080 frames of the benchmark scene through
``fastest_renderer(...).render`` and checks them against the digests of the
reference package's frames, then times frames and kernels with CUDA events.
The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.  Needs one CUDA card; there is no CPU fallback.
"""

import faulthandler
import sys

# a hang anywhere (a kernel that never returns, a stuck build) becomes a
# traceback and a non-zero exit instead of a run that never ends
faulthandler.dump_traceback_later(600, exit=True)

import hashlib  # noqa: E402
import json  # noqa: E402
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
# f32 and int32 operations in one automaton step of the traversal kernel,
# counted low from its source (an ADVANCE substep alone takes ~85)
TRAVERSE_OPS_PER_STEP = 100


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
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    from voxelhex_tpu_torch.ops.shade import shade, shade_plain
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS, traverse
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid, make_bitgrid_tracer
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.scene import build_scene

    # ---- phase 1: build
    t0 = time.time()
    _build.library()
    log(f"phase 1 build: {time.time() - t0:.1f} s -> {_build.library_path()}")
    for line in _build.build_log().splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
            log(f"  ptxas: {line.strip()}")

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
    log(f"phase 2 kernels == plain versions: {time.time() - t0:.1f} s")

    # ---- phase 3: the main path, three poses
    t0 = time.time()
    renderer = fastest_renderer(scene, device="cuda")
    traverse.launches = 0
    shade.launches = 0
    frames = {}
    for yaw in YAWS:
        frames[yaw] = renderer.render(orbit_camera(128.0, yaw_deg=yaw, resolution=RES), out_u8=True)
    torch.cuda.synchronize()
    launches = {"traverse": traverse.launches, "shade": shade.launches}
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        if n < len(YAWS):
            raise AssertionError(f"{name} kernel launched {n} times on the main path")
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
            ro, rd = device_rays(cam, dev)
            h, v, _a, _b, n = plain(tree, ro, rd)
            ref = shade_plain(h, v, n, tree["palette"]).reshape(frames[yaw].shape)
            diff = (frames[yaw].int() - ref.int()).abs()
            log(f"  frame yaw {yaw}: {int((diff > 0).any(dim=-1).sum())} pixels differ from "
                f"the plain versions, largest difference {int(diff.max())}")
        raise AssertionError(f"frames {bad} differ from the reference digests")
    log(f"phase 3 main path: {time.time() - t0:.1f} s")

    # ---- phase 4: timing
    t0 = time.time()
    cam = orbit_camera(128.0, resolution=RES)
    for _ in range(2):
        renderer.render(cam)
    frame_ms = timed(lambda: renderer.render(cam), TIMED_FRAMES)
    raygen_ms = timed(lambda: device_rays(cam, dev), TIMED_FRAMES)
    trav_ms = timed(lambda: traverse(tree, o, d), TIMED_FRAMES)
    shade_ms = timed(lambda: shade(hit, voxel, hn, tree["palette"]), TIMED_FRAMES)
    shade_plain_ms = timed(lambda: shade_plain(hit, voxel, hn, tree["palette"]), 3)
    log(f"frame 1920x1080: {frame_ms:.3f} ms, {R / frame_ms * 1e3:.0f} rays/s {tag}")
    log(f"raygen (plain PyTorch): {raygen_ms:.3f} ms/frame {tag}")
    log(f"traverse kernel: {trav_ms:.3f} ms/launch, 1 launch/frame {tag}")
    log(f"shade kernel: {shade_ms:.3f} ms/launch, 1 launch/frame {tag}")
    log(f"plain tracer: {plain_trace_ms:.1f} ms (host clock, one run); "
        f"plain shade: {shade_plain_ms:.3f} ms {tag}")

    # least time the card could take for the same work
    n_pairs = tree["occ_pairs"].shape[0]
    trav_bytes = R * (12 + 12) + n_pairs * 8 + n_hit * 2 + R * (1 + 4 + 12 + 12 + 12)
    trav_ops = steps * TRAVERSE_OPS_PER_STEP
    trav_bound, trav_by = bound(trav_bytes, trav_ops)
    shade_bytes = R * (1 + 4 + 12 + 3) + tree["palette"].shape[0] * 16
    shade_bound, shade_by = bound(shade_bytes, R * 12)
    log(f"bounds: traverse {trav_bound:.4f} ms ({trav_bytes} B, {trav_ops} ops), "
        f"shade {shade_bound:.4f} ms ({shade_bytes} B) {tag}")
    log(f"phase 4 timing: {time.time() - t0:.1f} s")

    kernels = [
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
