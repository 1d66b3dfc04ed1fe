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
paths in turns and each kernel alone.

The batched frames follow (phase 4b): the batched kernel (``csrc/frames.cu``,
K frames a launch with each frame's row digest) against its plain version
on every pixel and digest of a 16-frame batch of the three poses, each frame
against the reference digests; ``render_delta_many`` of 16 bench frames
twice (one launch a batch; the first fetches one frame, the second none,
with one blocking read); a block painted into the scene, of which only the
row band is fetched; ``FramePipeline`` frames; then the device times of
the batched kernel, the frame kernel and the multi-hit march in turns, and
the per-frame host time of the delta batch, of waited ``render()`` calls
and of pipelined frames, in turns; then (f) what the automaton's warps
run at the bench pose: the plain tracer's record of each ray's moves, the
share of 4 x 8 warp-steps whose lanes move differently, and the DDA steps
a warp runs with one branch a move and with one DDA step a turn (the loop
of ``csrc/traverse.cuh``), with ptxas's report of the four kernels that
run the automaton (no stack, no spills).

The training slice follows: the multi-hit march, the composite's forward
and backward and the Adam update, each against its plain version at the
bench's shapes (every ray of the 1080p bench pose, K = 2, the 67,108,864
params of the 256^3 world); the march against the reference package's hits
by digest, with ptxas's report of its kernel (no stack, no spills) and the
share of lane-steps that do work when a warp runs its rays to their first
hits and then on, and when it runs each ray in one loop, counted from the
plain march's steps; the training path (``SoftRenderer.train_step_fused``)
on the bench's own target (loss exactly 0, params unchanged) and on a
constant target for 4 steps against the reference package's losses and param sums,
one launch of each of the four kernels per step and no host
synchronization inside a step; then its timing.

Phase 10 runs the scene model: the bench scene built as a BoxTree by
``from_voxels``, flattened and turned into a BitGrid by the host library,
equal to the painted one field for field, and rendered by
``fastest_renderer(tree)`` to the reference digests; a bencode save and
load; an edit (``insert_at_lod``) whose delta batch fetches one row band,
equal to a fresh ``render()``; the same content at brick_dim 32 in a 512
world (5 levels, a padded top level) and the 1024 terrain (2 GiB of
colors) resident on the card, each frame against ``render_frame_plain`` on
every pixel and the reference digest, the batched kernel against the frame
kernel on 16 terrain poses; then each stage's host seconds and both frame
kernels' device time at the terrain beside the bench.  The last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
Needs one CUDA card; there is no CPU fallback.
"""

import faulthandler
import sys

# a hang anywhere (a kernel that never returns, a stuck build) becomes a
# traceback and a non-zero exit instead of a run that never ends
faulthandler.dump_traceback_later(900, exit=True)

import ctypes  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
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
BATCH = 16  # bench.py's K: frames a render_delta_many batch
# the batched kernel's mixed-pose check: the three poses, each for two frames
MIXED_YAWS = tuple(YAWS[k // 2 % len(YAWS)] for k in range(BATCH))
# a block painted into the scene for the content-change check: its min
# corner and edge, in voxels; it moves a band of about 80 of the 1080 rows
# of the bench pose
PAINT = ((96, 8, 30), 8)
# ---- phase 10, the scene model: the bench content at brick_dim 32 in a 512
# world (5 levels, a padded top level), and the large terrain
# (examples/terrain.py, BASELINE.json's config 4) in a 1024 world
TERRAIN_WORLD = 1024
# sha256 of the reference package's u8 frames, made on the CPU with
#   fastest_renderer(from_voxels(pts, cols, size=512, brick_dim=32)).render(
#       orbit_camera(128.0, yaw_deg=40, resolution=(1920, 1080)), out_u8=True)
# over bench.build_scene()'s points and colors (the same frame as the
# 256 world's, REFERENCE_SHA256[40.0]), and with
#   fastest_renderer(examples/terrain.build_terrain(1024)).render(
#       orbit_camera(1024.0, resolution=(1920, 1080)), out_u8=True)
BRICK32_SHA256 = "d91c061522544beaaef401931cfee12625ddee1e3771ce0d108ac062208fca62"
TERRAIN_SHA256 = "4453a7c9857153c1f9842a6b376aebac2aca7b99ebd094f0d645062b3dbbe6b2"
# the edit of phase 10 (c): insert_at_lod of this block into the bench tree
EDIT = ((96, 8, 30), 8, (30, 30, 240, 255))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
# f32 and int32 operations in one automaton step of the traversal kernel,
# counted low from its source (an ADVANCE substep alone takes ~85)
TRAVERSE_OPS_PER_STEP = 100
# f32 operations per pixel of the frame kernel's ray generation (prologue)
# and shading with the u8 step (epilogue), counted low from frame.cu
FRAME_OPS_PER_PIXEL = 40

# ---- the training slice: bench.py's SoftRenderer(tree, max_hits=2,
# max_iters=2048) with optax.adam(0.05), on the bench pose at 1920x1080
MAX_HITS = 2
LR = 0.05
CONST_TARGET = (0.25, 0.5, 0.75)
TRAIN_STEPS = 4
CHAIN = 16  # steps timed back to back (bench.py's CHAIN)
# sha256 of count (int32 [R]) then voxels (int32 [R, 2, 3]) from the
# reference package's march, made on the CPU with
#   SoftRenderer(flatten(bench.build_scene()), max_hits=2, max_iters=2048)
#   .trace_hits(o, d, compact=True)
# on device_rays(orbit_camera(128.0, yaw_deg=40, resolution=(1920, 1080)))
HITS_SHA256 = "a646a03a5f5e3f0d4117f445fc9f40f2ec665e2ccfe35e51ed1cd1bdea1a51e7"
# the reference package's 4 steps of train_step_fused from init_params()
# with optax.adam(0.05) on those rays and the constant target, on the CPU:
# each step's loss, and the float64 sums of albedo and logits after it
# (REF_SUM0: before the first step)
REF_LOSSES = (0.2622765898704529, 0.2590024173259735, 0.256399929523468, 0.2544224262237549)
REF_SUM0 = {"albedo": 89102.28788679838, "logits": -166815187.1749115}
REF_SUMS = {
    "albedo": (90025.99316576123, 90742.01666738093, 91332.63153621554, 91779.63657346368),
    "logits": (-166815207.79333878, -166815221.9527297, -166815231.7289281,
               -166815239.2986846),
}
# tolerances of the training path against the reference.  The losses are
# means over the same squared errors; the backward's atomics add in run
# order, which moves a gradient by ulps, and Adam's nearly sign-like step
# turns a gradient ulps from zero into a param step of +-lr: the change of
# each param sum since REF_SUM0 is held to a relative 1e-4 plus 0.25, five
# params stepped the other way.
LOSS_RTOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 0.25
# the composite's kernels against their plain versions: expf in the kernel
# and in PyTorch's sigmoid may round an alpha an ulp apart (rgb atol 1e-6);
# the backward's atomics add in no fixed order (a gradient element to a
# relative 1e-4 of itself or 1e-6 of the largest element)
RGB_ATOL = 1e-6
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 1e-6
# f32 operations per hit slot of the composite forward (sigmoid, weight,
# three products and sums) and backward (its recompute plus the recurrence
# and four products), counted low from composite.cu; per element of Adam
COMPOSITE_FWD_OPS_PER_SLOT = 20
COMPOSITE_BWD_OPS_PER_SLOT = 40
ADAM_OPS_PER_ELEMENT = 16


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


def ptxas_usage(log, kernel):
    """``(registers, stack B, spill stores B, spill loads B)`` of the entry
    function whose name holds ``kernel``, from an ``nvcc -Xptxas -v`` log."""
    for chunk in log.split("Compiling entry function")[1:]:
        if kernel not in chunk.splitlines()[0]:
            continue
        regs = re.search(r"Used (\d+) registers", chunk)
        mem = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", chunk)
        if regs and mem:
            return (int(regs.group(1)),) + tuple(int(x) for x in mem.groups())
    raise AssertionError(f"no ptxas report of {kernel}")


def warp_steps(phases):
    """Warp-steps of warps of 32 consecutive rays whose lanes run ``phases``
    (a list of per-ray step counts) one after the other: each phase costs a
    warp its lanes' largest count, so lanes done early wait."""
    return sum(int(torch.nn.functional.pad(p, (0, -p.numel() % 32)).reshape(-1, 32)
                   .max(dim=1).values.sum()) for p in phases)


# the turn codes of move_counts: a step's first turn by its move, or a
# later ADVANCE substep
TURN_HIT, TURN_DESCEND, TURN_ASCEND, TURN_LATERAL, TURN_RESTART = 1, 2, 3, 4, 5
TURN_ADVANCE, TURN_SUBSTEP = 6, 7
# the three shapes of the automaton's loop that move_counts counts
LOOPS = {"branches": "one branch a move (the loop before)",
         "step_turns": "one DDA step a turn, the warp's lanes in one step",
         "free_turns": "one DDA step a turn, each lane's turns free-running"}


def move_counts(moves, res, tile, substeps):
    """What warps of ``tile`` (columns, rows) pixels run, from the plain
    tracer's move record ``moves`` (int8 [T, h * w], ``MOVE_*`` codes) of a
    frame of ``res``, under three shapes of the automaton's loop (``LOOPS``):

    * ``branches``: a warp-step runs every move one of its lanes makes, a
      DDA step for ascend (restart included) and for lateral if a lane takes
      it, and the ADVANCE's as often as its longest lane's substeps;
    * ``step_turns``: the warp's lanes still take a step together, and each
      DDA step of it is shared: the first of every moving lane's, then the
      ADVANCE's others, as often as its longest lane's substeps;
    * ``free_turns``: each lane's step takes a turn (an ADVANCE one a
      substep), a lane's turns follow each other whatever the other lanes
      do, and a turn runs one DDA step if any of its lanes needs one.

    Returns counts summed over the warps: ``dda_<loop>``, the DDA steps
    run; ``turns_<loop>``, the loop's turns (warp-steps for the first
    two); ``runs_<loop>_<branch>``, the turns in which a branch runs."""
    from voxelhex_tpu_torch.render import bitgrid as bgm

    (w, h), (tw, th) = res, tile
    T = moves.shape[0]
    x = torch.zeros((T, -(-h // th) * th, -(-w // tw) * tw), dtype=torch.int8,
                    device=moves.device)
    x[:, :h, :w] = moves.reshape(T, h, w)
    lanes = x.reshape(T, x.shape[1] // th, th, x.shape[2] // tw, tw).permute(0, 1, 3, 2, 4)
    lanes = lanes.reshape(T, -1, tw * th).long()  # [T, warps, lanes]
    took = lanes != bgm.MOVE_NONE
    adv = lanes > bgm.MOVE_ADVANCE
    k = torch.where(adv, lanes - bgm.MOVE_ADVANCE, 0)
    kinds = {"hit": lanes == bgm.MOVE_HIT, "descend": lanes == bgm.MOVE_DESCEND,
             "ascend": lanes == bgm.MOVE_ASCEND, "lateral": lanes == bgm.MOVE_LATERAL,
             "restart": lanes == bgm.MOVE_RESTART, "advance": adv}
    present = {name: m.any(dim=2) for name, m in kinds.items()}
    steps = took.any(dim=2)
    n_kinds = sum(p.long() for p in present.values())
    up = present["ascend"] | present["restart"]
    k_max = k.max(dim=2).values
    out = {"warps": lanes.shape[1], "lane_steps": int(took.sum()),
           "mixed_warp_steps": int((n_kinds >= 2).sum())}
    # a warp-step's branches, the same in the two shapes that keep steps together
    step = {"start": steps, "reach_mask": (took & ~kinds["hit"]).any(dim=2),
            "hit": present["hit"], "descend": present["descend"], "ascend": up,
            "restart": present["restart"], "lateral": present["lateral"],
            "fetch": present["descend"] | up | present["lateral"]}
    shared = torch.maximum((up | present["lateral"]).long(), k_max)
    for loop, dda in (("branches", up.long() + present["lateral"].long() + k_max),
                      ("step_turns", shared)):
        out[f"dda_{loop}"] = int(dda.sum())
        out[f"turns_{loop}"] = int(steps.sum())
        out.update({f"runs_{loop}_{name}": int(m.sum()) for name, m in step.items()})
        out[f"runs_{loop}_advance"] = int(k_max.sum())
    # free-running turns: each lane's turns in order
    n = torch.where(adv, k, took.long())
    end = n.cumsum(dim=0)
    start = end - n
    n_turns = int(end[-1].max())
    code = torch.full_like(lanes, 0)
    for name, c in (("hit", TURN_HIT), ("descend", TURN_DESCEND), ("ascend", TURN_ASCEND),
                    ("lateral", TURN_LATERAL), ("restart", TURN_RESTART),
                    ("advance", TURN_ADVANCE)):
        code = torch.where(kinds[name], c, code)
    turns = torch.zeros((n_turns + 1,) + lanes.shape[1:], dtype=torch.int8, device=lanes.device)
    for j in range(substeps):
        at = torch.where(n > j, start + j, n_turns)  # row n_turns takes what no turn does
        turns.scatter_(0, at, (code if j == 0 else torch.full_like(code, TURN_SUBSTEP)).to(
            torch.int8))
    turns = turns[:n_turns].long()
    has = {c: (turns == c).any(dim=2) for c in range(1, 8)}
    up_t = has[TURN_ASCEND] | has[TURN_RESTART]
    free = {"start": has[TURN_HIT] | has[TURN_DESCEND] | up_t | has[TURN_LATERAL]
            | has[TURN_ADVANCE],
            "reach_mask": up_t | has[TURN_ADVANCE], "hit": has[TURN_HIT],
            "descend": has[TURN_DESCEND], "ascend": up_t, "restart": has[TURN_RESTART],
            "lateral": has[TURN_LATERAL], "fetch": has[TURN_DESCEND] | up_t | has[TURN_LATERAL],
            "advance": has[TURN_ADVANCE] | has[TURN_SUBSTEP]}
    out["dda_free_turns"] = int((up_t | has[TURN_LATERAL] | free["advance"]).sum())
    out["turns_free_turns"] = int((turns != 0).any(dim=2).sum())
    out.update({f"runs_free_turns_{name}": int(m.sum()) for name, m in free.items()})
    return out


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

    from voxelhex_tpu_torch import native
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frame import render_frame, render_frame_plain
    from voxelhex_tpu_torch.ops.shade import shade, shade_plain
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS, traverse
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid, make_bitgrid_tracer
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.scene import build_scene

    # ---- phase 1: build the CUDA kernels and, beside them, the host library
    t0 = time.time()
    _build.library()
    native.library()
    log(f"phase 1 build: {time.time() - t0:.1f} s -> {_build.library_dir()}, "
        f"{native.library_path()}")
    for source in _build.SOURCES:
        for line in ptxas_lines(_build.build_log(source)):
            log(f"  ptxas {source}: {line}")
    for source, kernel, max_regs in (("frame.cu", "frame_kernel", 47),
                                     ("frames.cu", "frames_kernel", None),
                                     ("traverse.cu", "traverse_kernel", None),
                                     ("multihit.cu", "multihit_kernel", None)):
        usage = ptxas_usage(_build.build_log(source), kernel)
        log(f"  ptxas {kernel}: {usage[0]} registers, {usage[1]} B stack frame, {usage[2]} B "
            f"spill stores, {usage[3]} B spill loads")
        if usage[1:] != (0, 0, 0) or (max_regs is not None and usage[0] > max_regs):
            raise AssertionError(f"{kernel}: {usage[0]} registers (at most {max_regs}), "
                                 f"{usage[1:]} B of stack and spills")

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

    def device_frame(cam):
        """The main path's u8 frame, left on the card."""
        return renderer.render(cam, out_u8=True, out_device=True)

    def two_kernel_frame(cam):
        """The frame through the traversal and shading kernels, from rays
        made by ``device_rays``."""
        w, h = cam.resolution
        hit, voxel, _hv, _pt, hn = renderer.trace(*device_rays(cam, dev))
        return shade(hit, voxel, hn, renderer.tree["palette"]).reshape(h, w, 3)

    launches = {}
    for path, draw, want in (
        ("main path (render)", device_frame, {"frame": len(YAWS), "traverse": 0, "shade": 0}),
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
    paths = {"two-kernel": lambda: two_kernel_frame(cam), "frame kernel": lambda: device_frame(cam)}
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
    # shade's 41.7 MB of inputs fit the 50 MB L2, where the timing above finds
    # them: time it also with the L2 flushed (256 MB written) before each launch
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cold = device_ms_each(lambda: shade(hit, voxel, hn, tree["palette"]), TIMED_FRAMES,
                          before=flush.zero_)
    shade_cold_ms = sum(cold) / len(cold)
    del flush
    log(f"frame kernel: {frame_ms:.4f} ms/launch device time (u8), {frame_f32_ms:.4f} ms (f32), "
        f"1 launch/frame {tag}")
    ev, ho = (sum(turns["frame kernel"][k]) / 2 for k in ("event", "host"))
    log(f"card busy on the frame path: {frame_ms / ev:.3f} of back-to-back frames, "
        f"{frame_ms / ho:.3f} of render() calls that each wait for their frame {tag}")
    log(f"raygen (plain PyTorch, two-kernel path): {raygen_ms:.3f} ms/frame by CUDA events {tag}")
    log(f"traverse kernel: {trav_ms:.4f} ms/launch device time, {trav_event_ms:.4f} ms by "
        f"CUDA events around the calls {tag}")
    log(f"shade kernel: {shade_ms:.4f} ms/launch device time with its inputs in L2, "
        f"{shade_cold_ms:.4f} ms with the L2 flushed before each launch, {shade_event_ms:.4f} ms "
        f"by CUDA events around the calls {tag}")
    log(f"plain tracer: {plain_trace_ms:.1f} ms (host clock, one run); "
        f"plain shade: {shade_plain_ms:.3f} ms; plain frame: {frame_plain_ms:.1f} ms "
        f"(host clock, one run) {tag}")

    # least time the card could take for the same work: the pyramid's word
    # pairs and the colors that the march at this pose reads, each once
    reads = plain_reads(tree, orbit_camera(128.0, resolution=RES), dev)
    if (reads["steps"], reads["hits"]) != (steps, n_hit):
        raise AssertionError(f"the plain march's record {reads} differs from phase 2's "
                             f"{steps} steps and {n_hit} hits")
    log(f"  the march at the bench pose reads {reads['pairs']} word pairs and "
        f"{reads['colors']} colors ({reads['sectors']} sectors of 32 B)")
    read_bytes = reads["pairs"] * 8 + reads["colors"] * 2
    trav_bytes = R * (12 + 12) + read_bytes + R * (1 + 4 + 12 + 12 + 12)
    trav_ops = steps * TRAVERSE_OPS_PER_STEP
    trav_bound, trav_by = bound(trav_bytes, trav_ops)
    shade_bytes = R * (1 + 4 + 12 + 3) + tree["palette"].shape[0] * 16
    shade_bound, shade_by = bound(shade_bytes, R * 12)
    # the frame reads those, the palette and its launch parameters, and
    # writes 3 B per pixel
    frame_bytes = (read_bytes + tree["palette"].shape[0] * 16
                   + ctypes.sizeof(_build.FrameParams) + R * 3)
    frame_ops = steps * TRAVERSE_OPS_PER_STEP + R * FRAME_OPS_PER_PIXEL
    frame_bound, frame_by = bound(frame_bytes, frame_ops)
    log(f"bounds: traverse {trav_bound:.4f} ms ({trav_bytes} B, {trav_ops} ops), "
        f"shade {shade_bound:.4f} ms ({shade_bytes} B), "
        f"frame {frame_bound:.4f} ms ({frame_bytes} B, {frame_ops} ops) {tag}")
    log(f"phase 4 timing: {time.time() - t0:.1f} s")

    frames_entry = batched_slice(dev, tree, renderer, tag, reads)
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
         "max_abs_err": shade_err, "ms": shade_cold_ms, "plain_ms": shade_plain_ms,
         "bound_ms": shade_bound, "bound_by": shade_by, "library_ms": None},
        frames_entry,
    ]
    del k_out, p_out, st, hit, voxel, hn, s_k, s_p
    torch.cuda.empty_cache()
    kernels += training_slice(dev, scene, o, d, tag)
    # after phase 9, whose profile stays the process's first, as before
    profile_delta(renderer, [cam] * BATCH, tag)
    del renderer
    torch.cuda.empty_cache()
    counts = scene_model_slice(dev, card)
    kernels[0]["launches"] += counts["frame"]
    frames_entry["launches"] += counts["frames"]
    log(f"total: {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def sha(frame):
    return hashlib.sha256(frame.cpu().contiguous().numpy().tobytes()).hexdigest()


def device_ms_each(fn, reps, before=None):
    """Device ms of each of ``reps`` launches of ``fn()``, each between
    events of its own, all queued behind a GPU-side wait so that host time
    does not count; ``before()``, if given, runs before each launch, outside
    its events (an L2 flush)."""
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPACER_CYCLES)
    for start, end in pairs:
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
    behind = pairs[0][0].query()
    torch.cuda.synchronize()
    if behind:
        raise AssertionError("the GPU-side wait ended before the launches were enqueued")
    return [start.elapsed_time(end) for start, end in pairs]


def batched_slice(dev, tree, renderer, tag, reads):
    """Phase 4b: the batched kernel against its plain version, the delta
    path, a content change, the pipeline and the timings; ``reads``, the
    march's record at the bench pose (:func:`plain_reads`).  Returns the
    batched kernel's entry of the kernels line."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.ops.frames import (render_frames, render_frames_digest,
                                               render_frames_plain)
    from voxelhex_tpu_torch.ops.multihit import multihit
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_grids, device_bitgrid
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.render.pipeline import FramePipeline
    from voxelhex_tpu_torch.scene import SIZE, grids_from_points, scene_points

    t0 = time.time()
    R = RES[0] * RES[1]
    cam = orbit_camera(128.0, resolution=RES)
    bench = [cam] * BATCH

    # (a) the kernel against its plain version: 16 frames of the three poses,
    # frame 0 against a baseline that differs from it in one row
    mixed = [orbit_camera(128.0, yaw_deg=y, resolution=RES) for y in MIXED_YAWS]
    prev = render_frame(tree, mixed[0])
    prev[RES[1] // 2, RES[0] // 3, 1] ^= 1
    k_out = render_frames(tree, mixed, prev=prev)
    torch.cuda.synchronize()
    t1 = time.time()
    p_out = render_frames_plain(tree, mixed, prev=prev)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t1) * 1e3
    for name, a, b in zip(("frames", "nrows_changed", "rowflags"), k_out, p_out):
        n_bad = int((~same(a, b)).sum())
        log(f"  frames {name}: {n_bad} elements differ from the plain version")
        if n_bad or a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"the batched kernel differs from its plain version on {name}")
    err = max(max_abs_err(a, b) for a, b in zip(k_out, p_out))
    nrows = k_out[1].tolist()
    log(f"  batched kernel == plain on {BATCH} frames of yaws {MIXED_YAWS}: changed rows "
        f"{nrows} (plain batch {plain_ms:.1f} ms, host clock, one run)")
    if nrows[0] != 1 or nrows[1] != 0 or min(nrows[2::2]) == 0 or max(nrows[1::2]) != 0:
        raise AssertionError("the digests do not show the baseline's row and the pose changes")
    bad = [k for k, (y, f) in enumerate(zip(MIXED_YAWS, k_out[0])) if sha(f) != REFERENCE_SHA256[y]]
    log(f"  batched frames against the reference digests: {BATCH - len(bad)} of {BATCH} equal")
    if bad:
        raise AssertionError(f"batched frames {bad} differ from the reference digests")
    del k_out, p_out

    # (b) the delta path: the bench's batch twice, the counts read around it
    counters = (render_frames, render_frame)
    for fn in counters:
        fn.launches = 0
    batches, stats = [], []
    for _ in range(2):
        batches.append(renderer.render_delta_many(bench))
        stats.append(dict(renderer.last_stats))
    counts = {fn.__name__: fn.launches for fn in counters}
    log(f"  render_delta_many x {BATCH}, two batches: launches {counts}")
    for st in stats:
        log(f"    {st}")
    if counts != {"render_frames": 2, "render_frame": 0}:
        raise AssertionError(f"the delta path's launches {counts}, want 2 batched, 0 single")
    if [st["delta_fetched"] for st in stats] != [1, 0] or stats[1]["host_reads"] != 1:
        raise AssertionError("the first batch did not fetch one frame, or the second fetched "
                             "a frame or read more than the digests")
    frames_launches = counts["render_frames"]
    distinct = {id(f): f for b in batches for f in b}
    digests = {sha(torch.from_numpy(f)) for f in distinct.values()}
    log(f"  delta frames: {len(distinct)} distinct array(s), sha256 {digests}")
    if digests != {REFERENCE_SHA256[40.0]} or len(distinct) != 1:
        raise AssertionError("the delta frames differ from the reference or were fetched again")

    # (c) a content change: a block painted into the scene's grids, swapped
    # in with the edit pattern; only its band of rows is fetched
    (x0, y0, z0), e = PAINT
    occ, colors, palette = grids_from_points(*scene_points(), SIZE)
    occ[x0:x0 + e, y0:y0 + e, z0:z0 + e] = True
    colors.reshape(SIZE, SIZE, SIZE)[z0:z0 + e, y0:y0 + e, x0:x0 + e] = 0  # [z, y, x]
    original = (renderer.bitgrid, renderer.tree)
    renderer.bitgrid = bitgrid_from_grids(occ, colors, palette)
    renderer.tree = device_bitgrid(renderer.bitgrid, dev)
    renderer.invalidate_beam()
    painted = renderer.render_delta_many(bench)
    st = dict(renderer.last_stats)
    fresh = renderer.render(cam, out_u8=True)
    log(f"  painted block {PAINT}: {st}")
    if st["delta_fetched"] != 1 or not 0 < st["delta_rows_fetched"] < RES[1] // 2:
        raise AssertionError("the content change did not fetch one band of rows")
    if not all(f is painted[0] for f in painted) or not (painted[0] == fresh).all():
        raise AssertionError("the patched frame differs from a fresh render()")
    renderer.bitgrid, renderer.tree = original
    renderer.invalidate_beam()
    del occ, colors, painted, fresh

    # (d) FramePipeline frames against the reference digests (= render()'s)
    pipe = FramePipeline(renderer)
    poses = list(YAWS) * 2
    futs = [pipe.render(orbit_camera(128.0, yaw_deg=y, resolution=RES), out_u8=True)
            for y in poses]
    pipe.close()
    bad = [y for y, f in zip(poses, futs) if sha(torch.from_numpy(f.result())) !=
           REFERENCE_SHA256[y]]
    log(f"  FramePipeline: {len(poses) - len(bad)} of {len(poses)} frames equal the reference")
    if bad:
        raise AssertionError(f"pipelined frames {bad} differ from the reference digests")
    log(f"phase 4b (a-d) batched kernel, delta path, content change, pipeline: "
        f"{time.time() - t0:.1f} s")

    # (e) timing: the kernels of the automaton in turns, device time: the
    # batched kernel and the frame kernel a frame, the multi-hit march a launch
    t0 = time.time()
    bench_prev = render_frame(tree, cam)
    o, d = device_rays(cam, dev)
    for _ in range(2):
        render_frames(tree, bench, prev=bench_prev)
        multihit(tree, o, d, MAX_HITS)
    timers = {"frame kernel": lambda: device_ms(lambda: render_frame(tree, cam), BATCH),
              "batched kernel": lambda: device_ms(
                  lambda: render_frames(tree, bench, prev=bench_prev), 4) / BATCH,
              "multihit kernel": lambda: device_ms(lambda: multihit(tree, o, d, MAX_HITS),
                                                   TIMED_FRAMES)}
    dev_turns = {name: [] for name in timers}
    for name in list(timers) + list(timers)[::-1]:
        ms = timers[name]()
        dev_turns[name].append(ms)
        log(f"  turn {name}: {ms:.4f} ms {'a launch' if name == 'multihit kernel' else 'a frame'} "
            f"device time {tag}")
    frame_dev = sum(dev_turns["frame kernel"]) / 2
    batch_dev = sum(dev_turns["batched kernel"]) / 2
    log(f"device time per frame: batched kernel (K={BATCH}, with digest) {batch_dev:.4f} ms, "
        f"frame kernel {frame_dev:.4f} ms; multihit kernel (K={MAX_HITS}) "
        f"{sum(dev_turns['multihit kernel']) / 2:.4f} ms a launch, in the same turns {tag}")

    # the host's time to enqueue one delta batch (the frames and their digest),
    # with the card busy, so that no wait counts
    enqueue = []
    torch.cuda.synchronize()
    torch.cuda._sleep(SPACER_CYCLES)
    for _ in range(3):
        t1 = time.perf_counter()
        render_frames_digest(tree, bench, prev=bench_prev)
        enqueue.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    log(f"host time to enqueue a batch of {BATCH}: {enqueue} ms {tag}")

    # the per-frame host time of three paths that deliver 16 frames to the host
    pipe = FramePipeline(renderer)

    def delta_batch():
        renderer.render_delta_many(bench)

    def waited_renders():
        for _ in range(BATCH):
            renderer.render(cam, out_u8=True)

    def pipelined():
        futs = [pipe.render(cam, out_u8=True) for _ in range(BATCH)]
        pipe.drain()
        return futs

    paths = {"render_delta_many": delta_batch, "16 waited render()": waited_renders,
             "FramePipeline": pipelined}
    for fn in paths.values():
        fn()
    host_turns = {name: [] for name in paths}
    for name in list(paths) + list(paths)[::-1]:
        ms = host_ms(paths[name], 3) / BATCH
        host_turns[name].append(ms)
        log(f"  turn {name}: {ms:.4f} ms/frame by host clock {tag}")
    pipe.close()
    for name, t in host_turns.items():
        ms = sum(t) / 2
        kernel = batch_dev if name == "render_delta_many" else frame_dev
        log(f"{name}: {ms:.4f} ms/frame by host clock, frames on the host; card busy "
            f"{kernel / ms:.3f} (kernel device time over host time) {tag}")

    steps = reads["steps"]
    # a launch of K frames of one pose reads the word pairs and colors its
    # march reads (once), the palette, its parameters and the 6.2 MB
    # baseline; it writes K frames and digests
    G = -(-RES[1] // 8)
    frames_bytes = (reads["pairs"] * 8 + reads["colors"] * 2 + tree["palette"].shape[0] * 16
                    + ctypes.sizeof(_build.FramesParams) + R * 3 + BATCH * R * 3
                    + BATCH * (1 + G) * 4)
    frames_ops = BATCH * (steps * TRAVERSE_OPS_PER_STEP + R * FRAME_OPS_PER_PIXEL)
    frames_bound, frames_by = bound(frames_bytes, frames_ops)
    log(f"bound: batched kernel {frames_bound:.4f} ms a launch of {BATCH} ({frames_bytes} B, "
        f"{frames_ops} ops, {frames_by}); measured {batch_dev * BATCH:.4f} ms {tag}")
    log(f"phase 4b (e) timing: {time.time() - t0:.1f} s")

    t0 = time.time()
    automaton_report(dev, tree, tag, steps)
    log(f"phase 4b (f) the automaton's moves: {time.time() - t0:.1f} s")
    return {"name": "frames", "route": "cuda", "source": "voxelhex_tpu_torch/csrc/frames.cu",
            "replaces": "voxelhex_tpu/render/bitgrid.py:2215", "launches": frames_launches,
            "max_abs_err": err, "ms": batch_dev * BATCH, "plain_ms": plain_ms,
            "bound_ms": frames_bound, "bound_by": frames_by, "library_ms": None}


def automaton_report(dev, tree, tag, steps=None):
    """Phase 4b (f): what the automaton's warps run at the bench pose,
    from the plain tracer's move record, under the frame kernels' 4 x 8
    warp tile (``move_counts``), and ptxas's report of the four kernels
    that run the automaton.  ``steps``, if given, is what the move record
    must count: the march's automaton steps at that pose."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS
    from voxelhex_tpu_torch.render.bitgrid import MOVE_ADVANCE, make_bitgrid_tracer
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera

    R = RES[0] * RES[1]
    cam = orbit_camera(128.0, resolution=RES)
    substeps = KERNEL_CONFIG["advance_substeps"]
    plain = make_bitgrid_tracer(len(tree["bases"]), tree["size"], max_iters=MAX_ITERS,
                                **KERNEL_CONFIG)
    moves = []
    st = plain.run(tree, plain.init(tree, *device_rays(cam, dev)), MAX_ITERS, moves)
    moves = torch.stack(moves)
    mc = move_counts(moves, RES, WARP_TILE, substeps)
    if mc["lane_steps"] != int(st["iters"].sum()) or steps not in (None, mc["lane_steps"]):
        raise AssertionError(f"the move record holds {mc['lane_steps']} steps, the march took "
                             f"{int(st['iters'].sum())} ({steps} in phase 2)")
    names = {1: "hit", 2: "descend", 3: "ascend", 4: "lateral", 5: "ascend past the top"}
    names.update({MOVE_ADVANCE + j: f"advance of {j} substep(s)" for j in range(1, substeps + 1)})
    hist = {name: int((moves == code).sum()) for code, name in names.items()}
    log(f"  moves at the bench pose, {mc['lane_steps']} steps of {R} rays: {hist} {tag}")
    warp_steps = mc["turns_branches"]
    log(f"  warps of {WARP_TILE[0]} x {WARP_TILE[1]} pixels ({mc['warps']}): {warp_steps} "
        f"warp-steps, {mc['mixed_warp_steps']} ({mc['mixed_warp_steps'] / warp_steps:.4f}) with "
        "two or more different moves")
    for loop, what in LOOPS.items():
        dda, turns = mc[f"dda_{loop}"], mc[f"turns_{loop}"]
        key = f"runs_{loop}_"
        log(f"  {what}: {dda} DDA steps ({dda / mc['warps']:.3f} a warp) in {turns} turns "
            f"({turns / mc['warps']:.3f} a warp); turns a branch runs in "
            f"{ {k[len(key):]: v for k, v in mc.items() if k.startswith(key)} }")
    for source, kernel in (("traverse.cu", "traverse_kernel"), ("frame.cu", "frame_kernel"),
                           ("frames.cu", "frames_kernel"), ("multihit.cu", "multihit_kernel")):
        usage = ptxas_usage(_build.build_log(source), kernel)
        log(f"  ptxas {kernel}: {usage[0]} registers, {usage[1]} B stack frame, {usage[2]} B "
            f"spill stores, {usage[3]} B spill loads {tag}")
    return mc


def profile_delta(renderer, cameras, tag, n_batches=3):
    """Where a delta batch's time goes: ``torch.profiler`` over one batch
    that is not timed and ``n_batches`` that are; the device time a batch
    against the wall time a batch inside the profiler, and the host
    operations that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        renderer.render_delta_many(cameras)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n_batches):
            renderer.render_delta_many(cameras)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / n_batches
    events = prof.key_averages()
    n = n_batches + 1
    device = sum(getattr(e, "device_time_total", 0.0) for e in events
                 if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3 / n
    if device == 0.0:
        log(f"  profiler: no device time recorded; busy share not measured {tag}")
        return
    log(f"  profiler, per delta batch of {len(cameras)}: device time {device:.4f} ms, wall time "
        f"{wall:.4f} ms under the profiler, busy share {device / wall:.3f} {tag}")
    rows = sorted(((e.self_cpu_time_total / 1e3 / n, e.count / n, e.key) for e in events),
                  reverse=True)
    for ms, count, key in rows[:8]:
        log(f"    host {ms:.4f} ms  {count:g} x  {key[:80]}")


def profile_steps(soft, params, state, opt, o, d, target, step_ms, tag, n_steps=4):
    """Where a step's device time goes: ``torch.profiler`` over ``n_steps``
    steps, the device time of each kernel name per step, and the card's
    busy share (all device time over the step time of the unprofiled run)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        soft.train_steps_fused(params, state, opt, o, d, target, n_steps)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms = getattr(e, "device_time_total", 0.0) / 1e3 / n_steps
            rows.append((ms, e.count / n_steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0.0:
        log(f"  profiler: no device time recorded; busy share not measured {tag}")
        return
    log(f"  profiler, per step over {n_steps} steps: device time {busy:.4f} ms, busy share "
        f"{busy / step_ms:.3f} of the {step_ms:.4f} ms step {tag}")
    for ms, count, key in rows[:12]:
        log(f"    {ms:.4f} ms  {count:g} x  {key[:90]}")


def host_cpu():
    """The host CPU's model name, as ``lscpu`` or ``/proc/cpuinfo`` give it."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60)
    lines = out.stdout.splitlines() if out.returncode == 0 else []
    with open("/proc/cpuinfo") as f:
        lines += f.read().splitlines()
    for line in lines:
        key, _, value = line.partition(":")
        if key.strip().lower() in ("model name", "cpu model", "hardware") and value.strip():
            return value.strip()
    return "CPU model not reported"


def plain_reads(tree, cam, dev):
    """What the plain tracer's march over ``cam``'s rays takes of the card:
    ``steps`` (automaton steps), ``hits``, ``pairs`` (the distinct 8 B word
    pairs the rays fetch) and ``colors`` (the distinct 2 B colors of the hit
    voxels), each input counted once however many rays read it, the least a
    kernel that marches these rays must read; ``sectors``, the 32 B sectors
    those pairs and colors lie in; ``share``, the working lane-steps of the
    frame kernel's warps (:func:`working_share`)."""
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS
    from voxelhex_tpu_torch.render.bitgrid import make_bitgrid_tracer
    from voxelhex_tpu_torch.render.camera import device_rays

    o, d = device_rays(cam, dev)
    plain = make_bitgrid_tracer(len(tree["bases"]), tree["size"], max_iters=MAX_ITERS,
                                **KERNEL_CONFIG)
    reads = torch.zeros(tree["occ_pairs"].shape[0], dtype=torch.bool, device=dev)
    st = plain.run(tree, plain.init(tree, o, d), MAX_ITERS, reads=reads)
    v = st["hvox"][st["hit"]].long()
    S = tree["size"]
    caddr = torch.unique(v[:, 0] + (v[:, 1] + v[:, 2] * S) * S)
    pairs = torch.nonzero(reads).squeeze(1)
    w, h = cam.resolution
    return {"steps": int(st["iters"].sum()), "hits": int(st["hit"].sum()),
            "pairs": int(pairs.numel()), "colors": int(caddr.numel()),
            "sectors": int(torch.unique(pairs // 4).numel() + torch.unique(caddr // 16).numel()),
            "share": working_share(st["iters"].reshape(h, w), *WARP_TILE)}


def check_frames_plain(tree, cams, what):
    """Each frame kernel frame of ``cams`` against ``render_frame_plain`` on
    every pixel; returns the frames and the largest difference."""
    from voxelhex_tpu_torch.ops.frame import render_frame, render_frame_plain

    out, err = [], 0.0
    for cam in cams:
        k = render_frame(tree, cam)
        p = render_frame_plain(tree, cam)
        n_bad = int((~same(k, p)).any(dim=-1).sum())
        err = max(err, max_abs_err(k, p))
        log(f"  {what}: frame kernel against render_frame_plain, {n_bad} pixels differ")
        if n_bad:
            raise AssertionError(f"{what}: the frame kernel differs from its plain version")
        out.append(k)
        del p
    return out, err


def check_resident(renderer, bg, levels, what):
    """Every pyramid level and the colors of ``bg`` on the card, as the
    kernels read them."""
    t = renderer.tree
    pairs = np.stack([bg.occ_lo, bg.occ_hi], axis=1).view(np.int32)
    if (len(t["bases"]) != levels or bg.n_levels != levels
            or t["occ_pairs"].device.type != "cuda"
            or not np.array_equal(t["occ_pairs"].cpu().numpy(), pairs)
            or not np.array_equal(t["colors"].cpu().numpy().view(np.uint16), bg.colors)):
        raise AssertionError(f"{what}: the pyramid on the card is not the host's {levels} "
                             f"levels")
    log(f"  {what}: {levels} levels of {t['dims']} blocks an axis, bases {t['bases']}, "
        f"{pairs.shape[0]} word pairs and {bg.colors.nbytes} B of colors on the card")


def scene_model_slice(dev, card):
    """Phase 10: trees built by the port's scene model, rendered by the
    frame kernels.  Returns the launches of the frame and batched kernels in
    its main path's runs."""
    import tempfile

    from voxelhex_tpu_torch.io import bencode
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.ops.frames import render_frames
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_grids, build_bitgrid, device_bitgrid
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.scene import (SIZE, build_scene, build_scene_tree,
                                          grids_from_points, scene_points, terrain_points)
    from voxelhex_tpu_torch.tree.boxtree import Albedo
    from voxelhex_tpu_torch.tree.build import from_voxels
    from voxelhex_tpu_torch.tree.flat import ARRAYS, flatten

    t_all = time.time()
    cpu = host_cpu()
    host_tag = f"[{card}; host {cpu}]"
    log(f"phase 10 host: {cpu}, {os.cpu_count()} cores")
    fields = ("size", "n_levels", "level_bases", "occ_lo", "occ_hi", "colors", "palette")
    cam = orbit_camera(128.0, resolution=RES)
    counts = {"frame": 0, "frames": 0}

    def clock(fn):
        t1 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t1

    def read_counts():
        counts["frame"] += render_frame.launches
        counts["frames"] += render_frames.launches
        return {"frame": render_frame.launches, "frames": render_frames.launches}

    # (a) the bench scene through the tree
    t0 = time.time()
    tree, s_tree = clock(lambda: build_scene_tree(4))
    flat, s_flat = clock(lambda: flatten(tree))
    bg, s_native = clock(lambda: build_bitgrid(flat))
    bg_np, s_numpy = clock(lambda: build_bitgrid(flat, native=False))
    painted = build_scene()
    for name, got in (("host library", bg), ("NumPy", bg_np)):
        bad = [k for k in fields if not np.array_equal(getattr(got, k), getattr(painted, k))]
        if bad:
            raise AssertionError(f"bench tree, {name} build_bitgrid: {bad} differ from "
                                 "build_scene()'s")
    log(f"  bench tree: {tree.node_count} nodes, {flat.n_bricks} bricks of 4^3, "
        f"{len(tree.color_palette)} colors; build_bitgrid (native and NumPy) == build_scene() "
        f"in every field")
    log(f"bench host stages: from_voxels {s_tree:.3f} s, flatten {s_flat:.3f} s, "
        f"build_bitgrid native {s_native:.3f} s, NumPy {s_numpy:.3f} s {host_tag}")
    del bg_np
    render_frame.launches = render_frames.launches = 0
    (renderer, s_up) = clock(lambda: fastest_renderer(tree))
    frames = {yaw: sha(renderer.render(orbit_camera(128.0, yaw_deg=yaw, resolution=RES),
                                       out_u8=True, out_device=True)) for yaw in YAWS}
    n = read_counts()
    log(f"  fastest_renderer(tree) ({s_up:.3f} s from the tree to the card): launches {n}, "
        f"digests == reference: {[frames[y] == REFERENCE_SHA256[y] for y in YAWS]}")
    if n != {"frame": len(YAWS), "frames": 0}:
        raise AssertionError(f"fastest_renderer(tree): launches {n}")
    if frames != REFERENCE_SHA256:
        raise AssertionError("the tree-built bench frames differ from the reference digests")
    log(f"phase 10 (a) bench tree: {time.time() - t0:.1f} s")

    # (e) the bencode round trip
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.bencode")
        bencode.save(tree, path)
        n_bytes = os.path.getsize(path)
        again = flatten(bencode.load(path))
    bad = [k for k in ARRAYS if not np.array_equal(getattr(again, k), getattr(flat, k))]
    log(f"  bencode save -> load: {n_bytes} B, flattens to the same arrays: {not bad}")
    if bad:
        raise AssertionError(f"bencode round trip: {bad} differ")
    log(f"phase 10 (e) bencode: {time.time() - t0:.1f} s")
    del again

    # (c) an edit the reference's way, through the port's tree
    t0 = time.time()
    bench = [cam] * BATCH
    renderer.render_delta_many(bench)
    pos, lod, rgba = EDIT
    tree.insert_at_lod(pos, lod, Albedo(*rgba))
    render_frame.launches = render_frames.launches = 0
    renderer.bitgrid = build_bitgrid(tree)
    renderer.tree = device_bitgrid(renderer.bitgrid, dev)
    renderer.invalidate_beam()
    edited = renderer.render_delta_many(bench)
    st = dict(renderer.last_stats)
    n = read_counts()
    fresh = renderer.render(cam, out_u8=True)
    log(f"  insert_at_lod{EDIT}: launches {n}, {st}")
    if n != {"frame": 0, "frames": 1}:
        raise AssertionError(f"the edit's delta batch: launches {n}")
    if st["delta_fetched"] != 1 or not 0 < st["delta_rows_fetched"] < RES[1] // 2:
        raise AssertionError("the edit did not fetch one band of rows")
    if not all(f is edited[0] for f in edited) or not (edited[0] == fresh).all():
        raise AssertionError("the edited frame differs from a fresh render()")
    log(f"phase 10 (c) edit: {time.time() - t0:.1f} s")
    bench_bg = painted  # the timing below renders the unedited bench
    del tree, flat, bg, renderer, edited, fresh

    # (b) the bench content at brick_dim 32 in a 512 world
    t0 = time.time()
    tree32 = build_scene_tree(32)
    flat32 = flatten(tree32)
    bg32 = build_bitgrid(flat32)
    S = bg32.size
    occ, colors, palette = grids_from_points(*scene_points(), SIZE)
    occ_w = np.zeros((S, S, S), dtype=bool)
    occ_w[:SIZE, :SIZE, :SIZE] = occ
    col_w = np.full((S, S, S), 0xFFFF, dtype=np.uint16)
    col_w[:SIZE, :SIZE, :SIZE] = colors.reshape(SIZE, SIZE, SIZE)  # [z, y, x]
    want = bitgrid_from_grids(occ_w, col_w.ravel(), palette)
    bad = [k for k in fields if not np.array_equal(getattr(bg32, k), getattr(want, k))]
    if S != 512 or bad:
        raise AssertionError(f"brick_dim 32: world {S}, {bad} differ from the painted grids "
                             "placed in the 512 world")
    log(f"  brick_dim 32: world {S}, {tree32.node_count} nodes, {flat32.n_bricks} bricks of "
        f"32^3; grids == the painted ones on [0, {SIZE})^3 and empty elsewhere")
    del occ, colors, occ_w, col_w, want, tree32
    render_frame.launches = render_frames.launches = 0
    r32 = fastest_renderer(flat32)
    (k32,), err32 = check_frames_plain(r32.tree, [cam], "brick_dim 32, bench pose")
    n = read_counts()
    check_resident(r32, r32.bitgrid, 5, "brick_dim 32")
    digest = sha(k32)
    log(f"  brick_dim 32: launches {n}, sha256 {digest} "
        f"{'==' if digest == BRICK32_SHA256 else '!='} reference")
    if digest != BRICK32_SHA256 or n != {"frame": 1, "frames": 0}:
        raise AssertionError("brick_dim 32: the frame differs from the reference digest, or "
                             f"launches {n}")
    log(f"phase 10 (b) brick_dim 32: {time.time() - t0:.1f} s")
    del r32, flat32, bg32, k32
    torch.cuda.empty_cache()

    # (d) the terrain, resident on the card
    t0 = time.time()
    (pts, cols), s_pts = clock(lambda: terrain_points(TERRAIN_WORLD))
    tree, s_tree = clock(lambda: from_voxels(pts, cols, size=TERRAIN_WORLD, brick_dim=4))
    del pts, cols
    flat, s_flat = clock(lambda: flatten(tree))
    n_nodes = tree.node_count
    del tree
    tbg, s_native = clock(lambda: build_bitgrid(flat))
    n_bricks = flat.n_bricks
    del flat
    render_frame.launches = render_frames.launches = 0
    tr, s_up = clock(lambda: fastest_renderer(tbg))
    torch.cuda.synchronize()
    log(f"terrain host stages: points {s_pts:.3f} s, from_voxels {s_tree:.3f} s, flatten "
        f"{s_flat:.3f} s, build_bitgrid native {s_native:.3f} s, upload {s_up:.3f} s "
        f"({n_nodes} nodes, {n_bricks} bricks of 4^3) {host_tag}")
    check_resident(tr, tbg, 5, "terrain")
    tcam = orbit_camera(float(TERRAIN_WORLD), resolution=RES)
    (kt,), errt = check_frames_plain(tr.tree, [tcam], "terrain")
    digest = sha(kt)
    log(f"  terrain: sha256 {digest} {'==' if digest == TERRAIN_SHA256 else '!='} reference")
    if digest != TERRAIN_SHA256:
        raise AssertionError("terrain: the frame differs from the reference digest")
    tcams = [orbit_camera(float(TERRAIN_WORLD), yaw_deg=40.0 + 22.5 * k, resolution=RES)
             for k in range(BATCH)]
    batch = tr.render_many(tcams, out_u8=True, out_device=True)
    single = [tr.render(c, out_u8=True, out_device=True) for c in tcams]
    n = read_counts()
    n_bad = [int((~same(a, b)).any(dim=-1).sum()) for a, b in zip(batch, single)]
    log(f"  terrain, 16 poses: batched kernel against the frame kernel, pixels that differ "
        f"{n_bad}; launches {n}")
    if any(n_bad) or n != {"frame": 1 + BATCH, "frames": 1}:
        raise AssertionError(f"terrain: the batched frames differ from the frame kernel's, "
                             f"or launches {n}")
    del batch, single
    log(f"phase 10 (d) terrain: {time.time() - t0:.1f} s")

    # (f) the frame kernels' device time, the terrain beside the bench
    t0 = time.time()
    scenes = {"bench": (device_bitgrid(bench_bg, dev), cam),
              "terrain": (tr.tree, tcam)}
    timers, stats = {}, {}
    for name, (t, c) in scenes.items():
        prev = render_frame(t, c)
        timers[f"{name} frame kernel"] = (lambda t=t, c=c: device_ms(
            lambda: render_frame(t, c), BATCH))
        timers[f"{name} batched kernel"] = (lambda t=t, c=c, prev=prev: device_ms(
            lambda: render_frames(t, [c] * BATCH, prev=prev), 4) / BATCH)
        stats[name] = plain_reads(t, c, dev)
    turns = {name: [] for name in timers}
    for name in list(timers) + list(timers)[::-1]:
        turns[name].append(timers[name]())
        log(f"  turn {name}: {turns[name][-1]:.4f} ms a frame device time {host_tag}")
    R = RES[0] * RES[1]
    G = -(-RES[1] // 8)
    for name, (t, c) in scenes.items():
        rd = stats[name]
        steps, n_pal = rd["steps"], t["palette"].shape[0]
        # the word pairs and colors the march reads, each once (the 16
        # frames of the batch share one pose)
        read_bytes = rd["pairs"] * 8 + rd["colors"] * 2
        fb, fby = bound(read_bytes + n_pal * 16 + ctypes.sizeof(_build.FrameParams) + R * 3,
                        steps * TRAVERSE_OPS_PER_STEP + R * FRAME_OPS_PER_PIXEL)
        bb, bby = bound(read_bytes + n_pal * 16 + ctypes.sizeof(_build.FramesParams) + R * 3
                        + BATCH * R * 3 + BATCH * (1 + G) * 4,
                        BATCH * (steps * TRAVERSE_OPS_PER_STEP + R * FRAME_OPS_PER_PIXEL))
        fm = sum(turns[f"{name} frame kernel"]) / 2
        bm = sum(turns[f"{name} batched kernel"]) / 2
        log(f"{name} ({t['size']}^3, {len(t['bases'])} levels, {t['occ_pairs'].shape[0]} word "
            f"pairs, {steps} automaton steps, {rd['hits']} hits; the march reads {rd['pairs']} "
            f"word pairs and {rd['colors']} colors, {rd['sectors'] * 32} B of 32 B sectors; "
            f"working lane-steps of {WARP_TILE[0]} x {WARP_TILE[1]} warps {rd['share']:.4f}): "
            f"frame kernel {fm:.4f} ms, bound {fb:.4f} ms ({fby}); batched kernel {bm:.4f} ms "
            f"a frame, bound {bb / BATCH:.4f} ms a frame ({bby}) {host_tag}")
    log(f"phase 10 (f) timing: {time.time() - t0:.1f} s")
    log(f"phase 10 scene model: {time.time() - t_all:.1f} s, launches {counts}, max abs err "
        f"{max(err32, errt)}")
    return counts


def training_slice(dev, scene, o, d, tag):
    """Phases 5-9: the training slice's kernels against their plain versions
    and the reference, the training path, its timing.  Returns the four
    kernels' entries of the kernels line."""
    from voxelhex_tpu_torch.diff.optim import adam
    from voxelhex_tpu_torch.diff.soft import CLAMPS, SoftRenderer
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops import adam as adam_ops
    from voxelhex_tpu_torch.ops.composite import (
        composite_backward, composite_backward_plain, composite_forward,
        composite_forward_plain)
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.ops.multihit import multihit
    from voxelhex_tpu_torch.ops.shade import shade
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS, traverse
    from voxelhex_tpu_torch.render.bitgrid import make_multihit_tracer

    R = o.shape[0]
    K = MAX_HITS
    soft = SoftRenderer(scene, max_hits=K, max_iters=MAX_ITERS, device=dev)
    tree = soft.tree
    n_vox = soft.size ** 3

    # ---- phase 5: the multi-hit march against its plain version and the reference
    t0 = time.time()
    k_hits = multihit(tree, o, d, K)
    torch.cuda.synchronize()
    t1 = time.time()
    trace = make_multihit_tracer(len(tree["bases"]), tree["size"], K, MAX_ITERS, **KERNEL_CONFIG)
    *p_hits, steps = trace(tree, o, d, with_steps=True)
    torch.cuda.synchronize()
    mh_plain_ms = (time.time() - t1) * 1e3
    usage = ptxas_usage(_build.build_log("multihit.cu"), "multihit_kernel")
    log(f"  ptxas multihit_kernel: {usage[0]} registers, {usage[1]} B stack frame, {usage[2]} B "
        f"spill stores, {usage[3]} B spill loads")
    if usage[1:] != (0, 0, 0):
        raise AssertionError("multihit_kernel uses local memory")
    for name, a, b in zip(("count", "voxels"), k_hits, p_hits):
        n_bad = int((a != b).reshape(R, -1).any(dim=1).sum())
        log(f"  multihit {name}: {n_bad} rays differ from the plain march")
        if n_bad:
            raise AssertionError(f"multihit kernel differs from the plain march on {name}")
    kd, pd = k_hits[2], p_hits[2]
    ulps = (kd.view(torch.int32).long() - pd.view(torch.int32).long()).abs()
    ulps = torch.where(same(kd, pd), torch.zeros_like(ulps), ulps)
    n_bad = int((ulps > 0).sum())
    log(f"  multihit dists: {n_bad} slots differ from the plain march, largest {int(ulps.max())} "
        "ulp")
    if int(ulps.max()) > 1:
        raise AssertionError("multihit dists differ from the plain march by more than 1 ulp")
    mh_err = max(max_abs_err(k_hits[0], p_hits[0]), max_abs_err(k_hits[1], p_hits[1]),
                 max_abs_err(kd, pd))
    count, voxels = k_hits[0], k_hits[1]
    # the distinct word pairs the march reads, for its bound
    mh_reads = torch.zeros(tree["occ_pairs"].shape[0], dtype=torch.bool, device=dev)
    trace(tree, o, d, reads=mh_reads)
    n_mh_pairs = int(mh_reads.sum())
    del mh_reads
    n_hit_rays = int((count > 0).sum())
    n_slots = int(count.sum())
    v = voxels[voxels[..., 0] >= 0].long()  # [n_slots, 3]
    n_unique = int(torch.unique(v[:, 0] + (v[:, 1] + v[:, 2] * soft.size) * soft.size).numel())
    del v
    total_steps = int(steps.sum())
    at_budget = int((steps >= K * MAX_ITERS).sum())
    log(f"  multihit == plain on all {R} rays: {n_hit_rays} rays hit, {n_slots} hit slots "
        f"on {n_unique} distinct voxels, "
        f"{total_steps} automaton steps (max {int(steps.max())} per ray), {at_budget} rays at "
        f"the step budget of {K * MAX_ITERS}, {n_mh_pairs} word pairs read")
    # the schedules' lane-steps, from the plain march's steps a ray, in warps
    # of 32 consecutive rays: two phases run each ray to its first hit, then
    # on to the next (K = 2); one loop runs each ray once
    trace1 = make_multihit_tracer(len(tree["bases"]), tree["size"], 1, MAX_ITERS,
                                  **KERNEL_CONFIG)
    steps1 = trace1(tree, o, d, with_steps=True)[-1]
    schedules = {"two phases a ray": [steps1, steps - steps1],
                 "one loop a ray": [steps]}
    for name, phases in schedules.items():
        ws = warp_steps(phases)
        log(f"  working lane-steps, {name}, warps of 32 consecutive rays: "
            f"{total_steps / (32 * ws):.4f} ({ws} warp-steps)")
    log(f"  lanes refilled as rays end (the limit): {-(-total_steps // 32)} warp-steps")
    del steps1
    digest = hashlib.sha256(count.cpu().numpy().tobytes()
                            + voxels.cpu().numpy().tobytes()).hexdigest()
    log(f"  multihit count+voxels sha256 {digest} "
        f"{'== reference' if digest == HITS_SHA256 else '!= reference'}")
    if digest != HITS_SHA256:
        raise AssertionError("the multi-hit march differs from the reference package's")
    del p_hits, steps
    log(f"phase 5 multi-hit march: {time.time() - t0:.1f} s")

    # ---- phase 6: the composite's kernels against their plain versions
    t0 = time.time()
    params = soft.init_params()
    alb, lgt = params["albedo"], params["logits"]
    rgb_k = composite_forward(alb, lgt, voxels, soft.size)
    torch.cuda.synchronize()
    rgb_p = composite_forward_plain(alb, lgt, voxels, soft.size)
    fwd_err = max_abs_err(rgb_k, rgb_p)
    n_bad = int((~same(rgb_k, rgb_p)).any(dim=1).sum())
    log(f"  composite forward: {n_bad} rays differ from the plain version, max abs err "
        f"{fwd_err} (tolerance {RGB_ATOL})")
    if fwd_err > RGB_ATOL:
        raise AssertionError("composite forward kernel differs from its plain version")
    target = torch.tensor(CONST_TARGET, dtype=torch.float32, device=dev).expand(R, 3).contiguous()
    grad_rgb = (2.0 * (rgb_k - target) / (3 * R)).contiguous()
    g_k = composite_backward(grad_rgb, alb, lgt, voxels, soft.size)
    torch.cuda.synchronize()
    g_p = composite_backward_plain(grad_rgb, alb, lgt, voxels, soft.size)
    bwd_err = 0.0
    for name, a, b in zip(("albedo", "logits"), g_k, g_p):
        err = max_abs_err(a, b)
        scale = float(b.abs().max())
        rel = float(((a - b).abs() / b.abs().clamp_min(1e-30))[b != 0].max())
        zeros_differ = int(((a == 0) != (b == 0)).sum())
        bwd_err = max(bwd_err, err)
        log(f"  composite backward {name}: max abs err {err} (largest element {scale}), max "
            f"relative err {rel}, {int((b != 0).sum())} non-zero, {zeros_differ} zero in one "
            "only")
        ok = bool(((a - b).abs() <= GRAD_RTOL * b.abs() + GRAD_ATOL_SHARE * scale).all())
        if not ok or zeros_differ or scale == 0:
            raise AssertionError(f"composite backward kernel differs on {name}")
    del rgb_p, g_p
    log(f"phase 6 composite kernels == plain versions: {time.time() - t0:.1f} s")

    # ---- phase 7: the Adam kernel against its plain version, all params, two steps
    t0 = time.time()
    opt = adam(LR)
    pk = soft.init_params()
    sk = opt.init(pk)
    pp = {k: v.clone() for k, v in pk.items()}
    sp = opt.init(pp)
    adam_err = 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    for step in range(2):
        grads = {k: torch.randn(v.shape, generator=gen, device=dev) * 1e-4
                 for k, v in pk.items()}
        grads["logits"][: n_vox // 2] = 0.0  # half the voxels see no gradient
        sk = adam_ops.adam_update(pk, grads, sk, opt, 0.0, CLAMPS)
        torch.cuda.synchronize()
        sp = adam_ops.adam_plain(pp, grads, sp, opt, 0.0, CLAMPS)
        for name, a, b in (("albedo", pk["albedo"], pp["albedo"]),
                           ("logits", pk["logits"], pp["logits"]),
                           ("mu albedo", sk["mu"]["albedo"], sp["mu"]["albedo"]),
                           ("mu logits", sk["mu"]["logits"], sp["mu"]["logits"]),
                           ("nu albedo", sk["nu"]["albedo"], sp["nu"]["albedo"]),
                           ("nu logits", sk["nu"]["logits"], sp["nu"]["logits"])):
            n_bad = int((~same(a, b)).sum())
            adam_err = max(adam_err, max_abs_err(a, b))
            if n_bad:
                raise AssertionError(f"adam kernel step {step}: {name} differs in {n_bad} "
                                     "elements")
        if int(sk["count"]) != step + 1 or int(sp["count"]) != step + 1:
            raise AssertionError("adam count")
    log(f"  adam == plain on all {n_vox * 4} params, mu and nu, two steps (max abs err "
        f"{adam_err})")
    del pp, sp, grads
    log(f"phase 7 adam kernel == plain: {time.time() - t0:.1f} s")

    # ---- phase 8: the training path
    t0 = time.time()
    counters = (multihit, composite_forward, composite_backward, adam_ops.adam_update,
                render_frame, traverse, shade)

    def reset():
        for fn in counters:
            fn.launches = 0

    def read():
        return {fn.__name__: fn.launches for fn in counters}

    def want(n):
        return {"multihit": n, "composite_forward": n, "composite_backward": n,
                "adam_update": n, "render_frame": 0, "traverse": 0, "shade": 0}

    # (a) the bench's target: the stop-gradient composite of the initial params
    params = soft.init_params()
    state = opt.init(params)
    _c, vox_t, _d = soft.trace_hits(o, d)
    bench_target = soft.composite(params, vox_t).detach()
    before = {k: v.clone() for k, v in params.items()}
    reset()
    params, state, loss = soft.train_step_fused(params, state, opt, o, d, bench_target)
    torch.cuda.synchronize()
    counts = read()
    unchanged = all(bool((params[k] == before[k]).all()) for k in before)
    log(f"  (a) bench target: loss {float(loss)!r}, params unchanged: {unchanged}, "
        f"launches {counts}")
    if float(loss) != 0.0 or not unchanged or counts != want(1):
        raise AssertionError("the bench target's step is not a no-op of one launch per kernel")
    del before, bench_target

    # (b) the constant target, 4 steps, against the reference's constants
    params = soft.init_params()
    state = opt.init(params)
    sums0 = {k: float(v.double().sum()) for k, v in params.items()}
    for k, v in sums0.items():
        if abs(v - REF_SUM0[k]) > 1e-9 * abs(REF_SUM0[k]):
            raise AssertionError(f"initial {k} sum {v!r} != the reference's {REF_SUM0[k]!r}")
    losses, sums = [], {k: [] for k in sums0}
    reset()
    for _ in range(TRAIN_STEPS):
        torch.cuda.set_sync_debug_mode("error")  # a step that reads the host raises
        try:
            params, state, loss = soft.train_step_fused(params, state, opt, o, d, target)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses.append(float(loss))
        for k in sums:
            sums[k].append(float(params[k].double().sum()))
    counts = read()
    log(f"  (b) constant target {CONST_TARGET}, {TRAIN_STEPS} steps, launches {counts}")
    if counts != want(TRAIN_STEPS):
        raise AssertionError(f"training path launches {counts}, want {want(TRAIN_STEPS)}")
    bad = []
    for i in range(TRAIN_STEPS):
        rel = abs(losses[i] - REF_LOSSES[i]) / REF_LOSSES[i]
        line = f"  step {i}: loss {losses[i]!r} (reference {REF_LOSSES[i]!r}, rel err {rel:.3g})"
        if rel > LOSS_RTOL:
            bad.append(f"loss {i}")
        for k in sums:
            got, ref = sums[k][i] - sums0[k], REF_SUMS[k][i] - REF_SUM0[k]
            line += f"; {k} sum change {got!r} (reference {ref!r})"
            if abs(got - ref) > SUM_RTOL * abs(ref) + SUM_ATOL:
                bad.append(f"{k} sum {i}")
        log(line)
    if bad or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"the training path differs from the reference: {bad}")
    log(f"phase 8 training path: {time.time() - t0:.1f} s")

    # ---- phase 9: timing
    t0 = time.time()
    for _ in range(2):
        soft.train_steps_fused(params, state, opt, o, d, target, 2)
    torch.cuda.synchronize()
    step_ms = timed(lambda: soft.train_steps_fused(params, state, opt, o, d, target, CHAIN),
                    1) / CHAIN
    step_host_ms = host_ms(lambda: soft.train_steps_fused(params, state, opt, o, d, target,
                                                          CHAIN), 1) / CHAIN
    mh_ms = device_ms(lambda: multihit(tree, o, d, K), TIMED_FRAMES)
    fwd_ms = device_ms(lambda: composite_forward(alb, lgt, voxels, soft.size), TIMED_FRAMES)
    # as the step calls it: the two dense gradients zeroed, then the scatter
    bwd_ms = device_ms(lambda: composite_backward(grad_rgb, alb, lgt, voxels, soft.size),
                       TIMED_FRAMES)
    grads = {k: torch.randn(v.shape, generator=gen, device=dev) * 1e-4 for k, v in pk.items()}

    def adam_step():
        return adam_ops.adam_update(pk, grads, sk, opt, 0.0, CLAMPS)

    adam_ms = device_ms(adam_step, TIMED_FRAMES)
    fwd_plain_ms = timed(lambda: composite_forward_plain(alb, lgt, voxels, soft.size), 3)
    bwd_plain_ms = timed(lambda: composite_backward_plain(grad_rgb, alb, lgt, voxels,
                                                          soft.size), 3)
    adam_plain_ms = timed(lambda: adam_ops.adam_plain(pk, grads, sk, opt, 0.0, CLAMPS), 3)
    # torch.optim.Adam(fused=True) on the same tensors, as a yardstick only
    lib_params = [torch.nn.Parameter(pk[k].clone()) for k in ("albedo", "logits")]
    for prm, k in zip(lib_params, ("albedo", "logits")):
        prm.grad = grads[k].clone()
    lib_opt = torch.optim.Adam(lib_params, lr=LR, fused=True)
    lib_opt.step()
    adam_lib_ms = timed(lib_opt.step, TIMED_FRAMES)
    adam_event_ms = timed(adam_step, TIMED_FRAMES)
    del lib_opt, lib_params
    kernel_sum = mh_ms + fwd_ms + bwd_ms + adam_ms
    log(f"training step, 1920x1080, K={K}: {step_ms:.4f} ms/step back to back over {CHAIN} "
        f"steps by CUDA events, {step_host_ms:.4f} ms/step by host clock {tag}")
    log(f"  multihit {mh_ms:.4f} ms, composite forward {fwd_ms:.4f} ms, composite backward "
        f"{bwd_ms:.4f} ms, adam {adam_ms:.4f} ms device time per launch; the four kernels "
        f"{kernel_sum:.4f} ms = {kernel_sum / step_ms:.3f} of the step {tag}")
    log(f"  plain versions: multihit {mh_plain_ms:.1f} ms (host clock, one run), composite "
        f"forward {fwd_plain_ms:.3f} ms, backward {bwd_plain_ms:.3f} ms, adam "
        f"{adam_plain_ms:.3f} ms (CUDA events); adam kernel {adam_event_ms:.4f} ms and "
        f"torch.optim.Adam(fused=True).step() {adam_lib_ms:.4f} ms by CUDA events around the "
        f"calls {tag}")
    log(f"  observation, not a claim: {R / step_ms * 1e3:.0f} rays/s through the training "
        f"step {tag}")
    profile_steps(soft, params, state, opt, o, d, target, step_ms, tag)

    # least time the card could take for the same work
    mh_bound, mh_by = bound(R * 24 + n_mh_pairs * 8 + R * (4 + 16 * K),
                            total_steps * TRAVERSE_OPS_PER_STEP)
    # the composite reads each ray's slots, the params of each distinct hit
    # voxel (16 B) and, backward, dL/drgb of the rays with a hit (a ray with
    # none gets a zero gradient); it writes rgb, or the two dense gradients
    fwd_bound, fwd_by = bound(R * 12 * K + n_unique * 16 + R * 12,
                              n_slots * COMPOSITE_FWD_OPS_PER_SLOT)
    bwd_bound, bwd_by = bound(n_hit_rays * 12 + R * 12 * K + n_unique * 16 + 4 * 4 * n_vox,
                              n_slots * COMPOSITE_BWD_OPS_PER_SLOT)
    adam_bound, adam_by = bound(7 * 4 * 4 * n_vox, ADAM_OPS_PER_ELEMENT * 4 * n_vox)
    log(f"bounds: multihit {mh_bound:.4f} ms ({mh_by}), composite forward {fwd_bound:.4f} ms "
        f"({fwd_by}), composite backward {bwd_bound:.4f} ms ({bwd_by}), adam "
        f"{adam_bound:.4f} ms ({adam_by}) {tag}")
    log(f"phase 9 training timing: {time.time() - t0:.1f} s")
    src = "voxelhex_tpu_torch/csrc/"
    return [
        {"name": "multihit", "route": "cuda", "source": src + "multihit.cu",
         "replaces": "voxelhex_tpu/diff/soft.py:108", "launches": counts["multihit"],
         "max_abs_err": mh_err, "ms": mh_ms, "plain_ms": mh_plain_ms, "bound_ms": mh_bound,
         "bound_by": mh_by, "library_ms": None},
        {"name": "composite_forward", "route": "cuda", "source": src + "composite.cu",
         "replaces": "voxelhex_tpu/diff/soft.py:1033", "launches": counts["composite_forward"],
         "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "library_ms": None},
        {"name": "composite_backward", "route": "cuda", "source": src + "composite.cu",
         "replaces": "voxelhex_tpu/diff/soft.py:95", "launches": counts["composite_backward"],
         "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound,
         "bound_by": bwd_by, "library_ms": None},
        {"name": "adam", "route": "cuda", "source": src + "adam.cu",
         "replaces": "voxelhex_tpu/diff/soft.py:532", "launches": counts["adam_update"],
         "max_abs_err": adam_err, "ms": adam_ms, "plain_ms": adam_plain_ms,
         "bound_ms": adam_bound, "bound_by": adam_by, "library_ms": adam_lib_ms},
    ]


if __name__ == "__main__":
    sys.exit(main())
