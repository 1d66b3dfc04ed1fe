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
kernels' device time at the terrain beside the bench.

Phase 11 runs checkpoints and the offline trainers: (a) ``save_tree`` /
``load_tree`` and ``save_flat`` / ``load_flat`` of the bench tree, and
``load_vox_tree_cached`` of a ``.vox`` built in code (written, then read
back from the cache with the model overwritten); (b) ``DiffRenderer`` over
two 1080p poses (4,147,200 rays): the albedo kernel (``csrc/albedo.cu``)
against its plain version on every ray, forward bit for bit and backward
within the composite's tolerance, with the atomic adds the backward
issues (its runs of rays on one row) counted from the data, then
``fit_albedo`` from gray for 16 steps (one traversal, then one forward,
backward and Adam launch a step; the loss falls); (c) ``with_candidates``
on the bench scene against its CPU route, the multi-hit march and the
composite at K = 6 against their plain versions, ``fit_soft`` for 16
steps with checkpoints against the plain versions' steps on the card,
resumed from step 8, and with the row layout;
(d) the identity bake of ``params_to_tree`` rendered to the bench digest,
and the bake of the fitted params; (e) the albedo kernels beside
``index_add_`` (the backward and ``index_add_`` also with the L2 flushed),
the K = 6 kernels and a step of each trainer, timed in turns, with a
profile of the steps.

Phase 12 runs streaming over phase 10's 1024 terrain (the fly-over of
``benches/ab_flyover.py``): (a) ``StreamingView(tree, view_size=256,
regions_per_update=8192)`` follows ``flight_cam`` for 8 frames at
1920x1080, one window shift a frame and a whole-world ring at factor 4,
one coarse rebuild an update after the first (its launches counted);
each launch of the region scatter, coarse rebuild and window shift
(``csrc/stream.cu``) is held to its plain version on the same inputs, the
window on the card to the host's BitGrid after every update, each frame
of the far-frame kernel (``csrc/far.cu``) to ``far_frame_plain`` on every
pixel (with the plain march's steps a ray against the step limit) and to
the reference package's digest; (b) 64 regions an update with
placeholders and occlusion pruning, rendered until settled, to (a)'s last
frame; (d) ``async_uploads`` with ``async_far`` settled at two poses, to
the reference digests; (e) a 64 window (W/S = 16: an anchored ring at
factor 4 and the world at 16), two frames against the plain version; (c)
an ``insert_at_lod`` that pages through the partial scatter, to a new
view's frame; (f) the four kernels' device times in turns beside their
bounds, plain versions, ``index_copy_`` and ``torch.roll``, the region
scatter also with the L2 flushed before each launch and beside the host
clock of its wire's three copies to the card, the far frame
and the same launch on the window alone beside ``frame.cu`` at the same
window and pose, each fly-over layer's rays and steps, and the fly-over's
frames by host clock, split into the update (placeholders, rasterize, the
rest), the far refresh and the device.

Phase 13 serves over HTTP (``RenderService``, ``make_server``) at
1920x1080, each reply's PNG decoded with zlib and every reply held to 200:
(a) the bench tree's three poses, one batched-kernel launch and no
frame-kernel launch a request, to the reference digests; (b) the bench
pose four times more, fetched as digests only and pose-validated from the
second; (c) ``POST /edit`` of phase 10's block and of its clear, each next
frame one row band equal to a fresh ``render()``, the renderer kept; (d)
``POST /view`` of a 128 window served until settled, equal to a
synchronous view's frame, then switches 128 -> 0 -> 128 -> 0 that leave
the tree's triggers and the card's allocated memory as they were; (e)
phase 12's terrain through a 256 window with ``async_far``, three fly-over
poses each served until settled to the reference digests, the same pose
again from the idle cache with no launch, and an edit that re-renders it;
(f) ``POST /load`` of a ``.vox`` equal to ``fastest_renderer`` of the
file's tree, the second upload read from the bencode cache; (g)
``NativeEditTree`` and the BoxTree after the same 2,000 seeded ops,
rendered equal on the card, and both engines' host us a voxel; (h) host
times in turns of ``service.render``, ``encode_png`` and the whole ``GET
/frame`` for a new and a repeated dense pose, an idle-cache and a moved
streamed pose, and of ``POST /edit``.  The last line is ``{"ok": true,
"device": {...}}``; any failure exits non-zero before it.  Needs one CUDA
card; there is no CPU fallback.
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
import struct  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402
import zlib  # noqa: E402

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

# ---- phase 12, streaming: the terrain fly-over of benches/ab_flyover.py
# (examples/terrain.py's StreamingView, BASELINE.json's config 4): the
# 1024 terrain through a 256 window, 8 frames at 1920x1080
FLY_FRAMES = 8
FLY_VIEW = 256
# sha256 of the reference package's u8 frames of the fly-over, made on the
# CPU with
#   view = StreamingView(examples/terrain.build_terrain(1024), view_size=256,
#                        regions_per_update=8192)
#   view.render(benches/ab_flyover.flight_cam(i, 8, (1920, 1080)), out_u8=True)
# for i = 0 .. 7 in turn (each frame settled: no region left to page)
FLYOVER_SHA256 = (
    "6aceaffe20bdfb4866349605b3ea6b7f91b8c49f25a0e5d971f8daf8832370e1",
    "1bac077d264896856aedb8461dfda9bbf2628bfe44ab8e595ebb7feb57df2ea0",
    "cfbeef70adbcd048196f8d4d4b127b01d0c4294bf8ee23c3556df74a5b0d9661",
    "9c7fd05d6b279b9c33f5b266ebb5dbb6fd09c87858ebd23ea110e7ed7740b5a1",
    "557f6c8f2dce7d0e91981543f018c13adaa73480f0f0a5b53832147da33decf0",
    "e112cc451893b0423425b14b0960ef22cffbae8e1e62fddb672210dab3a4c118",
    "8e9a422266d1f736bb9cc03e9dd10b6f636092331ab60ce7fccb760876268442",
    "f41dccc1278251b85fabc80f41a82091f86801dee5af33c2e248973d3f17ca4c",
)
# the budgeted view's regions an update (the reference's default)
FLY_BUDGET = 64
# the edit of phase 12 (c): insert_at_lod of this block into the terrain,
# inside the last fly-over frame's window and in its view
FLY_EDIT = ((816, 80, 400), 16, (250, 40, 40, 255))
# the ring ladder of phase 12 (e): a 64 window in the 1024 world (W/S = 16)
LADDER_VIEW = 64

# ---- phase 13, serving: RenderService over HTTP on the bench tree and on
# phase 12's terrain through a 256 window, at 1920x1080
# an edit of (e): insert_at_lod of this block into the terrain, inside the
# window of flight_cam(2) and in its view (phase 12's FLY_EDIT, already in
# the terrain, lies outside the view of flight_cam(0..2))
SERVE_EDIT = ((368, 96, 400), 16, (40, 40, 250, 255))
SERVE_FLY = (0, 1, 2)  # the fly-over poses served in (e)
SERVE_MAX_REQUESTS = 400  # requests a pose may take to settle
EDIT_ENGINE_OPS = 2000  # the seeded random ops of (g)
EDIT_TIMED_OPS = 2000  # ops a single-op timing of (g)
SERVE_TIMED = 4  # requests a case a turn in (h)

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

# ---- phase 11, the offline trainers on the bench tree at 1920x1080:
# DiffRenderer and fit_albedo (examples/fit_albedo.py, BASELINE.json's
# config 5) over the bench pose and a second one, 4,147,200 rays; fit_soft
# on with_candidates' dilated scene (examples/train_online.py) over the
# bench pose
ALBEDO_YAWS = (40.0, 130.0)
ALBEDO_LR = 0.1  # examples/fit_albedo.py
SOFT_LR = 0.15  # examples/train_online.py, with fit_albedo=False
CAND_HITS = 6  # with_candidates' max_hits
FIT_STEPS, FIT_CHAIN, FIT_EVERY = 16, 8, 8
# the target of fit_soft: the initial composite with the scene's voxels of
# this 8^3 block (min corner, edge) carved, a corner of the box
CARVE = ((20, 40, 20), 8)
# f32 operations a ray of the albedo kernels (Lambert, three products, the
# selects), counted low from albedo.cu
ALBEDO_OPS_PER_RAY = 10


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


def kernel_names(log, kernel):
    """The mangled names of the entry functions in an ``nvcc -Xptxas -v``
    log whose names hold ``kernel`` (one for each template instance)."""
    return [chunk.split("'")[1] for chunk in log.split("Compiling entry function")[1:]
            if kernel in chunk.splitlines()[0]]


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
                                     ("multihit.cu", "multihit_kernel", None),
                                     ("far.cu", "far_kernel", None),
                                     ("stream.cu", "coarse_kernel", None),
                                     ("stream.cu", "region_scatter_kernel", None)):
        build_log = _build.build_log(source)
        for name in kernel_names(build_log, kernel) or [kernel]:  # each template instance
            usage = ptxas_usage(build_log, name)
            log(f"  ptxas {name}: {usage[0]} registers, {usage[1]} B stack frame, {usage[2]} "
                f"B spill stores, {usage[3]} B spill loads")
            if usage[1:] != (0, 0, 0) or (max_regs is not None and usage[0] > max_regs):
                raise AssertionError(f"{name}: {usage[0]} registers (at most {max_regs}), "
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
    counts, terrain = scene_model_slice(dev, card)
    kernels[0]["launches"] += counts["frame"]
    frames_entry["launches"] += counts["frames"]
    torch.cuda.empty_cache()
    entries, counts, errs = offline_slice(dev, card)
    by_name = {k["name"]: k for k in kernels}
    for counter, name in (("render_frame", "frame"), ("traverse", "traverse"),
                          ("multihit", "multihit"), ("composite_forward", "composite_forward"),
                          ("composite_backward", "composite_backward"), ("adam_update", "adam")):
        by_name[name]["launches"] += counts[counter]
    for name, err in errs.items():
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    kernels += entries
    torch.cuda.empty_cache()
    kernels += streaming_slice(dev, card, terrain)
    torch.cuda.empty_cache()
    served = serving_slice(dev, card, terrain)
    by_name = {k["name"]: k for k in kernels}
    for counter, name in (("frames", "frames"), ("frame", "frame"), ("far", "far_frame"),
                          ("scatter", "region_scatter"), ("rebuild", "coarse_rebuild"),
                          ("shift", "window_shift")):
        by_name[name]["launches"] += served[counter]
    log(f"total: {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def sha(frame):
    """sha256 of a frame's bytes, a tensor on any device or a NumPy array."""
    if isinstance(frame, torch.Tensor):
        frame = frame.cpu().contiguous().numpy()
    return hashlib.sha256(np.ascontiguousarray(frame).tobytes()).hexdigest()


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
    """Where a training step's device time goes (:func:`profile_fn` over
    ``n_steps`` of ``train_steps_fused``)."""
    profile_fn(lambda: soft.train_steps_fused(params, state, opt, o, d, target, n_steps),
               n_steps, step_ms, tag)


def profile_fn(fn, n_steps, step_ms, tag):
    """Where a step's device time goes: ``torch.profiler`` over ``fn()``,
    which runs ``n_steps`` steps, the device time of each kernel name per
    step, and the card's busy share (all device time over the step time of
    the unprofiled run, ``step_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
    its main path's runs, and the terrain's BoxTree."""
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
    terrain = tree  # phase 12 streams it
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
    return counts, terrain


def vox_file_bytes(seed=0, n=600, extent=40):
    """A MagicaVoxel file of one model of ``n`` random voxels (the default
    palette): chunks MAIN, SIZE and XYZI."""
    rng = np.random.default_rng(seed)
    xyzi = np.concatenate([rng.integers(0, extent, (n, 3)), rng.integers(1, 256, (n, 1))],
                          axis=1).astype(np.uint8)

    def chunk(cid, content):
        return cid + struct.pack("<ii", len(content), 0) + content

    body = (chunk(b"SIZE", struct.pack("<3i", extent, extent, extent))
            + chunk(b"XYZI", struct.pack("<i", n) + xyzi.tobytes()))
    return b"VOX " + struct.pack("<i", 150) + b"MAIN" + struct.pack("<ii", 0, len(body)) + body


def param_sums(params):
    return {k: float(v.double().sum()) for k, v in params.items()}


def offline_slice(dev, card):
    """Phase 11 in a temporary directory that is removed however it ends
    (:func:`offline_phases`)."""
    with tempfile.TemporaryDirectory(prefix="vhx_offline_") as tmp:
        return offline_phases(dev, card, tmp)


def offline_phases(dev, card, tmp):
    """Phase 11: checkpoints and the offline trainers at full width on the
    card.  (a) tree, flat and ``.vox``-cache checkpoints of the bench tree;
    (b) ``DiffRenderer`` and ``fit_albedo``: the albedo kernels against
    their plain versions on every ray, 16 steps from gray; (c)
    ``with_candidates`` (against its CPU route), the multi-hit march and
    the composite at K = 6 against their plain versions, ``fit_soft`` with
    checkpoints, against the plain versions' steps, resumed from step 8 and
    with the row layout; (d) ``params_to_tree``: the identity bake renders
    the bench digest; (e) times in turns.  Returns the albedo kernels'
    entries of the kernels line, the launches of the other kernels in the
    main path's runs, and the errors of the K = 6 checks."""
    from voxelhex_tpu_torch.diff.fit import albedo_step, fit_albedo
    from voxelhex_tpu_torch.diff.optim import adam
    from voxelhex_tpu_torch.diff.render import DiffRenderer
    from voxelhex_tpu_torch.diff.soft import (CLAMPS, SoftRenderer, fit_soft, params_to_tree,
                                              with_candidates)
    from voxelhex_tpu_torch.io import checkpoint
    from voxelhex_tpu_torch.io.vox import load_vox_tree_cached
    from voxelhex_tpu_torch.ops.adam import adam_plain, adam_update
    from voxelhex_tpu_torch.ops.albedo import (CHUNK, albedo_backward, albedo_backward_plain,
                                               albedo_forward, albedo_forward_plain,
                                               backward_adds, lambert, shade_albedo)
    from voxelhex_tpu_torch.ops.composite import (
        composite_backward, composite_backward_plain, composite_forward,
        composite_forward_plain)
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.ops.multihit import multihit
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS, traverse
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import build_bitgrid, make_multihit_tracer
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.scene import build_scene, build_scene_tree
    from voxelhex_tpu_torch.tree.flat import ARRAYS, flatten

    tag = f"[{card}]"
    t_all = time.time()
    counters = (traverse, multihit, composite_forward, composite_backward, adam_update,
                albedo_forward, albedo_backward, render_frame)
    counts = {f.__name__: 0 for f in counters}

    def reset():
        for f in counters:
            f.launches = 0

    def read():
        n = {f.__name__: f.launches for f in counters}
        for k, v in n.items():
            counts[k] += v
        return n

    def want(**kw):
        return {f.__name__: kw.get(f.__name__, 0) for f in counters}

    def clock(fn):
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    cam = orbit_camera(128.0, resolution=RES)

    # (a) checkpoints of the bench tree, and the .vox cache
    t0 = time.time()
    tree = build_scene_tree(4)
    flat = flatten(tree)
    path = os.path.join(tmp, "bench.vhx")
    _, s_save = clock(lambda: checkpoint.save_tree(path, tree))
    loaded, s_load = clock(lambda: checkpoint.load_tree(path))
    again = flatten(loaded)
    bad = [k for k in ARRAYS if not np.array_equal(getattr(again, k), getattr(flat, k))]
    if bad or (again.size, again.brick_dim) != (flat.size, flat.brick_dim):
        raise AssertionError(f"save_tree -> load_tree: {bad} differ after flatten")
    log(f"  save_tree {s_save:.3f} s ({os.path.getsize(path)} B), load_tree {s_load:.3f} s: "
        f"flatten equals the original in every field {tag}")
    fpath = os.path.join(tmp, "bench.npz")
    _, s_save = clock(lambda: checkpoint.save_flat(fpath, flat))
    lf, s_load = clock(lambda: checkpoint.load_flat(fpath))
    saved = ("node_meta", "node_children", "node_ocbits", "node_mips", "bricks", "palette")
    bad = [k for k in saved if not np.array_equal(getattr(lf, k), getattr(flat, k))]
    if bad or checkpoint.peek_version(fpath) != checkpoint.FORMAT_VERSION:
        raise AssertionError(f"save_flat -> load_flat: {bad} differ")
    log(f"  save_flat {s_save:.3f} s ({os.path.getsize(fpath)} B), load_flat {s_load:.3f} s: "
        f"every saved array equal {tag}")
    vox_path = os.path.join(tmp, "scene.vox")
    with open(vox_path, "wb") as f:
        f.write(vox_file_bytes())
    cache = os.path.join(tmp, ".cache_scene.vox_4.vhx")
    first, s_first = clock(lambda: load_vox_tree_cached(vox_path, brick_dim=4))
    if not os.path.exists(cache):
        raise AssertionError("load_vox_tree_cached wrote no cache")
    with open(vox_path, "wb") as f:  # the second call must read the cache, not the model
        f.write(b"not a vox file")
    second, s_second = clock(lambda: load_vox_tree_cached(vox_path, brick_dim=4))
    a, b = flatten(first), flatten(second)
    bad = [k for k in ARRAYS if not np.array_equal(getattr(a, k), getattr(b, k))]
    if bad or a.n_bricks == 0:
        raise AssertionError(f"load_vox_tree_cached: the cached tree differs in {bad}")
    log(f"  load_vox_tree_cached: parsed and cached {s_first:.3f} s, from the cache {s_second:.3f} "
        f"s (the model overwritten), {a.n_nodes} nodes, equal trees {tag}")
    del loaded, again, lf, first, second, a, b
    log(f"phase 11 (a) checkpoints: {time.time() - t0:.1f} s")

    # (b) DiffRenderer and fit_albedo on two poses
    t0 = time.time()
    diff, s_diff = clock(lambda: DiffRenderer(flat, device=dev))
    rays = [device_rays(orbit_camera(128.0, yaw_deg=y, resolution=RES), dev) for y in ALBEDO_YAWS]
    o = torch.cat([r[0].reshape(-1, 3) for r in rays])
    d = torch.cat([r[1].reshape(-1, 3) for r in rays])
    del rays
    R = o.shape[0]
    true = diff.init_params()
    shape = tuple(true.shape[:2])
    hit, _voxel, brick, cell, _point, normal = diff.trace_rays(o, d)
    ok = hit & (brick >= 0)
    rows = brick[ok].long() * shape[1] + cell[ok].long()
    n_rows = int(torch.unique(rows).numel())
    log(f"  DiffRenderer (densify, lookup grids, pyramid, upload) {s_diff:.3f} s: {shape[0]} "
        f"bricks x {shape[1]} cells x 3 = {true.numel()} params; {R} rays, {int(hit.sum())} hits, "
        f"{int(ok.sum())} on {n_rows} distinct rows {tag}")
    if int(hit.sum()) != int(ok.sum()):
        raise AssertionError("a hit voxel of the densified bench tree has no params")
    fwd_err = 0.0
    for bg in ((0.0, 0.0, 0.0), BG):
        k = albedo_forward(true, hit, brick, cell, normal, bg)
        torch.cuda.synchronize()
        p = albedo_forward_plain(true, hit, brick, cell, normal, bg)
        n_bad = int((~same(k, p)).any(dim=1).sum())
        fwd_err = max(fwd_err, max_abs_err(k, p))
        log(f"  albedo forward, bg {bg}: {n_bad} of {R} rays differ from the plain version")
        if n_bad:
            raise AssertionError("the albedo forward kernel differs from its plain version")
    gen = torch.Generator(device=dev).manual_seed(11)
    g_rgb = torch.randn((R, 3), generator=gen, device=dev) * 1e-3
    gk = albedo_backward(g_rgb, hit, brick, cell, normal, shape)
    torch.cuda.synchronize()
    gp = albedo_backward_plain(g_rgb, hit, brick, cell, normal, shape)
    bwd_err = max_abs_err(gk, gp)
    scale = float(gp.abs().max())
    zeros_differ = int(((gk == 0) != (gp == 0)).sum())
    close = bool(((gk - gp).abs() <= GRAD_RTOL * gp.abs() + GRAD_ATOL_SHARE * scale).all())
    log(f"  albedo backward: max abs err {bwd_err} (largest element {scale}), "
        f"{int((gp != 0).sum())} non-zero, {zeros_differ} zero in one only (tolerance: relative "
        f"{GRAD_RTOL} or {GRAD_ATOL_SHARE} of the largest)")
    n_adds, n_runs = backward_adds(hit, brick, cell, shape)
    log(f"  albedo backward atomics, counted from the data: {n_adds} adds of {n_runs} runs "
        f"(chunks of {CHUNK} rays, runs merged in a warp, 8 B vector adds), against "
        f"{3 * int(ok.sum())} with one add a channel and hit ray")
    if not close or zeros_differ or scale == 0:
        raise AssertionError("the albedo backward kernel differs from its plain version")
    del gk, gp
    target = albedo_forward(true, hit, brick, cell, normal)
    gray = torch.full_like(true, 0.5)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset()
    (fitted, losses), s_fit = clock(lambda: fit_albedo(diff, o, d, target, steps=FIT_STEPS,
                                                       lr=ALBEDO_LR, params0=gray,
                                                       chain=FIT_CHAIN))
    n = read()
    peak = torch.cuda.max_memory_allocated() - base_mem
    plain0 = float(torch.mean((albedo_forward_plain(gray, hit, brick, cell, normal) - target) ** 2))
    err_after = float((albedo_forward(fitted, hit, brick, cell, normal) - target).abs().mean())
    log(f"  fit_albedo {FIT_STEPS} steps, chain {FIT_CHAIN}, lr {ALBEDO_LR}, from gray 0.5: "
        f"{s_fit:.3f} s, launches {n}, {peak} B of device memory at its peak above the inputs")
    log(f"    losses {losses}; the first from the plain versions {plain0!r}; mean |rgb - "
        f"target| after {err_after} {tag}")
    if n != want(traverse=1, albedo_forward=FIT_STEPS, albedo_backward=FIT_STEPS,
                 adam_update=FIT_STEPS):
        raise AssertionError(f"fit_albedo launches {n}")
    if (len(losses) != FIT_STEPS or not all(math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0] or abs(losses[0] - plain0) > LOSS_RTOL * plain0):
        raise AssertionError("fit_albedo's loss did not fall, or its first loss differs from "
                             "the plain versions'")
    log(f"phase 11 (b) DiffRenderer and fit_albedo: {time.time() - t0:.1f} s")

    # (c) with_candidates and fit_soft
    t0 = time.time()
    scene = build_scene()
    (soft, params0, cand), s_cand = clock(lambda: with_candidates(scene, radius=1,
                                                                  max_hits=CAND_HITS,
                                                                  device=dev))
    soft_c, params_c, cand_c = with_candidates(scene, radius=1, max_hits=CAND_HITS, device="cpu")
    fields = ("size", "n_levels", "level_bases", "occ_lo", "occ_hi", "colors", "palette")
    bad = [k for k in fields if not np.array_equal(getattr(soft.bitgrid, k),
                                                   getattr(soft_c.bitgrid, k))]
    bad += [k for k in params0 if not torch.equal(params0[k].cpu(), params_c[k])]
    if bad or not np.array_equal(cand, cand_c):
        raise AssertionError(f"with_candidates on the card differs from its CPU route: {bad}")
    n_scene = int((scene.colors != 0xFFFF).sum())
    log(f"  with_candidates(radius 1, max_hits {CAND_HITS}) {s_cand:.3f} s: {n_scene} scene "
        f"voxels, {int(cand.sum())} candidates; pyramid, mask and params equal the CPU route's {tag}")
    del soft_c, params_c, cand_c
    S = soft.size
    o, d = device_rays(cam, dev)
    R = o.shape[0]
    tree6 = soft.tree
    k_hits = multihit(tree6, o, d, CAND_HITS)
    torch.cuda.synchronize()
    trace6 = make_multihit_tracer(len(tree6["bases"]), S, CAND_HITS, MAX_ITERS, **KERNEL_CONFIG)
    t1 = time.time()
    reads6 = torch.zeros(tree6["occ_pairs"].shape[0], dtype=torch.bool, device=dev)
    *p_hits, steps6 = trace6(tree6, o, d, with_steps=True, reads=reads6)
    torch.cuda.synchronize()
    mh_plain_ms = (time.time() - t1) * 1e3
    for name, a, b in zip(("count", "voxels"), k_hits, p_hits):
        n_bad = int((a != b).reshape(R, -1).any(dim=1).sum())
        log(f"  multihit K={CAND_HITS} {name}: {n_bad} rays differ from the plain march")
        if n_bad:
            raise AssertionError(f"multihit kernel at K={CAND_HITS} differs on {name}")
    ulps = (k_hits[2].view(torch.int32).long() - p_hits[2].view(torch.int32).long()).abs()
    ulps = torch.where(same(k_hits[2], p_hits[2]), torch.zeros_like(ulps), ulps)
    if int(ulps.max()) > 1:
        raise AssertionError(f"multihit dists at K={CAND_HITS} differ by more than 1 ulp")
    mh6_err = max(max_abs_err(a, b) for a, b in zip(k_hits, p_hits))
    count6, voxels = k_hits[0], k_hits[1]
    n_slots, n_hit_rays = int(count6.sum()), int((count6 > 0).sum())
    v = voxels[voxels[..., 0] >= 0].long()
    n_unique = int(torch.unique(v[:, 0] + (v[:, 1] + v[:, 2] * S) * S).numel())
    total6 = int(steps6.sum())
    n_pairs6 = int(reads6.sum())
    log(f"  multihit K={CAND_HITS} == plain on all {R} rays: {n_hit_rays} rays hit, {n_slots} "
        f"slots on {n_unique} voxels, {total6} automaton steps, {n_pairs6} word pairs read, "
        f"dists within {int(ulps.max())} ulp")
    del p_hits, steps6, reads6, v
    alb, lgt = params0["albedo"], params0["logits"]
    rgb_k = composite_forward(alb, lgt, voxels, S)
    torch.cuda.synchronize()
    rgb_p = composite_forward_plain(alb, lgt, voxels, S)
    cfwd6_err = max_abs_err(rgb_k, rgb_p)
    # the gradient of phase 6: the loss against the constant target
    const = torch.tensor(CONST_TARGET, dtype=torch.float32, device=dev)
    grad6 = (2.0 * (rgb_k - const) / (3 * R)).contiguous()
    ga_k, gl_k = composite_backward(grad6, alb, lgt, voxels, S)
    torch.cuda.synchronize()
    ga_p, gl_p = composite_backward_plain(grad6, alb, lgt, voxels, S)
    cbwd6_err = 0.0
    failed = []
    for name, a, b in (("albedo", ga_k, ga_p), ("logits", gl_k, gl_p)):
        scale = float(b.abs().max())
        cbwd6_err = max(cbwd6_err, max_abs_err(a, b))
        out = (a - b).abs() > GRAD_RTOL * b.abs() + GRAD_ATOL_SHARE * scale
        zeros_differ = int(((a == 0) != (b == 0)).sum())
        log(f"  composite backward K={CAND_HITS} {name}: max abs err {max_abs_err(a, b)} (largest "
            f"element {scale}), {int(out.sum())} elements out of tolerance, {zeros_differ} zero "
            f"in one only, {int((b != 0).sum())} non-zero")
        if bool(out.any()) or zeros_differ or scale == 0:
            failed.append(name)
    log(f"  composite K={CAND_HITS}: forward max abs err {cfwd6_err} (tolerance {RGB_ATOL}), "
        f"backward max abs err {cbwd6_err} (relative {GRAD_RTOL} or {GRAD_ATOL_SHARE} of the "
        "largest)")
    if failed:
        raise AssertionError(f"composite backward at K={CAND_HITS} differs on {failed}")
    # a gradient of random signs cancels inside a voxel's sum, where an
    # elementwise relative tolerance does not hold for either f32 order:
    # both against the f64 sum, for the record
    g_rand = (torch.randn((R, 3), generator=gen, device=dev) * 1e-3).contiguous()
    _ga, rl_k = composite_backward(g_rand, alb, lgt, voxels, S)
    _ga, rl_p = composite_backward_plain(g_rand, alb, lgt, voxels, S, need_albedo=False)
    _ga, rl_d = composite_backward_plain(g_rand.double(), alb.double(), lgt.double(), voxels, S,
                                         need_albedo=False)
    scale = float(rl_d.abs().max())
    out = (rl_k.double() - rl_p.double()).abs() > GRAD_RTOL * rl_p.double().abs() + \
        GRAD_ATOL_SHARE * scale
    log(f"  random-sign dL/drgb, logits: kernel against f64 max abs err "
        f"{float((rl_k.double() - rl_d).abs().max())}, plain f32 against f64 "
        f"{float((rl_p.double() - rl_d).abs().max())} (largest {scale}); {int(out.sum())} "
        "elements outside the elementwise tolerance between the two f32 sums")
    del _ga, rl_k, rl_p, rl_d, g_rand, out
    if cfwd6_err > RGB_ATOL:
        raise AssertionError(f"composite forward at K={CAND_HITS} differs from its plain version")
    del rgb_p, ga_k, gl_k, ga_p, gl_p
    # the target: the initial composite with one block of the scene carved
    (x0, y0, z0), e = CARVE
    xs, ys, zs = (torch.arange(c, c + e, device=dev) for c in (x0, y0, z0))
    block = (xs[:, None, None] + ys[None, :, None] * S + zs[None, None, :] * S * S).reshape(-1)
    occupied = torch.from_numpy(scene.colors != 0xFFFF).to(dev)
    carved = block[occupied[block]]
    t_logits = lgt.clone()
    t_logits[carved] = -10.0
    target6 = composite_forward(alb, t_logits, voxels, S)
    n_changed = int((target6 != rgb_k).any(dim=1).sum())
    log(f"  target: {carved.numel()} scene voxels of the block {CARVE} carved, {n_changed} pixels "
        "changed")
    if not n_changed:
        raise AssertionError("the carved block changes no pixel of the target")
    del t_logits, rgb_k
    opt = adam(SOFT_LR)
    kw = dict(lr=SOFT_LR, params0=params0, fit_albedo=False, chain=FIT_CHAIN)
    sums0 = param_sums(params0)
    path_a, path_b = os.path.join(tmp, "fit_a.ckpt"), os.path.join(tmp, "fit_b.ckpt")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset()
    (p_a, l_a), s_a = clock(lambda: fit_soft(soft, o, d, target6, steps=FIT_STEPS,
                                             checkpoint_path=path_a,
                                             checkpoint_every=FIT_EVERY, **kw))
    n = read()
    peak = torch.cuda.max_memory_allocated() - base_mem
    log(f"  fit_soft {FIT_STEPS} steps, chain {FIT_CHAIN}, checkpoints every {FIT_EVERY}, lr "
        f"{SOFT_LR}, fit_albedo=False: {s_a:.3f} s with 3 saves, launches {n}, {peak} B of "
        f"device memory at its peak above the inputs {tag}")
    log(f"    losses {l_a}")
    if n != want(multihit=1, composite_forward=FIT_STEPS, composite_backward=FIT_STEPS,
                 adam_update=FIT_STEPS):
        raise AssertionError(f"fit_soft launches {n}")
    if len(l_a) != FIT_STEPS or not all(math.isfinite(x) for x in l_a) or not l_a[-1] < l_a[0]:
        raise AssertionError("fit_soft's loss did not fall")
    n_vox = S ** 3
    log(f"    on the card: params {4 * 4 * n_vox} B, moments {2 * 4 * 4 * n_vox} B, logits "
        f"gradient {4 * n_vox} B (albedo frozen: no albedo gradient), voxels "
        f"{voxels.numel() * 4} B")
    # the plain versions' steps on the same voxels, on the card
    pp = {k: v.clone() for k, v in params0.items()}
    sp = opt.init(pp)
    l_p = []
    for _ in range(FIT_STEPS):
        rgb = composite_forward_plain(pp["albedo"], pp["logits"], voxels, S)
        diff_rgb = rgb - target6
        l_p.append(float(torch.mean(diff_rgb ** 2)))
        _ga, gl = composite_backward_plain((diff_rgb * (2.0 / diff_rgb.numel())).contiguous(),
                                           pp["albedo"], pp["logits"], voxels, S,
                                           need_albedo=False)
        sp = adam_plain(pp, {"albedo": None, "logits": gl}, sp, opt, 0.0, CLAMPS)
    bad = [i for i in range(FIT_STEPS) if abs(l_a[i] - l_p[i]) > LOSS_RTOL * l_p[i]]
    sums_a, sums_p = param_sums(p_a), param_sums(pp)
    for k in sums0:
        got, ref = sums_a[k] - sums0[k], sums_p[k] - sums0[k]
        log(f"    {k} sum change {got!r}, the plain versions' {ref!r}")
        if abs(got - ref) > SUM_RTOL * abs(ref) + SUM_ATOL:
            bad.append(f"{k} sum")
    log(f"    the plain versions' losses {l_p}")
    if bad:
        raise AssertionError(f"fit_soft differs from the plain versions' steps: {bad}")
    del pp, sp
    # interrupted at step 8, resumed
    reset()
    (_p, l_b1), s_b1 = clock(lambda: fit_soft(soft, o, d, target6, steps=FIT_EVERY,
                                              checkpoint_path=path_b,
                                              checkpoint_every=FIT_EVERY, **kw))
    (p_b, l_b), s_b = clock(lambda: fit_soft(soft, o, d, target6, steps=FIT_STEPS,
                                             checkpoint_path=path_b, **kw))
    n = read()
    bad = [i for i in range(FIT_EVERY) if abs(l_b[i] - l_a[FIT_EVERY + i])
           > LOSS_RTOL * l_a[FIT_EVERY + i]]
    bad += [i for i in range(FIT_EVERY) if abs(l_b1[i] - l_a[i]) > LOSS_RTOL * l_a[i]]
    sums_b = param_sums(p_b)
    for k in sums0:
        got, ref = sums_b[k] - sums0[k], sums_a[k] - sums0[k]
        if abs(got - ref) > SUM_RTOL * abs(ref) + SUM_ATOL:
            bad.append(f"{k} sum")
    log(f"  fit_soft to step {FIT_EVERY} ({s_b1:.3f} s), then resumed to {FIT_STEPS} ({s_b:.3f} s, "
        f"{len(l_b)} losses): launches {n}; losses {l_b}")
    if len(l_b1) != FIT_EVERY or len(l_b) != FIT_STEPS - FIT_EVERY or bad:
        raise AssertionError(f"the resumed fit differs from the uninterrupted one: {bad}")
    # the row layout
    soft_rows = SoftRenderer(soft.bitgrid, max_hits=CAND_HITS, flat_params=False, device=dev)
    reset()
    p_rows, l_rows = fit_soft(soft_rows, o, d, target6, steps=2, lr=SOFT_LR, fit_albedo=False,
                              params0={"albedo": alb.view(-1, 3), "logits": lgt})
    torch.cuda.synchronize()
    n = read()
    log(f"  flat_params=False: losses {l_rows} (flat {l_a[:2]}), albedo "
        f"{tuple(p_rows['albedo'].shape)}, launches {n}")
    if (p_rows["albedo"].shape != (n_vox, 3)
            or any(abs(x - y) > LOSS_RTOL * y for x, y in zip(l_rows, l_a[:2]))):
        raise AssertionError("the row layout's losses differ from the flat layout's")
    del soft_rows, p_rows, p_b, _p
    # the train-state checkpoint's size and seconds
    spath = os.path.join(tmp, "state.ckpt")
    state = opt.init(p_a)
    _, s_save = clock(lambda: checkpoint.save_train_state(spath, FIT_STEPS, p_a, state))
    (_step, _pl, _sl), s_load = clock(lambda: checkpoint.load_train_state(spath, p_a, state))
    log(f"  train-state checkpoint of {4 * 4 * n_vox * 3} B of params and moments: save "
        f"{s_save:.3f} s, load {s_load:.3f} s, {os.path.getsize(spath)} B on disk {tag}")
    del state, _pl, _sl
    log(f"phase 11 (c) with_candidates and fit_soft: {time.time() - t0:.1f} s")

    # (d) params_to_tree
    t0 = time.time()
    soft0 = SoftRenderer(tree, device=dev)
    baked, s_bake = clock(lambda: params_to_tree(soft0, soft0.init_params()))
    del soft0
    reset()
    frame = fastest_renderer(baked, device=dev).render(cam, out_u8=True, out_device=True)
    n = read()
    digest = sha(frame)
    log(f"  identity bake of SoftRenderer(bench tree).init_params() ({s_bake:.3f} s): launches "
        f"{n}, sha256 {digest} {'==' if digest == REFERENCE_SHA256[40.0] else '!='} reference")
    if digest != REFERENCE_SHA256[40.0] or n != want(render_frame=1):
        raise AssertionError("the identity bake does not render the bench frame")
    fitted_tree, s_fit_bake = clock(lambda: params_to_tree(soft, p_a))
    n_baked = int((build_bitgrid(fitted_tree).colors != 0xFFFF).sum())
    log(f"  bake of fit_soft's params ({s_fit_bake:.3f} s): {n_baked} voxels (the scene "
        f"{n_scene}, the carved block {carved.numel()}) {tag}")
    del baked, fitted_tree, frame
    log(f"phase 11 (d) params_to_tree: {time.time() - t0:.1f} s")

    # (e) times, in turns
    t0 = time.time()
    lam = lambert(normal[ok])
    pre = (g_rgb[ok] * lam[:, None]).reshape(-1)
    flat_idx = (rows[:, None] * 3 + torch.arange(3, device=dev)).reshape(-1)
    n_params = true.numel()
    grad_out = torch.zeros(n_params, device=dev)

    def library():
        return grad_out.zero_().index_add_(0, flat_idx, pre)

    timers = {
        "albedo forward": lambda: device_ms(
            lambda: albedo_forward(true, hit, brick, cell, normal), TIMED_FRAMES),
        "albedo backward": lambda: device_ms(
            lambda: albedo_backward(g_rgb, hit, brick, cell, normal, shape), TIMED_FRAMES),
        "index_add_": lambda: device_ms(library, TIMED_FRAMES),
        f"multihit K={CAND_HITS}": lambda: device_ms(
            lambda: multihit(tree6, o, d, CAND_HITS), TIMED_FRAMES),
        f"composite forward K={CAND_HITS}": lambda: device_ms(
            lambda: composite_forward(alb, lgt, voxels, S), TIMED_FRAMES),
        f"composite backward K={CAND_HITS}": lambda: device_ms(
            lambda: composite_backward(grad6, alb, lgt, voxels, S), TIMED_FRAMES),
    }
    for fn in timers.values():
        fn()
    turns = {name: [] for name in timers}
    for name in list(timers) + list(timers)[::-1]:
        turns[name].append(timers[name]())
        log(f"  turn {name}: {turns[name][-1]:.4f} ms device time {tag}")
    ms = {name: sum(t) / 2 for name, t in turns.items()}
    # the backward's 22 MB of inputs fit the 50 MB L2, where the turns above
    # find them: time it and index_add_ also with the L2 flushed (256 MB
    # written) before each launch
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cold = {name: device_ms_each(fn, TIMED_FRAMES, before=flush.zero_) for name, fn in (
        ("albedo backward", lambda: albedo_backward(g_rgb, hit, brick, cell, normal, shape)),
        ("index_add_", library))}
    cold = {name: sum(t) / len(t) for name, t in cold.items()}
    del flush
    fwd_plain_ms = timed(lambda: albedo_forward_plain(true, hit, brick, cell, normal), 3)
    bwd_plain_ms = timed(lambda: albedo_backward_plain(g_rgb, hit, brick, cell, normal, shape), 3)

    # a step of each trainer, 16 queued back to back (CUDA events around the
    # host's calls, as phase 9 times the training step)
    def loss_fn(p):
        return torch.mean((shade_albedo(p, hit, brick, cell, normal) - target) ** 2)

    a_opt = adam(ALBEDO_LR)
    a_params = gray.clone()
    a_state = a_opt.init(a_params)
    s_params = {k: v.clone() for k, v in params0.items()}
    s_state = opt.init(s_params)

    def albedo_steps():
        nonlocal a_params, a_state
        for _ in range(FIT_STEPS):
            a_params, a_state, _loss = albedo_step(a_params, a_state, a_opt, loss_fn)

    def soft_steps():
        nonlocal s_params, s_state
        for _ in range(FIT_STEPS):
            s_params, s_state, _loss = soft.fit_step(s_params, s_state, opt, voxels, target6,
                                                     0.0, False)

    steps_t = {"fit_albedo step": albedo_steps, "fit_soft step": soft_steps}
    for fn in steps_t.values():
        fn()
    step_turns = {name: [] for name in steps_t}
    for name in list(steps_t) + list(steps_t)[::-1]:
        step_turns[name].append(timed(steps_t[name], 1) / FIT_STEPS)
        log(f"  turn {name}: {step_turns[name][-1]:.4f} ms a step by CUDA events, {FIT_STEPS} "
            f"back to back {tag}")
    # what this run's rays need: every ray's hit flag; the forward writes
    # every ray's rgb and reads a hit ray's brick, cell, normal and row; the
    # backward reads a hit ray's brick, cell, normal and dL/drgb and writes
    # the whole gradient (zeroed, then the rows added)
    R2, n_hit2, n_ok2 = hit.shape[0], int(hit.sum()), int(ok.sum())
    fwd_bytes = R2 * (1 + 12) + n_hit2 * (4 + 12) + n_ok2 * 4 + n_rows * 12
    bwd_bytes = R2 + n_hit2 * 4 + n_ok2 * (4 + 12 + 12) + n_params * 4
    fwd_bound, fwd_by = bound(fwd_bytes, n_hit2 * ALBEDO_OPS_PER_RAY)
    bwd_bound, bwd_by = bound(bwd_bytes, n_ok2 * ALBEDO_OPS_PER_RAY)
    mh_bound, mh_by = bound(R * 24 + n_pairs6 * 8 + R * (4 + 16 * CAND_HITS),
                            total6 * TRAVERSE_OPS_PER_STEP)
    cf_bound, cf_by = bound(R * 12 * CAND_HITS + n_unique * 16 + R * 12,
                            n_slots * COMPOSITE_FWD_OPS_PER_SLOT)
    cb_bound, cb_by = bound(n_hit_rays * 12 + R * 12 * CAND_HITS + n_unique * 16 + 4 * 4 * n_vox,
                            n_slots * COMPOSITE_BWD_OPS_PER_SLOT)
    log(f"albedo forward {ms['albedo forward']:.4f} ms, bound {fwd_bound:.4f} ms ({fwd_by}); "
        f"backward {ms['albedo backward']:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_by}), "
        f"index_add_ of the same rows {ms['index_add_']:.4f} ms; with the L2 flushed before "
        f"each launch: backward {cold['albedo backward']:.4f} ms, index_add_ "
        f"{cold['index_add_']:.4f} ms; plain forward "
        f"{fwd_plain_ms:.3f} ms, backward {bwd_plain_ms:.3f} ms (CUDA events); {R2} rays {tag}")
    log(f"K={CAND_HITS} on the dilated bench: multihit {ms[f'multihit K={CAND_HITS}']:.4f} ms "
        f"(bound {mh_bound:.4f}, {mh_by}; plain {mh_plain_ms:.1f} ms, host clock, one run), "
        f"composite forward {ms[f'composite forward K={CAND_HITS}']:.4f} ms (bound "
        f"{cf_bound:.4f}, {cf_by}), backward {ms[f'composite backward K={CAND_HITS}']:.4f} ms "
        f"(bound {cb_bound:.4f}, {cb_by}) {tag}")
    log(f"  albedo bounds: forward {fwd_bytes} B, backward {bwd_bytes} B ({n_hit2} of {R2} rays "
        f"hit, {n_rows} distinct rows, {n_params} params)")
    step_ms = {name: sum(t) / 2 for name, t in step_turns.items()}
    log(f"trainer steps: fit_albedo {step_ms['fit_albedo step']:.4f} ms, fit_soft "
        f"{step_ms['fit_soft step']:.4f} ms a step {tag}")
    for name, fn in steps_t.items():
        log(f"  {name}:")
        profile_fn(fn, FIT_STEPS, step_ms[name], tag)
    log(f"phase 11 (e) timing: {time.time() - t0:.1f} s")
    log(f"phase 11 offline trainers: {time.time() - t_all:.1f} s, launches {counts}")
    src = "voxelhex_tpu_torch/csrc/albedo.cu"
    entries = [
        {"name": "albedo_forward", "route": "cuda", "source": src,
         "replaces": "voxelhex_tpu/diff/render.py:154", "launches": counts["albedo_forward"],
         "max_abs_err": fwd_err, "ms": ms["albedo forward"], "plain_ms": fwd_plain_ms,
         "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None},
        {"name": "albedo_backward", "route": "cuda", "source": src,
         "replaces": "voxelhex_tpu/diff/render.py:158", "launches": counts["albedo_backward"],
         "max_abs_err": bwd_err, "ms": ms["albedo backward"], "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": ms["index_add_"]},
    ]
    errs = {"multihit": mh6_err, "composite_forward": cfwd6_err, "composite_backward": cbwd6_err}
    return entries, counts, errs


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


def flight_cam(i, res=RES):
    """``benches/ab_flyover.flight_cam(i, FLY_FRAMES, res)``: the camera of
    fly-over frame ``i`` over the 1024 terrain."""
    from voxelhex_tpu_torch.render.camera import Camera

    t = i / (FLY_FRAMES - 1)
    cx = TERRAIN_WORLD * (0.2 + 0.6 * t)
    cz = TERRAIN_WORLD * 0.4
    return Camera(origin=np.array([cx - 80.0, TERRAIN_WORLD * 0.12, cz - 120.0]),
                  target=np.array([cx, TERRAIN_WORLD * 0.05, cz]), resolution=res,
                  fov_y_deg=55.0)


class CheckedUpdates:
    """The streaming view's three device updates, each launch held to its
    plain version on the same inputs, bit for bit (installed where
    ``render/streaming.py`` calls them, for phase 12's checked runs).  The
    plain versions launch no kernel, so the wrappers' counts hold the
    kernels' launches alone.  ``last`` keeps each kernel's latest inputs for
    the timing."""

    def __init__(self):
        from voxelhex_tpu_torch.ops import stream
        from voxelhex_tpu_torch.render import streaming

        self.stream, self.streaming = stream, streaming
        self.calls = {"region_scatter": 0, "coarse_rebuild": 0, "window_shift": 0}
        self.last = {}

    @staticmethod
    def _grids(tree):
        return tree["colors"].clone(), tree["occ_pairs"].clone()

    def _check(self, name, got, want):
        self.calls[name] += 1
        if not all(bool(same(a, b).all()) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: the kernel's grids differ from its plain version's")

    def region_scatter(self, tree, corners, col_vals, blk_vals):
        colors, pairs = self._grids(tree)
        self.last["region_scatter"] = (corners, col_vals, blk_vals)
        self.stream.region_scatter_plain(colors, pairs, corners, col_vals, blk_vals,
                                         int(tree["size"]))
        self.stream.region_scatter(tree, corners, col_vals, blk_vals)
        self._check("region_scatter", (tree["colors"], tree["occ_pairs"]), (colors, pairs))

    def coarse_rebuild(self, tree):
        pairs = self.stream.coarse_rebuild_plain(tree["occ_pairs"].clone(), tree["bases"],
                                                 tree["dims"])
        self.stream.coarse_rebuild(tree)
        self._check("coarse_rebuild", (tree["occ_pairs"],), (pairs,))

    def window_shift(self, tree, shift):
        want = self.stream.window_shift_plain(tree["colors"], tree["occ_pairs"],
                                              int(tree["size"]), shift)
        self.last["window_shift"] = tuple(int(v) for v in shift)
        got = self.stream.window_shift(tree, shift)
        self._check("window_shift", got, want)
        return got

    def __enter__(self):
        for name in self.calls:
            setattr(self.streaming, name, getattr(self, name))
        return self

    def __exit__(self, *exc):
        for name in self.calls:
            setattr(self.streaming, name, getattr(self.stream, name))


def check_window(view, what):
    """The window's grids on the card against the view's host BitGrid (the
    mirrors the reference's host path keeps)."""
    t, bg = view.renderer.tree, view.renderer.bitgrid
    pairs = np.stack([bg.occ_lo, bg.occ_hi], axis=1).view(np.int32)
    if (not np.array_equal(t["occ_pairs"].cpu().numpy(), pairs)
            or not np.array_equal(t["colors"].cpu().numpy().view(np.uint16), bg.colors)):
        raise AssertionError(f"{what}: the window on the card differs from the host's BitGrid")


def check_far_frame(view, cam, frame, what):
    """A view's far frame (the kernel's) against ``far_frame_plain`` on every
    pixel, with the plain march's steps: returns the plain march's record
    (``far_frame_plain``'s ``stats``), the largest difference and the plain
    frame's host-clock ms."""
    from voxelhex_tpu_torch.ops.far import far_frame_plain
    from voxelhex_tpu_torch.ops.traverse import MAX_ITERS

    stats = []
    t0 = time.perf_counter()
    plain = far_frame_plain(view.layers(cam), view.camera_inside(cam), out_u8=frame.dtype ==
                            torch.uint8, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_bad = int((~same(frame, plain)).any(dim=-1).sum())
    top = [int(s["iters"].max()) for s in stats]
    at_limit = sum(int((s["iters"] >= MAX_ITERS).sum()) for s in stats)
    log(f"  {what}: far-frame kernel against far_frame_plain, {n_bad} pixels differ; "
        f"{len(stats)} layers, most steps a ray {top}, {at_limit} rays at the limit of "
        f"{MAX_ITERS}")
    if n_bad:
        raise AssertionError(f"{what}: the far-frame kernel differs from its plain version")
    return stats, max_abs_err(frame, plain), plain_ms


def far_bound(view, cam, stats):
    """The far frame's bound from the plain march's record: the distinct
    word pairs and hit colors each layer reads, its palette and parameters,
    3 B a pixel written; each layer's steps and each ray it starts."""
    from voxelhex_tpu_torch.ops import _build

    R = cam.resolution[0] * cam.resolution[1]
    n_bytes, n_ops = ctypes.sizeof(_build.FarParams) + R * 3, 0
    for (tree, _c, _f), s in zip(view.layers(cam), stats):
        v = s["hvox"][s["hit"]].long()
        S = int(tree["size"])
        colors = int(torch.unique(v[:, 0] + (v[:, 1] + v[:, 2] * S) * S).numel())
        n_bytes += int(s["reads"].sum()) * 8 + colors * 2 + tree["palette"].shape[0] * 16
        n_ops += int(s["iters"].sum()) * TRAVERSE_OPS_PER_STEP + s["rays"] * FRAME_OPS_PER_PIXEL
    return bound(n_bytes, n_ops)


def settle(view, cam, what, max_renders=200):
    """Render ``cam`` until the view has no work left (worker jobs waited
    for); returns the settled frame on the card."""
    for _ in range(max_renders):
        frame = view.render(cam, out_u8=True, out_device=True)
        if view.settled():
            return view.render(cam, out_u8=True, out_device=True)
        if view._inflight:
            view._inflight[0][0].result()
        elif view.far is not None and view.far._job is not None:
            view.far._job[0].result()
    del frame
    raise AssertionError(f"{what}: not settled after {max_renders} renders")


def streaming_slice(dev, card, tree):
    """Phase 12: the port's ``StreamingView`` over the 1024 terrain (phase
    10's tree) on the card.  (a) the fly-over, the main path: 8 frames at
    1920x1080 through a 256 window and its whole-world ring, each update's
    device grids held to the plain scatter, rebuild and shift and to the
    host's BitGrid, one rebuild an update, each frame's far-frame kernel to
    ``far_frame_plain`` on every pixel and to the reference digest; (b)
    paging 64 regions an update with placeholders and occlusion pruning
    until settled; (d) worker
    threads (``async_uploads``, ``async_far``); (e) the ring ladder of a 64
    window; (c) an edit through the partial scatter; (f) each kernel's
    device time beside its bound, plain version and library call, the far
    frame and the window-only far frame beside ``frame.cu``, each layer's
    rays and steps, and a fly-over's frames by host clock.
    Returns the four kernels' entries of the ``kernels`` line."""
    from voxelhex_tpu_torch.ops import stream
    from voxelhex_tpu_torch.ops.far import render_far
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.render.streaming import FarField, FarTier, StreamingView
    from voxelhex_tpu_torch.tree.boxtree import Albedo

    t_all = time.time()
    host_tag = f"[{card}; host {host_cpu()}]"
    counters = (stream.region_scatter, stream.coarse_rebuild, stream.window_shift, render_far,
                render_frame)

    def counts():
        return {f.__name__: f.launches for f in counters}

    # (a) the fly-over, the main path
    t0 = time.time()
    checks = CheckedUpdates()
    far_err, fly_frames, fly_layers = 0.0, [], []
    with checks:
        view = StreamingView(tree, view_size=FLY_VIEW, regions_per_update=8192)
        for f in counters:
            f.launches = 0
        for i in range(FLY_FRAMES):
            cam = flight_cam(i)
            frame = view.render(cam, out_u8=True, out_device=True)
            # the plain versions launch nothing: the counts stay the path's
            check_window(view, f"fly-over frame {i}")
            stats, err, _ms = check_far_frame(view, cam, frame, f"fly-over frame {i}")
            far_err = max(far_err, err)
            fly_layers.append([(s["rays"], int(s["iters"].sum())) for s in stats])
            digest = sha(frame)
            log(f"  fly-over frame {i}: window at {tuple(int(v) for v in view.origin)}, "
                f"{view.uploads} regions paged, settled {view.settled()}; sha256 {digest} "
                f"{'==' if digest == FLYOVER_SHA256[i] else '!='} reference")
            if digest != FLYOVER_SHA256[i] or not view.settled():
                raise AssertionError(f"fly-over frame {i} differs from the reference digest")
            fly_frames.append(frame)
        launches = counts()
    ring = [(t.factor, t.cells, tuple(int(v) for v in t.origin)) for t in view.far.tiers]
    log(f"  fly-over: launches {launches}; calls held to their plain versions {checks.calls}; "
        f"the ring (factor, cells, origin) {ring}; a frame's scatter takes "
        f"{checks.last['region_scatter'][0].shape[0]} regions, its shift "
        f"{checks.last['window_shift']}")
    # frame 0 uploads the whole window; each later frame moves it and pages
    # the exposed regions through the partial scatter, then rebuilds once
    want = {"region_scatter": FLY_FRAMES - 1, "window_shift": FLY_FRAMES - 1,
            "coarse_rebuild": FLY_FRAMES - 1, "render_far": FLY_FRAMES, "render_frame": 0}
    if (any(launches[k] != n for k, n in want.items())
            or any(checks.calls[k] != launches[k] for k in checks.calls)):
        raise AssertionError(f"fly-over: launches {launches}, want {want}")
    fly_inputs = dict(checks.last)  # a fly-over frame's scatter and shift
    log(f"phase 12 (a) fly-over: {time.time() - t0:.1f} s")

    with checks:
        # (b) 64 regions an update, placeholders and occlusion pruning
        t0 = time.time()
        budget = StreamingView(tree, view_size=FLY_VIEW, regions_per_update=FLY_BUDGET)
        cam = flight_cam(FLY_FRAMES - 1)
        renders = 0
        while True:
            frame = budget.render(cam, out_u8=True, out_device=True)
            renders += 1
            if budget.settled() or renders > 2 * (FLY_VIEW // 16) ** 3 // FLY_BUDGET:
                break
        digest = sha(frame)
        log(f"  {FLY_BUDGET} regions an update: settled after {renders} renders, "
            f"{budget.uploads} regions paged, {len(budget._occluded)} parked by occlusion; "
            f"sha256 {digest} {'==' if digest == FLYOVER_SHA256[-1] else '!='} reference")
        if not budget.settled() or not bool((frame == fly_frames[-1]).all()):
            raise AssertionError("the budgeted view's settled frame differs from the fly-over's")
        budget.close()
        del budget
        log(f"phase 12 (b) budgeted paging: {time.time() - t0:.1f} s")

        # (d) worker threads
        t0 = time.time()
        workers = StreamingView(tree, view_size=FLY_VIEW, regions_per_update=8192,
                                async_uploads=True, async_far=True)
        for i in (FLY_FRAMES - 2, FLY_FRAMES - 1):
            digest = sha(settle(workers, flight_cam(i), f"worker threads, frame {i}"))
            log(f"  worker threads, frame {i}: sha256 {digest} "
                f"{'==' if digest == FLYOVER_SHA256[i] else '!='} reference")
            if digest != FLYOVER_SHA256[i]:
                raise AssertionError(f"worker threads: frame {i} differs from the reference")
        workers.close()
        del workers
        log(f"phase 12 (d) worker threads: {time.time() - t0:.1f} s")

        # (e) the ring ladder: a 64 window, W/S = 16
        t0 = time.time()
        ladder = StreamingView(tree, view_size=LADDER_VIEW, regions_per_update=8192)
        for i in (FLY_FRAMES - 2, FLY_FRAMES - 1):
            cam = flight_cam(i)
            frame = ladder.render(cam, out_u8=True, out_device=True)
            far_err = max(far_err, check_far_frame(
                ladder, cam, frame, f"ring ladder, frame {i} (camera inside the window: "
                f"{ladder.camera_inside(cam)})")[1])
        rings = [(t.factor, t.cells, tuple(int(v) for v in t.origin)) for t in ladder.far.tiers]
        log(f"  ring ladder: rings (factor, cells, origin) {rings}")
        if len(rings) != 2:
            raise AssertionError(f"the ring ladder has rings {rings}")
        ladder.close()
        del ladder
        log(f"phase 12 (e) ring ladder: {time.time() - t0:.1f} s")

        # (c) an edit inside the window: the partial scatter
        t0 = time.time()
        cam = flight_cam(FLY_FRAMES - 1)
        colors_before = view.renderer.tree["colors"]
        pos, lod, rgba = FLY_EDIT
        tree.insert_at_lod(pos, lod, Albedo(*rgba))
        dirty = len(view._dirty)
        edited = view.render(cam, out_u8=True, out_device=True)
        partial = view.renderer.tree["colors"] is colors_before
        check_window(view, "edit")
        edit_stats, err, far_plain_ms = check_far_frame(view, cam, edited, "edit")
        far_err = max(far_err, err)
        fresh_view = StreamingView(tree, view_size=FLY_VIEW, regions_per_update=8192)
        fresh = fresh_view.render(cam, out_u8=True, out_device=True)
        n_moved = int((edited != fly_frames[-1]).any(dim=-1).sum())
        log(f"  insert_at_lod{FLY_EDIT}: {dirty} regions paged by the partial scatter "
            f"{partial}, {n_moved} pixels changed, equal to a new view's frame "
            f"{bool((edited == fresh).all())}")
        if not partial or not n_moved or not bool((edited == fresh).all()):
            raise AssertionError("the edit: no partial scatter, no change, or a frame that "
                                 "differs from a new view's")
        fresh_view.close()
        del fresh_view, fresh
        log(f"phase 12 (c) edit: {time.time() - t0:.1f} s")

    # (f) times: each kernel at the fly-over's shapes, in turns; the far frame
    # beside frame.cu at the same window and pose
    t0 = time.time()
    cam = flight_cam(FLY_FRAMES - 1)
    window = view.renderer.tree
    S = FLY_VIEW
    work = dict(window, colors=window["colors"].clone(), occ_pairs=window["occ_pairs"].clone())
    corners, col_vals, blk_vals = fly_inputs["region_scatter"]
    shift = fly_inputs["window_shift"]
    K = corners.shape[0]
    # the library's scatter: index_copy_ of the widened colors and the pairs
    # at addresses built before the timing
    r = torch.arange(16, device=dev)
    c = corners.long()
    addr = (c[:, 0, None, None, None] + r[None, :, None, None]
            + (c[:, 1, None, None, None] + r[None, None, :, None]) * S
            + (c[:, 2, None, None, None] + r[None, None, None, :]) * S * S).reshape(-1)
    widened = work["colors"].clone()
    stream.region_scatter_plain(widened, work["occ_pairs"].clone(), corners, col_vals,
                                blk_vals, S)
    values16 = widened[addr]
    nb = S // 4
    b = torch.arange(4, device=dev)
    baddr = ((c[:, 0, None, None, None] // 4 + b[None, None, None, :])
             + (c[:, 1, None, None, None] // 4 + b[None, None, :, None]) * nb
             + (c[:, 2, None, None, None] // 4 + b[None, :, None, None]) * nb * nb).reshape(-1)
    blk2 = blk_vals.reshape(-1, 2)
    layers, inside = view.layers(cam), view.camera_inside(cam)
    cam_local = layers[0][1]
    def warm_ms(fn, reps):
        """device_ms after one call (which allocates what the calls reuse)."""
        fn()
        return device_ms(fn, reps)

    timers = {
        "region_scatter": lambda: warm_ms(lambda: stream.region_scatter(
            work, corners, col_vals, blk_vals), 20),
        "index_copy_": lambda: warm_ms(lambda: (work["colors"].index_copy_(0, addr, values16),
                                                work["occ_pairs"].index_copy_(0, baddr, blk2)),
                                       20),
        "coarse_rebuild": lambda: warm_ms(lambda: stream.coarse_rebuild(work), 20),
        "window_shift": lambda: warm_ms(lambda: stream.window_shift(work, shift), 10),
        "torch.roll": lambda: warm_ms(lambda: (
            torch.roll(work["colors"].view(S, S, S), (-shift[2], -shift[1], -shift[0]),
                       (0, 1, 2)),
            torch.roll(work["occ_pairs"][: nb**3].view(nb, nb, nb, 2),
                       (-shift[2] // 4, -shift[1] // 4, -shift[0] // 4), (0, 1, 2))), 5),
        "far frame": lambda: warm_ms(lambda: render_far(layers, inside), 10),
        "window-only far frame": lambda: warm_ms(lambda: render_far(layers[:1], inside), 10),
        "frame.cu": lambda: warm_ms(lambda: render_frame(window, cam_local), 10),
    }
    turns = {name: [] for name in timers}
    for name in list(timers) + list(timers)[::-1]:
        turns[name].append(timers[name]())
        log(f"  turn {name}: {turns[name][-1]:.4f} ms device time {host_tag}")
    ms = {name: sum(v) / len(v) for name, v in turns.items()}
    plain = {
        "region_scatter": host_ms(lambda: stream.region_scatter_plain(
            work["colors"], work["occ_pairs"], corners, col_vals, blk_vals, S), 3),
        "coarse_rebuild": host_ms(lambda: stream.coarse_rebuild_plain(
            work["occ_pairs"], work["bases"], work["dims"]), 3),
        "window_shift": host_ms(lambda: stream.window_shift_plain(
            work["colors"], work["occ_pairs"], S, shift), 3),
        "far frame": far_plain_ms,  # (c)'s check, at this state and pose
    }
    n_pairs = window["occ_pairs"].shape[0]
    wide = col_vals.element_size()
    bounds = {
        "region_scatter": bound(K * (12 + 4096 * wide + 64 * 8) + K * (4096 * 2 + 64 * 8), 0),
        # level 0 read, every level above written
        "coarse_rebuild": bound(n_pairs * 8, 0),
        "window_shift": bound(2 * (S**3 * 2 + n_pairs * 8), 0),
        "far frame": far_bound(view, cam, edit_stats),
    }
    for name in ("region_scatter", "coarse_rebuild", "window_shift", "far frame"):
        lib = {"region_scatter": "index_copy_", "window_shift": "torch.roll"}.get(name)
        log(f"{name}: {ms[name]:.4f} ms device time, bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}), plain version {plain[name]:.3f} ms (host clock)"
            + (f", {lib} {ms[lib]:.4f} ms" if lib else "") + f" {host_tag}")
    for i, per_layer in enumerate(fly_layers):
        log(f"  fly-over frame {i}, each layer's march (rays, steps): {per_layer}")
    log(f"far frame {ms['far frame']:.4f} ms against frame.cu {ms['frame.cu']:.4f} ms at the "
        f"same {FLY_VIEW} window and pose ({ms['far frame'] / ms['frame.cu']:.2f} times), "
        f"{ms['far frame'] / bounds['far frame'][0]:.1f} times its bound; on the window alone "
        f"{ms['window-only far frame']:.4f} ms "
        f"({ms['window-only far frame'] / ms['frame.cu']:.2f} times frame.cu) {host_tag}")
    log(f"coarse rebuild {ms['coarse_rebuild']:.4f} ms, one launch, "
        f"{ms['coarse_rebuild'] / bounds['coarse_rebuild'][0]:.1f} times its bound {host_tag}")
    # the scatter as an update meets it: its wire has just crossed from the
    # host, so it is timed with the L2 flushed before each launch too, beside
    # the host clock of the wire's three copies to the card (pageable NumPy
    # rows, as StreamingView sends them, each followed by a synchronize)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cold = device_ms_each(lambda: stream.region_scatter(work, corners, col_vals, blk_vals), 20,
                          before=flush.zero_)
    del flush
    cold_ms = sum(cold) / len(cold)
    log(f"region_scatter: {ms['region_scatter']:.4f} ms warm "
        f"({bounds['region_scatter'][0] / ms['region_scatter']:.1%} of its bound), "
        f"{cold_ms:.4f} ms with the L2 flushed before each launch "
        f"({bounds['region_scatter'][0] / cold_ms:.1%}; each "
        + ", ".join(f"{x:.4f}" for x in cold) + f") {host_tag}")
    wire = {name: t.cpu().numpy() for name, t in (("corners", corners), ("colors", col_vals),
                                                   ("word pairs", blk_vals))}
    copy_ms = {name: host_ms(lambda a=a: torch.from_numpy(a).to(dev), 20)
               for name, a in wire.items()}
    copy_ms["the three"] = host_ms(lambda: [torch.from_numpy(a).to(dev) for a in wire.values()],
                                   20)
    log("the scatter's wire to the card, host clock: " + ", ".join(
        f"{name} {copy_ms[name]:.4f} ms ({a.nbytes} B)" for name, a in wire.items())
        + f"; the three {copy_ms['the three']:.4f} ms "
        f"({sum(a.nbytes for a in wire.values())} B), "
        f"{copy_ms['the three'] / ms['region_scatter']:.1f} times the kernel warm {host_tag}")
    del work, widened

    # a fly-over's frames by host clock: the update and its stages, the far
    # refresh (the ring's plan: its hole cut and pyramid pack; its upload),
    # and the device (what is left of render(), the far frame's launch and
    # the wait for the card)
    spent = {}
    stages = ("_region_occluded", "_fill_placeholders", "_rasterize_batch_sync",
              "_shift_window", "_shift_device", "_update_device_partial", "_rebuild_device")
    wrapped = ([(StreamingView, "update"), (FarField, "refresh"), (FarTier, "plan_refresh"),
                (FarTier, "apply_refresh")] + [(StreamingView, name) for name in stages])
    originals = [getattr(cls, name) for cls, name in wrapped]

    def timer(fn, key):
        def call(*args, **kwargs):
            t1 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t1
        return call

    view.close()
    del view
    try:
        for (cls, name), fn in zip(wrapped, originals):
            setattr(cls, name, timer(fn, name))
        timed_view = StreamingView(tree, view_size=FLY_VIEW, regions_per_update=8192)
        for i in range(FLY_FRAMES):
            spent.clear()
            t1 = time.perf_counter()
            timed_view.render(flight_cam(i), out_u8=True, out_device=True)
            torch.cuda.synchronize()
            total = time.perf_counter() - t1
            ms_of = {k: spent.get(k, 0.0) * 1e3 for k in spent}
            other = ms_of["update"] - sum(ms_of.get(k, 0.0) for k in stages)
            log(f"  fly-over frame {i}: {total * 1e3:.1f} ms by host clock: update "
                f"{ms_of['update']:.1f} ms ("
                + ", ".join(f"{k.strip('_')} {ms_of.get(k, 0.0):.1f}" for k in stages)
                + f", the rest {other:.1f}), far refresh {ms_of.get('refresh', 0.0):.1f} ms "
                f"(plan {ms_of.get('plan_refresh', 0.0):.1f}, apply "
                f"{ms_of.get('apply_refresh', 0.0):.1f}), device and launch "
                f"{total * 1e3 - ms_of['update'] - ms_of.get('refresh', 0.0):.1f} ms {host_tag}")
    finally:
        for (cls, name), fn in zip(wrapped, originals):
            setattr(cls, name, fn)
    timed_view.close()
    del timed_view
    log(f"phase 12 (f) timing: {time.time() - t0:.1f} s")
    log(f"phase 12 streaming: {time.time() - t_all:.1f} s, launches {launches}")

    src = "voxelhex_tpu_torch/csrc/"
    ref = "voxelhex_tpu/render/streaming.py:"
    rows = (("region_scatter", "stream.cu", "42", "region_scatter", "index_copy_"),
            ("coarse_rebuild", "stream.cu", "114", "coarse_rebuild", None),
            ("window_shift", "stream.cu", "1073", "window_shift", "torch.roll"),
            ("far_frame", "far.cu", "1479", "far frame", None))
    return [{"name": name, "route": "cuda", "source": src + source, "replaces": ref + line,
             "launches": launches["render_far" if name == "far_frame" else name],
             "max_abs_err": far_err if name == "far_frame" else 0.0, "ms": ms[key],
             "plain_ms": plain[key],
             "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
             "library_ms": ms[lib] if lib else None}
            for name, source, line, key, lib in rows]


def png_pixels(data):
    """The ``[h, w, 3]`` u8 pixels of a PNG of 8-bit RGB rows with filter 0
    (what ``utils.png.encode_png`` writes), decoded with zlib; each chunk's
    CRC is checked."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("the reply is not a PNG")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype = ihdr[:4]
    if (depth, ctype) != (8, 2):
        raise AssertionError(f"PNG of depth {depth}, color type {ctype}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError("PNG rows filtered other than by 0")
    return raw[:, 1:].reshape(h, w, 3)


class Client:
    """A ``make_server`` of ``service`` on a daemon thread, and requests to
    it through an opener with no proxy; any reply but 200 raises with its
    body."""

    def __init__(self, service):
        from voxelhex_tpu_torch.serve import make_server

        self.service = service
        self.srv = make_server(service, port=0)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def _open(self, req):
        try:
            with self.opener.open(req, timeout=600) as reply:
                if reply.status != 200:
                    raise AssertionError(f"{req.full_url}: HTTP {reply.status}")
                return reply.read()
        except urllib.error.HTTPError as e:
            raise AssertionError(f"{req.full_url}: HTTP {e.code}: {e.read()[:2000]!r}") from e

    def get(self, path):
        return self._open(urllib.request.Request(self.base + path))

    def post(self, path, body):
        if not isinstance(body, bytes):
            body = json.dumps(body).encode()
        return self._open(urllib.request.Request(self.base + path, data=body, method="POST"))

    def stats(self):
        return json.loads(self.get("/stats"))

    def frame(self, cam):
        """``(pixels, png)`` of ``GET /frame`` at ``cam``, its origin, target
        and fov written with ``repr``."""
        names = ("ox", "oy", "oz", "tx", "ty", "tz")
        values = [*np.asarray(cam.origin).tolist(), *np.asarray(cam.target).tolist()]
        query = "&".join(f"{k}={float(v)!r}" for k, v in zip(names, values))
        w, h = cam.resolution
        png = self.get(f"/frame?{query}&w={w}&h={h}&fov={float(cam.fov_y_deg)!r}")
        return png_pixels(png), png

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def random_edit_ops(rng, n, size):
    """``n`` seeded edits ``(method, args)`` at random voxels of a ``size``
    world: insert, update and clear, and insert_at_lod and clear_at_lod at
    2, 4 and 8; one color in seven transparent."""
    from voxelhex_tpu_torch.tree.boxtree import Albedo

    ops = []
    for _ in range(n):
        p = tuple(int(v) for v in rng.integers(0, size, 3))
        c = [int(v) for v in rng.integers(0, 256, 4)]
        if rng.random() < 0.15:
            c[3] = 0
        r = rng.random()
        if r < 0.45:
            ops.append(("insert", (p, Albedo(*c))))
        elif r < 0.6:
            ops.append(("update", (p, Albedo(*c))))
        elif r < 0.8:
            ops.append(("clear", (p,)))
        elif r < 0.9:
            ops.append(("insert_at_lod", (p, int(rng.choice([2, 4, 8])), Albedo(*c))))
        else:
            ops.append(("clear_at_lod", (p, int(rng.choice([2, 4, 8])))))
    return ops


def serving_slice(dev, card, terrain):
    """Phase 13: the port's ``RenderService`` on the card, over HTTP.  (a)
    the bench tree's three poses, one batched-kernel launch a request, to
    the reference digests; (b) the bench pose again, fetched as digests only
    and pose-validated; (c) an edit and its clear, each frame one row band,
    equal to a fresh render; (d) a 128 window until settled, equal to a
    synchronous view's frame, then switches that leave no view and no device
    memory behind; (e) the terrain through a 256 window (``async_far``) at
    three fly-over poses until settled, to the reference digests, an
    idle-cache hit that launches nothing and an edit; (f) a ``.vox`` upload
    and its bencode cache; (g) the native edit engine against the BoxTree
    after the same 2,000 ops, rendered on the card, and both engines' host
    us per op; (h) host times of the requests in turns.  Returns the
    launches of the batched and far-frame kernels on the main path."""
    import gc

    from voxelhex_tpu_torch.io import vox
    from voxelhex_tpu_torch.ops import stream
    from voxelhex_tpu_torch.ops.far import render_far
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.ops.frames import render_frames
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.render.streaming import StreamingView
    from voxelhex_tpu_torch.scene import build_scene_tree
    from voxelhex_tpu_torch.serve import RenderService
    from voxelhex_tpu_torch.tree.boxtree import Albedo
    from voxelhex_tpu_torch.tree.build import insert_many
    from voxelhex_tpu_torch.tree.native_edit import NativeEditTree
    from voxelhex_tpu_torch.utils.png import encode_png

    t_all = time.time()
    cpu = host_cpu()
    host_tag = f"[{card}; host {cpu}]"
    counters = {"frames": render_frames, "frame": render_frame, "far": render_far,
                "scatter": stream.region_scatter, "rebuild": stream.coarse_rebuild,
                "shift": stream.window_shift}
    served = dict.fromkeys(counters, 0)

    def request(fn):
        """``fn()`` on the main path, every count set to 0 just before it
        and read just after: ``(its result, its launches)``."""
        for c in counters.values():
            c.launches = 0
        out = fn()
        n = {k: c.launches for k, c in counters.items()}
        for k, v in n.items():
            served[k] += v
        return out, n

    def only(n, **want):
        return all(v == want.get(k, 0) for k, v in n.items())

    bench_cams = {yaw: orbit_camera(128.0, yaw_deg=yaw, resolution=RES) for yaw in YAWS}
    cam = bench_cams[YAWS[0]]

    # (a) the bench tree's three poses
    t0 = time.time()
    bench = build_scene_tree(4)
    service = RenderService(bench, device=dev)
    client = Client(service)
    for yaw, c in bench_cams.items():
        (px, png), n = request(lambda c=c: client.frame(c))
        d = sha(px)
        log(f"  GET /frame yaw {yaw}: {len(png)} B of PNG, launches {n}, sha256 {d} "
            f"{'==' if d == REFERENCE_SHA256[yaw] else '!='} reference")
        if d != REFERENCE_SHA256[yaw] or px.shape != (RES[1], RES[0], 3):
            raise AssertionError(f"served frame yaw {yaw} differs from the reference digest")
        if not only(n, frames=1):
            raise AssertionError(f"a dense request launched {n}, want one batched kernel")
    log(f"phase 13 (a) dense poses: {time.time() - t0:.1f} s")

    # (b) the bench pose again: digests only, pose-validated from the second
    t0 = time.time()
    validated = service.pose_validated_frames
    first = None
    for k in range(4):
        (px, _png), n = request(lambda: client.frame(cam))
        trace = client.stats()["last_trace"]
        first = px if first is None else first
        log(f"  repeat {k}: launches {n}, last_trace {trace}")
        if not only(n, frames=1) or not np.array_equal(px, first):
            raise AssertionError(f"repeat {k}: launches {n}, or a frame that changed")
        if k and (trace["delta_fetched"] != 0 or not trace["pose_validated"]):
            raise AssertionError(f"repeat {k} fetched a frame or was not pose-validated")
    if sha(first) != REFERENCE_SHA256[YAWS[0]]:
        raise AssertionError("the repeated frame differs from the reference digest")
    grew = service.pose_validated_frames - validated
    log(f"  pose_validated_frames grew by {grew} over 4 repeats (the port's rule: 3)")
    if grew != 3:
        raise AssertionError(f"pose_validated_frames grew by {grew}, want 3")
    log(f"phase 13 (b) repeated pose: {time.time() - t0:.1f} s")

    # (c) an edit and its clear through /edit
    t0 = time.time()
    renderer = service.renderer
    pos, lod, rgba = EDIT
    for op in ({"op": "insert", "pos": list(pos), "size": lod, "color": list(rgba)},
               {"op": "clear", "pos": list(pos), "size": lod}):
        reply, n = request(lambda op=op: client.post("/edit", op))
        if json.loads(reply) != {"applied": 1} or not only(n):
            raise AssertionError(f"/edit {op}: {reply!r}, launches {n}")
        (px, _png), n = request(lambda: client.frame(cam))
        trace = dict(service.renderer.last_stats)
        fresh = fastest_renderer(bench, device=dev).render(cam, out_u8=True)
        log(f"  /edit {op['op']}: the next frame launches {n}, fetched "
            f"{trace['delta_fetched']} frame, {trace['delta_rows_fetched']} rows; equal to a "
            f"fresh render() {np.array_equal(px, fresh)}")
        if (not np.array_equal(px, fresh) or not only(n, frames=1)
                or trace["delta_fetched"] != 1 or not 0 < trace["delta_rows_fetched"] < 540
                or service.renderer is not renderer):
            raise AssertionError(f"/edit {op['op']}: the frame after it is not one row band "
                                 "equal to a fresh render, or the renderer was replaced")
    log(f"phase 13 (c) edits: {time.time() - t0:.1f} s")

    # (d) a 128 window until settled, then switches that leave nothing behind
    t0 = time.time()
    triggers = len(bench.update_triggers)
    stats = json.loads(client.post("/view", {"view_size": 128}))
    if not stats["streaming"] or stats["view_size"] != 128:
        raise AssertionError(f"/view 128: {stats}")
    for k in range(1, SERVE_MAX_REQUESTS + 1):
        (px, _png), n = request(lambda: client.frame(cam))
        if service.view.settled():
            break
    else:
        raise AssertionError("the 128 window did not settle")
    sync = StreamingView(bench, view_size=128, regions_per_update=8192, device=dev)
    want = sync.render(cam, out_u8=True)
    sync.close()
    del sync
    log(f"  /view 128: settled after {k} requests, far tiers {client.stats().get('far_tiers')}; "
        f"equal to a synchronous view's frame {np.array_equal(px, want)}")
    if not np.array_equal(px, want):
        raise AssertionError("the served 128 window differs from a synchronous view's frame")
    levels = []
    for size in (0, 128, 0):
        client.post("/view", {"view_size": size})
        request(lambda: client.frame(cam))
        if size == 0:
            gc.collect()
            torch.cuda.synchronize()
            levels.append(torch.cuda.memory_allocated())
    log(f"  switches 128 -> 0 -> 128 -> 0: tree triggers {len(bench.update_triggers)} (before "
        f"{triggers}), memory_allocated after the first and last switch to dense {levels} B")
    if len(bench.update_triggers) != triggers or abs(levels[1] - levels[0]) > 2**20:
        raise AssertionError("a replaced view stayed on the tree or on the card")
    log(f"phase 13 (d) view distance: {time.time() - t0:.1f} s")

    # (e) the terrain through a 256 window, its rings built off the render path
    t0 = time.time()
    tservice = RenderService(terrain, view_size=FLY_VIEW, async_far=True, device=dev)
    tclient = Client(tservice)
    for i in SERVE_FLY:
        fcam = flight_cam(i)
        for k in range(1, SERVE_MAX_REQUESTS + 1):
            (px, png), n = request(lambda: tclient.frame(fcam))
            if tservice.view.settled():
                break
        else:
            raise AssertionError(f"fly-over pose {i} did not settle")
        d = sha(px)
        log(f"  fly-over pose {i}: settled after {k} requests ({tservice.view.uploads} regions "
            f"paged), {len(png)} B of PNG, sha256 {d} "
            f"{'==' if d == FLYOVER_SHA256[i] else '!='} reference")
        if d != FLYOVER_SHA256[i]:
            raise AssertionError(f"served fly-over pose {i} differs from the reference digest")
    hits = tservice.stream_cache_hits
    (again, _png), n = request(lambda: tclient.frame(fcam))
    log(f"  the same pose again: launches {n}, idle-cache hits {hits} -> "
        f"{tservice.stream_cache_hits}")
    if tservice.stream_cache_hits != hits + 1 or not only(n) or not np.array_equal(again, px):
        raise AssertionError("the settled pose was not served from the idle cache alone")
    pos, lod, rgba = SERVE_EDIT
    request(lambda: tclient.post("/edit", {"op": "insert", "pos": list(pos), "size": lod,
                                           "color": list(rgba)}))
    (edited, _png), n = request(lambda: tclient.frame(fcam))
    n_moved = int((edited != px).any(axis=-1).sum())
    log(f"  /edit insert_at_lod{SERVE_EDIT}: the pose re-renders with launches {n}, "
        f"{n_moved} pixels changed")
    if n["far"] != 1 or not n_moved:
        raise AssertionError("the edit did not re-render the pose, or changed no pixel")
    log(f"phase 13 (e) streamed terrain: {time.time() - t0:.1f} s")

    # (f) a .vox upload and its bencode cache
    t0 = time.time()
    parsed = []
    load_vox_tree = vox.load_vox_tree
    vox.load_vox_tree = lambda *a, **k: parsed.append(a) or load_vox_tree(*a, **k)
    saved_tmp = tempfile.tempdir
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tempfile.tempdir = tmp  # where load_vox_bytes keeps its cache
            data = vox_file_bytes()
            path = os.path.join(tmp, "smoke.vox")
            with open(path, "wb") as f:
                f.write(data)
            want_tree = load_vox_tree(path, brick_dim=4)
            vcam = orbit_camera(float(want_tree.size), resolution=RES)
            want = fastest_renderer(want_tree, device=dev).render(vcam, out_u8=True)
            for k in range(2):
                reply, _n = request(lambda: client.post("/load?name=smoke.vox", data))
                (px, _png), n = request(lambda: client.frame(vcam))
                log(f"  POST /load {k}: {reply!r}, .vox parses so far {len(parsed)}, frame "
                    f"launches {n}, equal to fastest_renderer(load_vox_tree) "
                    f"{np.array_equal(px, want)}")
                if (len(parsed) != 1 or not np.array_equal(px, want)
                        or json.loads(reply) != {"loaded": True, "size": want_tree.size}):
                    raise AssertionError(f"upload {k}: the served scene differs from the "
                                         "file's, or the cache was not read")
    finally:
        tempfile.tempdir = saved_tmp
        vox.load_vox_tree = load_vox_tree
    log(f"phase 13 (f) upload: {time.time() - t0:.1f} s")

    # (g) the native edit engine on the card's host
    t0 = time.time()
    py = build_scene_tree(4)
    nat = NativeEditTree.from_boxtree(py)
    ops = random_edit_ops(np.random.default_rng(13), EDIT_ENGINE_OPS, py.size)
    spent = {}
    for name, tree in (("BoxTree", py), ("NativeEditTree", nat)):
        t1 = time.perf_counter()
        for method, args in ops:
            getattr(tree, method)(*args)
        spent[name] = (time.perf_counter() - t1) / len(ops) * 1e6
    conv = nat.to_boxtree()
    a = fastest_renderer(py, device=dev).render(cam, out_u8=True, out_device=True)
    b = fastest_renderer(conv, device=dev).render(cam, out_u8=True, out_device=True)
    log(f"  {len(ops)} seeded ops: BoxTree {spent['BoxTree']:.1f} us/op, NativeEditTree "
        f"{spent['NativeEditTree']:.1f} us/op; nodes {py.node_count} and {conv.node_count}; "
        f"bench-pose frames equal {bool((a == b).all())} {host_tag}")
    if py.node_count != conv.node_count or not bool((a == b).all()):
        raise AssertionError("the edit engine's tree renders differently from the BoxTree's")
    rng = np.random.default_rng(14)
    pts = rng.integers(0, py.size, (EDIT_TIMED_OPS, 3))
    cols = rng.integers(1, 256, (EDIT_TIMED_OPS, 4)).astype(np.uint8)
    cols[:, 3] = 255
    albedos = [Albedo(*(int(v) for v in c)) for c in cols]
    us = {}
    for name in ("BoxTree", "NativeEditTree"):
        fresh = build_scene_tree(4)
        tree = fresh if name == "BoxTree" else NativeEditTree.from_boxtree(fresh)
        for op, run in (
                ("insert", lambda: [tree.insert(tuple(p), c) for p, c in zip(pts.tolist(),
                                                                             albedos)]),
                ("clear", lambda: [tree.clear(tuple(p)) for p in pts.tolist()]),
                ("insert_at_lod 4", lambda: [tree.insert_at_lod(tuple(p), 4, c)
                                             for p, c in zip(pts.tolist(), albedos)]),
                ("batch insert", lambda: (insert_many(tree, pts, cols) if name == "BoxTree"
                                          else tree.insert_batch(pts, cols)))):
            t1 = time.perf_counter()
            run()
            us[name, op] = (time.perf_counter() - t1) / EDIT_TIMED_OPS * 1e6
    for op in ("insert", "clear", "insert_at_lod 4", "batch insert"):
        log(f"edit engines, {op} ({EDIT_TIMED_OPS} random voxels of the bench tree): BoxTree "
            f"{us['BoxTree', op]:.2f} us a voxel, NativeEditTree {us['NativeEditTree', op]:.2f} "
            f"us a voxel ({us['BoxTree', op] / us['NativeEditTree', op]:.1f} times) {host_tag}")
    del py, nat, conv, a, b
    log(f"phase 13 (g) edit engine: {time.time() - t0:.1f} s")

    # (h) host times in turns at 1080p: the service's render, the PNG
    # encode, the whole GET /frame and the PNG's size of each case, and
    # the whole POST /edit of the dense scene (its BitGrid rebuilt and
    # uploaded)
    t0 = time.time()
    dense = RenderService(build_scene_tree(4), device=dev)
    dclient = Client(dense)
    near, far_cam = flight_cam(1), flight_cam(2)
    state = {"yaw": 0, "move": 0, "edit": 0}

    def next_yaw():
        state["yaw"] ^= 1
        return bench_cams[YAWS[state["yaw"]]]

    def next_move():
        state["move"] ^= 1
        return near if state["move"] else far_cam

    cases = {
        "dense, a new pose": (dense, dclient, next_yaw),
        "dense, the same pose": (dense, dclient, lambda: cam),
        "streamed, the idle cache": (tservice, tclient, lambda: far_cam),
        "streamed, after a move": (tservice, tclient, next_move),
    }
    times = {name: {"render": [], "encode": [], "get": [], "bytes": []} for name in cases}
    edit_ms = []

    def one_edit():
        pos, lod, rgba = EDIT
        op = ({"op": "insert", "pos": list(pos), "size": lod, "color": list(rgba)}
              if state["edit"] == 0 else {"op": "clear", "pos": list(pos), "size": lod})
        state["edit"] ^= 1
        t1 = time.perf_counter()
        dclient.post("/edit", op)
        edit_ms.append((time.perf_counter() - t1) * 1e3)

    def settle_service(svc, c):
        """Serve ``c`` until the view has settled and its frame is cached."""
        for _ in range(SERVE_MAX_REQUESTS):
            svc.render(c.origin, c.target, c.resolution, c.fov_y_deg)
            if svc.view.settled() and svc._stream_cache is not None:
                return
        raise AssertionError("the terrain window did not settle for the timing")

    for name in list(cases) + list(cases)[::-1]:
        svc, cl, pose = cases[name]
        c = pose()
        if name == "streamed, the idle cache":
            settle_service(svc, c)
        else:
            svc.render(c.origin, c.target, c.resolution, c.fov_y_deg)  # the turn's start
        t = times[name]
        for _ in range(SERVE_TIMED):
            c = pose()
            t1 = time.perf_counter()
            rgb = svc.render(c.origin, c.target, c.resolution, c.fov_y_deg)
            t2 = time.perf_counter()
            png = encode_png(rgb)
            t3 = time.perf_counter()
            c = pose()
            t4 = time.perf_counter()
            cl.frame(c)
            t5 = time.perf_counter()
            t["render"].append((t2 - t1) * 1e3)
            t["encode"].append((t3 - t2) * 1e3)
            t["get"].append((t5 - t4) * 1e3)
            t["bytes"].append(len(png))
        log(f"  turn {name}: service.render " + ", ".join(f"{v:.2f}" for v in
                                                          t["render"][-SERVE_TIMED:])
            + " ms; encode_png " + ", ".join(f"{v:.2f}" for v in t["encode"][-SERVE_TIMED:])
            + " ms; GET /frame " + ", ".join(f"{v:.2f}" for v in t["get"][-SERVE_TIMED:])
            + f" ms {host_tag}")
        one_edit()
    for name, t in times.items():
        log(f"served 1920x1080, {name}: service.render {np.mean(t['render']):.2f} ms, "
            f"encode_png {np.mean(t['encode']):.2f} ms, GET /frame {np.mean(t['get']):.2f} ms "
            f"(medians {np.median(t['render']):.2f}, {np.median(t['encode']):.2f}, "
            f"{np.median(t['get']):.2f}), PNG {int(np.mean(t['bytes']))} B {host_tag}")
    log("POST /edit of the dense bench tree (flatten, build_bitgrid, upload): "
        + ", ".join(f"{v:.1f}" for v in edit_ms) + f" ms, mean {np.mean(edit_ms):.1f} ms "
        f"{host_tag}")
    log(f"phase 13 (h) timing: {time.time() - t0:.1f} s")

    for c in (client, tclient, dclient):
        c.close()
    for svc in (service, tservice, dense):
        if svc.view is not None:
            svc.view.close()
    log(f"phase 13 serving: {time.time() - t_all:.1f} s, main-path launches {served}")
    return served


if __name__ == "__main__":
    sys.exit(main())
