"""The automaton's kernels, the skip tracer's and the start prepasses'
against another tree's, and their instructions.

    python3 tools/automaton_ab.py --sass [--moves] [--parent DIR] [--out DIR]
    python3 tools/automaton_ab.py --parent DIR [--rounds N] [--only WORDS] [--profile]
                                  [--variant NAME=DIR[:FLAG,FLAG...] ...]

``--sass`` builds ``tools/automaton_probes.cu`` (one kernel for each piece
of the loop of ``csrc/traverse.cuh``) with the kernels' nvcc flags and
prints each piece's instruction count from ``cuobjdump -sass``, leaving out
loads, stores, moves of constants and the kernel's frame; then, for the
four kernels that run the automaton (``traverse.cu``, ``frame.cu``,
``frames.cu``, ``multihit.cu``), their instructions and the DDA steps
inlined in each (a DDA step selects the constant BIG = 1e30 once on each
axis, and nothing else in those kernels uses it), for this tree and the one
in ``--parent``; then the instructions, registers and shared and global
loads of every instance of the skip tracer (``csrc/skip.cuh``: a kernel
for each pyramid depth in ``traverse.cu``, ``frame.cu``, ``frames.cu``,
``prepass.cu``, ``multihit.cu``) and of the start prepasses' kernels
(``beam.cu``, ``prepass.cu``'s one-launch prepass, ``splat.cu``'s two
passes); and with ``--parent``, which of the parent's functions in every
library this tree has byte for byte (its SASS, the function's name aside),
and how many it does not.  The SASS goes to
``--out``.  ``--moves`` adds ``chip_smoke.py``'s report of the automaton's
moves at the bench pose (phase 4b (f)): what the warps of the frame kernels
run under each shape of the loop.

``--parent DIR`` with no ``--sass`` times the kernels of this tree against
those of ``DIR`` (a copy of another commit, e.g. unpacked with ``git
archive``) in one process on one card: both are built from their own
sources, their outputs must be equal bit for bit, and then each kernel is
timed in turns, parent, change, change, parent, ``--rounds`` times, by
device time (``chip_smoke.device_ms``) at ``chip_smoke.py``'s shapes: a
batch of 16 bench frames with digests (``frames.cu``), the bench frame
(``frame.cu``), the bench pose's rays (``traverse.cu``) and its multi-hit
march at K = 2 (``multihit.cu``); the skip instances of ``frame.cu``,
``frames.cu`` (16 frames) and ``multihit.cu`` (K = 2) at the bench (4
levels) and at the 1024 terrain (5 levels, ``orbit_camera(1024.0)``); and
``beam.cu`` at the bench and terrain poses and in the window of fly-over
frame 0 (``chip_smoke.py`` phase 14's poses), for one frame and a batch of
16, and one frame over an empty grid of the bench's size (its launch
floor); the depth prepass at ``prepass_levels=2`` (both levels' depths and
the start map, however many launches each tree makes), stack and skip, at
the bench and terrain poses; and the splat prepass at the bench pose (its
device operations as each tree's wrapper makes them); the LOD frame
(``frame.cu``'s ``frame_lod_kernel``, f32) at the bench pose at
``lod_scale`` 0, 0.05 and 0.3 and in ``chip_smoke.py`` phase 10's 512 world
at 0.3, after each case's steps a ray and the steps on which its stop rule
decides, from the plain march; ``--only WORDS`` keeps the kernels whose
names hold one of the comma-separated words (``--only lod``, or words
naming LOD cases such as ``--only "bench (lod_scale 0.0)"``, sets up only
the LOD frame's worlds).
``--variant NAME=DIR[:FLAGS]`` (repeatable) adds another tree copy to the
turns, built from its own sources by its own ``_build.py`` with the extra
comma-separated nvcc ``FLAGS`` (e.g. ``-DNAME=1,-maxrregcount=64``): a
design tried against the parent and this tree, parent, change, variants,
then back in reverse, each held to the parent's outputs bit for bit.
``--profile`` first prints each tree's device time of each kernel and
fill a call launches (``torch.profiler``), e.g. the parent's launch a
level of the depth prepass beside this tree's one launch.

``--only flat`` sets up and times only the flat-tree kernels of
``csrc/flat.cu`` at ``chip_smoke.py`` phase 18's shapes (the bench FlatTree
at the 1080p bench pose, the 512 world): the wavefront, the fast kernel's
bitmap form, its voxel-read form in the 512 world, the prepass's depth
launch (960x540) and the full-res launch from the pooled starts, each in
this tree under four launch settings (warps on 4 x 8 tiles of the frame or
on rows, ``pow2`` products by inverses or divisions; a tree whose
``FlatParams`` lacks the fields takes rows and divisions), and
``flat_vmap_kernel`` as a control; first the registers, stack and spills
of every flat kernel of both trees, and the move record of the plain
wavefront and fast marches on the whole frame (``--flat-moves``); last,
each flat renderer's ``render()`` at 1080p by host clock in each tree
(a process a tree, in turns), with its ``Camera.rays()``, the rays' two
copies to the card and a frame's copy back.
``--flat-moves`` alone prints that record and stops: turns a warp,
working lane-turns and DDA steps a warp, rows against tiles
(``render/wavefront.py`` ``warp_moves``); with ``--cpu`` on the CPU, for
``--windows NXxNY`` windows of 64 x 32 pixels spread over the frame (each
its own small frame; the whole frame is too large for the CPU).
Needs one CUDA card, but for ``--flat-moves --cpu``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# vhx::BIG as cuobjdump prints an f32 immediate
BIG = re.compile(r"1\.0000000150474662\d*e\+30")
AUTOMATON = (("traverse.cu", "traverse_kernel"), ("frame.cu", "frame_kernel"),
             ("frames.cu", "frames_kernel"), ("multihit.cu", "multihit_kernel"))
# the redesigned kernels: every instance of the skip tracer and the start
# prepasses'
REDESIGNED = (("traverse.cu", "traverse_skip_kernel"), ("frame.cu", "frame_skip_kernel"),
              ("frames.cu", "frames_skip_kernel"), ("prepass.cu", "prepass_kernel"),
              ("prepass.cu", "prepass_frame_kernel"), ("multihit.cu", "multihit_form_kernel"),
              ("beam.cu", "beam_kernel"), ("splat.cu", "splat_point_kernel"),
              ("splat.cu", "splat_texel_kernel"), ("far.cu", "far_skip_kernel"),
              ("frame.cu", "frame_lod_kernel"), ("stream.cu", "skip_rows_kernel"),
              ("composite.cu", "composite_bwd_kernel"))
# the kernels whose functions may change (a name holds one of these):
# every other function the parent has is to keep its SASS (none here: the
# options' and the u8 colors' instances are new functions beside the
# parent's)
REDESIGNED_KERNELS = ()
SKIP_SUBSTEPS = 3  # chip_smoke.SKIP_SUBSTEPS
# what every probe has besides its piece: memory, constants, the frame
SKIP = re.compile(r"^(LDG|STG|LD|ST|LDS|STS|LDC|ULDC|S2R|S2UR|CS2R|MOV|UMOV|IMAD\.MOV|EXIT|BRA|"
                  r"NOP|BAR|BSSY|BSYNC|WARPSYNC)\b")


def sass_functions(text):
    """``{function name: [instruction mnemonics]}`` of a ``cuobjdump -sass``
    listing."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def _kernel_text(text, kernel):
    """The listing of the one function whose name holds ``kernel``."""
    parts = re.split(r"(?m)^\s*Function : ", text)
    names = [p for p in parts[1:] if kernel in p.split("\n", 1)[0]]
    if len(names) != 1:
        raise RuntimeError(f"{kernel}: {len(names)} SASS functions")
    return names[0]


def _kernel(funcs, kernel):
    names = [n for n in funcs if kernel in n]
    if len(names) != 1:
        raise RuntimeError(f"{kernel}: SASS functions {names}")
    return funcs[names[0]]


def _cuobjdump(nvcc):
    return os.path.join(os.path.dirname(nvcc), "cuobjdump")


def _library_sass(nvcc, build, source):
    lib = os.path.join(build.library_dir(), f"lib{os.path.splitext(source)[0]}.so")
    return subprocess.run([_cuobjdump(nvcc), "-sass", lib], check=True, capture_output=True,
                          text=True, timeout=120).stdout


def function_bodies(text):
    """``{function name: its SASS}`` of a ``cuobjdump -sass`` listing: the
    instruction and encoding lines, the name aside, each line's runs of
    blanks as one (cuobjdump pads its columns to the widest line of the
    whole listing, so a new function elsewhere in a library moves them)."""
    out = {}
    for part in re.split(r"(?m)^\s*Function : ", text)[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = "\n".join(" ".join(line.split()) for line in body.splitlines()
                                       if line.strip().startswith("/*"))
    return out


def short_name(mangled):
    """``frame_skip_kernel<1, 4>`` of a kernel's mangled name (its template
    arguments as numbers)."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(m.start(), m.end()):  # a length follows any digits before it
            word = mangled[m.end():m.end() + int(mangled[k:m.end()])]
            if word.endswith("kernel") and re.fullmatch(r"\w+", word):
                args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[m.end() + len(word):])
                if not args:
                    return word
                return f"{word}<{', '.join(re.findall(r'L[a-z](\d+)E', args.group(1)))}>"
    return mangled


def redesigned_report(nvcc, build, tag, out_dir):
    """Instructions, registers and loads by kind of every skip instance and
    beam kernel of ``build``."""
    import chip_smoke

    for source, kernel in REDESIGNED:
        text = _library_sass(nvcc, build, source)
        with open(os.path.join(out_dir, f"{tag}_lib{os.path.splitext(source)[0]}.sass"), "w") as f:
            f.write(text)
        log = build.build_log(source)
        for name, ops in sorted(sass_functions(text).items(), key=lambda f: short_name(f[0])):
            if kernel not in name:
                continue
            regs = chip_smoke.ptxas_usage(log, name)[0]
            loads = {kind: sum(1 for op in ops if op.split(".")[0] == kind)
                     for kind in ("LDS", "LDG", "LD")}
            print(f"  {tag} {source} {short_name(name)}: {len(ops)} instructions, {regs} "
                  f"registers; loads {loads}")


def sass_kept(nvcc, build, parent_build):
    """Which of the parent's functions in each library this tree has byte
    for byte; the number changed outside REDESIGNED_KERNELS, and their
    names."""
    changed = []
    for source in parent_build.SOURCES:
        change = set(function_bodies(_library_sass(nvcc, build, source)).values())
        for name, body in sorted(function_bodies(_library_sass(nvcc, parent_build,
                                                               source)).items()):
            kept = body in change
            if not kept and not any(k in name for k in REDESIGNED_KERNELS):
                changed.append(f"{source} {short_name(name)}")
            print(f"  {source} {short_name(name)} ({len(body.splitlines()) // 2} instructions): "
                  f"{'kept byte for byte' if kept else 'changed'}")
    outside = f" outside {', '.join(REDESIGNED_KERNELS)}" if REDESIGNED_KERNELS else ""
    print(f"  the parent's functions changed{outside}: "
          f"{len(changed)}{': ' if changed else ''}{', '.join(changed)}")


def sass_report(build, parent_build, out_dir):
    import chip_smoke

    os.makedirs(out_dir, exist_ok=True)
    nvcc = build._nvcc()
    cubin = os.path.join(out_dir, "automaton_probes.cubin")
    flags = [f for f in build.FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin,
                    os.path.join(ROOT, "tools", "automaton_probes.cu")], check=True, timeout=600)
    text = subprocess.run([_cuobjdump(nvcc), "-sass", cubin], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    with open(os.path.join(out_dir, "automaton_probes.sass"), "w") as f:
        f.write(text)
    print("instructions of each piece of the loop (SASS of tools/automaton_probes.cu, "
          "loads, stores, constants and the frame left out):")
    pieces = {}
    for name, ops in sorted(sass_functions(text).items()):
        counted = [op for op in ops if not SKIP.match(op)]
        pieces[name[len("probe_"):]] = len(counted)
        print(f"  {name}: {len(counted)} ({len(ops)} in all)")
    for tag, b in (("change", build), ("parent", parent_build)):
        if b is None:
            continue
        b.library()
        for source, kernel in AUTOMATON:
            text = _library_sass(nvcc, b, source)
            with open(os.path.join(out_dir, f"{tag}_{kernel}.sass"), "w") as f:
                f.write(text)
            ops = _kernel(sass_functions(text), kernel)
            n_big = len(BIG.findall(_kernel_text(text, kernel)))
            regs, stack, st_spill, ld_spill = chip_smoke.ptxas_usage(b.build_log(source), kernel)
            print(f"  {tag} {kernel}: {len(ops)} instructions, {n_big} selects of BIG = "
                  f"{n_big / 3:g} DDA steps inlined; {regs} registers, {stack} B stack, "
                  f"{st_spill} B spill stores, {ld_spill} B spill loads")
    print("the skip tracer's instances and the start prepasses' kernels:")
    for tag, b in (("change", build), ("parent", parent_build)):
        if b is not None:
            redesigned_report(nvcc, b, tag, out_dir)
    if parent_build is not None:
        print("the parent's functions in every library, in this tree:")
        sass_kept(nvcc, build, parent_build)
    return pieces


# what the probes do not hold, estimated from the source: a turn's loop
# test, step count and branches; a hit's policy call
LOOP_COST = 8
HIT_COST = 5


def instruction_model(mc, pieces):
    """The loop's warp-instructions a frame at the bench pose under each
    shape of the loop (``chip_smoke.LOOPS``): the turns in which each
    branch runs (``chip_smoke.move_counts``) times the branch's
    instructions (the probes).  The work outside the loop (ray generation,
    entry, shading) is the same in all and left out."""
    import chip_smoke

    tails = {"reach_mask": pieces["reach_mask"], "hit": HIT_COST,
             "descend": pieces["descend"], "restart": pieces["restart"],
             "start": pieces["choose_move"] - pieces["reach_mask"],
             "fetch": pieces["fetch"] + 2}  # the fetch's two loads
    own_dda = {"ascend": pieces["dda_before"] + pieces["ascend_tail"],
               "lateral": pieces["dda_before"] + pieces["lateral_tail"],
               "advance": pieces["dda_before"] + pieces["advance_tail"]}
    shared_dda = {"ascend": pieces["ascend_tail"], "lateral": pieces["lateral_tail"],
                  "advance": pieces["advance_tail"], "dda": pieces["move_dda"]}
    total = {}
    for loop, what in chip_smoke.LOOPS.items():
        cost = {"turns": LOOP_COST, **tails, **(own_dda if loop == "branches" else shared_dda)}
        counts = {b: mc[f"turns_{loop}" if b == "turns" else
                        f"dda_{loop}" if b == "dda" else f"runs_{loop}_{b}"] for b in cost}
        total[loop] = sum(counts[b] * cost[b] for b in cost)
        print(f"  loop warp-instructions, {what}: {total[loop]} "
              f"({total[loop] / mc['warps']:.1f} a warp) = "
              + ", ".join(f"{b} {counts[b]} x {cost[b]}" for b in cost))
    for loop in ("step_turns", "free_turns"):
        print(f"  {loop} / branches: {total[loop] / total['branches']:.4f}")


def load_build(pkg_root, name):
    """The ``_build`` module of the package copy under ``pkg_root``."""
    path = os.path.join(pkg_root, "voxelhex_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _struct_pointer(t):
    target = getattr(t, "_type_", None)
    return isinstance(target, type) and issubclass(target, ctypes.Structure)


def entries(build):
    """The entry points that ``ab`` times of a build, taking their params struct as an
    address (the two builds' ctypes structs are distinct classes of one
    layout)."""
    lib = build.library()
    out = {}
    for name in ("vhx_traverse", "vhx_render_frame", "vhx_render_frames", "vhx_multihit",
                 "vhx_render_frame_skip", "vhx_render_frames_skip", "vhx_multihit_skip",
                 "vhx_beam", "vhx_splat", "vhx_splat_block_words", "vhx_splat_scratch_words",
                 "vhx_prepass", "vhx_prepass_sync_words", "vhx_prepass_level",
                 "vhx_prepass_level_skip", "vhx_depth_start", "vhx_composite_backward",
                 "vhx_render_frame_lod", "vhx_render_frame_lod_stopless", "vhx_flat_vmap",
                 "vhx_flat_wavefront", "vhx_flat_fast", "vhx_flat_fast_depth"):
        fn = getattr(lib, name, None)
        if fn is None:  # an entry of one tree only
            continue
        fn.argtypes = [ctypes.c_void_p if _struct_pointer(t) else t for t in fn.argtypes]

        def call(*args, _fn=fn):
            return _fn(*[ctypes.addressof(a) if isinstance(a, ctypes.Structure) else a
                         for a in args])
        call.n_args = len(fn.argtypes)
        out[name] = call
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another tree's copy")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--moves", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sass"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--name", default="parent", help="what to call the other tree")
    ap.add_argument("--only", help="time only the kernels whose names hold one of these "
                                   "comma-separated words")
    ap.add_argument("--profile", action="store_true",
                    help="print each tree's device time of each launch of a call")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR[:FLAG,FLAG...]: another tree copy timed in the turns")
    ap.add_argument("--flat-moves", action="store_true",
                    help="print the flat marches' move record and stop")
    ap.add_argument("--cpu", action="store_true", help="with --flat-moves: on the CPU")
    ap.add_argument("--windows", default="8x6",
                    help="with --flat-moves --cpu: NXxNY windows of 64 x 32 pixels")
    args = ap.parse_args()

    import torch

    if args.flat_moves and args.cpu:
        nx, ny = (int(v) for v in args.windows.split("x"))
        flat_move_report(torch.device("cpu"), (nx, ny))
        return 0

    if not torch.cuda.is_available():
        print("automaton_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke

    chip_smoke.faulthandler.cancel_dump_traceback_later()
    from voxelhex_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    if args.flat_moves:
        flat_move_report(torch.device("cuda", 0), None, f" [{card}]")
        return 0
    parent = None if args.parent is None else load_build(os.path.abspath(args.parent),
                                                         "parent_build")
    t0 = time.time()
    variants = {}
    for spec in args.variant:
        name, _, rest = spec.partition("=")
        root, _, flags = rest.partition(":")
        variants[name] = load_build(os.path.abspath(root), f"{name}_build")
        variants[name].FLAGS = (*variants[name].FLAGS, *(f for f in flags.split(",") if f))
    builds = [_build] + ([] if parent is None else [parent]) + list(variants.values())
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:  # both trees at once
        for _lib in pool.map(lambda b: b.library(), builds):
            pass
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    if args.sass:
        pieces = sass_report(_build, parent, args.out)
        if args.moves:
            from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
            from voxelhex_tpu_torch.scene import build_scene

            dev = torch.device("cuda", 0)
            mc = chip_smoke.automaton_report(dev, device_bitgrid(build_scene(), dev),
                                             f"[{card}]")
            instruction_model(mc, pieces)
        return 0
    if parent is None:
        ap.error("--parent is needed to time")
    return ab(_build, parent, card, args.rounds, args.name,
              None if args.only is None else args.only.split(","), variants, args.profile)


def terrain_grid(dev):
    """The 1024 terrain of ``chip_smoke.py`` phase 10: its tree, and its grid
    on ``dev`` with its skip rows (5 levels)."""
    import chip_smoke
    from voxelhex_tpu_torch.render.bitgrid import build_bitgrid, device_bitgrid
    from voxelhex_tpu_torch.scene import terrain_points
    from voxelhex_tpu_torch.tree.build import from_voxels

    pts, cols = terrain_points(chip_smoke.TERRAIN_WORLD)
    tree = from_voxels(pts, cols, size=chip_smoke.TERRAIN_WORLD, brick_dim=4)
    return tree, device_bitgrid(build_bitgrid(tree), dev, skip_rows=True)


def lod_struct(build, tree, scale):
    """``render_lod``'s ``LodParams`` of ``tree`` at ``scale`` in the layout
    of ``build``'s mirror: this tree's, or an older tree's of the stop
    levels' threshold table and the scale."""
    import numpy as np

    from voxelhex_tpu_torch.ops.frame import lod_params
    from voxelhex_tpu_torch.render.bitgrid import LOD_THRESHOLDS

    if hasattr(build.LodParams, "stop_sq"):
        return build.LodParams.from_buffer_copy(bytes(lod_params(tree, scale)))
    p = build.LodParams()
    p.n_mip = 0
    while f"mip_rgb_{p.n_mip}" in tree:
        grid = tree[f"mip_rgb_{p.n_mip}"]
        p.mip[p.n_mip], p.mip_cells[p.n_mip] = grid.data_ptr(), grid.shape[0]
        p.n_mip += 1
    p.thresholds[:len(LOD_THRESHOLDS)] = LOD_THRESHOLDS
    p.scale = float(np.float32(scale))
    return p


def lod_turns(kernels, builds, libs, dev, cam, stream):
    """Add the LOD frame (``frame_lod_kernel``, f32) to ``kernels``: the bench
    pose at ``lod_scale`` 0, 0.05 and 0.3 and phase 10's 512 world at 0.3
    (``chip_smoke.py`` phase 16 (c)); first print each case's steps a ray
    and the steps on which the stop rule decides (an occupied cell above
    level 0: a descend, or a hit above level 0) from the plain march, and
    the frame kernel's steps a ray at the bench pose."""
    import torch

    import chip_smoke
    from voxelhex_tpu_torch.ops.frame import frame_params, lod_params, lod_stopless, lod_tracer
    from voxelhex_tpu_torch.ops.skip import plain_tracer
    from voxelhex_tpu_torch.ops.traverse import MAX_ITERS
    from voxelhex_tpu_torch.render.bitgrid import (MOVE_DESCEND, MOVE_HIT, build_bitgrid,
                                                   build_mip_colors, device_bitgrid)
    from voxelhex_tpu_torch.render.camera import device_rays
    from voxelhex_tpu_torch.scene import build_scene, build_scene_tree
    from voxelhex_tpu_torch.tree.flat import flatten

    worlds = {}
    for name, grid in (("bench", build_scene()),
                       ("512 world", build_bitgrid(flatten(build_scene_tree(32))))):
        worlds[name] = device_bitgrid(build_mip_colors(grid), dev)  # the MIP grids too
    o, d = device_rays(cam, dev)
    R = o.shape[0]
    t = worlds["bench"]
    trace = plain_tracer(t, MAX_ITERS)
    st = trace.run(t, trace.init(t, o, d), MAX_ITERS)
    print(f"  frame kernel's march (4 substeps), bench: {int(st['iters'].sum()) / R:.4f} "
          f"steps a ray", flush=True)
    w, h = cam.resolution
    cases = [("bench", 0.0), ("bench", 0.05), ("bench", 0.3), ("512 world", 0.3)]
    for where, scale in cases:
        t = worlds[where]
        trace = lod_tracer(t, scale)
        moves = []
        st = trace.run(t, trace.init(t, o, d), MAX_ITERS, moves=moves)
        mv = torch.stack(moves) if moves else torch.zeros((0, R), dtype=torch.int8, device=dev)
        hit = st["hit"]
        above = hit & (st.get("hlev", torch.zeros_like(st["iters"])) > 0)
        decides = int((mv == MOVE_DESCEND).sum()) + int(above.sum())
        steps = int(st["iters"].sum())
        print(f"  LOD march (2 substeps), {where}, lod_scale {scale}: {steps / R:.4f} steps a "
              f"ray, {decides / R:.4f} a ray on an occupied cell above level 0 "
              f"({decides / max(steps, 1):.4f} of steps: {int((mv == MOVE_DESCEND).sum())} "
              f"descends, {int(above.sum())} hits above level 0 of {int(hit.sum())} hits; "
              f"{int((mv == MOVE_HIT).sum())} hit moves)", flush=True)

    def lod(lib, build, where, scale):
        t = worlds[where]
        out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
        params = frame_params(t, cam)
        entry = lib["vhx_render_frame_lod"]  # render_lod's choice where the tree has two
        if "vhx_render_frame_lod_stopless" in lib and lod_stopless(params, lod_params(t, scale)):
            entry = lib["vhx_render_frame_lod_stopless"]
        err = entry(t["occ_pairs"].data_ptr(), t["colors"].data_ptr(), t["palette"].data_ptr(),
                    t["palette"].shape[0], params, lod_struct(build, t, scale), out.data_ptr(),
                    0, stream)
        build.check(err, "LOD frame")
        return (out,)

    tag_of = {id(lib): tag for tag, lib in libs.items()}  # the build of each library
    for where, scale in cases:
        kernels[f"lod frame.cu, {where} (lod_scale {scale})"] = (
            lambda lib, where=where, scale=scale: lod(lib, builds[tag_of[id(lib)]], where, scale),
            16, 1)


def flat_trees(dev):
    """The bench FlatTree's tensors on ``dev`` (``device_tree`` and packed)
    and the 512 world's packed tree (``chip_smoke.py`` phase 18)."""
    from voxelhex_tpu_torch.render.fast import pack_device_tree
    from voxelhex_tpu_torch.render.jax_renderer import device_tree
    from voxelhex_tpu_torch.scene import build_scene_tree
    from voxelhex_tpu_torch.tree.flat import flatten

    flat, flat512 = flatten(build_scene_tree(4)), flatten(build_scene_tree(32))
    return device_tree(flat, dev), pack_device_tree(flat, dev), pack_device_tree(flat512, dev)


def flat_move_report(dev, windows=None, tag=""):
    """The move record of the plain wavefront and fast marches at the 1080p
    bench pose (``lockstep_run``'s ``moves``), seen by warps of 32 rays of
    a row, of 4 x 8 tiles (the kernels') and of 8 x 4 (``warp_moves``):
    turns a warp, working lane-turns, DDA steps a warp under one shared DDA
    loop and under a branch a move.  With ``windows = (nx, ny)`` only nx x
    ny windows of 64 x 32 pixels spread evenly over the frame, each its own
    small frame."""
    import numpy as np
    import torch

    import chip_smoke
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.render.fast import make_fast_tracer
    from voxelhex_tpu_torch.render.jax_renderer import rays_on
    from voxelhex_tpu_torch.render.wavefront import make_wavefront_tracer, warp_moves

    w, h = chip_smoke.RES
    ho, hd = orbit_camera(128.0, resolution=chip_smoke.RES).rays()
    if windows is None:
        frames = [(0, 0, w, h)]
    else:
        nx, ny = windows
        frames = [(int(x), int(y), 64, 32) for y in np.linspace(0, h - 32, ny).round()
                  for x in np.linspace(0, w - 64, nx).round()]
    o = np.concatenate([ho[y:y + fh, x:x + fw].reshape(-1, 3) for x, y, fw, fh in frames])
    d = np.concatenate([hd[y:y + fh, x:x + fw].reshape(-1, 3) for x, y, fw, fh in frames])
    o, d = rays_on(o, d, dev)
    wf, fast, _f512 = flat_trees(dev)
    where = "the whole frame" if windows is None else (
        f"{len(frames)} windows of 64 x 32 ({o.shape[0]} rays)")
    for name, trace, tree in (("wavefront", make_wavefront_tracer(4, 4096), wf),
                              ("fast", make_fast_tracer(4, 4096), fast)):
        t0 = time.time()
        rec = {"moves": []}
        trace(tree, o, d, record=rec)
        steps = rec["steps"].double()
        print(f"flat moves, {name}, {where}: {float(steps.mean()):.4f} bodies a ray (max "
              f"{int(steps.max())}), {len(rec['moves'])} turns, plain march {time.time() - t0:.1f} "
              f"s{tag}", flush=True)
        for shape in (None, (4, 8), (8, 4)):
            total, off = {}, 0
            for _x, _y, fw, fh in frames:
                part = warp_moves([m[off:off + fw * fh] for m in rec["moves"]], fw, fh, shape)
                off += fw * fh
                for k, v in part.items():
                    if k != "working":
                        total[k] = total.get(k, 0) + v
            warps = total["warps"]
            label = "rows of 32" if shape is None else f"{shape[0]} x {shape[1]} tiles"
            print(f"  {label}: {total['turns'] / warps:.4f} turns a warp, working lane-turns "
                  f"{total['lane_turns'] / (32 * total['turns']):.4f}, DDA steps a warp "
                  f"{total['dda_shared'] / warps:.4f} shared, {total['dda_branches'] / warps:.4f} "
                  f"a branch a move ({warps} warps){tag}", flush=True)


# the launch settings of this tree's flat kernels that the turns time: warps
# on the frame's 4 x 8 tiles or on rows, products by inverses or divisions
FLAT_SETTINGS = (("tiles, pow2", True, True), ("rows, pow2", False, True),
                 ("tiles, div", True, False), ("rows, div", False, False))


def flat_struct(build, p, tiles, pow2):
    """``p`` (this tree's ``FlatParams``) in the layout of ``build``'s mirror,
    on rows without ``tiles``, by divisions without ``pow2``; a mirror of
    one flat struct (an older tree's) takes the tree's fields alone."""
    q = build.FlatParams()
    names = [n for n, _t in build.FlatParams._fields_]
    if "tree" not in names:
        for n, _t in q._fields_:
            setattr(q, n, getattr(p.tree, n))
        return q
    ctypes.memmove(ctypes.addressof(q), ctypes.addressof(p), ctypes.sizeof(q))
    q.pow2 = int(pow2 and p.pow2)
    if not tiles:
        q.tile_w = q.tile_h = 0
    return q


def flat_turns(kernels, builds, libs, dev, stream, card):
    """Add the flat-tree kernels to ``kernels`` (the module's note on
    ``--only flat``); first print the kernels' registers and the move
    record."""
    import torch

    import chip_smoke
    from voxelhex_tpu_torch.ops import flat as ops
    from voxelhex_tpu_torch.render.camera import Camera, orbit_camera
    from voxelhex_tpu_torch.render.jax_renderer import rays_on

    for tag, b in builds.items():
        log = b.build_log("flat.cu")
        for kname in chip_smoke.kernel_names(log, "flat_"):
            regs, stack, st_spill, ld_spill = chip_smoke.ptxas_usage(log, kname)
            print(f"  ptxas {tag} {short_name(kname)}: {regs} registers, {stack} B stack frame, "
                  f"{st_spill} B spill stores, {ld_spill} B spill loads", flush=True)
    flat_move_report(dev, None, f" [{card}]")
    wf, fast, f512 = flat_trees(dev)
    cam = orbit_camera(128.0, resolution=chip_smoke.RES)
    w, h = chip_smoke.RES
    half = Camera(origin=cam.origin, target=cam.target, up=cam.up, fov_y_deg=cam.fov_y_deg,
                  resolution=(w // 2, h // 2))
    o, d = rays_on(*cam.rays(), dev)
    po, pd = rays_on(*half.rays(), dev)
    dmap = ops.trace_fast(fast, 4, po, pd, 4096, depth=True, _width=w // 2)
    tag_of = {id(lib): tag for tag, lib in libs.items()}

    def run(lib, entry, tree, D, limit, ro, rd, frame, setting, start=None, half=(0, 0)):
        build = builds[tag_of[id(lib)]]
        p = ops.flat_params(tree, D, limit, start, 2 * half[1], half, frame)
        q = flat_struct(build, p, *setting)
        R = ro.shape[0]
        if entry == "vhx_flat_fast_depth":
            outs = (torch.empty(R, dtype=torch.float32, device=dev),)
        else:
            outs = ops._outputs(R, dev)
        err = lib[entry](q, ro.data_ptr(), rd.data_ptr(), R, *(t.data_ptr() for t in outs), 0,
                         stream)
        build.check(err, entry)
        return outs

    forms = {
        "wavefront": lambda lib, s: run(lib, "vhx_flat_wavefront", wf, 4, 4096, o, d, (w, h), s),
        "fast bitmap": lambda lib, s: run(lib, "vhx_flat_fast", fast, 4, 4096, o, d, (w, h), s),
        "fast voxel-read, 512 world": lambda lib, s: run(lib, "vhx_flat_fast", f512, 32, 4096, o,
                                                         d, (w, h), s),
        "fast depth, 960x540": lambda lib, s: run(lib, "vhx_flat_fast_depth", fast, 4, 4096, po,
                                                  pd, (w // 2, h // 2), s),
        "fast from the pooled starts": lambda lib, s: run(lib, "vhx_flat_fast", fast, 4, 4096, o,
                                                          d, (w, h), s, dmap, (h // 2, w // 2)),
    }
    for form, fn in forms.items():
        for name, tiles, pow2 in FLAT_SETTINGS:
            kernels[f"flat {form}, change {name}"] = (
                lambda lib, fn=fn, s=(tiles, pow2): fn(lib, s), 20, 1)
    kernels["flat vmap (unchanged control)"] = (
        lambda lib: run(lib, "vhx_flat_vmap", wf, 4, 2048, o, d, (0, 0), (False, False)), 20, 1)


# render() of each flat renderer at the 1080p bench pose by host clock, in
# the package under sys.argv[1], with its host pieces; a process a tree
RENDER_CLOCK = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
from voxelhex_tpu_torch.render.camera import orbit_camera
from voxelhex_tpu_torch.render.fast import FastRenderer
from voxelhex_tpu_torch.render.jax_renderer import JaxRenderer, rays_on
from voxelhex_tpu_torch.render.wavefront import WavefrontRenderer
from voxelhex_tpu_torch.scene import build_scene_tree
from voxelhex_tpu_torch.tree.flat import flatten

reps, res, tag = int(sys.argv[2]), (1920, 1080), sys.argv[3]
flat, cam, dev = flatten(build_scene_tree(4)), orbit_camera(128.0, resolution=(1920, 1080)), "cuda"


def clock(fn):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


ho, hd = cam.rays()
frame = torch.zeros((1080, 1920, 3), dtype=torch.float32, device=dev)
parts = {"Camera.rays()": clock(cam.rays),
         "the rays' two copies to the card": clock(lambda: rays_on(ho, hd, dev)),
         "a frame's copy back": clock(lambda: frame.cpu().numpy())}
renderers = {"vmap": JaxRenderer(flat, max_inner=2048, device=dev),
             "wavefront": WavefrontRenderer(flat, max_iters=4096, device=dev),
             "fast": FastRenderer(flat, max_iters=4096, device=dev),
             "fast_prepass": FastRenderer(flat, max_iters=4096, prepass=True, device=dev)}
times = {name: clock(lambda r=r: r.render(cam)) for name, r in renderers.items()}
print(f"render() host ms at 1080p, {tag}: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
      + "; " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
"""


def render_clock(roots, card, reps=10):
    """Run RENDER_CLOCK in each tree of ``roots`` ({tag: root}) in turns,
    first to last and back."""
    order = list(roots) + list(roots)[::-1]
    for tag in order:
        out = subprocess.run([sys.executable, "-c", RENDER_CLOCK, roots[tag], str(reps), tag],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            raise RuntimeError(f"render clock of {tag} failed:\n{out.stderr[-4000:]}")
        print(out.stdout.strip() + f" [{card}]", flush=True)


def ab(build, parent, card, rounds, other="parent", only=None, variants=None, profile=False):
    import numpy as np
    import torch

    import chip_smoke
    from voxelhex_tpu_torch.ops.beam import beam_params
    from voxelhex_tpu_torch.ops.frame import frame_params
    from voxelhex_tpu_torch.ops.frames import launch_frames
    from voxelhex_tpu_torch.ops.prepass import level_camera, prepass_params
    from voxelhex_tpu_torch.ops.splat import splat_params
    from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, trace_params
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.render.streaming import StreamingView
    from voxelhex_tpu_torch.scene import build_scene

    dev = torch.device("cuda", 0)
    scene = build_scene()
    tree = device_bitgrid(scene, dev, skip_rows=True)
    cam = orbit_camera(128.0, resolution=chip_smoke.RES)
    w, h = chip_smoke.RES
    K = chip_smoke.MAX_HITS
    S3 = SKIP_SUBSTEPS
    stream = torch.cuda.current_stream(dev).cuda_stream
    bench = [cam] * chip_smoke.BATCH
    prev = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
    scenes = {"bench": (tree, cam)}
    rays = {"bench": device_rays(cam, dev)}
    beams = {}
    kept = (lambda name: True) if only is None else (
        lambda name: any(word in name for word in only))

    def terrain_setup():
        """The terrain and the fly-over window: skip, beam and prepass
        turns."""
        terrain, tgrid = terrain_grid(dev)
        tcam = orbit_camera(float(chip_smoke.TERRAIN_WORLD), resolution=chip_smoke.RES)
        scenes["terrain"] = (tgrid, tcam)
        rays["terrain"] = device_rays(tcam, dev)
        # the beam's (grid, cell, camera) at the bench and terrain poses and
        # in the window of fly-over frame 0 (phase 14's poses)
        view = StreamingView(terrain, view_size=chip_smoke.FLY_VIEW, regions_per_update=8192,
                             beam_prepass=True, device=dev)
        fcam = chip_smoke.flight_cam(0)
        view.render(fcam, out_u8=True, out_device=True)
        wcam = view.layers(fcam)[0][1]
        beams.update({
            "bench": (*fastest_renderer(scene, device=dev)._beam_spec(cam), cam),
            "terrain": (*fastest_renderer(terrain, device=dev)._beam_spec(tcam), tcam),
            "fly-over window": (*view.renderer._beam_spec(wcam), wcam)})

    if only is None or not all("lod" in word or "flat" in word for word in only):
        terrain_setup()
    # after the view's frame, which launches through the package's own
    # bindings: entries() retypes the library's functions
    builds = {other: parent, "change": build, **(variants or {})}
    libs = {tag: entries(b) for tag, b in builds.items()}

    def frames(lib, where="bench", skip=False):
        t, c = scenes[where]

        # the entries without start maps, which every tree has, called with
        # the arguments of vhx_render_frames_start less the start map's three
        def entry(*args):
            if skip:
                return lib["vhx_render_frames_skip"](*args[:5], S3, *args[5:])
            return lib["vhx_render_frames"](*args[:5], *args[8:])

        return launch_frames(entry, t, [c] * chip_smoke.BATCH, (0.0, 0.0, 0.0), True, MAX_ITERS,
                             prev, stream=stream,
                             words=t["skip_rows"] if skip else None)[:2]

    def frame(lib, where="bench", skip=False):
        t, c = scenes[where]
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
        args = (t["colors"].data_ptr(), t["palette"].data_ptr(), t["palette"].shape[0],
                frame_params(t, c))
        if skip:
            err = lib["vhx_render_frame_skip"](t["skip_rows"].data_ptr(), *args, S3, None, 1,
                                               None, out.data_ptr(), 0, stream)
        else:
            err = lib["vhx_render_frame"](t["occ_pairs"].data_ptr(), *args, None, out.data_ptr(),
                                          0, stream)
        build.check(err, "frame")
        return (out,)

    def traverse(lib):
        o, d = rays["bench"]
        R = o.shape[0]
        outs = [torch.empty(R, dtype=torch.bool, device=dev),
                torch.empty(R, dtype=torch.int32, device=dev)] + [
            torch.empty((R, 3), dtype=t, device=dev)
            for t in (torch.int32, torch.float32, torch.float32)]
        build.check(lib["vhx_traverse"](o.data_ptr(), d.data_ptr(), tree["occ_pairs"].data_ptr(),
                                        tree["colors"].data_ptr(), trace_params(tree), R,
                                        *[t.data_ptr() for t in outs], 0, stream), "traverse")
        return outs

    def multihit(lib, where="bench", skip=False):
        t, _c = scenes[where]
        o, d = rays[where]
        R = o.shape[0]
        outs = [torch.empty(R, dtype=torch.int32, device=dev),
                torch.empty((R, K, 3), dtype=torch.int32, device=dev),
                torch.empty((R, K), dtype=torch.float32, device=dev)]
        ptrs = [x.data_ptr() for x in outs]
        if skip:
            err = lib["vhx_multihit_skip"](o.data_ptr(), d.data_ptr(), t["skip_rows"].data_ptr(),
                                           trace_params(t), R, K, S3, None, 1, 1, *ptrs, 0,
                                           stream)
        else:
            err = lib["vhx_multihit"](o.data_ptr(), d.data_ptr(), t["occ_pairs"].data_ptr(),
                                      trace_params(t), R, K, *ptrs, 0, stream)
        build.check(err, "multihit")
        return outs

    def beam(lib, pose="bench", n_frames=1, empty_grid=False):
        grid, cell, c = beams[pose]
        if empty_grid:
            empty = device_bitgrid(bitgrid_from_occupancy(np.zeros((grid["size"],) * 3,
                                                                   dtype=bool)), dev)
        p = beam_params([(empty if empty_grid else grid, cell, c)] * n_frames, 8)
        out = torch.empty((n_frames, h // 8, w // 8), dtype=torch.float32, device=dev)
        build.check(lib["vhx_beam"](p, out.data_ptr(), 0, stream), "beam")
        return (out,)

    levels = chip_smoke.PREPASS_LEVELS
    sync = build.StreamScratch()

    def prepass(lib, where="bench", skip=False):
        """Each level's depths, the coarsest first, and the start map: one
        launch of vhx_prepass where the tree has it, else a launch a level
        and one of the start map."""
        t, c = scenes[where]
        words = t["skip_rows"] if skip else t["occ_pairs"]
        cams = [level_camera(c, i) for i in range(1, levels + 1)]  # level 1 first
        outs = [torch.empty((ci.resolution[1], ci.resolution[0]), dtype=torch.float32,
                            device=dev) for ci in cams]
        start = torch.empty_like(outs[0])
        params = [prepass_params(t, ci) for ci in cams]
        if "vhx_prepass" in lib:
            arr = (type(params[0]) * levels)(*params)
            ptrs = (ctypes.c_void_p * levels)(*(x.data_ptr() for x in outs))
            w1, h1 = cams[0].resolution
            with sync.take(dev, lib["vhx_prepass_sync_words"](w1, h1, levels)) as (s, epoch):
                err = lib["vhx_prepass"](words.data_ptr(), ctypes.addressof(arr), levels,
                                         S3 if skip else 0, ptrs, start.data_ptr(), s.data_ptr(),
                                         epoch, 0, stream)
            build.check(err, "prepass")
        else:
            coarser = None
            for p, x in zip(params[::-1], outs[::-1]):
                cp = None if coarser is None else coarser.data_ptr()
                if skip:
                    err = lib["vhx_prepass_level_skip"](words.data_ptr(), p, S3, cp, x.data_ptr(),
                                                        0, stream)
                else:
                    err = lib["vhx_prepass_level"](words.data_ptr(), p, cp, x.data_ptr(), 0,
                                                   stream)
                build.check(err, "prepass level")
                coarser = x
            w1, h1 = cams[0].resolution
            build.check(lib["vhx_depth_start"](outs[0].data_ptr(), w1, h1, start.data_ptr(), 0,
                                               stream), "depth start")
        return (*outs[::-1], start)

    pts = fastest_renderer(scene, device=dev)._splat_points()
    scratch = build.StreamScratch()
    w2, h2 = w // 2, h // 2

    def splat(lib):
        """The splat map as each tree's wrapper makes it: this tree's two
        launches over scratch kept between calls, the parent's two fills
        and two launches."""
        p = splat_params(cam, pts.shape[0])
        out = torch.empty((h2, w2), dtype=torch.float32, device=dev)
        if "vhx_splat_scratch_words" in lib:
            with scratch.take(dev, lib["vhx_splat_scratch_words"](w2, h2)) as (s, epoch):
                err = lib["vhx_splat"](pts.data_ptr(), p, s.data_ptr(), epoch, out.data_ptr(), 0,
                                       stream)
        else:
            depth = torch.empty(h2 * w2, dtype=torch.int32, device=dev)
            flags = torch.empty(lib["vhx_splat_block_words"](w2, h2), dtype=torch.int32,
                                device=dev)
            err = lib["vhx_splat"](pts.data_ptr(), p, depth.data_ptr(), flags.data_ptr(),
                                   out.data_ptr(), 0, stream)
        build.check(err, "splat")
        return (out,)

    # the composite backward at phase 9's shapes: the bench pose's march at
    # K = 2 over SoftRenderer's initial params, dL/drgb of the constant
    # target, the two gradients zeroed before each launch, as the step
    # calls it (this tree's kernel with the march's count, or without it)
    soft_state = {}

    def soft_setup():
        from voxelhex_tpu_torch.diff.soft import SoftRenderer
        from voxelhex_tpu_torch.ops.composite import composite_forward

        soft = SoftRenderer(scene, max_hits=K, max_iters=MAX_ITERS, device=dev)
        sp = soft.init_params()
        alb, lgt = sp["albedo"].reshape(-1), sp["logits"]
        count, vox, _d = soft.trace_hits(*rays["bench"])
        rgb = composite_forward(alb, lgt, vox, soft.size)
        target = torch.tensor(chip_smoke.CONST_TARGET, dtype=torch.float32, device=dev)
        soft_state.update(size=soft.size, alb=alb, lgt=lgt, count=count, vox=vox,
                          grad=(2.0 * (rgb - target) / rgb.numel()).contiguous())

    def composite_bwd(lib, with_count=True):
        if not soft_state:
            soft_setup()
        st = soft_state
        entry = lib["vhx_composite_backward"]
        ga, gl = torch.zeros_like(st["alb"]), torch.zeros_like(st["lgt"])
        args = (st["grad"].data_ptr(), st["alb"].data_ptr(), st["lgt"].data_ptr(),
                st["vox"].data_ptr())
        rest = (st["vox"].shape[0], K, st["size"], None, ga.data_ptr(), gl.data_ptr(), 0, stream)
        if entry.n_args == 13:  # the march's count
            err = entry(*args, st["count"].data_ptr() if with_count else None, *rest)
        else:
            err = entry(*args, *rest)
        build.check(err, "composite backward")
        return ga, gl

    def grads_close(want, got):
        """Phase 6's tolerance: elementwise relative, a share of the largest
        element, and the same zeros."""
        for a, b in zip(got, want):
            scale = float(b.abs().max())
            if not bool(((a - b).abs() <= chip_smoke.GRAD_RTOL * b.abs()
                         + chip_smoke.GRAD_ATOL_SHARE * scale).all()) or \
                    bool(((a == 0) != (b == 0)).any()):
                return False
        return True

    kernels = {"frames.cu (K=16, a frame)": (frames, 4, chip_smoke.BATCH),
               "frame.cu": (frame, 16, 1), "traverse.cu": (traverse, 10, 1),
               "multihit.cu (K=2)": (multihit, 10, 1)}
    for where, L in (("bench", 4), ("terrain", 5)):
        kernels[f"skip frame.cu, {where} (L={L})"] = (
            lambda lib, where=where: frame(lib, where, True), 16, 1)
        kernels[f"skip frames.cu, {where} (L={L}, K=16, a frame)"] = (
            lambda lib, where=where: frames(lib, where, True), 2, chip_smoke.BATCH)
        kernels[f"skip multihit.cu, {where} (L={L}, K=2)"] = (
            lambda lib, where=where: multihit(lib, where, True), 10, 1)
    for pose in beams:
        kernels[f"beam.cu, {pose} (1 frame)"] = (lambda lib, pose=pose: beam(lib, pose), 20, 1)
        kernels[f"beam.cu, {pose} ({chip_smoke.BATCH} frames)"] = (
            lambda lib, pose=pose: beam(lib, pose, chip_smoke.BATCH), 10, 1)
    kernels["beam.cu over an empty grid (1 frame)"] = (
        lambda lib: beam(lib, empty_grid=True), 20, 1)
    for where in ("bench", "terrain"):
        for skip in (False, True):
            kernels[f"{'skip ' if skip else ''}prepass.cu, {where} ({levels} levels)"] = (
                lambda lib, where=where, skip=skip: prepass(lib, where, skip), 20, 1)
    kernels["splat.cu, bench"] = (splat, 20, 1)
    kernels["composite backward, bench (K=2), as the step calls it"] = (
        composite_bwd, 20, 1, grads_close)
    kernels["composite backward, bench (K=2), without the count"] = (
        lambda lib: composite_bwd(lib, False), 20, 1, grads_close)
    if only is None or any("lod" in word for word in only):
        lod_turns(kernels, builds, libs, dev, cam, stream)
    if only is None or any("flat" in word for word in only):
        flat_turns(kernels, builds, libs, dev, stream, card)
    kernels = {k: v for k, v in kernels.items() if kept(k)}
    tags = [t for t in libs if t != other]  # change, then the variants
    prev.copy_(frame(libs[other])[0])
    for name, (fn, _reps, _per, *close) in kernels.items():
        want = [x.clone() for x in fn(libs[other])]
        for tag in tags:
            got = fn(libs[tag])
            torch.cuda.synchronize()
            if close:  # f32 atomics in no fixed order: within a tolerance
                ok = close[0](want, got)
                print(f"  {name}: {tag} within the tolerance of {other}: {ok}", flush=True)
                if not ok:
                    raise AssertionError(f"{name}: {tag} differs from {other}")
                continue
            bad = [i for i, (x, y) in enumerate(zip(want, got))
                   if not bool(chip_smoke.same(x, y).all())]
            print(f"  {name}: {tag} == {other} on every output: {not bad}", flush=True)
            if bad:
                raise AssertionError(f"{name}: outputs {bad} differ between {other} and {tag}")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiled

        for name, (fn, reps, *_rest) in kernels.items():
            for tag in (other, *tags):
                with profiled(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn(libs[tag])
                    torch.cuda.synchronize()
                rows = [f"{e.key[:48]} {e.device_time_total / 1e3 / reps:.4f}"
                        for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
                        and not e.key.startswith(("aten::", "cuda"))]
                print(f"profile {name} {tag}: {', '.join(rows)} ms a call [{card}]", flush=True)
    order = (other, *tags, *tags[::-1], other)
    for name, (fn, reps, per, *_close) in kernels.items():
        for tag in (other, *tags):
            for _ in range(2):
                fn(libs[tag])
        turns = []
        for _ in range(rounds):
            for tag in order:
                turns.append((tag, chip_smoke.device_ms(lambda: fn(libs[tag]), reps) / per))
        mean = {t: sum(ms for tag, ms in turns if tag == t) / sum(tag == t for tag, _ in turns)
                for t in (other, *tags)}
        print(f"{name}: turns " + ", ".join(f"{tag} {ms:.4f}" for tag, ms in turns)
              + " ms; means " + ", ".join(f"{t} {m:.4f}" for t, m in mean.items())
              + " ms; " + ", ".join(f"{t} / {other} {mean[t] / mean[other]:.4f}" for t in tags)
              + f" [{card}]", flush=True)
    if only is not None and any("flat" in word for word in only):
        roots = {other: os.path.dirname(os.path.dirname(os.path.dirname(parent.__file__))),
                 "change": ROOT}
        render_clock(roots, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
