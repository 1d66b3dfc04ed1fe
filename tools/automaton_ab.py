"""The automaton's kernels against another tree's, and their instructions.

    python3 tools/automaton_ab.py --sass [--moves] [--parent DIR] [--out DIR]
    python3 tools/automaton_ab.py --parent DIR [--rounds N]

``--sass`` builds ``tools/automaton_probes.cu`` (one kernel for each piece
of the loop of ``csrc/traverse.cuh``) with the kernels' nvcc flags and
prints each piece's instruction count from ``cuobjdump -sass``, leaving out
loads, stores, moves of constants and the kernel's frame; then, for the
four kernels that run the automaton (``traverse.cu``, ``frame.cu``,
``frames.cu``, ``multihit.cu``), their instructions and the DDA steps
inlined in each (a DDA step selects the constant BIG = 1e30 once on each
axis, and nothing else in those kernels uses it), for this tree and the one
in ``--parent``.  The SASS goes to ``--out``.  ``--moves`` adds
``chip_smoke.py``'s report of the automaton's moves at the bench pose
(phase 4b (f)): what the warps of the frame kernels run under each shape
of the loop.

``--parent DIR`` with no ``--sass`` times the four kernels of this tree
against those of ``DIR`` (a copy of another commit, e.g. unpacked with
``git archive``) in one process on one card: both are built from their own
sources, their outputs must be equal bit for bit, and then each kernel is
timed in turns, parent, change, change, parent, ``--rounds`` times, by
device time (``chip_smoke.device_ms``) at ``chip_smoke.py``'s shapes: a
batch of 16 bench frames with digests (``frames.cu``), the bench frame
(``frame.cu``), the bench pose's rays (``traverse.cu``) and its multi-hit
march at K = 2 (``multihit.cu``).  Needs one CUDA card.
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
            lib = os.path.join(b.library_dir(), f"lib{os.path.splitext(source)[0]}.so")
            text = subprocess.run([_cuobjdump(nvcc), "-sass", lib], check=True,
                                  capture_output=True, text=True, timeout=120).stdout
            with open(os.path.join(out_dir, f"{tag}_{kernel}.sass"), "w") as f:
                f.write(text)
            ops = _kernel(sass_functions(text), kernel)
            n_big = len(BIG.findall(_kernel_text(text, kernel)))
            regs, stack, st_spill, ld_spill = chip_smoke.ptxas_usage(b.build_log(source), kernel)
            print(f"  {tag} {kernel}: {len(ops)} instructions, {n_big} selects of BIG = "
                  f"{n_big / 3:g} DDA steps inlined; {regs} registers, {stack} B stack, "
                  f"{st_spill} B spill stores, {ld_spill} B spill loads")
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
    """The four entry points of a build, taking their params struct as an
    address (the two builds' ctypes structs are distinct classes of one
    layout)."""
    lib = build.library()
    out = {}
    for name in ("vhx_traverse", "vhx_render_frame", "vhx_render_frames", "vhx_multihit"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p if _struct_pointer(t) else t for t in fn.argtypes]

        def call(*args, _fn=fn):
            return _fn(*[ctypes.addressof(a) if isinstance(a, ctypes.Structure) else a
                         for a in args])
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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("automaton_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke

    chip_smoke.faulthandler.cancel_dump_traceback_later()
    from voxelhex_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    parent = None if args.parent is None else load_build(os.path.abspath(args.parent),
                                                         "parent_build")
    t0 = time.time()
    builds = [_build] + ([] if parent is None else [parent])
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
    return ab(_build, parent, card, args.rounds, args.name)


def ab(build, parent, card, rounds, other="parent"):
    import torch

    import chip_smoke
    from voxelhex_tpu_torch.ops.frame import frame_params
    from voxelhex_tpu_torch.ops.frames import launch_frames
    from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, trace_params
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.scene import build_scene

    dev = torch.device("cuda", 0)
    tree = device_bitgrid(build_scene(), dev)
    cam = orbit_camera(128.0, resolution=chip_smoke.RES)
    w, h = chip_smoke.RES
    o, d = device_rays(cam, dev)
    R = o.shape[0]
    K = chip_smoke.MAX_HITS
    stream = torch.cuda.current_stream(dev).cuda_stream
    occ, colors, pal = tree["occ_pairs"], tree["colors"], tree["palette"]
    n_colors = pal.shape[0]
    bench = [cam] * chip_smoke.BATCH
    fparams = frame_params(tree, cam)
    tparams = trace_params(tree)
    prev = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
    libs = {other: entries(parent), "change": entries(build)}

    def frames(lib):
        return launch_frames(lib["vhx_render_frames"], tree, bench, (0.0, 0.0, 0.0), True,
                             MAX_ITERS, prev, stream=stream)[:2]

    def frame(lib):
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
        build.check(lib["vhx_render_frame"](occ.data_ptr(), colors.data_ptr(), pal.data_ptr(),
                                            n_colors, fparams, None, out.data_ptr(), 0, stream),
                    "frame")
        return (out,)

    def traverse(lib):
        outs = [torch.empty(R, dtype=torch.bool, device=dev),
                torch.empty(R, dtype=torch.int32, device=dev)] + [
            torch.empty((R, 3), dtype=t, device=dev)
            for t in (torch.int32, torch.float32, torch.float32)]
        build.check(lib["vhx_traverse"](o.data_ptr(), d.data_ptr(), occ.data_ptr(),
                                        colors.data_ptr(), tparams, R,
                                        *[t.data_ptr() for t in outs], 0, stream), "traverse")
        return outs

    def multihit(lib):
        outs = [torch.empty(R, dtype=torch.int32, device=dev),
                torch.empty((R, K, 3), dtype=torch.int32, device=dev),
                torch.empty((R, K), dtype=torch.float32, device=dev)]
        build.check(lib["vhx_multihit"](o.data_ptr(), d.data_ptr(), occ.data_ptr(), tparams, R,
                                        K, *[t.data_ptr() for t in outs], 0, stream),
                    "multihit")
        return outs

    kernels = {"frames.cu (K=16, a frame)": (frames, 4, chip_smoke.BATCH),
               "frame.cu": (frame, 16, 1), "traverse.cu": (traverse, 10, 1),
               "multihit.cu (K=2)": (multihit, 10, 1)}
    prev.copy_(frame(libs[other])[0])
    for name, (fn, _reps, _per) in kernels.items():
        a, b = fn(libs[other]), fn(libs["change"])
        torch.cuda.synchronize()
        bad = [i for i, (x, y) in enumerate(zip(a, b)) if not bool(chip_smoke.same(x, y).all())]
        print(f"  {name}: change == {other} on every output: {not bad}", flush=True)
        if bad:
            raise AssertionError(f"{name}: outputs {bad} differ between {other} and change")
    order = (other, "change", "change", other)
    for name, (fn, reps, per) in kernels.items():
        for tag in (other, "change"):
            for _ in range(2):
                fn(libs[tag])
        turns = []
        for _ in range(rounds):
            for tag in order:
                turns.append((tag, chip_smoke.device_ms(lambda: fn(libs[tag]), reps) / per))
        p = [ms for tag, ms in turns if tag == other]
        c = [ms for tag, ms in turns if tag == "change"]
        print(f"{name}: turns " + ", ".join(f"{tag} {ms:.4f}" for tag, ms in turns)
              + f" ms; means {other} {sum(p) / len(p):.4f}, change {sum(c) / len(c):.4f} ms, "
              f"change / {other} {sum(c) / len(c) / (sum(p) / len(p)):.4f} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
