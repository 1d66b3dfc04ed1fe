"""The streaming view's far frame, coarse rebuild and region scatter against
another tree's.

    python3 tools/stream_ab.py [--parent DIR] [--far-variant NAME=FLAGS ...] [--rounds N]
                               [--frames N] [--skip] [--time-frames I,J,...]

Follows ``chip_smoke.py``'s fly-over (phase 12 (a)): the 1024 terrain
through ``StreamingView(tree, view_size=256, regions_per_update=8192)``
along ``flight_cam`` at 1920x1080.  At each frame's pose it prints each
layer's march from ``far_frame_plain(..., stats=[])``: the rays that
start it, their automaton steps (sum and most), and the share of
lane-steps that do work when a warp takes a 4 x 8 pixel tile (the kernel
of one pixel a thread) and when a block's rays that go on to a ring are
packed into its first warps in tile order (a block of 4 or 8 warps).
Then it times by device time (``chip_smoke.device_ms``), in turns:

* the far frame (``render_far``) and the same launch on the window alone
  (``layers[:1]``), beside ``frame.cu`` at the same window and pose;
* the coarse rebuild of the window's levels above level 0 (``coarse_rebuild``
  on a copy of the window);
* the region scatter of the update that led to the frame (every frame after
  the first: the regions the move exposed, as ``region_scatter`` got them),
  on a copy of the window, each tree's kernel first held to
  ``region_scatter_plain`` bit for bit.

``--parent DIR``: ``DIR`` is another commit's tree (e.g. unpacked with
``git archive`` under ``build/parent``); its kernels are built with its
own ``_build``, held equal to this tree's on every output, and timed in the
same turns: parent, change, change, parent, ``--rounds`` times (``--name``
names the other tree in the output).
``--far-variant NAME=FLAGS`` (repeated) adds this tree's ``far.cu`` built
with the extra nvcc ``FLAGS`` as another contender, e.g.
``r48=-maxrregcount=48``.  Prints ``far_kernel``'s registers, stack and
spills of each build.  Each tree's ``region_scatter_kernel`` instances are
listed with their registers, SASS instructions and global stores by kind
(``cuobjdump``): a 16 B store that the compiler splits into 4 B ones shows
there.

``--skip`` flies the view under ``tracer="skip"`` (phase 16 (b)) and times
the far frame of both tracers on its trees instead of the rebuild and the
scatter: the skip far frame (``far_skip_kernel``, ``skip_substeps`` 3) of
each contender and its launch on the window alone, the stack far frame
and its window alone, and ``frame.cu``'s stack and skip instances at the
window and pose.  Each layer's rays, then, also get their skip march from
``far_frame_plain(..., stats=[], skip_substeps=3)``: body iterations (a
row fetch each: the entry's fetch, and one after each body but the last)
and working lane-steps, beside the stack march's steps.  The window's
march is the one that ``frame.cu`` runs at that pose.  Every contender's
skip far frame, whole and on the window alone, is first held to
``far_frame_plain`` bit for bit.  Prints the registers, stack and spills
of each build's ``far_skip_kernel`` and ``frame.cu``'s
``frame_skip_kernel`` instances of the window's depth.
``--time-frames`` times only the frames listed (the view still flies
through every frame up to ``--frames``).

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

FAR_REPS = 10
SUBSTEPS = 3  # chip_smoke.SKIP_SUBSTEPS, the view's skip_substeps
REBUILD_REPS = 20
SCATTER_REPS = 20


def lane_shares(iters, go, warps, tile=(4, 8)):
    """``(tile, packed)``: the share of lane-steps that do work for the
    per-ray steps ``iters`` [h, w] of the rays ``go`` [h, w] that march,
    with a warp on each 4 x 8 tile, and with each block's (``warps`` tiles
    side by side) marching rays packed into its first warps in thread
    order."""
    import torch

    tw, th = tile
    h, w = iters.shape
    bw = tw * warps
    H, W = -(-h // th) * th, -(-w // bw) * bw
    it = torch.zeros((H, W), dtype=torch.float64)
    g = torch.zeros((H, W), dtype=torch.bool)
    it[:h, :w] = iters.double().cpu()
    g[:h, :w] = go.cpu()
    it = torch.where(g, it, torch.zeros_like(it))
    # [block row, lane row, block col, warp, lane col] -> blocks of threads in order
    def blocks(x):
        x = x.reshape(H // th, th, W // bw, warps, tw).permute(0, 2, 3, 1, 4)
        return x.reshape(-1, 32 * warps)
    ib, gb = blocks(it), blocks(g)
    work = float(ib.sum())
    if work == 0:
        return 1.0, 1.0
    tiled = float(ib.reshape(-1, 32).max(dim=1).values.sum()) * 32
    order = torch.argsort((~gb).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(ib, 1, order)
    packed_cost = float(packed.reshape(-1, 32).max(dim=1).values.sum()) * 32
    return work / tiled, work / packed_cost


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another tree's copy")
    ap.add_argument("--name", default="parent", help="what to call the other tree")
    ap.add_argument("--far-variant", action="append", default=[], metavar="NAME=FLAGS",
                    help="also time this tree's far.cu built with these nvcc flags")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--frames", type=int, default=8, help="fly-over frames (at most 8)")
    ap.add_argument("--skip", action="store_true",
                    help="the skip view: the far frames of both tracers, no rebuild or scatter")
    ap.add_argument("--time-frames", help="comma-separated frames to time (default: all)")
    args = ap.parse_args()
    time_frames = (None if args.time_frames is None
                   else {int(v) for v in args.time_frames.split(",")})

    import torch

    if not torch.cuda.is_available():
        print("stream_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import concurrent.futures

    import chip_smoke
    from automaton_ab import _cuobjdump, load_build, sass_functions, short_name

    chip_smoke.faulthandler.cancel_dump_traceback_later()
    from voxelhex_tpu_torch.ops import _build, stream
    from voxelhex_tpu_torch.ops.far import far_frame_plain, far_params, render_far
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.render import streaming
    from voxelhex_tpu_torch.render.streaming import StreamingView
    from voxelhex_tpu_torch.scene import terrain_points
    from voxelhex_tpu_torch.tree.build import from_voxels

    card = chip_smoke.card_line()
    tag = f"[{card}]"
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    t0 = time.time()
    _build.library()
    contenders = {"change": None}
    builds = {"change": _build}
    if args.parent:
        parent = load_build(os.path.abspath(args.parent), "parent_build")
        parent.library()
        builds[args.name] = parent
        contenders[args.name] = parent
    def build_variant(variant):
        name, _, flags = variant.partition("=")
        out = os.path.join(ROOT, "build", "stream_ab", f"libfar_{name}.so")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        run = subprocess.run([_build._nvcc(), *_build.FLAGS, *flags.split(), "-o", out,
                              os.path.join(_build.CSRC, "far.cu")],
                             capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc far.cu {flags}:\n{run.stdout}{run.stderr}")
        return name, flags, out, run.stdout + run.stderr

    with concurrent.futures.ThreadPoolExecutor(max(len(args.far_variant), 1)) as pool:
        built = list(pool.map(build_variant, args.far_variant))
    for name, flags, out, log in built:
        for kernel in ("far_kernel", "far_skip_kernel"):
            for k in chip_smoke.kernel_names(log, kernel):
                if kernel == "far_kernel" or short_name(k).endswith(", 4, 3>"):
                    usage = chip_smoke.ptxas_usage(log, k)
                    print(f"  change {name} ({flags}) {short_name(k)}: {usage[0]} registers, "
                          f"{usage[1]} B stack, {usage[2]} B spill stores, {usage[3]} B spill "
                          "loads", flush=True)
        contenders[f"change {name}"] = ctypes.CDLL(out)
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    for name, b in builds.items():
        text = subprocess.run([_cuobjdump(_build._nvcc()), "-sass",
                               os.path.join(b.library_dir(), "libstream.so")],
                              check=True, capture_output=True, text=True, timeout=120).stdout
        for fn, ops in sass_functions(text).items():
            if "region_scatter_kernel" in fn:
                stores = Counter(op for op in ops if op.startswith("STG"))
                print(f"  {name} {fn}: {len(ops)} SASS instructions, global stores "
                      f"{dict(sorted(stores.items()))}", flush=True)
        for source, kernel in (("far.cu", "far_kernel"), ("stream.cu", "region_scatter_kernel"),
                               ("far.cu", "far_skip_kernel"), ("frame.cu", "frame_skip_kernel")):
            log = b.build_log(source)
            for k in chip_smoke.kernel_names(log, kernel):
                if "skip" in kernel and ", 4" not in short_name(k):
                    continue  # the skip instances of the window's depth, 4
                usage = chip_smoke.ptxas_usage(log, k)
                print(f"  {name} {short_name(k)}: {usage[0]} registers, {usage[1]} B stack, "
                      f"{usage[2]} B spill stores, {usage[3]} B spill loads", flush=True)

    def far_fn(name):
        """One far frame of ``name``'s kernel: ``fn(layers, inside)``."""
        if name == "change":
            return lambda layers, inside: render_far(layers, inside)
        lib = contenders[name]
        if isinstance(lib, ctypes.CDLL):
            entry = lib.vhx_render_far
        else:
            entry = lib.library().vhx_render_far
        entry.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p]
        entry.restype = ctypes.c_int

        def call(layers, inside):
            p = far_params(layers, inside)
            out = torch.empty((p.h, p.w, 3), dtype=torch.uint8, device=dev)
            _build.check(entry(ctypes.addressof(p), None, out.data_ptr(), 0, cuda_stream),
                         f"{name} far frame")
            return out
        return call

    def skip_fn(name):
        """One skip far frame of ``name``'s kernel: ``fn(layers, inside)``."""
        if name == "change":
            return lambda layers, inside: render_far(layers, inside, skip_substeps=SUBSTEPS)
        lib = contenders[name]
        entry = (lib if isinstance(lib, ctypes.CDLL) else lib.library()).vhx_render_far_skip
        entry.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        entry.restype = ctypes.c_int

        def call(layers, inside):
            p = far_params(layers, inside, skip=True)
            out = torch.empty((p.h, p.w, 3), dtype=torch.uint8, device=dev)
            _build.check(entry(ctypes.addressof(p), SUBSTEPS, None, 1, None, out.data_ptr(), 0,
                               cuda_stream), f"{name} skip far frame")
            return out
        return call

    def rebuild_fn(name):
        """One coarse rebuild of ``name``'s kernel on a window ``tree``."""
        if name == "change":
            return stream.coarse_rebuild
        entry = builds[name].library().vhx_coarse_rebuild
        if len(entry.argtypes) == 6:  # one launch a level: no ticket counter
            return lambda tree: _build.check(entry(
                tree["occ_pairs"].data_ptr(), stream._ints(tree["bases"]),
                stream._ints(tree["dims"]), len(tree["bases"]), 0, cuda_stream),
                f"{name} rebuild")
        tickets = torch.zeros(1, dtype=torch.int32, device=dev)
        return lambda tree: _build.check(entry(
            tree["occ_pairs"].data_ptr(), stream._ints(tree["bases"]),
            stream._ints(tree["dims"]), len(tree["bases"]), tickets.data_ptr(), 0, cuda_stream),
            f"{name} rebuild")

    def scatter_fn(name):
        """One region scatter of ``name``'s kernel: ``fn(tree, corners,
        col_vals, blk_vals)``."""
        if name == "change":
            return stream.region_scatter
        entry = builds[name].library().vhx_region_scatter

        def call(tree, corners, col_vals, blk_vals):
            _build.check(entry(tree["colors"].data_ptr(), tree["occ_pairs"].data_ptr(),
                               corners.data_ptr(), col_vals.data_ptr(), blk_vals.data_ptr(),
                               corners.shape[0], int(tree["size"]),
                               int(col_vals.dtype == torch.int16), 0, cuda_stream),
                         f"{name} scatter")
        return call

    fars = {name: far_fn(name) for name in contenders}
    skips = {name: skip_fn(name) for name in contenders} if args.skip else {}
    rebuilds = {name: rebuild_fn(name) for name in builds}
    scatters = {name: scatter_fn(name) for name in builds}
    other = ([n for n in contenders if n != "change"] or ["change"])[0]

    t0 = time.time()
    pts, cols = terrain_points(chip_smoke.TERRAIN_WORLD)
    tree = from_voxels(pts, cols, size=chip_smoke.TERRAIN_WORLD, brick_dim=4)
    del pts, cols
    view = StreamingView(tree, view_size=chip_smoke.FLY_VIEW, regions_per_update=8192,
                         tracer="skip" if args.skip else "stack")
    print(f"terrain and view: {time.time() - t0:.1f} s", flush=True)
    sums = {}
    paged = []  # the update's scatter inputs

    def capture(window, *inputs):
        paged.append(inputs)
        stream.region_scatter(window, *inputs)

    for i in range(min(args.frames, chip_smoke.FLY_FRAMES)):
        cam = chip_smoke.flight_cam(i)
        paged.clear()
        streaming.region_scatter = capture
        try:
            frame = view.render(cam, out_u8=True, out_device=True)
        finally:
            streaming.region_scatter = stream.region_scatter
        layers, inside = view.layers(cam), view.camera_inside(cam)
        stats = []
        plain = far_frame_plain(layers, inside, stats=stats)
        want = far_frame_plain(layers, inside, skip_substeps=SUBSTEPS) if args.skip else plain
        if not bool((want == frame).all()):
            raise AssertionError(f"frame {i}: render() differs from far_frame_plain")
        if time_frames is not None and i not in time_frames:
            continue
        h, w = plain.shape[:2]
        print(f"frame {i}: camera inside the window {inside}", flush=True)
        for li, s in enumerate(stats):
            iters = s["iters"].reshape(h, w)
            go = iters > 0 if li and inside else torch.ones_like(iters, dtype=torch.bool)
            shares = [lane_shares(iters, go, warps) for warps in (4, 8)]
            print(f"  layer {li}: {s['rays']} rays, {int(s['iters'].sum())} steps, most "
                  f"{int(s['iters'].max())}; working lane-steps: 4 x 8 tile {shares[0][0]:.4f}, "
                  f"packed in a block of 4 warps {shares[0][1]:.4f}, of 8 warps "
                  f"{shares[1][1]:.4f}", flush=True)
        if args.skip:
            skip_stats = []
            skip_plain = far_frame_plain(layers, inside, stats=skip_stats, skip_substeps=SUBSTEPS)
            for li, (s, st) in enumerate(zip(skip_stats, stats)):
                iters = s["iters"].reshape(h, w)
                go = iters > 0 if li and inside else torch.ones_like(iters, dtype=torch.bool)
                n_it, n_st = int(s["iters"].sum()), int(st["iters"].sum())
                print(f"  layer {li} skip march: {s['rays']} rays, {n_it} body iterations "
                      f"({n_it / max(s['rays'], 1):.3f} a ray; {n_st / max(st['rays'], 1):.3f} "
                      f"stack steps a ray), most {int(s['iters'].max())}; {int(s['reads'].sum())} "
                      f"distinct rows; working lane-steps, 4 x 8 tile "
                      f"{lane_shares(iters, go, 4)[0]:.4f}", flush=True)
            skip_window = far_frame_plain(layers[:1], inside, skip_substeps=SUBSTEPS)
            for name, fn in skips.items():
                for lay, want in ((layers, skip_plain), (layers[:1], skip_window)):
                    if not bool((fn(lay, inside) == want).all()):
                        raise AssertionError(f"frame {i}: {name}'s skip far frame ({len(lay)} "
                                             "layers) differs from far_frame_plain")
        window_plain = far_frame_plain(layers[:1], inside)
        for name, fn in fars.items():
            for lay, want in ((layers, plain), (layers[:1], window_plain)):
                if not bool((fn(lay, inside) == want).all()):
                    raise AssertionError(f"frame {i}: {name}'s far frame ({len(lay)} layers) "
                                         "differs from far_frame_plain")
        window = layers[0][0]
        work = dict(window, occ_pairs=window["occ_pairs"].clone())
        want = stream.coarse_rebuild_plain(window["occ_pairs"].clone(), window["bases"],
                                           window["dims"])
        for name, fn in rebuilds.items():
            work["occ_pairs"].zero_()
            work["occ_pairs"][: window["dims"][0] ** 3] = window["occ_pairs"][
                : window["dims"][0] ** 3]
            fn(work)
            if not bool((work["occ_pairs"] == want).all()):
                raise AssertionError(f"frame {i}: {name}'s rebuild differs from the plain one")

        scatter_work = None
        if paged and not args.skip:
            corners, col_vals, blk_vals = paged[-1]
            S = int(window["size"])
            scatter_work = dict(window, colors=window["colors"].clone(),
                                occ_pairs=window["occ_pairs"].clone())
            want = (scatter_work["colors"].clone(), scatter_work["occ_pairs"].clone())
            stream.region_scatter_plain(*want, corners, col_vals, blk_vals, S)
            for name, fn in scatters.items():
                scatter_work["colors"].copy_(window["colors"])
                scatter_work["occ_pairs"].copy_(window["occ_pairs"])
                fn(scatter_work, corners, col_vals, blk_vals)
                if not (bool((scatter_work["colors"] == want[0]).all())
                        and bool((scatter_work["occ_pairs"] == want[1]).all())):
                    raise AssertionError(f"frame {i}: {name}'s scatter differs from the plain one")
            print(f"  scatter: {corners.shape[0]} regions, {col_vals.dtype} wire, every tree's "
                  "kernel equal to region_scatter_plain", flush=True)

        timers = {}
        for name, fn in fars.items():
            timers[f"far {name}"] = (lambda fn=fn: fn(layers, inside), FAR_REPS)
            timers[f"window-only far {name}"] = (lambda fn=fn: fn(layers[:1], inside), FAR_REPS)
        for name, fn in skips.items():
            timers[f"skip far {name}"] = (lambda fn=fn: fn(layers, inside), FAR_REPS)
            timers[f"skip window-only far {name}"] = (lambda fn=fn: fn(layers[:1], inside),
                                                      FAR_REPS)
        timers["frame.cu"] = (lambda: render_frame(window, layers[0][1]), FAR_REPS)
        if args.skip:
            timers["skip frame.cu"] = (lambda: render_frame(window, layers[0][1],
                                                            skip_substeps=SUBSTEPS), FAR_REPS)
        for name, fn in rebuilds.items() if not args.skip else ():
            timers[f"rebuild {name}"] = (lambda fn=fn: fn(work), REBUILD_REPS)
        if scatter_work is not None:
            for name, fn in scatters.items():
                timers[f"scatter {name}"] = (
                    lambda fn=fn: fn(scatter_work, corners, col_vals, blk_vals), SCATTER_REPS)
        for fn, _reps in timers.values():
            fn()
            fn()
        got = {k: [] for k in timers}
        rest = [n for n in contenders if n != other]
        turn = [other] + rest + rest[::-1] + [other] if rest else [other, other]
        for _ in range(args.rounds):
            for name in turn:
                for key in [k for k in timers if k.endswith(" " + name)]:
                    fn, reps = timers[key]
                    got[key].append(chip_smoke.device_ms(fn, reps))
            for key in ("frame.cu", "skip frame.cu"):
                if key in timers:
                    fn, reps = timers[key]
                    got[key].append(chip_smoke.device_ms(fn, reps))
        for key, t in got.items():
            if not t:
                continue
            mean = sum(t) / len(t)
            sums.setdefault(key, []).append(mean)
            print(f"  {key}: turns " + ", ".join(f"{x:.4f}" for x in t)
                  + f" ms; mean {mean:.4f} ms {tag}", flush=True)
    print("means over the frames:", flush=True)
    for key, v in sums.items():
        print(f"  {key}: {sum(v) / len(v):.4f} ms ({', '.join(f'{x:.4f}' for x in v)}) {tag}",
              flush=True)
    view.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
