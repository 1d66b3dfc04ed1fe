"""The kernels' instances of the renderer's automaton options and of the u8
color grid, compiled for the host and run on the CPU through their C
entries (``vhx_traverse_ex``, ``vhx_render_frame_ex``,
``vhx_render_frame_lod_ex``, ``vhx_render_frames_ex``, ``vhx_prepass_ex``),
against their plain versions, bit for bit: the optioned instances of
``traverse.cu``, ``frame.cu`` (with and without a start map),
``frames.cu`` (with its digest) and ``prepass.cu`` (one launch, and a
chained one) under each option, over u16 and u8 colors; the u8 instances of
the default options, of the skip tracer and of the LOD frame.  Each launch
records which instance it ran, and the test checks it.

As ``tests/test_torch_kernels_host.py`` does (whose stand-in header for the
CUDA names this file shares), each source is built with the host compiler
(at -O0: the build, not the launches, takes most of the time here), one
library a source, all at once, and its launches are rewritten into
loops over the grid: the threads in turn, and the depth prepass's blocks
all at once, meeting at their barriers.  Skips where there is no C++
compiler.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_kernels_host import CSRC, SHIM
from test_torch_kernels_host_lod_skip import _equal

GLOBALS = r"""
#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local VhxWarp* vhx_warp = nullptr;
thread_local VhxBlock* vhx_block = nullptr;
std::mutex vhx_host_atomic_lock;
long long vhx_host_atomics = 0;
std::condition_variable vhx_flag_cv;
long long vhx_host_polls = 0;
const void* vhx_launched = nullptr;
"""

# the instances each source's test launches, in the order of
# host_last_instance's index (the test grids have 3 levels)
INSTANCES = {
    "traverse": ["traverse_kernel", "traverse_form_kernel<false, true>",
                 "traverse_form_kernel<true, false>", "traverse_form_kernel<true, true>",
                 "traverse_skip_kernel<3, true>"],
    "frame": ["frame_kernel", "frame_start_kernel"]
    + [f"frame_form_kernel<{s}, {o}, {u}>" for s in ("false", "true")
       for o, u in (("false", "true"), ("true", "false"), ("true", "true"))]
    + ["frame_skip_kernel<false, 3, true>", "frame_skip_kernel<true, 3, true>",
       "frame_lod_kernel<false, true>", "frame_lod_kernel<true, true>"],
    "frames": ["frames_kernel", "frames_start_kernel"]
    + [f"frames_form_kernel<{s}, {o}, {u}>" for s in ("false", "true")
       for o, u in (("false", "true"), ("true", "false"), ("true", "true"))]
    + ["frames_skip_kernel<false, 3, true>"],
    "prepass": ["prepass_frame_kernel<0, false, false>", "prepass_frame_kernel<0, false, true>",
                "prepass_frame_kernel<0, true, true>"],
}
# the renderer's automaton options (ops.traverse.AutomatonOptions fields):
# each branch of the optioned automaton, no lateral steps, the parent skip
# with lateral steps and without, ADVANCEs of 0 to 3 substeps read at run time
OPTIONS = [(False, False, 1), (True, False, 0), (True, True, 3), (False, True, 2)]
RES = (43, 29)
BG = (0.1, 0.2, 0.3)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("kernels_host_options")
    (d / "cuda_runtime.h").write_text(SHIM)
    for header in ("traverse.cuh", "frame.cuh", "skip.cuh"):
        shutil.copy(os.path.join(CSRC, header), d)
    entry = re.compile(r"(\w+(?:<[\w ,]+>)?)<<<(.*?)>>>\((.*?)\);", flags=re.S)
    shared = re.compile(r"__shared__ ([\w:]+) (\w+)((?:\[[^\]]+\])*);")
    procs = {}
    for name, instances in INSTANCES.items():
        launcher = "vhx_host_grid_launch" if name == "prepass" else "vhx_host_launch"

        def sub(m, launcher=launcher):
            return (f"{{ vhx_launched = (const void*)({m.group(1)}); "
                    f"{launcher}({m.group(2)}, [&] {{ {m.group(1)}({m.group(3)}); }}); }}")

        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            src = entry.sub(sub, f.read())
        if name == "prepass":
            src = shared.sub(r"auto& \2 = vhx_block_shared<\1\3>(__LINE__);", src)
        (d / f"{name}_host.cu").write_text(src)
        table = ", ".join(f"(const void*)&{k}" for k in instances)
        (d / f"{name}_harness.cpp").write_text(
            GLOBALS + f'#include "{name}_host.cu"\n'
            f"static const void* vhx_instances[] = {{{table}}};\n"
            'extern "C" int host_last_instance() {\n'
            f"    for (int i = 0; i < {len(instances)}; ++i)\n"
            "        if (vhx_launched == vhx_instances[i]) return i;\n"
            "    return -1;\n}\n")
        procs[name] = subprocess.Popen(
            [cxx, "-std=c++17", "-O0", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
             "-fPIC", "-shared", f"-I{d}", "-o", str(d / f"lib{name}.so"),
             str(d / f"{name}_harness.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    from voxelhex_tpu_torch.ops import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    opts_p = ctypes.POINTER(_build.TraceOptions)
    signatures = {
        "traverse": {"vhx_traverse_ex": [p, p, p, p, ctypes.POINTER(_build.TraceParams), opts_p,
                                         i, i, i, p, p, p, p, p, i, p]},
        "frame": {"vhx_render_frame_ex": [p, p, p, i, ctypes.POINTER(_build.FrameParams), opts_p,
                                          i, i, p, i, p, p, i, p],
                  "vhx_render_frame_lod_ex": [p, p, p, i, ctypes.POINTER(_build.FrameParams),
                                              ctypes.POINTER(_build.LodParams), i, i, p, i, p]},
        "frames": {"vhx_render_frames_ex": [p, p, p, i, ctypes.POINTER(_build.FramesParams),
                                            opts_p, i, i, p, i, ctypes.c_uint, p, p, p, p, i,
                                            p]},
        "prepass": {"vhx_prepass_ex": [p, ctypes.POINTER(_build.PrepassParams), i, i, opts_p,
                                       ctypes.POINTER(p), p, p, p, i, i, p],
                    "vhx_prepass_sync_words": [i, i, i]},
    }
    for name, proc in procs.items():
        log = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(d / f"lib{name}.so"))
        for fn, args in signatures[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_longlong if fn.endswith("words") else i
        lib.host_last_instance.restype = i
        out[name] = lib
    return out


def _launched(libs, name):
    return INSTANCES[name][libs[name].host_last_instance()]


def _tree(u8, skip=False, mip=False):
    """A 64^3 grid (3 levels) of random voxels, a solid block and voxels
    with no color, 6 colors: u8 with ``u8``."""
    from voxelhex_tpu_torch.render.bitgrid import (bitgrid_from_grids, build_mip_colors,
                                                   device_bitgrid)

    size = 64
    rng = np.random.default_rng(5)
    occ = rng.random((size, size, size)) < 0.02
    occ[8:24, :16, 8:32] = True
    colors = np.where(occ, rng.integers(0, 6, occ.shape), 0xFFFF).astype(np.uint16)
    colors[occ & (rng.random(occ.shape) < 0.05)] = 0xFFFE
    bg = bitgrid_from_grids(occ, np.ascontiguousarray(colors.transpose(2, 1, 0)).ravel(),
                            rng.random((6, 4)).astype(np.float32))
    if mip:
        build_mip_colors(bg)
    tree = device_bitgrid(bg, "cpu", skip_rows=skip, color_u8=u8)
    assert tree["colors"].dtype == (torch.uint8 if u8 else torch.int16)
    return tree


def _rays(n=600, size=64, seed=4):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    d = rng.uniform(0, size, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def _cams():
    from voxelhex_tpu_torch.render.camera import orbit_camera

    return [orbit_camera(64.0, yaw_deg=y, resolution=RES) for y in (30.0, 150.0)]


def _traverse(libs, tree, o, d, max_iters, opts, substeps=0):
    from voxelhex_tpu_torch.ops.traverse import color_bytes, trace_params

    n = o.shape[0]
    out = [torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32),
           torch.zeros((n, 3), dtype=torch.int32), torch.zeros((n, 3)), torch.zeros((n, 3))]
    words = tree["skip_rows"] if substeps else tree["occ_pairs"]
    assert libs["traverse"].vhx_traverse_ex(
        o.data_ptr(), d.data_ptr(), words.data_ptr(), tree["colors"].data_ptr(),
        trace_params(tree, max_iters), opts, color_bytes(tree), substeps, n,
        *[t.data_ptr() for t in out], 0, None) == 0
    return out


def _frame(libs, tree, cam, max_iters, opts, start=None, substeps=0):
    from voxelhex_tpu_torch.ops.frame import frame_params
    from voxelhex_tpu_torch.ops.traverse import color_bytes

    out = torch.full((RES[1], RES[0], 3), 7.0)
    words = tree["skip_rows"] if substeps else tree["occ_pairs"]
    assert libs["frame"].vhx_render_frame_ex(
        words.data_ptr(), tree["colors"].data_ptr(), tree["palette"].data_ptr(),
        tree["palette"].shape[0], frame_params(tree, cam, BG, max_iters), opts,
        color_bytes(tree), substeps, None if start is None else start.data_ptr(), 8,
        out.data_ptr(), None, 0, None) == 0
    return out


def _frames(libs, tree, cams, max_iters, opts, substeps=0):
    from voxelhex_tpu_torch.ops.frames import launch_frames
    from voxelhex_tpu_torch.ops.traverse import color_bytes

    lib = libs["frames"]

    def entry(words, colors, palette, n_colors, p, *rest):
        return lib.vhx_render_frames_ex(words, colors, palette, n_colors, p, opts,
                                        color_bytes(tree), substeps, *rest)

    prev = torch.zeros((RES[1], RES[0], 3), dtype=torch.uint8)
    prev[::3] = 40
    frames, digest, n = launch_frames(entry, tree, cams, BG, True, max_iters, prev,
                                      words=tree["skip_rows"] if substeps else None)
    assert n == 1
    return frames, digest, prev


def _prepass(libs, tree, cam, levels, max_iters, opts, coarse=None):
    """prepass.cu's launch through vhx_prepass_ex: the depths of each level,
    the coarsest first, and the start map (with ``coarse``, the coarsest
    level starts from it: the chained form)."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.prepass import level_camera, prepass_params

    lib = libs["prepass"]
    cams = [level_camera(cam, i) for i in range(1, levels + 1)]
    outs = [torch.full((c.resolution[1], c.resolution[0]), 7.0) for c in cams]
    start = torch.full_like(outs[0], 7.0)
    params = (_build.PrepassParams * levels)(*(prepass_params(tree, c, max_iters) for c in cams))
    ptrs = (ctypes.c_void_p * levels)(*(t.data_ptr() for t in outs))
    w1, h1 = cams[0].resolution
    sync = torch.zeros(int(lib.vhx_prepass_sync_words(w1, h1, levels)), dtype=torch.int32)
    assert lib.vhx_prepass_ex(tree["occ_pairs"].data_ptr(), params, levels, 0, opts, ptrs,
                              start.data_ptr(), None if coarse is None else coarse.data_ptr(),
                              sync.data_ptr(), 1, 0, None) == 0
    return outs[::-1], start


@pytest.mark.parametrize("options", OPTIONS)
def test_option_instances_equal_plain(libs, options):
    """Each option's instances (over u8 colors for every other option)
    against the plain versions under the same option: the traversal at the
    default step limit (100 steps for ADVANCEs of no substep, whose rays
    spin in place) and at 7; the frame without a start map at 24 steps
    (where the option changes what the rays end with) and from one at 7; a
    two-frame batch with its digests and the depth prepass at 2 levels, one
    launch, then chained from a coarse start map, at 24 steps."""
    from voxelhex_tpu_torch.ops.frame import render_frame_plain
    from voxelhex_tpu_torch.ops.frames import render_frames_plain
    from voxelhex_tpu_torch.ops.prepass import depth_start_plain, level_camera, level_depth_plain
    from voxelhex_tpu_torch.ops.traverse import AutomatonOptions, kernel_options, traverse_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera

    u8 = OPTIONS.index(options) % 2 == 1
    opts = AutomatonOptions(*options)
    tree = _tree(u8)
    o, d = _rays()
    full = 2048 if opts.advance_substeps > 0 else 100
    suffix = "true>" if u8 else "false>"
    for max_iters in (full, 7):
        got = _traverse(libs, tree, o, d, max_iters, kernel_options(opts))
        assert _launched(libs, "traverse") == f"traverse_form_kernel<true, {suffix}"
        for a, b in zip(got, traverse_plain(tree, o, d, max_iters, opts)):
            assert _equal(a, b)
    cams = _cams()
    start = torch.from_numpy(np.random.default_rng(2).random((4, 6)).astype(np.float32) * 60)
    mid = 24
    for s, max_iters in ((None, mid), (start, 7)):
        got = _frame(libs, tree, cams[0], max_iters, kernel_options(opts), s)
        form = "true" if s is not None else "false"
        assert _launched(libs, "frame") == f"frame_form_kernel<{form}, true, {suffix}"
        assert _equal(got, render_frame_plain(tree, cams[0], BG, False, max_iters, s, 8,
                                              options=opts))
    frames, digest, prev = _frames(libs, tree, cams, mid, kernel_options(opts))
    assert _launched(libs, "frames") == f"frames_form_kernel<false, true, {suffix}"
    want, nrows, flags = render_frames_plain(tree, cams, BG, True, mid, prev, options=opts)
    assert _equal(frames, want)
    assert _equal(digest, torch.cat([nrows[:, None], flags], dim=1))
    cam = orbit_camera(64.0, yaw_deg=150.0, resolution=(64, 40))
    depths, start = _prepass(libs, tree, cam, 2, mid, kernel_options(opts))
    assert _launched(libs, "prepass") == "prepass_frame_kernel<0, false, true>"
    plain = None
    for k, c in enumerate(reversed([level_camera(cam, i) for i in (1, 2)])):
        plain = level_depth_plain(tree, c, plain, mid, options=opts)
        assert _equal(depths[k], plain)
    assert _equal(start, depth_start_plain(plain))
    # chained: level 1 alone, from level 2's start map
    coarse = depth_start_plain(depths[0])
    depths1, start1 = _prepass(libs, tree, cam, 1, mid, kernel_options(opts), coarse)
    assert _launched(libs, "prepass") == "prepass_frame_kernel<0, true, true>"
    assert _equal(depths1[0], depths[1]) and _equal(start1, start)


def test_u8_instances_equal_plain(libs):
    """The u8 instances of the default options (traversal, frame with and
    without a start map, batch), of the skip tracer (traversal, frame,
    batch) and of the LOD frame (stop and stopless) against the plain
    versions over the u8 grid (the batches against the u16 grid's plain
    frames; the plain versions over both grids are held equal in
    ``test_torch_color_u8.py``)."""
    from voxelhex_tpu_torch.ops.frame import (frame_params, lod_params, render_frame_plain,
                                              render_lod_plain)
    from voxelhex_tpu_torch.ops.frames import render_frames_plain
    from voxelhex_tpu_torch.ops.skip import trace_skip_plain
    from voxelhex_tpu_torch.ops.traverse import traverse_plain

    t8, t16 = _tree(True, skip=True, mip=True), _tree(False, skip=True)
    o, d = _rays(seed=6)
    cams = _cams()
    start = torch.from_numpy(np.random.default_rng(3).random((4, 6)).astype(np.float32) * 60)
    got = _traverse(libs, t8, o, d, 2048, None)
    assert _launched(libs, "traverse") == "traverse_form_kernel<false, true>"
    for a, b in zip(got, traverse_plain(t8, o, d)):
        assert _equal(a, b)
    got = _traverse(libs, t8, o, d, 2048, None, substeps=3)
    assert _launched(libs, "traverse") == "traverse_skip_kernel<3, true>"
    for a, b in zip(got, trace_skip_plain(t8, o, d)):
        assert _equal(a, b)
    for substeps, skip in ((0, None), (3, 3)):
        for s in (None, start):
            got = _frame(libs, t8, cams[0], 2048, None, s, substeps)
            form = "true" if s is not None else "false"
            want = (f"frame_form_kernel<{form}, false, true>" if not substeps
                    else f"frame_skip_kernel<{form}, 3, true>")
            assert _launched(libs, "frame") == want
            assert _equal(got, render_frame_plain(t8, cams[0], BG, False, 2048, s, 8, skip))
        frames, digest, prev = _frames(libs, t8, cams, 2048, None, substeps)
        assert _launched(libs, "frames") == ("frames_form_kernel<false, false, true>"
                                             if not substeps else
                                             "frames_skip_kernel<false, 3, true>")
        want, nrows, flags = render_frames_plain(t16, cams, BG, True, 2048, prev,
                                                 skip_substeps=skip)
        assert _equal(frames, want)
        assert _equal(digest, torch.cat([nrows[:, None], flags], dim=1))
    for scale in (0.0, 0.3):
        out = torch.full((RES[1], RES[0], 3), 7.0)
        stop = int(scale > 0)
        assert libs["frame"].vhx_render_frame_lod_ex(
            t8["occ_pairs"].data_ptr(), t8["colors"].data_ptr(), t8["palette"].data_ptr(),
            t8["palette"].shape[0], frame_params(t8, cams[1], BG), lod_params(t8, scale), 1,
            stop, out.data_ptr(), 0, None) == 0
        assert _launched(libs, "frame") == f"frame_lod_kernel<{'true' if stop else 'false'}, true>"
        assert _equal(out, render_lod_plain(t8, cams[1], scale, BG))


def test_entries_refuse_bad_forms(libs):
    """A color width other than 1 or 2, and automaton options with the skip
    tracer, are refused (cudaErrorInvalidValue) before any launch."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frame import frame_params
    from voxelhex_tpu_torch.ops.traverse import trace_params

    tree = _tree(False, skip=True)
    o, d = _rays(8)
    outs = [torch.zeros((8, 3)) for _ in range(5)]
    opts = _build.TraceOptions(0, 0, 4)
    for width, substeps, o_ in ((4, 0, None), (2, 3, opts)):
        words = tree["skip_rows"] if substeps else tree["occ_pairs"]
        assert libs["traverse"].vhx_traverse_ex(
            o.data_ptr(), d.data_ptr(), words.data_ptr(), tree["colors"].data_ptr(),
            trace_params(tree), o_, width, substeps, 8, *[t.data_ptr() for t in outs], 0,
            None) != 0
        assert libs["frame"].vhx_render_frame_ex(
            words.data_ptr(), tree["colors"].data_ptr(), tree["palette"].data_ptr(), 6,
            frame_params(tree, _cams()[0]), o_, width, substeps, None, 1, outs[0].data_ptr(),
            None, 0, None) != 0
