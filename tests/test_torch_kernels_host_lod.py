"""The LOD frame kernel (``csrc/frame.cu`` ``frame_lod_kernel``, its stop
instance and its stopless one) compiled for the host and run on the CPU
through its C entry, against ``render_lod_plain``, bit for bit.

As ``tests/test_torch_kernels_host.py`` does (whose stand-in header for the
CUDA names this file shares), the source is built with the host compiler
and the C entry's launch is rewritten into a loop over the grid, the
threads in turn; the rewrite also records which instance the entry
launched.  Skips where there is no C++ compiler.
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
from test_torch_kernels_host_lod_skip import _equal, _grid

HARNESS = r"""
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
#include "frame_host.cu"
// 1 if the last launch was frame_lod_kernel's stopless instance, 0 if its
// stop instance, -1 if another kernel
extern "C" int vhx_last_lod_stopless() {
    if (vhx_launched == (const void*)&frame_lod_kernel<false, false>) return 1;
    return vhx_launched == (const void*)&frame_lod_kernel<true, false> ? 0 : -1;
}
"""

BG = (0.1, 0.2, 0.3)
RES = (43, 29)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("kernels_host_lod")
    (d / "cuda_runtime.h").write_text(SHIM)
    for header in ("traverse.cuh", "frame.cuh", "skip.cuh"):
        shutil.copy(os.path.join(CSRC, header), d)
    entry = re.compile(r"(\w+(?:<[\w ,]+>)?)<<<(.*?)>>>\((.*?)\);", flags=re.S)

    def sub(m):
        return (f"{{ vhx_launched = (const void*)({m.group(1)}); "
                f"vhx_host_launch({m.group(2)}, [&] {{ {m.group(1)}({m.group(3)}); }}); }}")

    with open(os.path.join(CSRC, "frame.cu")) as f:
        (d / "frame_host.cu").write_text(entry.sub(sub, f.read()))
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libkernels_host_lod.so"
    out = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
         "-fPIC", "-shared", f"-I{d}", "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    from voxelhex_tpu_torch.ops import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    frame_p, lod_p = ctypes.POINTER(_build.FrameParams), ctypes.POINTER(_build.LodParams)
    for name in ("vhx_render_frame_lod", "vhx_render_frame_lod_stopless"):
        getattr(lib, name).argtypes = [p, p, p, i, frame_p, lod_p, p, i, p]
    for name in ("vhx_render_frame_lod", "vhx_render_frame_lod_stopless",
                 "vhx_last_lod_stopless"):
        getattr(lib, name).restype = i
    return lib


@pytest.fixture(scope="module")
def world():
    """test_lod_kernel_source_equals_plain's 64^3 grid (3 levels) and camera."""
    from voxelhex_tpu_torch.render.camera import orbit_camera

    return _grid(64, 0.02, 3, mip=True), orbit_camera(64.0, yaw_deg=30.0, distance_factor=1.3,
                                                      resolution=RES)


def _launch(lib, tree, cam, scale, stop=None):
    """The frame at ``scale`` of the C entry that ``render_lod`` chooses
    (``lod_stopless``), or of the stop instance's if ``stop``, and whether
    the stopless instance was launched."""
    from voxelhex_tpu_torch.ops.frame import frame_params, lod_params, lod_stopless

    out = torch.full((RES[1], RES[0], 3), 7.0)
    fp, lp = frame_params(tree, cam, BG), lod_params(tree, scale)
    if stop is None:
        stop = not lod_stopless(fp, lp)
    entry = lib.vhx_render_frame_lod if stop else lib.vhx_render_frame_lod_stopless
    assert entry(tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(),
                 tree["palette"].data_ptr(), tree["palette"].shape[0], fp, lp, out.data_ptr(), 0,
                 None) == 0
    stopless = lib.vhx_last_lod_stopless()
    assert stopless == (not stop)
    return out, bool(stopless)


@pytest.mark.parametrize("scale", [0.0, 0.04, 0.3, float("inf"), -1.0, float("nan"), 1e-3,
                                   1e-30, 1e-45])
def test_lod_instances_equal_plain(host_lib, world, scale):
    """Each scale's frame through the C entry equals render_lod_plain.  The
    stopless instance is chosen where no step can stop above level 0: a
    scale not above 0, a subnormal one (XLA:CPU's 0), one whose every stop
    distance is infinite (1e-30); there the stop instance gives the same
    frame.  The stop instance at the others, 1e-3 included, whose stop
    distances lie beyond the frame's."""
    from voxelhex_tpu_torch.ops.frame import render_lod_plain

    tree, cam = world
    out, stopless = _launch(host_lib, tree, cam, scale)
    assert stopless == (not scale > 1e-30)
    want = render_lod_plain(tree, cam, scale, BG)
    assert _equal(out, want)
    if stopless:
        assert _equal(_launch(host_lib, tree, cam, scale, stop=True)[0], want)


@pytest.mark.parametrize("scale", [0.04, 0.3])
def test_lod_stop_instance_stops_across_thresholds(host_lib, world, scale):
    """The stop instance against the stopless one and the plain march: its
    frame differs from the stopless frame where hits stop above level 0,
    some rays cross a stop level's threshold between their entry and their
    hit, and the rays whose hits stop above level 0 keep their level's MIP
    color."""
    from voxelhex_tpu_torch.ops.frame import lod_tracer, render_lod_plain
    from voxelhex_tpu_torch.render.bitgrid import lod_stop_level
    from voxelhex_tpu_torch.render.camera import device_rays

    tree, cam = world
    out, stopless = _launch(host_lib, tree, cam, scale)
    flat, flat_stopless = _launch(host_lib, tree, cam, 0.0)
    assert not stopless and flat_stopless
    assert _equal(out, render_lod_plain(tree, cam, scale, BG))
    o, d = device_rays(cam, "cpu")
    trace = lod_tracer(tree, scale)
    st0 = trace.init(tree, o, d)
    st = trace.run(tree, trace.init(tree, o, d), 2048)
    above = (st["hit"] & (st["hlev"] > 0)).reshape(RES[1], RES[0])
    assert int(above.sum()) > 20
    assert bool((out != flat).any(dim=-1)[above].any())

    def stop(point):
        x = point - o
        dist = torch.sqrt((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2])
        return lod_stop_level(dist * np.float32(scale), 2)

    assert int((st["hit"] & (stop(st["point"]) > stop(st0["point"]))).sum()) > 0


def test_lod_stopless_at_infinite_entries_needs_a_finite_camera(world):
    """Where every stop distance is +inf, the stopless instance is chosen
    only for a camera whose coordinates lie under 2^62, so that no squared
    distance on an occupied cell overflows to +inf; where every entry is
    NaN, for any camera."""
    from voxelhex_tpu_torch.ops.frame import frame_params, lod_params, lod_stopless

    tree, cam = world
    fp, tiny, flat = frame_params(tree, cam, BG), lod_params(tree, 1e-30), lod_params(tree, 0.0)
    assert lod_stopless(fp, tiny) and lod_stopless(fp, flat)
    for far in (2.0**62, float("inf"), float("nan")):
        fp.origin[0] = far
        assert not lod_stopless(fp, tiny) and lod_stopless(fp, flat)
    assert not lod_stopless(frame_params(tree, cam, BG), lod_params(tree, 1e-3))
