"""The composite backward and the skip far frame: their CUDA sources compiled
for the host and run on the CPU, through their C entries, against their
plain PyTorch versions.

As ``tests/test_torch_kernels_host.py`` does (whose stand-in header for the
CUDA names this file shares), each source is built with the host compiler
and each C entry's launch is rewritten into a loop over the grid: the
composite's into ``vhx_host_warp_launch``, which runs each warp's 32 lanes
as threads that meet in each warp intrinsic (the backward's
``__match_any_sync``, shuffles and votes), with the f32 atomics taken one
at a time and counted; the far frame's into ``vhx_host_launch``, its
threads in turn.  The composite's gradients hold the plain version's
within its tolerance (the atomics add in no fixed order) and its atomics
equal ``backward_adds``'s count from the data; the far frames equal
``far_frame_plain`` bit for bit.  Skips where there is no C++ compiler.
"""

import ctypes
import functools
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_kernels_host import CSRC, SHIM, _soft_inputs
from test_torch_kernels_host_lod_skip import _equal, _far_case

HARNESS = r"""
#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local VhxWarp* vhx_warp = nullptr;
thread_local VhxBlock* vhx_block = nullptr;
std::mutex vhx_host_atomic_lock;
long long vhx_host_atomics = 0;
extern "C" long long host_atomics() { return vhx_host_atomics; }
std::condition_variable vhx_flag_cv;
long long vhx_host_polls = 0;
#include "frame.cuh"
#include "skip.cuh"
namespace comp {
#include "composite_host.cu"
}
namespace farn {
#include "far_host.cu"
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("kernels_host_composite_far")
    (d / "cuda_runtime.h").write_text(SHIM)
    for header in ("traverse.cuh", "frame.cuh", "skip.cuh"):
        shutil.copy(os.path.join(CSRC, header), d)
    # each launch in a C entry becomes a call of the launcher over the grid
    entry = re.compile(r"(\w+(?:<[\w ,]+>)?)<<<(.*?)>>>\((.*?)\);", flags=re.S)
    for name, launcher, n_launches in (("composite", "vhx_host_warp_launch", 2),
                                       ("far", "vhx_host_launch", 4)):
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            src, n = entry.subn(
                lambda m: f"{launcher}({m.group(2)}, [&] {{ {m.group(1)}({m.group(3)}); }});",
                f.read())
        assert n == n_launches
        (d / f"{name}_host.cu").write_text(src)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libkernels_host_composite_far.so"
    out = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
         "-fPIC", "-shared", f"-I{d}", "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    from voxelhex_tpu_torch.ops import _build

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vhx_composite_backward.argtypes = [p, p, p, p, p, i, i, i, ctypes.POINTER(f), p, p, i,
                                           p]
    lib.vhx_render_far_skip.argtypes = [ctypes.POINTER(_build.FarParams), i, p, i, p, p, i, p]
    for name in ("vhx_composite_backward", "vhx_render_far_skip"):
        getattr(lib, name).restype = i
    lib.host_atomics.restype = ctypes.c_longlong
    return lib


# ---- the composite backward

SIZE = 16


@functools.lru_cache(maxsize=None)
def _composite_case(K, packed, seed=0):
    """Params, recorded voxels, counts and dL/drgb of 600 rays (18 whole
    warps and a ragged one): the multi-hit march of random rays, with warp
    0's 32 rays all on one voxel in every slot, warp 1's rays all missing,
    and, unless ``packed``, the slots reversed (empty slots first).  Shared
    between tests: not to be changed."""
    albedo, logits, voxels, grad = _soft_inputs(SIZE, K, 7 + K + seed)
    voxels, grad = voxels[:600].clone(), grad[:600].contiguous()
    voxels[:32] = torch.tensor([5, 6, 7], dtype=torch.int32)
    voxels[32:64] = -1
    count = (voxels[..., 0] >= 0).sum(dim=1).to(torch.int32)
    if not packed:
        voxels = voxels.flip(1).contiguous()
        assert K == 1 or bool(((voxels[:, 0, 0] < 0) & (voxels[:, -1, 0] >= 0)).any())
    return albedo, logits, voxels, count, grad


def _host_backward(host_lib, grad, albedo, logits, voxels, count, bg, init=None,
                   need=(True, True)):
    """The C entry's gradients, added into zeros (as the wrapper calls it)
    or into ``init``, and the atomics it issued."""
    R, K = voxels.shape[0], voxels.shape[1]
    g = [None if not n else (torch.zeros_like(t) if init is None else init[j].clone())
         for j, (n, t) in enumerate(zip(need, (albedo, logits)))]
    bg_arg = None if bg is None else (ctypes.c_float * 3)(*bg)
    n0 = host_lib.host_atomics()
    assert host_lib.vhx_composite_backward(
        grad.data_ptr(), albedo.data_ptr(), logits.data_ptr(), voxels.data_ptr(),
        None if count is None else count.data_ptr(), R, K, SIZE, bg_arg,
        None if g[0] is None else g[0].data_ptr(), None if g[1] is None else g[1].data_ptr(),
        0, None) == 0
    return g[0], g[1], host_lib.host_atomics() - n0


def _assert_close(got, ref):
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-6 * scale)
    assert bool(((got == 0) == (ref == 0)).all())  # the same voxels receive gradient


@pytest.mark.parametrize("K", [1, 2, 6])
@pytest.mark.parametrize("bg", [None, (0.25, 0.5, 0.75)])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("with_count", [True, False])
def test_composite_backward_source_equals_plain(host_lib, K, bg, packed, with_count):
    """The backward through its C entry (a warp's lanes as threads meeting
    in its intrinsics) against composite_backward_plain,
    with the march's count and without; its atomics against
    backward_adds.  Warp 0 (32 rays on one voxel) adds once a slot, warp 1
    (no hit) not at all."""
    from voxelhex_tpu_torch.ops.composite import backward_adds, composite_backward_plain

    albedo, logits, voxels, count, grad = _composite_case(K, packed)
    R = voxels.shape[0]
    assert R % 32 != 0
    valid = voxels[..., 0] >= 0
    addr = voxels[..., 0] + voxels[..., 1] * SIZE + voxels[..., 2] * SIZE * SIZE
    assert {0, 1} <= set((3 * addr[valid] % 2).tolist())  # both parities of 3 addr
    cnt = count if with_count else None
    ga, gl, adds = _host_backward(host_lib, grad, albedo, logits, voxels, cnt, bg)
    wa, wl = composite_backward_plain(grad, albedo, logits, voxels, SIZE, bg, count=cnt)
    assert int((wl != 0).sum()) > 100
    _assert_close(ga, wa)
    _assert_close(gl, wl)
    want_adds, hit_slots = backward_adds(voxels, SIZE, cnt)
    assert adds == want_adds
    assert hit_slots == int(valid.sum())
    # warp 0: one logit and two albedo adds a slot; warp 1: none
    assert backward_adds(voxels[:32], SIZE, count[:32])[0] == 3 * K
    assert backward_adds(voxels[32:64], SIZE, count[32:64])[0] == 0
    assert want_adds < 3 * hit_slots  # lanes merged their adds


@pytest.mark.parametrize("need", [(True, False), (False, True)])
def test_composite_backward_source_one_gradient(host_lib, need):
    """A gradient that is not wanted (null) is not added to; the other
    equals the plain version's."""
    from voxelhex_tpu_torch.ops.composite import backward_adds, composite_backward_plain

    albedo, logits, voxels, count, grad = _composite_case(2, True, seed=1)
    ga, gl, adds = _host_backward(host_lib, grad, albedo, logits, voxels, count, None,
                                  need=need)
    wa, wl = composite_backward_plain(grad, albedo, logits, voxels, SIZE, None, *need, count)
    for got, ref in ((ga, wa), (gl, wl)):
        assert (got is None) == (ref is None)
        if got is not None:
            _assert_close(got, ref)
    assert adds == backward_adds(voxels, SIZE, count, *need)[0]


def test_composite_backward_source_adds_into(host_lib):
    """The entry adds into what the gradients hold."""
    from voxelhex_tpu_torch.ops.composite import composite_backward_plain

    albedo, logits, voxels, count, grad = _composite_case(2, True, seed=2)
    rng = np.random.default_rng(3)
    init = [torch.from_numpy(rng.normal(0, 1e-3, t.shape).astype(np.float32))
            for t in (albedo, logits)]
    ga, gl, _adds = _host_backward(host_lib, grad, albedo, logits, voxels, count, None,
                                   init=init)
    wa, wl = composite_backward_plain(grad, albedo, logits, voxels, SIZE, count=count)
    for got, ref, start in ((ga, wa, init[0]), (gl, wl, init[1])):
        want = start + ref
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(want.abs().max()))
        assert not torch.equal(got, start)


def test_composite_backward_count_zero_reads_no_slot(host_lib):
    """A ray of count 0 adds nothing, whatever its slots hold (the kernel
    does not read them): the plain version with the same count agrees."""
    from voxelhex_tpu_torch.ops.composite import composite_backward_plain

    albedo, logits, voxels, count, grad = _composite_case(2, True, seed=3)
    hit = torch.nonzero(count > 0).flatten()
    count = count.clone()
    count[hit[::3]] = 0  # slots with voxels, but a count of 0
    ga, gl, _adds = _host_backward(host_lib, grad, albedo, logits, voxels, count, None)
    wa, wl = composite_backward_plain(grad, albedo, logits, voxels, SIZE, count=count)
    full = composite_backward_plain(grad, albedo, logits, voxels, SIZE)
    _assert_close(ga, wa)
    _assert_close(gl, wl)
    assert not torch.equal(wl, full[1])


# ---- the skip far frame


@pytest.mark.parametrize("depths", [(3, 2), (2, 2, 1)])
@pytest.mark.parametrize("inside", [True, False])
@pytest.mark.parametrize("substeps", [3, 2])
def test_far_skip_instances_equal_plain(host_lib, depths, inside, substeps):
    """Each instance of far_skip_kernel through vhx_render_far_skip: the
    camera inside the window and outside, 3 substeps (an instance of its
    own) and 2, with and without the window's start map, u8 and f32, over
    layers of the window's depth and one less, against far_frame_plain bit
    for bit."""
    from voxelhex_tpu_torch.ops.far import far_frame_plain, far_params

    layers = _far_case(depths, inside)
    bg = (0.1, 0.2, 0.3)
    rng = np.random.default_rng(9)
    start = torch.from_numpy(rng.uniform(0, 30, (6, 10)).astype(np.float32))
    for out_u8, st in ((True, None), (False, None), (True, start), (False, start)):
        out = torch.full((21, 37, 3), 7, dtype=torch.uint8 if out_u8 else torch.float32)
        assert host_lib.vhx_render_far_skip(
            far_params(layers, inside, bg, skip=True), substeps,
            None if st is None else st.data_ptr(), 4, None if out_u8 else out.data_ptr(),
            out.data_ptr() if out_u8 else None, 0, None) == 0
        want = far_frame_plain(layers, inside, bg, out_u8, start=st, start_tile=4,
                               skip_substeps=substeps)
        assert _equal(out, want), (out_u8, st is None)
    assert len(torch.unique(want.reshape(-1, 3), dim=0)) >= 3
