"""The batched flat-tree kernels (``csrc/flat.cu``: ``flat_wavefront_kernel``
and every form of ``flat_fast_kernel``) on frames: warps on 4 x 8 pixel
tiles or on rows, products by exact inverses (``pow2``) or divisions.

The source is compiled for the host as ``tests/test_torch_kernels_host_flat.
py`` compiles it (each launch a loop over the grid, the threads in turn)
and held bit for bit to the plain tracers on frames of odd and even sides,
with and without the frame's width, at the default caps and at 9 bodies,
over trees whose world edge is a power of two and over one whose edge is
not (the division route).  The inverses themselves are held to the
division and ``fmodf`` on the corners and edges the plain marches see.
Also ``trace_fast``'s refusal of two starts.  Skips where there is no C++
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
from test_torch_kernels_host_flat import HARNESS, SCENES, _equal_all, _same, make_flat

PROBES = r"""
extern "C" void vhx_probe_corner(int n, const float* x, const float* p, float* pow2,
                                 float* div) {
    for (int i = 0; i < n; ++i) {
        pow2[i] = vhx::flat::parent_corner<true>(x[i], p[i]);
        div[i] = vhx::flat::parent_corner<false>(x[i], p[i]);
    }
}
extern "C" void vhx_probe_div(int n, const float* x, const float* e, float* pow2, float* div) {
    for (int i = 0; i < n; ++i) {
        pow2[i] = vhx::flat::div_edge<true>(x[i], e[i]);
        div[i] = vhx::flat::div_edge<false>(x[i], e[i]);
    }
}
extern "C" void vhx_probe_sectant(int n, const float* off, const float* e, int* pow2, int* div) {
    for (int i = 0; i < n; ++i) {
        pow2[i] = vhx::flat::sectant_in<true>(off + 3 * i, e[i]);
        div[i] = vhx::flat::sectant_in<false>(off + 3 * i, e[i]);
    }
}
"""

RESOLUTIONS = [(32, 20), (30, 18), (37, 21)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("kernels_host_flat_tiles")
    (d / "cuda_runtime.h").write_text(SHIM)
    shutil.copy(os.path.join(CSRC, "traverse.cuh"), d)
    entry = re.compile(r"(\w+(?:<[\w ,]+>)?)<<<(.*?)>>>\((.*?)\);", flags=re.S)
    with open(os.path.join(CSRC, "flat.cu")) as f:
        src = entry.sub(lambda m: f"vhx_host_launch({m.group(2)}, [&] {{ "
                                  f"{m.group(1)}({m.group(3)}); }});", f.read())
    (d / "flat_host.cu").write_text(src)
    (d / "harness.cpp").write_text(HARNESS + PROBES)
    so = d / "libkernels_host_flat_tiles.so"
    out = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
         "-fPIC", "-shared", f"-I{d}", "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    from voxelhex_tpu_torch.ops import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    params = ctypes.POINTER(_build.FlatParams)
    for name in ("vhx_flat_wavefront", "vhx_flat_fast"):
        getattr(lib, name).argtypes = [params, p, p, i, p, p, p, p, p, p, i, p]
        getattr(lib, name).restype = i
    lib.vhx_flat_fast_depth.argtypes = [params, p, p, i, p, i, p]
    lib.vhx_flat_fast_depth.restype = i
    for name in ("vhx_probe_corner", "vhx_probe_div", "vhx_probe_sectant"):
        getattr(lib, name).argtypes = [i, p, p, p, p]
    assert lib.vhx_flat_params_size() == ctypes.sizeof(_build.FlatParams)
    return lib


# the host tests' scenes, and the d4 tree at a world edge of 60 (not a power
# of two: the division route)
TILE_SCENES = sorted(SCENES) + ["d4_edge60"]


@pytest.fixture(scope="module")
def flats():
    out = {k: make_flat(s, d, n, seed, solid=k == "solid") for k, (s, d, n, seed) in SCENES.items()}
    out["d4_edge60"] = out["d4"]
    return out


def _trees(flats, scene):
    """``(device_tree, packed tree, edge)`` of a scene on the CPU, the d4
    tree's dicts given a world edge of 60 by hand for ``d4_edge60``."""
    from voxelhex_tpu_torch.render.fast import pack_device_tree
    from voxelhex_tpu_torch.render.jax_renderer import device_tree

    flat = flats[scene]
    wf, fast = device_tree(flat, "cpu"), pack_device_tree(flat, "cpu")
    if scene == "d4_edge60":
        wf["size"] = fast["size"] = 60.0
    return wf, fast, wf["size"]


def _frame_rays(edge, res, yaw=30.0):
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.render.jax_renderer import rays_on

    return rays_on(*orbit_camera(float(edge), yaw_deg=yaw, resolution=res).rays(), "cpu")


def _launch(lib, name, params, o, d, depth=False):
    R = o.shape[0]
    if depth:
        out = torch.full((R,), 7.0)
        assert lib.vhx_flat_fast_depth(ctypes.byref(params), o.data_ptr(), d.data_ptr(), R,
                                       out.data_ptr(), 0, None) == 0
        return out
    outs = (torch.zeros(R, dtype=torch.bool), torch.full((R,), 7, dtype=torch.int32),
            torch.full((R,), 7, dtype=torch.int32), torch.full((R,), 7, dtype=torch.int32),
            torch.full((R, 3), 7.0), torch.full((R, 3), 7.0))
    assert getattr(lib, name)(ctypes.byref(params), o.data_ptr(), d.data_ptr(), R,
                              *(t.data_ptr() for t in outs), 0, None) == 0
    return outs


@pytest.mark.parametrize("res", RESOLUTIONS)
@pytest.mark.parametrize("scene", TILE_SCENES)
@pytest.mark.parametrize("limit", [4096, 9])
def test_batched_kernels_on_tiles_equal_plain(host_lib, flats, scene, res, limit):
    """Every form of the two batched kernels, on rows and on the frame's
    tiles, against its plain tracer on every ray of a frame: the wavefront,
    the fast kernel from the entry point, from a start a ray and its depth
    form, and on even frames the prepassed frame's two launches (the
    half-res depths, the full-res march from their pooled starts)."""
    from voxelhex_tpu_torch.ops.flat import flat_params
    from voxelhex_tpu_torch.render.fast import (
        PREPASS_ENTRY_FMA,
        make_fast_tracer,
        prepass_depth,
        start_from_depth,
    )
    from voxelhex_tpu_torch.render.wavefront import make_wavefront_tracer

    wf, fast, edge = _trees(flats, scene)
    D = flats[scene].brick_dim
    w, h = res
    o, d = _frame_rays(edge, res)
    params = lambda tree, frame, *a: flat_params(tree, D, limit, *a, frame=frame)  # noqa: E731
    assert params(fast, (0, 0)).pow2 == int(scene != "d4_edge60")
    want_wf = make_wavefront_tracer(D, limit)(wf, o, d)
    trace = make_fast_tracer(D, limit)
    want = trace(fast, o, d)
    start = torch.from_numpy(np.random.default_rng(15).random(w * h).astype(np.float32)
                             * np.float32(edge))
    want_start = trace(fast, o, d, start)
    for frame in ((0, 0), (w, h)):
        _equal_all(_launch(host_lib, "vhx_flat_wavefront", params(wf, frame), o, d), want_wf)
        _equal_all(_launch(host_lib, "vhx_flat_fast", params(fast, frame), o, d), want)
        depth = _launch(host_lib, "", params(fast, frame), o, d, depth=True)
        assert _same(depth, prepass_depth(want[0], want[4], o))
        _equal_all(_launch(host_lib, "vhx_flat_fast", params(fast, frame, start), o, d),
                   want_start)
    if w % 2 or h % 2:
        return
    po, pd = _frame_rays(edge, (w // 2, h // 2))
    p = trace(fast, po, pd)
    dmap = prepass_depth(p[0], p[4], po)
    want = make_fast_tracer(D, limit, entry_fma=PREPASS_ENTRY_FMA)(
        fast, o, d, start_from_depth(dmap, h // 2, w // 2))
    for frame, half_frame in (((0, 0), (0, 0)), ((w, h), (w // 2, h // 2))):
        got = _launch(host_lib, "", params(fast, half_frame), po, pd, depth=True)
        assert _same(got, dmap)
        pooled = flat_params(fast, D, limit, dmap, w, (h // 2, w // 2), frame)
        _equal_all(_launch(host_lib, "vhx_flat_fast", pooled, o, d), want)
    if limit == 4096 and scene != "solid":
        assert int(want[0].sum()) > 10


def test_tile_launch_refuses_a_frame_of_other_rays(host_lib, flats):
    """A launch whose frame is not its rays' count is refused."""
    from voxelhex_tpu_torch.ops.flat import flat_params

    _wf, fast, edge = _trees(flats, "d4")
    o, d = _frame_rays(edge, (30, 18))
    R = o.shape[0]
    out = torch.zeros(R)
    for frame in ((31, 18), (30, 0)):
        p = flat_params(fast, 4, 4096, frame=frame)
        assert host_lib.vhx_flat_fast_depth(ctypes.byref(p), o.data_ptr(), d.data_ptr(), R,
                                            out.data_ptr(), 0, None) != 0


def _march_values(tree, o, d, cfg, turns=60):
    """The node corners, edges and offsets of every body of a plain march:
    ``(corners, parent edges, offsets [n, 3], their edges, brick cell
    numerators, brick edges)``, turn by turn."""
    from voxelhex_tpu_torch.render.wavefront import LockstepConfig, lockstep_init, lockstep_run

    one = LockstepConfig(cfg.d, 1, cfg.max_restarts, cfg.packed, cfg.bitmap, cfg.brick_substeps,
                         cfg.advance_substeps, cfg.entry_fma)
    st = lockstep_init(tree, o, d, cfg)
    keep = {k: [] for k in ("corner", "parent", "off", "edge", "cell", "bsize")}
    for _ in range(turns):
        keep["corner"].append(st["cur_min"].reshape(-1))
        keep["parent"].append((st["cur_size"] * 4.0).repeat_interleave(3))
        for off, edge in ((st["point"] - st["tmin"], st["tsize"]),
                          (st["point"] - st["cur_min"], st["cur_size"]),
                          (st["cur_min"] + (st["cur_size"] / 2)[:, None]
                           - (st["cur_min"] - torch.fmod(st["cur_min"],
                                                         (st["cur_size"] * 4)[:, None])),
                           st["cur_size"] * 4)):
            keep["off"].append(off)
            keep["edge"].append(edge)
        keep["cell"].append(((st["point"] - st["bmin"]) * cfg.d).reshape(-1))
        keep["bsize"].append(st["bsize"].repeat_interleave(3))
        if bool((st["phase"] == 2).all()):
            break
        st = lockstep_run(tree, st, one)
    return {k: torch.cat(v) for k, v in keep.items()}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_inverses_equal_divisions(host_lib, flats, scene):
    """The pow2 route's block_floor and products by inverses against
    fmodf's corner and the IEEE divisions: on every node corner, offset
    and edge that the plain wavefront and fast marches of a frame see, and
    on seeded random corners (multiples of each edge of the world) and
    offsets."""
    from voxelhex_tpu_torch.render.fast import make_fast_tracer
    from voxelhex_tpu_torch.render.wavefront import make_wavefront_tracer

    wf, fast, edge = _trees(flats, scene)
    D = flats[scene].brick_dim
    o, d = _frame_rays(edge, (30, 18), yaw=70.0)
    seen = [_march_values(wf, o, d, make_wavefront_tracer(D).config),
            _march_values(fast, o, d, make_fast_tracer(D).config)]
    rng = np.random.default_rng(16)
    edges = np.float32(edge) / np.float32(4.0) ** np.arange(0, 5, dtype=np.float32)
    k = rng.integers(0, 4 ** 5, 4000)
    e = rng.choice(edges, 4000).astype(np.float32)
    corners = torch.from_numpy((k % (np.float32(edge) / e).astype(np.int64)).astype(np.float32)
                               * e)
    parents = torch.from_numpy(np.minimum(e * 4, np.float32(edge) * 4))
    offs = torch.from_numpy((rng.random((4000, 3)) * e[:, None] * 1.25).astype(np.float32))
    seen.append({"corner": corners, "parent": parents, "off": offs,
                 "edge": torch.from_numpy(e), "cell": offs.reshape(-1) * D,
                 "bsize": torch.from_numpy(e).repeat_interleave(3)})
    for v in seen:
        n = v["corner"].numel()
        a, b = torch.zeros(n), torch.ones(n)
        host_lib.vhx_probe_corner(n, v["corner"].contiguous().data_ptr(),
                                  v["parent"].contiguous().data_ptr(), a.data_ptr(), b.data_ptr())
        assert _same(a, b)
        n = v["cell"].numel()
        a, b = torch.zeros(n), torch.ones(n)
        host_lib.vhx_probe_div(n, v["cell"].contiguous().data_ptr(),
                               v["bsize"].contiguous().data_ptr(), a.data_ptr(), b.data_ptr())
        assert _same(a, b)
        off, e_off = torch.cat([v["off"].reshape(-1, 3)]), v["edge"].reshape(-1)
        n = e_off.numel()
        si, sj = torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.int32)
        host_lib.vhx_probe_sectant(n, off.contiguous().data_ptr(), e_off.contiguous().data_ptr(),
                                   si.data_ptr(), sj.data_ptr())
        assert bool((si == sj).all())
    assert seen[0]["corner"].numel() > 1000
    if scene != "d8":  # a world of one leaf node: its march never leaves the root
        assert bool((seen[0]["corner"] > 0).any()) and bool((seen[1]["corner"] > 0).any())


def test_trace_fast_refuses_both_starts():
    """Given ``start_t`` and ``start_depth`` together, ``trace_fast`` raises
    before either route (the CPU route once took the depths, the card's
    ``start_t``)."""
    from voxelhex_tpu_torch.ops.flat import trace_fast
    from voxelhex_tpu_torch.render.fast import pack_device_tree

    fast = pack_device_tree(make_flat(64, 4, 50, 9), "cpu")
    o, d = _frame_rays(64.0, (8, 6))
    start = torch.zeros(48)
    dmap = torch.ones(12)
    with pytest.raises(ValueError, match="not both"):
        trace_fast(fast, 4, o, d, start_t=start, start_depth=(dmap, 3, 4))
    with pytest.raises(ValueError, match="not both"):
        trace_fast(fast, 4, o, d, start_t=start, start_depth=(dmap, 3, 4), depth=True)
    got = trace_fast(fast, 4, o, d, start_depth=(dmap, 3, 4))
    assert got[0].shape == (48,)


@pytest.mark.parametrize("width", [0, 7, 100])
def test_trace_wrappers_refuse_a_frame_of_other_rays(width):
    """``_width`` must divide the rays into whole rows, on both routes."""
    from voxelhex_tpu_torch.ops.flat import trace_fast, trace_wavefront
    from voxelhex_tpu_torch.render.fast import pack_device_tree
    from voxelhex_tpu_torch.render.jax_renderer import device_tree

    flat = make_flat(64, 4, 50, 9)
    o, d = _frame_rays(64.0, (8, 6))
    with pytest.raises(ValueError, match="_width"):
        trace_fast(pack_device_tree(flat, "cpu"), 4, o, d, _width=width)
    with pytest.raises(ValueError, match="_width"):
        trace_wavefront(device_tree(flat, "cpu"), 4, o, d, _width=width)


@pytest.mark.parametrize("x,want", [(64.0, True), (1.0, True), (2.0 ** 30, True),
                                    (60.0, False), (0.5, False), (2.0 ** 31, False),
                                    (0.0, False), (float("inf"), False)])
def test_is_pow2(x, want):
    """The host's check for the kernels' products by inverses."""
    from voxelhex_tpu_torch.ops.flat import is_pow2

    assert is_pow2(x) is want


def test_warp_moves_counts_rows_and_tiles():
    """``warp_moves`` on a hand-made record of an 8 x 8 frame: two warps
    either way; in turn 0 every ray takes a BRICK body of 2 cell steps but
    ray 0 a POP, in turn 1 rays 3 and 35 (column 3, rows 0 and 4) take an
    ADVANCE of 2 substeps, in two warps of 32 in a row but in one 4 x 8
    tile."""
    from voxelhex_tpu_torch.render.wavefront import (
        MOVE_ADVANCE,
        MOVE_BRICK,
        MOVE_DDA,
        MOVE_POP,
        warp_moves,
    )

    t0 = torch.full((64,), MOVE_BRICK + 2 * MOVE_DDA, dtype=torch.int8)
    t0[0] = MOVE_POP + MOVE_DDA
    t1 = torch.zeros(64, dtype=torch.int8)
    t1[[3, 35]] = MOVE_ADVANCE + 2 * MOVE_DDA
    rows = warp_moves([t0, t1], 8, 8)
    tiles = warp_moves([t0, t1], 8, 8, (4, 8))
    assert rows == {"warps": 2, "turns": 4, "lane_turns": 66, "dda_shared": 8,
                    "dda_branches": 9, "working": 66 / 128}
    assert tiles == {"warps": 2, "turns": 3, "lane_turns": 66, "dda_shared": 6,
                     "dda_branches": 7, "working": 66 / 96}
    with pytest.raises(ValueError, match="32 lanes"):
        warp_moves([t0], 8, 8, (4, 4))


@pytest.mark.parametrize("tracer", ["wavefront", "fast"])
def test_move_record_matches_the_march(flats, tracer):
    """The plain marches' move record: a body for each ray each turn until
    it is done (as many as its ``steps``), each of a known kind with no
    more DDA steps than its substeps allow, a restart flagged where the
    stack ran dry; the march's outputs are unchanged by recording."""
    from voxelhex_tpu_torch.render.fast import make_fast_tracer
    from voxelhex_tpu_torch.render.wavefront import (
        MOVE_BRICK,
        MOVE_DDA,
        MOVE_RESTART,
        make_wavefront_tracer,
        warp_moves,
    )

    wf, fast, edge = _trees(flats, "d4")
    o, d = _frame_rays(edge, (32, 20), yaw=50.0)
    trace, tree, cells = ((make_wavefront_tracer(4), wf, 1) if tracer == "wavefront"
                          else (make_fast_tracer(4), fast, 4))
    rec = {"moves": []}
    got = trace(tree, o, d, record=rec)
    for a, b in zip(got, trace(tree, o, d)):
        assert _same(a, b)
    m = torch.stack(rec["moves"]).long()
    kind, dda = m & 7, (m // MOVE_DDA) & 7
    assert bool(((kind > 0).sum(dim=0) == rec["steps"]).all())
    assert bool((kind <= 5).all()) and int((m & MOVE_RESTART).sum()) > 0
    assert int(dda[kind == MOVE_BRICK].max()) == cells
    stats = warp_moves(rec["moves"], 32, 20)
    assert stats["lane_turns"] == int(rec["steps"].sum()) and stats["warps"] == 20
    assert warp_moves(rec["moves"], 32, 20, (4, 8))["warps"] == 24
    assert stats["dda_shared"] <= stats["dda_branches"]
