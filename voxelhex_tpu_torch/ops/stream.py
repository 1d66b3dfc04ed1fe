"""The streaming view's device updates: the CUDA kernels of
``csrc/stream.cu`` and their wrappers, each beside its plain PyTorch
version.

* :func:`region_scatter` writes paged regions into the resident window
  (the reference's ``_make_region_scatter``,
  ``voxelhex_tpu/render/streaming.py:42``);
* :func:`coarse_rebuild` rebuilds the pyramid's levels above level 0
  (``_make_coarse_rebuild``, ``:114``, with ``_jnp_pack_bits``, ``:89``);
* :func:`window_shift` moves the window's colors and level-0 word pairs
  when the window moves (``roll_zero`` in ``_shift_device``, ``:1073``);
* :func:`refresh_skip_rows` derives the skip tracer's rows from the word
  pairs after they change (``_skip_rows_from_pairs_jit``,
  ``voxelhex_tpu/render/bitgrid.py:848``, which the reference runs at
  ``streaming.py:432-441`` and ``:1359-1382``).

The window is a :func:`~voxelhex_tpu_torch.render.bitgrid.device_bitgrid`
dict: ``colors`` int16 [S^3] (u16 bit patterns, x fastest), ``occ_pairs``
int32 [B, 2] (u32 bit patterns), ``bases`` and ``dims``.  A wrapper runs
the plain version for CPU tensors and launches the kernel for CUDA ones.
"""

from __future__ import annotations

import ctypes
import types

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.render.bitgrid import skip_row_index, skip_rows_from_pairs

REGION = 16  # voxels a paged region's edge (render/streaming.py's REGION)
COLOR_EMPTY = 0xFFFF


def _as_i32(words):
    """u32 values held in int64 as their int32 bit patterns."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _as_i16(values):
    """u16 values held in int32 as their int16 bit patterns."""
    return torch.where(values >= 2**15, values - 2**16, values).to(torch.int16)


def check_corners(corners, S: int):
    """Raise ``ValueError`` unless each region corner of ``corners`` [K, 3]
    (NumPy or a tensor, read on the host) is a multiple of 16 in [0, S - 16]
    on every axis, so that its region lies inside the window of edge S."""
    c = (corners.cpu().numpy() if torch.is_tensor(corners) else np.asarray(corners))
    c = c.astype(np.int64).reshape(-1, 3)
    bad = ((c % REGION != 0) | (c < 0) | (c > S - REGION)).any(axis=1)
    if bad.any():
        raise ValueError(f"region corner {c[bad.argmax()].tolist()}: corners are multiples of "
                         f"{REGION} in [0, {S - REGION}] in a window of {S}")


def region_scatter_plain(colors, pairs, corners, col_vals, blk_vals, S: int):
    """The plain scatter (see :func:`region_scatter`), in place; checks the
    corners first (:func:`check_corners`)."""
    check_corners(corners, S)
    K = corners.shape[0]
    c = corners.long()
    r = torch.arange(REGION, dtype=torch.int64, device=corners.device)
    # a wire row is the region's [x, y, z] grid, z fastest
    x = c[:, 0, None, None, None] + r[None, :, None, None]
    y = c[:, 1, None, None, None] + r[None, None, :, None]
    z = c[:, 2, None, None, None] + r[None, None, None, :]
    addr = (x + y * S + z * S * S).reshape(-1)
    v = col_vals.reshape(-1)
    if v.dtype == torch.uint8:
        w = v.int()
        v = _as_i16(torch.where(w == 255, 0xFFFF, torch.where(w == 254, 0xFFFE, w)))
    colors[addr] = v
    # the word pairs are rows of the region's [bz, by, bx] blocks, bx fastest
    n = REGION // 4
    nb = S // 4
    b = torch.arange(n, dtype=torch.int64, device=corners.device)
    bx = c[:, 0, None, None, None] // 4 + b[None, None, None, :]
    by = c[:, 1, None, None, None] // 4 + b[None, None, :, None]
    bz = c[:, 2, None, None, None] // 4 + b[None, :, None, None]
    pairs[(bx + by * nb + bz * nb * nb).reshape(-1)] = blk_vals.reshape(K * n**3, 2)
    return colors, pairs


def region_scatter(tree, corners, col_vals, blk_vals):
    """Write K paged regions into the window ``tree`` in place: ``corners``
    int32 [K, 3] (each region's min voxel, multiples of 16), ``col_vals``
    its colors [K, 16^3] as uint8 (255 empty, 254 colorless) or int16 (u16
    bit patterns), rows of its [x, y, z] grid, and ``blk_vals`` int32 [K,
    64, 2] its level-0 word pairs, rows of its [bz, by, bx] blocks.

    CPU tensors run the plain version, which raises ``ValueError`` for a
    corner off that contract (:func:`check_corners`).  CUDA tensors launch
    the kernel, which relies on the contract and does not check it (that
    would read the corners back to the host): the caller checks its corners
    before they are copied to the card, as ``StreamingView`` does.  The
    kernel also needs every tensor 16 B aligned."""
    colors, pairs, S = tree["colors"], tree["occ_pairs"], int(tree["size"])
    dev = colors.device
    if dev.type == "cpu":
        region_scatter_plain(colors, pairs, corners, col_vals, blk_vals, S)
        return
    if dev.type != "cuda":
        raise ValueError(f"region_scatter runs on cuda or cpu tensors, not {dev}")
    K = corners.shape[0]
    if col_vals.dtype not in (torch.uint8, torch.int16):
        raise ValueError(f"col_vals: uint8 or int16, not {col_vals.dtype}")
    _build.check_inputs(dev, (
        ("colors", colors, torch.int16, (S**3,)),
        ("occ_pairs", pairs, torch.int32, (pairs.shape[0], 2)),
        ("corners", corners, torch.int32, (K, 3)),
        ("col_vals", col_vals, col_vals.dtype, (K, REGION**3)),
        ("blk_vals", blk_vals, torch.int32, (K, (REGION // 4) ** 3, 2)),
    ))
    lib = _build.library()
    err = lib.vhx_region_scatter(colors.data_ptr(), pairs.data_ptr(), corners.data_ptr(),
                                 col_vals.data_ptr(), blk_vals.data_ptr(), K, S,
                                 int(col_vals.dtype == torch.int16), dev.index or 0,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "region scatter launch")
    region_scatter.launches += 1


region_scatter.launches = 0


def _pack_bits(grid):
    """``_jnp_pack_bits`` in PyTorch: bool [c, c, c] (x, y, z) -> (lo, hi)
    int64 [n^3] blocks x fastest, coarse bool [n, n, n]; a level whose cells
    an axis are not a multiple of 4 is padded with empty cells."""
    c = grid.shape[0]
    if c % 4:
        t = (c + 3) // 4 * 4
        padded = torch.zeros((t, t, t), dtype=torch.bool, device=grid.device)
        padded[:c, :c, :c] = grid
        grid, c = padded, t
    n = c // 4
    g = grid.reshape(n, 4, n, 4, n, 4).permute(0, 2, 4, 5, 3, 1)  # [bx, by, bz, z, y, x]
    bits = g.reshape(n, n, n, 64).long()
    sh = torch.arange(32, dtype=torch.int64, device=grid.device)
    lo = (bits[..., :32] << sh).sum(-1)
    hi = (bits[..., 32:] << sh).sum(-1)
    return (lo.permute(2, 1, 0).reshape(-1), hi.permute(2, 1, 0).reshape(-1),
            bits.any(-1))


def coarse_rebuild_plain(pairs, bases, dims):
    """The plain rebuild (see :func:`coarse_rebuild`), in place."""
    nb = int(dims[0])
    occ = (pairs[: nb**3, 0] | pairs[: nb**3, 1]) != 0
    grid = occ.reshape(nb, nb, nb).permute(2, 1, 0)  # flat x fastest -> [x, y, z]
    for level in range(1, len(bases)):
        lo, hi, grid = _pack_bits(grid)
        base = int(bases[level])
        pairs[base: base + lo.shape[0]] = torch.stack([_as_i32(lo), _as_i32(hi)], dim=1)
    return pairs


# the coarse rebuild's ticket counters, one int32 a (device, stream), 0
# between launches: launches on one stream are ordered
_tickets = {}


def _ticket_counter(dev):
    key = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _tickets[key]


def coarse_rebuild(tree):
    """Rebuild every pyramid level above level 0 of the window ``tree`` in
    place from its level-0 word pairs: a bit of a level-(l + 1) word is set
    where its child block's pair at level l is not zero.

    CPU tensors run the plain version; CUDA tensors launch the kernel, once
    for all the levels above level 0 (none for a pyramid of one level)."""
    pairs, bases, dims = tree["occ_pairs"], tree["bases"], tree["dims"]
    dev = pairs.device
    if dev.type == "cpu":
        coarse_rebuild_plain(pairs, bases, dims)
        return
    if dev.type != "cuda":
        raise ValueError(f"coarse_rebuild runs on cuda or cpu tensors, not {dev}")
    _build.check_inputs(dev, (("occ_pairs", pairs, torch.int32, (pairs.shape[0], 2)),))
    n = len(bases)
    if not 1 <= n <= _build.MAX_LEVELS or bases[-1] + dims[-1] ** 3 != pairs.shape[0]:
        raise ValueError(f"a pyramid of {n} levels, bases {bases}, dims {dims} over "
                         f"{pairs.shape[0]} word pairs")
    if n == 1:
        return
    lib = _build.library()
    err = lib.vhx_coarse_rebuild(pairs.data_ptr(), _ints(bases), _ints(dims), n,
                                 _ticket_counter(dev).data_ptr(), dev.index or 0,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "coarse rebuild launch")
    coarse_rebuild.launches += 1


coarse_rebuild.launches = 0


def _ints(values):
    """A C int array of ``values``."""
    return (ctypes.c_int * len(values))(*(int(v) for v in values))


def moved_grid(grid, shift, fill):
    """``grid`` [n, n, n, ...] ([z, y, x]) moved by -shift (x, y, z): out[z,
    y, x] = grid[z + sz, y + sy, x + sx] inside, ``fill`` outside (a new
    tensor)."""
    n = grid.shape[0]
    out = torch.full_like(grid, fill)
    src, dst = [], []
    for s in (int(shift[2]), int(shift[1]), int(shift[0])):  # axes z, y, x
        lo, hi = max(s, 0), min(n + s, n)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst)] = grid[tuple(src)]
    return out


def window_shift_plain(colors, pairs, S: int, shift):
    """The plain shift (see :func:`window_shift`)."""
    nb = S // 4
    empty = COLOR_EMPTY - 2**16  # the empty color's int16 bit pattern
    out_colors = moved_grid(colors.reshape(S, S, S), shift, empty).reshape(-1)
    out_pairs = pairs.clone()
    sb = [int(s) // 4 for s in shift]
    out_pairs[: nb**3] = moved_grid(pairs[: nb**3].reshape(nb, nb, nb, 2), sb, 0).reshape(-1, 2)
    return out_colors, out_pairs


def window_shift(tree, shift):
    """The window ``tree`` moved by ``shift`` (voxels along x, y, z,
    multiples of 4): new ``(colors, occ_pairs)`` tensors in which the
    colors and the level-0 word pairs moved by -shift (by -shift / 4) and
    the slab the move exposes holds the empty color or 0; the other levels
    are copied as they are (:func:`coarse_rebuild` follows).  The inputs are
    not written.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    colors, pairs, S = tree["colors"], tree["occ_pairs"], int(tree["size"])
    shift = [int(s) for s in np.asarray(shift).reshape(3)]
    if any(s % 4 for s in shift):
        raise ValueError(f"shift {shift}: the window moves by whole blocks of 4")
    dev = colors.device
    if dev.type == "cpu":
        return window_shift_plain(colors, pairs, S, shift)
    if dev.type != "cuda":
        raise ValueError(f"window_shift runs on cuda or cpu tensors, not {dev}")
    _build.check_inputs(dev, (
        ("colors", colors, torch.int16, (S**3,)),
        ("occ_pairs", pairs, torch.int32, (pairs.shape[0], 2)),
    ))
    out_colors = torch.empty_like(colors)
    out_pairs = torch.empty_like(pairs)
    lib = _build.library()
    err = lib.vhx_window_shift(colors.data_ptr(), out_colors.data_ptr(), pairs.data_ptr(),
                               out_pairs.data_ptr(), pairs.shape[0], S, *shift,
                               dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "window shift launch")
    window_shift.launches += 1
    return out_colors, out_pairs


window_shift.launches = 0


def skip_rows_plain(pairs, bases, dims, size: int):
    """The plain refresh (see :func:`refresh_skip_rows`): the reference's
    ``skip_rows_from_pairs`` over ``skip_row_index``'s index, a new int32
    tensor ``[n0^3, 2L]``."""
    pyramid = types.SimpleNamespace(size=int(size), n_levels=len(bases), level_bases=bases)
    idx = torch.from_numpy(skip_row_index(pyramid)).to(pairs.device).long()
    return skip_rows_from_pairs(pairs, idx).contiguous()


def refresh_skip_rows(tree):
    """Set ``tree["skip_rows"]`` to the skip rows of ``tree``'s word pairs
    (every level's pair over each level-0 block, as
    :func:`~voxelhex_tpu_torch.render.bitgrid.build_skip_rows` builds them
    on the host), after the pairs changed; the upper levels must be
    current.

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    into the tree's rows when it has rows of the pyramid's shape."""
    pairs, bases, dims, size = tree["occ_pairs"], tree["bases"], tree["dims"], tree["size"]
    dev = pairs.device
    if dev.type == "cpu":
        tree["skip_rows"] = skip_rows_plain(pairs, bases, dims, size)
        return
    if dev.type != "cuda":
        raise ValueError(f"refresh_skip_rows runs on cuda or cpu tensors, not {dev}")
    n = len(bases)
    _build.check_inputs(dev, (("occ_pairs", pairs, torch.int32, (pairs.shape[0], 2)),))
    if not 1 <= n <= _build.MAX_LEVELS or bases[-1] + dims[-1] ** 3 != pairs.shape[0]:
        raise ValueError(f"a pyramid of {n} levels, bases {bases}, dims {dims} over "
                         f"{pairs.shape[0]} word pairs")
    shape = (int(dims[0]) ** 3, 2 * n)
    rows = tree.get("skip_rows")
    if rows is None or rows.device != dev or tuple(rows.shape) != shape or \
            rows.dtype != torch.int32 or not rows.is_contiguous() or rows.data_ptr() % 16:
        rows = torch.empty(shape, dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.vhx_skip_rows(pairs.data_ptr(), rows.data_ptr(), _ints(bases), _ints(dims), n,
                            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "skip rows launch")
    tree["skip_rows"] = rows
    refresh_skip_rows.launches += 1


refresh_skip_rows.launches = 0
