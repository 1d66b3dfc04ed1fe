"""The depth prepass's chain of dependent steps, and a model of its block
schedule, from the plain prepass's step counts.

    python3 tools/prepass_chain.py [--levels 2] [--res 1920x1080]

Runs the plain depth prepass (``level_depth_plain`` with ``stats``) of the
bench scene at the bench pose on the CPU and prints, for each level, its
steps, its longest ray and its longest 4 x 8 warp; then the longest chain
of dependent steps through the levels (a pixel's steps plus the most of
the chains of its 2 x 2 edge-clamped coarser pixels, level by level); then,
in steps, a model of the card's schedule of three layouts:

- a launch a level (``prepass_kernel``): a 16 x 8 block lasts its longest
  warp plus ``INIT`` steps; the blocks of a level go in order onto
  ``SLOTS`` resident blocks, and each level starts when the one before
  has ended;
- one launch with per-tile flags (``prepass_frame_kernel``): the same
  blocks in ticket order, the coarsest level first, then the start map's
  32 x 16 tiles; a block starts on its slot and waits until the coarser
  tiles under it have ended;
- one launch of halo tiles: a block owns a ``HALO_TILE`` tile of level 1
  and marches it and the halo its start map and the coarser levels need,
  one warp a 4 x 8 patch, a level after the last of its own patches, on
  ``HALO_SLOTS`` resident blocks of 16 warps.

These are counts and a model, not times: the card's time comes from
``chip_smoke.py`` phase 14 and ``tools/automaton_ab.py``.  Needs no card.
"""

from __future__ import annotations

import argparse
import heapq
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

INIT = 2  # steps' worth of a block's ray generation, entry and store
START_COST = 0.3  # a start-map tile, in steps
SLOTS = 132 * 9  # resident 128-thread blocks at 56 registers
HALO_TILE = (31, 15)  # a level-1 tile whose region with its halo is 32 x 16
HALO_SLOTS = 132 * 2  # resident 512-thread blocks


def warp_max(it, x0, x1, y0, y1):
    """The longest 4 x 8 warp of each patch of it[y0:y1, x0:x1], in the
    frame kernels' layout from (x0, y0)."""
    return [int(it[y:min(y + 8, y1), x:min(x + 4, x1)].max())
            for y in range(y0, y1, 8) for x in range(x0, x1, 4)]


def makespan(costs, slots, deps=None):
    """When the last block ends: ``costs`` in order onto ``slots`` slots;
    block i starts at the later of its slot's freeing and the ends of the
    blocks ``deps[i]``."""
    free, end = [0.0] * slots, []
    for i, c in enumerate(costs):
        t = heapq.heappop(free)
        if deps is not None:
            t = max([t] + [end[j] for j in deps[i]])
        end.append(t + c)
        heapq.heappush(free, t + c)
    return max(end)


def level_blocks(it):
    """{(tx, ty): cost} of a level's 16 x 8 blocks."""
    h, w = it.shape
    return {(tx, ty): max(warp_max(it, tx * 16, min(tx * 16 + 16, w), ty * 8,
                                   min(ty * 8 + 8, h))) + INIT
            for ty in range(-(-h // 8)) for tx in range(-(-w // 16))}


def flags_model(its):
    """The one launch with flags: its[0] is the coarsest level."""
    costs, deps, index = [], [], {}
    for k, it in enumerate(its):
        h, w = it.shape
        for (tx, ty), c in sorted(level_blocks(it).items(), key=lambda b: b[0][::-1]):
            d = []
            if k:
                ch, cw = its[k - 1].shape
                cx, cy = tx * 8, ty * 4
                d = [index[k - 1, a, b] for b in range(cy // 8, min(cy + 4, ch - 1) // 8 + 1)
                     for a in range(cx // 16, min(cx + 8, cw - 1) // 16 + 1)]
            index[k, tx, ty] = len(costs)
            costs.append(c)
            deps.append(d)
    h, w = its[-1].shape
    k = len(its) - 1
    for sy in range(-(-h // 16)):
        for sx in range(-(-w // 32)):
            x0, y0 = sx * 32, sy * 16
            deps.append([index[k, a, b] for b in range(y0 // 8, min(y0 + 16, h - 1) // 8 + 1)
                         for a in range(x0 // 16, min(x0 + 32, w - 1) // 16 + 1)])
            costs.append(START_COST)
    return makespan(costs, SLOTS, deps)


def halo_model(its):
    """The one launch of halo tiles: each block's levels one after another,
    a level as long as its longest patch."""
    tw, th = HALO_TILE
    h1, w1 = its[-1].shape
    costs = []
    for y0 in range(0, h1, th):
        for x0 in range(0, w1, tw):
            a, b, c, d = x0, min(x0 + tw + 1, w1), y0, min(y0 + th + 1, h1)
            total = 0
            for k in range(len(its) - 1, -1, -1):  # level 1 first, then each coarser one
                total += max(warp_max(its[k], a, b, c, d)) + INIT
                if k:
                    hc, wc = its[k - 1].shape
                    a, b = a // 2, min((b - 1) // 2 + 2, wc)
                    c, d = c // 2, min((d - 1) // 2 + 2, hc)
            costs.append(total)
    return makespan(costs, HALO_SLOTS)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--res", default="1920x1080")
    args = ap.parse_args()
    import torch

    from voxelhex_tpu_torch.ops.prepass import level_camera, level_depth_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.scene import build_scene

    w, h = (int(x) for x in args.res.split("x"))
    tree = device_bitgrid(build_scene(), "cpu")
    cam = orbit_camera(128.0, resolution=(w, h))
    its, depth = [], None
    for i in range(args.levels, 0, -1):  # the coarsest first
        cam_i = level_camera(cam, i)
        st = {}
        depth = level_depth_plain(tree, cam_i, depth, stats=st)
        wi, hi = cam_i.resolution
        it = st["iters"].reshape(hi, wi).to(torch.int64).numpy()
        its.append(it)
        print(f"level {i} ({wi}x{hi}): {int(it.sum())} steps, the longest ray {int(it.max())}, "
              f"the longest 4 x 8 warp {max(warp_max(it, 0, wi, 0, hi))}")
    chain = its[0]
    for it in its[1:]:
        hc, wc = chain.shape
        ys, xs = np.arange(it.shape[0]) // 2, np.arange(it.shape[1]) // 2
        y1, x1 = np.minimum(ys + 1, hc - 1), np.minimum(xs + 1, wc - 1)
        coarse = np.maximum(np.maximum(chain[ys][:, xs], chain[y1][:, xs]),
                            np.maximum(chain[ys][:, x1], chain[y1][:, x1]))
        chain = it + coarse
    y, x = np.unravel_index(int(chain.argmax()), chain.shape)
    print(f"the longest chain through the levels: {int(chain.max())} steps, at level 1's pixel "
          f"({x}, {y})")
    by_level = sum(makespan(list(level_blocks(it).values()), SLOTS) for it in its)
    print(f"schedule model, in steps: a launch a level {by_level:.1f}; one launch with flags "
          f"{flags_model(its):.1f}; one launch of {HALO_TILE[0]} x {HALO_TILE[1]} halo tiles "
          f"{halo_model(its):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
