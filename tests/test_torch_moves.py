"""The plain tracer's move record (``make_bitgrid_tracer``'s ``run(...,
moves=...)``): one move a step for every ray, and nothing else changed.

The record measures the automaton: ``chip_smoke.py`` counts from it what
each warp of the frame kernels runs.  Imports no JAX.
"""

import numpy as np
import pytest
import torch

from voxelhex_tpu_torch.render import bitgrid as bgm

KEYS = ("hit", "hvox", "hnormal", "point", "tsect", "tmin", "tsize", "level", "lo", "hi",
        "bmin", "restarts", "active", "iters")


def _case(size=64, density=0.02, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    occ = rng.random((size, size, size)) < density
    occ[size // 2:] = False  # an empty half: rays there ascend past the top level
    tree = bgm.device_bitgrid(bgm.bitgrid_from_occupancy(occ), "cpu")
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    d = rng.uniform(0, size, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tree, torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


@pytest.mark.parametrize("substeps,lateral,max_iters", [
    (4, True, 2048), (2, True, 2048), (4, False, 2048), (4, True, 7), (4, True, 1)])
def test_move_record_numbers_each_step(substeps, lateral, max_iters):
    """Each ray's recorded moves number its ``iters``, in the first
    iterations; an ADVANCE takes 1 .. ``substeps`` substeps; a hit is the
    last move of its ray; the record changes none of the tracer's state."""
    tree, o, d = _case()
    trace = bgm.make_bitgrid_tracer(len(tree["bases"]), tree["size"], max_iters=max_iters,
                                    advance_substeps=substeps, lateral_step=lateral)
    moves = []
    on = trace.run(tree, trace.init(tree, o, d), max_iters, moves)
    off = trace.run(tree, trace.init(tree, o, d), max_iters)
    for k in KEYS:
        assert torch.equal(on[k], off[k]), k
    rec = torch.stack(moves).long()  # [T, R]
    took = rec != bgm.MOVE_NONE
    assert torch.equal(took.sum(dim=0), on["iters"].long())
    # a ray steps in the first iters iterations and in no later one
    t = torch.arange(rec.shape[0])[:, None]
    assert torch.equal(took, t < on["iters"].long()[None])
    adv = rec > bgm.MOVE_ADVANCE
    assert bool((rec[adv] <= bgm.MOVE_ADVANCE + substeps).all()) and int(adv.sum()) > 0
    kinds = {bgm.MOVE_HIT, bgm.MOVE_DESCEND, bgm.MOVE_ASCEND, bgm.MOVE_LATERAL,
             bgm.MOVE_RESTART}
    assert set(rec[took & ~adv].unique().tolist()) <= kinds
    hits = rec == bgm.MOVE_HIT
    assert torch.equal(hits.any(dim=0), on["hit"])
    last = rec.gather(0, (on["iters"].long() - 1).clamp(min=0)[None])[0]
    assert bool((last[on["hit"]] == bgm.MOVE_HIT).all())
    if max_iters == 2048:  # every ray ran to its end: each leaves by a lateral step or the top
        assert not bool(on["active"].any())
        gone = ~on["hit"] & (on["iters"] > 0)
        if lateral:
            assert set(last[gone].unique().tolist()) == {bgm.MOVE_LATERAL, bgm.MOVE_RESTART}
        else:
            assert not bool((rec == bgm.MOVE_LATERAL).any())


def test_move_record_counts_advance_substeps():
    """An ADVANCE's recorded substeps are the DDA substeps it took.  A ray
    along +x at y = z = 1.5 crosses three empty level-1 cells to the one
    that holds voxel (13, 1, 1), descends, advances one voxel and hits."""
    size = 16
    occ = np.zeros((size, size, size), dtype=bool)
    occ[13, 1, 1] = True
    tree = bgm.device_bitgrid(bgm.bitgrid_from_occupancy(occ), "cpu")
    assert len(tree["bases"]) == 2
    o = torch.tensor([[-3.0, 1.5, 1.5]])
    d = torch.tensor([[1.0, 0.0, 0.0]])
    adv, down, hit = bgm.MOVE_ADVANCE, bgm.MOVE_DESCEND, bgm.MOVE_HIT
    want = {4: [adv + 3, down, adv + 1, hit],
            2: [adv + 2, adv + 1, down, adv + 1, hit],
            1: [adv + 1, adv + 1, adv + 1, down, adv + 1, hit]}
    for substeps, seq in want.items():
        trace = bgm.make_bitgrid_tracer(2, size, advance_substeps=substeps)
        moves = []
        st = trace.run(tree, trace.init(tree, o, d), 2048, moves)
        assert [int(m[0]) for m in moves] == seq
        assert bool(st["hit"][0]) and st["hvox"][0].tolist() == [13, 1, 1]
