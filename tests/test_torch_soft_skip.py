"""The port's soft renderer under ``tracer="skip"`` (plain versions, on the
CPU) against the reference's: its compacted skip march
(``trace_hits_compacted``, the route the reference takes at frame scale and
the one route of the port), with and without the beam, exact; and the
reference's non-compacted route, which marches the stack tracer whatever
``tracer`` says, pinned in a test of its own.  The scene and cameras are
``test_torch_soft_beam.py``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_soft_beam import assert_hits_equal, camera_pair, cube, one_thread, rays  # noqa: F401


@pytest.fixture(scope="module")
def skip_pair():
    """The reference's and the port's skip renderers, K = 3, and the
    port's stack renderer."""
    from voxelhex_tpu.diff.soft import SoftRenderer as RefSoft
    from voxelhex_tpu.tree.flat import flatten
    from voxelhex_tpu_torch.diff.soft import SoftRenderer

    return (RefSoft(flatten(cube("voxelhex_tpu")), max_hits=3, tracer="skip"),
            SoftRenderer(cube("voxelhex_tpu_torch"), max_hits=3, tracer="skip", device="cpu"),
            SoftRenderer(cube("voxelhex_tpu_torch"), max_hits=3, device="cpu"))


@pytest.fixture(scope="module")
def skip_rays(skip_pair):
    """The rays of the 160 x 120 camera at distance factor 1.6, and the
    reference's compacted skip march of them without a beam: made once, for
    the two tests that read it."""
    ref_cam, cam = camera_pair(factor=1.6)
    o, d = rays(ref_cam)
    march = skip_pair[0].trace_hits_compacted(jnp.asarray(o), jnp.asarray(d))
    return ref_cam, cam, o, d, [np.asarray(x) for x in march]


@pytest.mark.parametrize("beam", [False, True])
def test_skip_march_equals_reference_compacted(skip_pair, skip_rays, beam):
    """``SoftRenderer(tracer="skip")`` against the reference's compacted
    skip march (the route the reference takes at frame scale, and the one
    route of the port): exact; and counts and voxels equal to the stack
    march's, with distances within the reference's 1e-2 of them
    (``test_soft_diff.py``: the two tracers reach a hit point through
    different float chains)."""
    ref, port, stack = skip_pair
    ref_cam, cam, o, d, want = skip_rays
    spec_p = port.beam_spec(cam) if beam else None
    if beam:
        want = ref.trace_hits_compacted(jnp.asarray(o), jnp.asarray(d),
                                        beam=ref.beam_spec(ref_cam))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = port.trace_hits(ot, dt, beam=spec_p)
    assert_hits_equal(got, want, rtol=0, atol=0)
    assert int((got[0] == 3).sum()) > 100
    s = stack.trace_hits(ot, dt, beam=spec_p)
    for a, b in zip(got[:2], s[:2]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got[2].numpy(), s[2].numpy(), atol=1e-2)


def test_reference_uncompacted_skip_marches_the_stack(skip_pair, skip_rays):
    """The reference's trap: ``trace_hits(compact=False)`` (and any call
    under 262,144 rays) marches ``make_multihit_tracer``, the stack tracer,
    whatever ``tracer`` says (soft.py:181).  So its distances are the stack
    march's, not the skip march's that its compacted route gives; counts and
    voxels agree.  The port's skip renderer gives the skip march on every
    call.  (The reference's non-compacted program fuses a few multiply-adds
    otherwise than its compacted one: its stack distances are held to the
    port's stack march at ``test_torch_soft.py``'s rtol 2.4e-7.)"""
    ref, port, stack = skip_pair
    _ref_cam, _cam, o, d, skip = skip_rays
    plain = [np.asarray(x) for x in ref.trace_hits(jnp.asarray(o), jnp.asarray(d),
                                                    compact=False)]
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    np.testing.assert_allclose(stack.trace_hits(ot, dt)[2].numpy(), plain[2], rtol=2.4e-7,
                               atol=0)
    np.testing.assert_array_equal(skip[2], port.trace_hits(ot, dt)[2].numpy())
    assert (plain[2] != skip[2]).any()
    for a, b in zip(plain[:2], skip[:2]):
        np.testing.assert_array_equal(a, b)
