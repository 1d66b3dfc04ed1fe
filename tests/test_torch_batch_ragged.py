"""The port's ``render_many`` (plain versions, on the CPU) against the
reference renderer's at 37 x 21, where the pixel tiles are ragged on the
right and at the bottom; the scene and the checks are
``test_torch_batch.py``'s."""

import pytest
from test_torch_batch import check_render_many, make_renderers

RES = (37, 21)


@pytest.fixture(scope="module")
def renderers():
    return make_renderers(RES)


@pytest.mark.parametrize("out_u8", [True, False])
def test_render_many_equals_reference(renderers, out_u8):
    check_render_many(*renderers, RES, out_u8)
