"""Plain shading and the u8 step (the reference's ``_shade`` and
``_to_u8``): albedo x Lambert on a hit, the background on a miss."""

from __future__ import annotations

import torch

from voxelhex_tpu_torch.constants import NO_COLOR_HIT


def shade(palette, hit, voxel, normal, bg):
    """rgb f32 [R, 3] from hit bool [R], voxel int32 [R], normal f32 [R, 3],
    palette f32 [P, 4] and bg f32 [3]."""
    has_color = hit & (voxel != NO_COLOR_HIT) & (voxel >= 0)
    albedo = palette[voxel.clamp(0, palette.shape[0] - 1).long(), :3]
    albedo = torch.where(has_color[:, None], albedo, torch.zeros_like(albedo))
    # dot(n, (-0.5, 0.5, -0.5)), summed in the reference's order
    s = (normal[:, 0] * -0.5 + normal[:, 1] * 0.5) + normal[:, 2] * -0.5
    lambert = s / 2.0 + 0.5
    lit = albedo * lambert[:, None]
    return torch.where(hit[:, None], lit, bg.reshape(1, 3).expand_as(lit))


def to_u8(rgb):
    """``clip(round(rgb * 255), 0, 255)`` as uint8; round is half to even
    and NaN becomes 0."""
    q = torch.round(rgb * 255.0)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return q.clamp(0.0, 255.0).to(torch.uint8)
