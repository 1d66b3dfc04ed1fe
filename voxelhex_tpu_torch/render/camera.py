"""Pinhole camera and ray generation.

A copy of the reference camera (``Camera``, ``orbit_camera``) and its
device ray generator.  Rays come out as f32 ``[h*w, 3]`` tensors, bit-equal
to the reference's ``device_rays`` on XLA:CPU: the same constant folding
(``x / w * 2`` is ``x * (2/w)``), the same fused multiply-adds and the same
reduction order for the norm.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from voxelhex_tpu_torch.fp import fma32, sqrt32


def _norm(v):
    """f32 length of a 3-vector as the reference's NumPy computes it
    (products in f32, sum in f64, one rounding back to f32), written out so
    that it does not depend on the BLAS that NumPy was built with."""
    v = np.asarray(v, dtype=np.float32)
    sq = np.float32(sum(float(v[i] * v[i]) for i in range(3)))
    return np.sqrt(sq)


def _normalize(v):
    v = np.asarray(v, dtype=np.float32)
    return v / _norm(v)


@dataclass
class Camera:
    origin: np.ndarray
    target: np.ndarray
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov_y_deg: float = 50.0
    resolution: tuple[int, int] = (1280, 720)  # (width, height)

    def basis(self):
        """``(forward, right, up)`` f32 unit vectors."""
        forward = _normalize(np.asarray(self.target) - np.asarray(self.origin))
        up_hint = _normalize(np.asarray(self.up, dtype=np.float32))
        # Gram-Schmidt the up hint against forward; fall back to a fixed
        # axis only when the two are exactly parallel
        dot = float(sum(float(up_hint[i] * forward[i]) for i in range(3)))
        resid = up_hint - np.float32(dot) * forward
        rn = float(_norm(resid))
        if rn > 1e-6:
            up_hint = resid / rn
        else:
            up_hint = np.array(
                [0.0, 0.0, 1.0] if abs(forward[2]) < 0.9 else [1.0, 0.0, 0.0],
                dtype=np.float32,
            )
        right = _normalize(np.cross(up_hint, forward))
        up = np.cross(forward, right)
        return forward, right, up


def orbit_camera(
    scene_size: float,
    yaw_deg: float = 40.0,
    pitch_deg: float = 30.0,
    distance_factor: float = 1.8,
    resolution=(1280, 720),
    fov_y_deg: float = 50.0,
) -> Camera:
    """Camera orbiting the center of a ``scene_size`` cube."""
    center = np.array([scene_size / 2.0] * 3, dtype=np.float32)
    r = scene_size * distance_factor
    yaw, pitch = np.radians(yaw_deg), np.radians(pitch_deg)
    offset = np.array(
        [
            r * np.cos(pitch) * np.sin(yaw),
            r * np.sin(pitch),
            -r * np.cos(pitch) * np.cos(yaw),
        ],
        dtype=np.float32,
    )
    return Camera(
        origin=center + offset,
        target=center,
        resolution=resolution,
        fov_y_deg=fov_y_deg,
    )


def camera_params(camera: Camera):
    """The ~60 bytes of camera state ray generation reads:
    ``(origin, right, up, forward, scale)`` as f32 NumPy arrays."""
    w, h = camera.resolution
    forward, right, up = camera.basis()
    tan_half = float(np.tan(np.radians(camera.fov_y_deg) / 2.0))
    scale = np.array([tan_half * (w / h), tan_half], dtype=np.float32)
    return (
        np.asarray(camera.origin, dtype=np.float32),
        right.astype(np.float32),
        up.astype(np.float32),
        forward.astype(np.float32),
        scale,
    )


def pixel_steps(w: int, h: int):
    """``(1 / w * 2, 1 / h * 2)``: the f32 constants into which the
    reference folds the divide of ``(i + 0.5) / w * 2 - 1``."""
    return (float(np.float32(1.0) / np.float32(w) * np.float32(2.0)),
            float(np.float32(1.0) / np.float32(h) * np.float32(2.0)))


def raygen(w: int, h: int, origin, right, up, forward, scale):
    """Rays of a ``w x h`` frame from camera params (f32 tensors on one
    device): ``(origins, dirs)``, each f32 ``[h*w, 3]``, row-major from the
    top-left pixel."""
    dev = forward.device
    cw, ch = pixel_steps(w, h)
    px = fma32(torch.arange(w, dtype=torch.float32, device=dev) + 0.5, cw, -1.0)
    py = fma32(-(torch.arange(h, dtype=torch.float32, device=dev) + 0.5), ch, 1.0)
    pxs = (px * scale[0])[None, :, None]  # [1, w, 1]
    pys = (py * scale[1])[:, None, None]  # [h, 1, 1]
    # XLA computes the direction twice, in two fusions: the norm's copy adds
    # the row term (hoisted out of the column loop) with a plain add, the
    # divided copy fuses it into the multiply-add chain
    head = fma32(pxs, right, forward)  # [h, w, 3]
    dn = head + pys * up
    n2 = fma32(dn[..., 2], dn[..., 2],
               fma32(dn[..., 1], dn[..., 1], dn[..., 0] * dn[..., 0]))
    d = fma32(pys, up, head) / sqrt32(n2)[..., None]
    d = d.reshape(-1, 3)
    return origin.reshape(1, 3).expand(d.shape[0], 3).contiguous(), d


def device_rays(camera: Camera, device="cuda"):
    """The camera's rays generated on ``device``: ``(origins, dirs)`` as
    f32 ``[h*w, 3]`` tensors.  Only the camera params cross to the device."""
    w, h = camera.resolution
    params = [torch.from_numpy(p).to(device) for p in camera_params(camera)]
    return raygen(w, h, *params)
