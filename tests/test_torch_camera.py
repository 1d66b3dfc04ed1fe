"""Port camera and ray generation against the reference's, bit for bit."""

import numpy as np
import pytest
import torch

from voxelhex_tpu.render import camera as ref
from voxelhex_tpu_torch.render import camera as port

POSES = [(40.0, 30.0), (130.0, 30.0), (250.0, -20.0)]


@pytest.mark.parametrize("res", [(160, 90), (37, 23)])
@pytest.mark.parametrize("yaw,pitch", POSES)
def test_device_rays_bit_equal(res, yaw, pitch):
    o_ref, d_ref = ref.device_rays(ref.orbit_camera(128.0, yaw, pitch, resolution=res))
    o, d = port.device_rays(port.orbit_camera(128.0, yaw, pitch, resolution=res), device="cpu")
    assert o.dtype == d.dtype == torch.float32
    assert tuple(d.shape) == (res[0] * res[1], 3)
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))


def test_camera_basis_bit_equal():
    rng = np.random.default_rng(7)
    for _ in range(200):
        origin = rng.uniform(-300, 300, 3).astype(np.float32)
        target = rng.uniform(0, 128, 3).astype(np.float32)
        a = ref.Camera(origin=origin, target=target).basis()
        b = port.Camera(origin=origin, target=target).basis()
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
