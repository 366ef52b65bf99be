"""The port's depth renderer against the JAX package's.

`raycast.render_depth` (the plain version of the raycast kernel) is held
against the JAX package's jnp renderer and against its Pallas raycast
kernel run in interpret mode: equal codes, or at most 0.05% of pixels one
code apart (XLA:CPU may fuse a multiply-add the port rounds twice, moving
a ray's t by an ulp at a quantization edge). The CUDA kernel is held to
the plain version on the card in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrifly_tpu.ops import rotation as jrot
from agrifly_tpu.render import orchard as jorch, pallas_raycast as jpr, raycast as jray
from agrifly_tpu_torch.render import cuda_raycast, orchard as torch_orch, raycast as tray

MAX_OFF_BY_ONE = 5e-4  # fraction of pixels allowed one code apart


def _poses(seed, n):
    """Camera poses over the orchard: positions among the trees, small tilts."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, 40, n), rng.uniform(-8, 8, n), rng.uniform(0.5, 3.5, n)],
                   axis=1).astype(np.float32)
    ypr = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    body = np.stack([np.asarray(jrot.from_euler_ypr(*(jnp.float32(v) for v in row)), np.float32)
                     for row in ypr])
    cam = np.array(jax.vmap(jray.camera_attitude)(jnp.asarray(body)), np.float32)
    return pos, body, cam


def _check_codes(got, ref, what):
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    n_off = int((d > 0).sum())
    print(f"{what}: {n_off} of {d.size} pixels differ (max {d.max()} code)")
    assert d.max() <= 1, (what, int(d.max()))
    assert n_off <= MAX_OFF_BY_ONE * d.size, (what, n_off)
    assert len(np.unique(ref)) > 20  # the scene is not empty


def test_camera_attitude_matches():
    _, body, cam = _poses(0, 8)
    got = tray.camera_attitude(torch.from_numpy(body)).numpy()
    np.testing.assert_array_equal(got, cam)


def test_plain_render_matches_jnp_renderer():
    cfg_j, cfg_t = jray.make_config(160, 120), tray.make_config(160, 120)
    scene_j, scene_t = jorch.make_params(), torch_orch.make_params(device="cpu")
    pos, _, cam = _poses(1, 6)
    got = tray.render_depth(cfg_t, scene_t, torch.from_numpy(pos), torch.from_numpy(cam)).numpy()
    ref = np.stack([np.asarray(jray.render_depth(cfg_j, scene_j, jnp.asarray(p), jnp.asarray(c)))
                    for p, c in zip(pos, cam)])
    assert got.dtype == np.int32 and got.shape == (6, 120, 160)
    _check_codes(got, ref, "plain vs raycast.render_depth")


def test_plain_render_matches_pallas_kernel_interpret():
    # the Pallas kernel renders 16-row strips, so H must be a multiple of 16
    cfg_j, cfg_t = jray.make_config(128, 96), tray.make_config(128, 96)
    scene_j, scene_t = jorch.make_params(), torch_orch.make_params(device="cpu")
    pos, _, cam = _poses(2, 2)
    ref = np.asarray(jpr.render_depth_batch(cfg_j, scene_j, jnp.asarray(pos), jnp.asarray(cam),
                                            interpret=True))
    got = cuda_raycast.render_depth_batch(cfg_t, scene_t, torch.from_numpy(pos),
                                          torch.from_numpy(cam)).numpy()
    _check_codes(got, ref, "plain vs pallas_raycast (interpret)")


def test_cpu_tensors_take_the_plain_version():
    cfg, scene = tray.make_config(64, 48), torch_orch.make_params(device="cpu")
    pos, body, cam = _poses(3, 2)
    before = cuda_raycast.render_depth_batch.launches
    a = cuda_raycast.render_depth_body_batch(cfg, scene, torch.from_numpy(pos),
                                             torch.from_numpy(body))
    b = tray.render_depth(cfg, scene, torch.from_numpy(pos), torch.from_numpy(cam))
    assert torch.equal(a, b)
    assert cuda_raycast.render_depth_batch.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    cfg, scene = tray.make_config(64, 48), torch_orch.make_params(device="cpu")
    pos, cam = torch.zeros(2, 3), torch.tensor([[1.0, 0, 0, 0]] * 2)
    if bad == "shape":
        pos = pos[:, :2]
    else:
        pos = pos.double()
    with pytest.raises(ValueError):
        cuda_raycast.render_depth_batch(cfg, scene, pos, cam)
