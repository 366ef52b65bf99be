"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py configures JAX). Without a card they skip.
Both kernels are held bit for bit: the raycast codes everywhere, the
inflation's ok everywhere and its maxd and edges wherever ok.
"""

import numpy as np
import pytest
import torch

from _torch_parity import cuda, gradient_scene, make_scene  # noqa: F401  (cuda: fixture)
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.planner import cuda_inflate, rappids
from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast


def _poses(seed, n, device):
    g = torch.Generator().manual_seed(seed)
    pos = torch.stack([torch.rand(n, generator=g) * 40, torch.rand(n, generator=g) * 16 - 8,
                       torch.rand(n, generator=g) * 3 + 0.5], dim=1)
    ypr = (torch.rand(n, 3, generator=g) - 0.5) * 0.8
    body = rot.from_euler_ypr(ypr[:, 0], ypr[:, 1], ypr[:, 2])
    return pos.to(device), raycast.camera_attitude(body).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_raycast_kernel_bit_equal_to_plain(cuda, B):  # noqa: F811
    cfg, scene = raycast.make_config(640, 480), orchard.make_params(device=cuda)
    pos, cam = _poses(B, B, cuda)
    before = cuda_raycast.render_depth_batch.launches
    got = cuda_raycast.render_depth_batch(cfg, scene, pos, cam)
    ref = raycast.render_depth(cfg, scene, pos, cam)
    torch.cuda.synchronize()
    assert cuda_raycast.render_depth_batch.launches == before + 1
    assert torch.equal(got, ref)
    assert got.unique().numel() > 20


@pytest.mark.cuda
@pytest.mark.parametrize("kind,W,H", [("clutter", 160, 120), ("gradient", 160, 120),
                                      ("clutter", 320, 240), ("clutter", 640, 480)])
@pytest.mark.parametrize("shrink_extra", [0, 1])
def test_inflate_kernel_bit_equal_to_plain(cuda, kind, W, H, shrink_extra):  # noqa: F811
    params = rappids.make_params(rappids.make_camera(W, H, focal=W / 2.0, device=cuda),
                                 0.116, 0.174)
    img = make_scene(W, H, 8, seed=3) if kind == "clutter" else gradient_scene(W, H)
    img = torch.from_numpy(img).to(cuda)
    rng = np.random.default_rng(W + shrink_extra)
    seeds = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(2, W - 2, 20).astype(np.float32), rng.integers(2, H - 2, 20).astype(np.float32),
        rng.uniform(1.5, 3.0, 20).astype(np.float32))]
    before = cuda_inflate.inflate_pyramids.launches
    ok, maxd, edges = cuda_inflate.inflate_pyramids(params, img, *seeds, shrink_extra)
    ok_r, maxd_r, edges_r = rappids.inflate_pyramid(params, img, *seeds, shrink_extra)
    torch.cuda.synchronize()
    assert cuda_inflate.inflate_pyramids.launches == before + 1
    assert torch.equal(ok, ok_r) and int(ok.sum()) >= 1
    assert torch.equal(maxd[ok], maxd_r[ok]) and torch.equal(edges[ok], edges_r[ok])
