"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py configures JAX). Without a card they skip.
The raycaster and the inflation are held bit for bit: the raycast codes
everywhere, the inflation's ok everywhere and its maxd and edges wherever
ok. The fused tick block is held to the tick criteria of
tests/_torch_parity.py against the plain ticks on the card, for one vehicle
and for a fleet (one launch for B vehicles); the inflation for one image
and for a batch of images (one launch for B x P seeds).
"""

import numpy as np
import pytest
import torch

from _torch_parity import compare_state, cuda, gradient_scene, make_scene  # noqa: F401
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.planner import cuda_inflate, rappids
from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast
from agrifly_tpu_torch.sim import cuda_frame, orchard_env


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


@pytest.mark.cuda
@pytest.mark.parametrize("W,H", [(320, 240), (640, 480)])
@pytest.mark.parametrize("shrink_extra", [0, 1])
def test_inflate_kernel_batched_bit_equal_to_plain(cuda, W, H, shrink_extra):  # noqa: F811
    """Four images (three cluttered, one blocker-free gradient) x 10 seeds
    in one launch, against the batched plain inflation."""
    params = rappids.make_params(rappids.make_camera(W, H, focal=W / 2.0, device=cuda),
                                 0.116, 0.174)
    imgs = np.stack([make_scene(W, H, 8, seed=s) for s in (3, 4, 5)] + [gradient_scene(W, H)])
    imgs = torch.from_numpy(imgs).to(cuda)
    rng = np.random.default_rng(W + shrink_extra)
    seeds = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(2, W - 2, (4, 10)).astype(np.float32),
        rng.integers(2, H - 2, (4, 10)).astype(np.float32),
        rng.uniform(1.5, 3.0, (4, 10)).astype(np.float32))]
    before = cuda_inflate.inflate_pyramids.launches
    ok, maxd, edges = cuda_inflate.inflate_pyramids(params, imgs, *seeds, shrink_extra)
    ok_r, maxd_r, edges_r = rappids.inflate_pyramid(params, imgs, *seeds, shrink_extra)
    torch.cuda.synchronize()
    assert cuda_inflate.inflate_pyramids.launches == before + 1
    assert ok.shape == (4, 10) and torch.equal(ok, ok_r) and int(ok.sum()) >= 1
    assert torch.equal(maxd[ok], maxd_r[ok]) and torch.equal(edges[ok], edges_r[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cold", "takeoff", "tracking", "landing", "complete",
                                  "ekf_full"])
def test_frame_ticks_kernel_matches_plain(cuda, case):  # noqa: F811
    from chip_smoke import tick_states  # the smoke test's five port-built states

    p = orchard_env.make_params(start_flight_time=0.3, device="cpu")
    s = tick_states(p)["takeoff" if case == "ekf_full" else case]
    if case == "ekf_full":  # the EKF's full prediction (after a first UWB fix)
        kf = s.base.logic.kf._replace(uwb_init=torch.tensor(True))
        s = s._replace(base=s.base._replace(logic=s.base.logic._replace(kf=kf)))
    p = orchard_env.OrchardEnv(p).to(cuda).params
    leaves, rebuild = convert.flatten_tensors(s)
    s = rebuild([t.to(cuda) for t in leaves])
    noise = torch.randn((16, 2, 3), generator=torch.Generator().manual_seed(7)).to(cuda)
    before = cuda_frame.frame_ticks.launches
    got = cuda_frame.frame_ticks(p, s, noise)
    ref = orchard_env.frame_ticks_plain(p, s, noise)
    torch.cuda.synchronize()
    assert cuda_frame.frame_ticks.launches == before + 1
    assert int(got.base.step) == int(s.base.step) + 16
    if case == "landing":
        assert int(ref.mstage) == orchard_env.MSTAGE_COMPLETE
    leaves, rebuild = convert.flatten_tensors(ref)
    compare_state(got, rebuild([t.cpu() for t in leaves]))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [5, 37])
def test_frame_ticks_kernel_batched_matches_plain(cuda, B):  # noqa: F811
    """The fleet's tick kernel (K3b): the five mission states, repeated to
    B rows (37 crosses the 32-thread block), in one launch, against the
    plain ticks of each vehicle on the card."""
    from chip_smoke import tick_states

    p = orchard_env.make_params(start_flight_time=0.3, device="cpu")
    states = list(tick_states(p).values())
    fleet = orchard_env.stack_states([states[b % len(states)] for b in range(B)])
    p = orchard_env.OrchardEnv(p).to(cuda).params
    leaves, rebuild = convert.flatten_tensors(fleet)
    fleet = rebuild([t.to(cuda) for t in leaves])
    noise = torch.randn((B, 16, 2, 3), generator=torch.Generator().manual_seed(B)).to(cuda)
    before = cuda_frame.frame_ticks.launches
    got = cuda_frame.frame_ticks(p, fleet, noise)
    ref = orchard_env.frame_ticks_plain_fleet(p, fleet, noise)
    torch.cuda.synchronize()
    assert cuda_frame.frame_ticks.launches == before + 1
    assert torch.equal(got.base.step, fleet.base.step + 16)
    leaves, rebuild = convert.flatten_tensors(ref)
    compare_state(got, rebuild([t.cpu() for t in leaves]))
