"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py configures JAX). Without a card they skip.
The raycaster and the inflation are held bit for bit: the raycast codes
everywhere, the inflation's ok everywhere and its maxd and edges wherever
ok; the mesh raycasters, strip-culled (K4) and window (K4w), bit for bit
and equal to each other. The fused tick block is held to the tick criteria of
tests/_torch_parity.py against the plain ticks on the card, for one vehicle
and for a fleet (one launch for B vehicles); the inflation for one image
and for a batch of images (one launch for B x P seeds). The grouped
inflation (K2g, S seeds per block) is held to K2 and to the plain version
the same way, bit for bit wherever ok.
"""

import numpy as np
import pytest
import torch

from _torch_parity import compare_state, cuda, gradient_scene, make_scene  # noqa: F401
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.planner import cuda_inflate, rappids
from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast, meshscene, orchard, raycast
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


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["baked", "mixed"])
@pytest.mark.parametrize("B", [1, 4])
def test_mesh_kernels_bit_equal_to_plain(cuda, scene, B, tmp_path):  # noqa: F811
    """K4 and K4w at 640x480, one launch each for B cameras of random yaw,
    against render_strips and render_depth_window on the card, and equal
    to each other; on the baked orchard and on the scene of primitives and
    OBJ triangles that chip_smoke.py writes and loads."""
    from chip_smoke import baked_orchard, mesh_poses, mixed_scene

    cfg = raycast.make_config(640, 480)
    mesh = baked_orchard(cuda) if scene == "baked" else mixed_scene(cuda, tmp_path)
    pos, cam = mesh_poses(torch.Generator().manual_seed(B), B, cuda)
    windows = meshscene.select_window(mesh, pos, cfg.far * meshscene.slant_factor(cfg), 192)
    before = (cuda_meshscene.render_depth_strips_batch.launches,
              cuda_meshscene.render_depth_window_batch.launches)
    k4 = cuda_meshscene.render_depth_strips_batch(cfg, windows, pos, cam)
    k4w = cuda_meshscene.render_depth_window_batch(cfg, windows, pos, cam)
    strips, nvis = meshscene.strip_windows(cfg, windows, pos, cam, cuda_meshscene.TILE_H)
    ref4 = meshscene.render_strips(cfg, strips, pos, cam)
    ref4w = meshscene.render_depth_window(cfg, windows, pos, cam)
    torch.cuda.synchronize()
    assert (cuda_meshscene.render_depth_strips_batch.launches,
            cuda_meshscene.render_depth_window_batch.launches) == (before[0] + 1, before[1] + 1)
    assert k4.shape == (B, 480, 640) and windows.shape[1] == 192
    assert torch.equal(k4, ref4) and torch.equal(k4w, ref4w) and torch.equal(k4, k4w)
    assert k4.unique().numel() > 20 and float(nvis.float().mean()) < 96


def _endpoint_seeds(params, n, seed, lead=()):
    """The endpoints of n candidates drawn from a seed (the evaluation
    harnesses' seeds): pixel x, pixel y, depth, each (*lead, n)."""
    dev = params.cam.focal.device
    u = torch.rand(tuple(lead) + (4, n), generator=torch.Generator().manual_seed(seed)).to(dev)
    vel = torch.tensor([0.0, 0.0, 1.5], device=dev).expand(tuple(lead) + (3,))
    return list(rappids.endpoint_seeds(
        params, rappids.sample_candidates(params, u, vel, torch.zeros_like(vel))))


def _assert_grouped(params, img, seeds, S, shrink_extra=0):
    """K2g with S seeds per block, one launch, against K2 and the plain
    version: ok everywhere, maxd and edges wherever ok."""
    counts = lambda: (cuda_inflate.inflate_pyramids.launches,  # noqa: E731
                      cuda_inflate.inflate_pyramids.grouped_launches)
    before = counts()
    ok, maxd, edges = cuda_inflate.inflate_pyramids(params, img, *seeds, shrink_extra,
                                                    seeds_per_program=S)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 1)
    k2 = cuda_inflate.inflate_pyramids(params, img, *seeds, shrink_extra)
    plain = rappids.inflate_pyramid(params, img, *seeds, shrink_extra)
    for ok_r, maxd_r, edges_r in (k2, plain):
        assert torch.equal(ok, ok_r)
        assert torch.equal(maxd[ok], maxd_r[ok]) and torch.equal(edges[ok], edges_r[ok])
    return int(ok.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4, 8])
def test_grouped_inflate_kernel_on_an_orchard_view(cuda, S):  # noqa: F811
    """128 endpoint seeds on a rendered 640x480 orchard view, full
    resolution."""
    params = rappids.make_params(rappids.make_camera(640, 480, device=cuda), 0.116, 0.174)
    att = raycast.camera_attitude(rot.identity(cuda)[None])
    img = cuda_raycast.render_depth_batch(raycast.make_config(640, 480),
                                          orchard.make_params(device=cuda),
                                          torch.tensor([[5.0, 0.0, 2.5]], device=cuda), att)[0]
    assert _assert_grouped(params, img, _endpoint_seeds(params, 128, S), S) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["clutter", "gradient"])
def test_grouped_inflate_kernel_ragged_and_gradient(cuda, kind):  # noqa: F811
    """P = 13 seeds with S = 4 (three pad rows) on a cluttered and on the
    blocker-free gradient scene at 320x240, with the pooled path's margin."""
    W, H = 320, 240
    params = rappids.make_params(rappids.make_camera(W, H, focal=W / 2.0, device=cuda),
                                 0.116, 0.174)
    img = make_scene(W, H, 8, seed=3) if kind == "clutter" else gradient_scene(W, H)
    rng = np.random.default_rng(13)
    seeds = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(30, W - 30, 13).astype(np.float32),
        rng.integers(30, H - 30, 13).astype(np.float32),
        rng.uniform(1.5, 3.0, 13).astype(np.float32))]
    assert _assert_grouped(params, torch.from_numpy(img).to(cuda), seeds, 4, 1) >= 1


@pytest.mark.cuda
def test_grouped_inflate_kernel_batched(cuda):  # noqa: F811
    """Four orchard views x 128 endpoint seeds in one launch (S = 4)."""
    params = rappids.make_params(rappids.make_camera(640, 480, device=cuda), 0.116, 0.174)
    pos = torch.tensor([[5.0, 0.0, 2.5], [12.0, 1.5, 2.0], [20.0, -1.0, 3.0],
                        [30.0, 0.5, 1.5]], device=cuda)
    att = raycast.camera_attitude(rot.identity(cuda).expand(4, 4))
    imgs = cuda_raycast.render_depth_batch(raycast.make_config(640, 480),
                                           orchard.make_params(device=cuda), pos, att)
    assert _assert_grouped(params, imgs, _endpoint_seeds(params, 128, 4, (4,)), 4) >= 4
