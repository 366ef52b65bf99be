"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py configures JAX). Without a card they skip.
The raycaster and the inflation are held bit for bit: the raycast codes
everywhere (and the cells its early exit evaluates, against its plain
mirror, on a scene where the exit is barred too), the inflation's ok everywhere and its maxd and edges wherever
ok (one image and a batch, and the shapes its early exits, search chunks
and shrink table make risky); the mesh raycasters, strip-culled (K4, whose per-strip row counts
equal strip_windows') and window (K4w), bit for bit and equal to each other; their RGB instances (K1-rgb, K4-rgb) bit for bit
against `raycast.render_rgb` and both plain mesh scans, with a camera whose
trees all lie beyond the far plane and a pair of rows tied on t. The fused tick block is held to the tick criteria of
tests/_torch_parity.py against the plain ticks on the card, for one vehicle
and for a fleet (one launch for B vehicles); the inflation for one image
and for a batch of images (one launch for B x P seeds). The grouped
inflation (K2g, S seeds per block) is held to K2 and to the plain version
the same way, bit for bit wherever ok; the cluster form (K2c) at every
cluster size on the edge cases. The env rollout (K5) in every mode and
build, the wind fleet (K5's wind build; with a UWB network on every
vehicle its TICK_WIND + TICK_UWB build, bit for bit) and the shared-UWB
fleet (K6) are held to the tick criteria against their plain rollouts on
the card, every
lane group size bit for bit against one lane; the plain rollout on the card
is held to the tick criteria against the same plain rollout on the CPU. The cluster-size choice and
the constants the wrappers share with the kernel sources are checked on the
CPU too.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import compare_state, cuda, gradient_scene, make_scene  # noqa: F401
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.planner import cuda_inflate, cuda_plan, rappids
from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast, meshscene, orchard, raycast
from agrifly_tpu_torch.sim import cuda_fleet_uwb, cuda_frame, cuda_rollout, env, fleet_env, uwb
from agrifly_tpu_torch.sim import orchard_env
from chip_smoke import RAY_SCENES  # the default orchard, the make_params limit, a loose scene


def _poses(seed, n, device):
    g = torch.Generator().manual_seed(seed)
    pos = torch.stack([torch.rand(n, generator=g) * 40, torch.rand(n, generator=g) * 16 - 8,
                       torch.rand(n, generator=g) * 3 + 0.5], dim=1)
    ypr = (torch.rand(n, 3, generator=g) - 0.5) * 0.8
    body = rot.from_euler_ypr(ypr[:, 0], ypr[:, 1], ypr[:, 2])
    return pos.to(device), raycast.camera_attitude(body).to(device)




@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", list(RAY_SCENES))
@pytest.mark.parametrize("B", [1, 4, 16])
def test_raycast_kernel_bit_equal_to_plain(cuda, B, scene_name):  # noqa: F811
    """K1 at 640x480, one launch for B cameras, bit-equal to render_depth;
    the cells it evaluated per pixel equal its plain mirror's
    (render_depth_exit), all 8 where the scene fails the containment test."""
    cfg = raycast.make_config(640, 480)
    scene = orchard.make_params(device=cuda, **RAY_SCENES[scene_name])
    pos, cam = _poses(B, B, cuda)
    before = cuda_raycast.render_depth_batch.launches
    got = cuda_raycast.render_depth_batch(cfg, scene, pos, cam)
    ref = raycast.render_depth(cfg, scene, pos, cam)
    torch.cuda.synchronize()
    assert cuda_raycast.render_depth_batch.launches == before + 1
    assert torch.equal(got, ref)
    assert got.unique().numel() > 20
    cells = torch.empty_like(got)
    again = cuda_raycast._launch(cfg, scene, pos, cam, cells)
    mirror, mirror_cells = raycast.render_depth_exit(cfg, scene, pos, cam)
    assert torch.equal(again, ref) and torch.equal(mirror, ref)
    assert torch.equal(cells, mirror_cells)
    if scene_name == "loose":
        assert int(cells.min()) == cfg.dda_steps
    else:
        assert float(cells.float().mean()) < 4.0


def _inflations():
    """K2 and K2c launches so far (the wrapper picks one per call)."""
    return cuda_inflate.inflate_pyramids.launches + cuda_inflate.inflate_pyramids.cluster_launches


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
    before = _inflations()
    ok, maxd, edges = cuda_inflate.inflate_pyramids(params, img, *seeds, shrink_extra)
    ok_r, maxd_r, edges_r = rappids.inflate_pyramid(params, img, *seeds, shrink_extra)
    torch.cuda.synchronize()
    assert _inflations() == before + 1
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
    before = _inflations()
    ok, maxd, edges = cuda_inflate.inflate_pyramids(params, imgs, *seeds, shrink_extra)
    ok_r, maxd_r, edges_r = rappids.inflate_pyramid(params, imgs, *seeds, shrink_extra)
    torch.cuda.synchronize()
    assert _inflations() == before + 1
    assert ok.shape == (4, 10) and torch.equal(ok, ok_r) and int(ok.sum()) >= 1
    assert torch.equal(maxd[ok], maxd_r[ok]) and torch.equal(edges[ok], edges_r[ok])


def _edge_case(kind, dev):
    """(params, image, seeds, shrink_extra) of one shape the kernel's
    early exits, search chunks and shrink table make risky."""
    W, H = 320, 240
    params = rappids.make_params(rappids.make_camera(W, H, focal=W / 2.0, device=dev),
                                 0.116, 0.174)
    img = make_scene(W, H, 8, seed=5)
    rng = np.random.default_rng(len(kind))
    P = {"one seed": 1, "ragged": 7, "slab rows": 20}.get(kind, 12)
    x0 = rng.integers(30, W - 30, P).astype(np.float32)
    y0 = rng.integers(30, H - 30, P).astype(np.float32)
    depth = rng.uniform(1.5, 3.0, P).astype(np.float32)
    extra = 1
    if kind == "early fail":  # seeds on the obstacles: most fail pass A
        ys, xs = np.nonzero(img < 140)
        pick = rng.choice(len(xs), P, replace=False)
        x0, y0 = xs[pick].astype(np.float32), ys[pick].astype(np.float32)
        x0[:3], y0[:3] = rng.integers(30, W - 30, 3), rng.integers(30, H - 30, 3)
    elif kind == "middle rows":  # rectangles across the image's middle rows
        y0[:] = H // 2 + rng.integers(-3, 4, P)
    elif kind == "slab rows":  # blockers and seeds on the rows where K2c's slabs meet
        img = np.full((H, W), 230, np.int32)
        for k, y in enumerate((30, 60, 90, 120, 150, 180, 210)):
            img[y, 20 + 30 * k: 140 + 30 * k] = 60
        img[40:200, 100] = 60
        y0[:] = rng.choice([29, 31, 59, 61, 119, 121, 179, 181], P)
        depth = rng.uniform(1.0, 2.0, P).astype(np.float32)
    elif kind == "gradient":  # no blocker: every search runs to the image's edge
        img = gradient_scene(W, H)
    elif kind == "pooled fill":  # a 2x2-pooled 640x480 frame with ignored cells (1 << 17)
        full = np.full((2 * H, 2 * W), 230, np.int32)
        full[:, 2 * W // 3:] = 1  # nearer than the vehicle radius: ignored
        full[100:300, 150:180] = 60
        big = rappids.make_params(rappids.make_camera(2 * W, 2 * H, focal=W * 1.0, device=dev),
                                  0.116, 0.174)
        pooled, cam = rappids._pooled(big, torch.from_numpy(full).to(dev), 2)
        assert int((pooled == 1 << 17).sum()) > 1000
        return big._replace(cam=cam), pooled, _seeds(x0, y0, depth, dev), extra
    elif kind == "above 65535":  # codes past 16 bits, and seeds deeper than 65535 codes
        img = np.where(img < 230, 70000, 200000).astype(np.int32)
        img[40:200, 20:26] = 5000
        depth = rng.uniform(2900.0, 4000.0, P).astype(np.float32)
    return params, torch.from_numpy(img).to(dev), _seeds(x0, y0, depth, dev), extra


def _seeds(x0, y0, depth, dev):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (x0, y0, depth)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one seed", "ragged", "early fail", "middle rows",
                                  "pooled fill", "above 65535", "slab rows", "gradient"])
def test_inflate_kernel_edge_cases(cuda, kind):  # noqa: F811
    """K2, and K2c at every cluster size, against the plain version: one
    seed; a ragged P = 7; seeds that fail pass A before the block fills its
    shrink table; rectangles across the middle rows; a pooled frame holding
    the 1 << 17 fill of ignored cells; pixels above 65535 with seeds deep
    enough that blocking depends on their exact values; blockers and seeds
    on the rows where the slabs of 2, 4 and 8 blocks meet (P = 20, more than
    one cluster per seed's share of the card's SMs); a blocker-free
    gradient."""
    params, img, seeds, extra = _edge_case(kind, cuda)
    ok_r, maxd_r, edges_r = rappids.inflate_pyramid(params, img, *seeds, extra)
    rows = rappids.seed_rows(params, *seeds, extra)
    got = [cuda_inflate.inflate_pyramids(params, img, *seeds, extra)]
    for C in (1,) + cuda_inflate.CLUSTER_SIZES:
        out = cuda_inflate._launch(img.contiguous(), rows, cluster=C)
        got.append((out[..., 0] > 0, out[..., 1], out[..., 2:6]))
    torch.cuda.synchronize()
    for ok, maxd, edges in got:
        assert torch.equal(ok, ok_r) and int(ok.sum()) >= 1
        assert torch.equal(maxd[ok], maxd_r[ok]) and torch.equal(edges[ok], edges_r[ok])
    if kind == "early fail":
        assert int((~ok_r).sum()) >= 3


CSRC = Path(cuda_inflate.__file__).resolve().parents[1] / "csrc"


def _constant(source, name):
    """An int constexpr of a kernel source (a product of literals)."""
    expr = re.search(rf"constexpr int {name} = ([0-9* ]+);", source).group(1)
    return int(np.prod([int(f) for f in expr.split("*")]))


def test_inflate_cluster_constants_match_the_kernel_source():
    src = (CSRC / "inflate.cu").read_text()
    assert _constant(src, "kMaxSlabBytes") == cuda_inflate.MAX_SLAB_BYTES
    assert _constant(src, "kMaxCluster") == max(cuda_inflate.CLUSTER_SIZES)
    assert _constant(src, "kMaxGroup") == cuda_inflate.MAX_SEEDS_PER_PROGRAM


def test_grouped_constants_match_the_kernel_source():
    """K2g: the launcher takes every S from 2 to MAX_SEEDS_PER_PROGRAM
    (kMaxGroup) and launches it as a cluster of S blocks, within the
    portable cluster size (kMaxCluster); each block's shared memory holds
    a corner's values of a whole group."""
    src = (CSRC / "inflate.cu").read_text()
    launcher = src[src.index('extern "C" int inflate_grouped_launch'):]
    assert "if (S < 2 || S > kMaxGroup) return" in launcher
    assert "attr[0].val.clusterDim.x = S;" in launcher
    assert _constant(src, "kMaxGroup") == cuda_inflate.MAX_SEEDS_PER_PROGRAM
    assert cuda_inflate.MAX_SEEDS_PER_PROGRAM <= _constant(src, "kMaxCluster")
    assert "kGroupValues = 3 * kMaxGroup;" in src


@pytest.mark.parametrize("B,P,H,W,want", [
    (1, 10, 240, 320, 8),    # the frame's round, one vehicle: 80 blocks
    (1, 20, 240, 320, 8),    # 160 blocks
    (1, 33, 240, 320, 8),    # 264 blocks, two a SM
    (1, 34, 240, 320, 4),
    (1, 132, 240, 320, 2),   # the smallest cluster (a 240-row slab is too large)
    (1, 133, 240, 320, 1),   # K2
    (16, 10, 240, 320, 1),   # a fleet's round fills the card with K2's blocks
    (1, 16, 480, 640, 8),    # 480x640: only 8 blocks' 60-row slabs fit
    (1, 34, 480, 640, 1),
    (1, 128, 480, 640, 1),   # the evaluation's seed batches
    (1, 1, 2000, 2000, 1),   # no cluster's slab fits
])
def test_inflate_cluster_size(B, P, H, W, want):
    """K2c's blocks per seed from H x W and the grid on a 132-SM card."""
    assert cuda_inflate.cluster_size(B, P, H, W, 132) == want
    if want > 1:
        assert cuda_inflate.slab_bytes(H, W, want) <= cuda_inflate.MAX_SLAB_BYTES
        assert B * P * want <= cuda_inflate.CLUSTER_BLOCKS_PER_SM * 132


def test_frame_section_names_match_the_kernel_source():
    """chip_smoke.py's section names follow frame.cu's Section enum."""
    from chip_smoke import SECTIONS

    body = re.search(r"enum Section \{([^}]*)\}", (CSRC / "frame.cu").read_text()).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "kNumSections" and len(names) - 1 == len(SECTIONS)


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
@pytest.mark.parametrize("B", [5, 37, 65])
def test_frame_ticks_kernel_batched_matches_plain(cuda, B):  # noqa: F811
    """The fleet's tick kernel (K3b): the five mission states, repeated to
    B rows (none a multiple of the kernel's 4 vehicles per block, so the
    last block has idle warps), in one launch, against the plain ticks of
    each vehicle on the card."""
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
@pytest.mark.parametrize("scene_name", list(RAY_SCENES))
def test_raycast_rgb_kernel_exit_on_cameras_pitched_up(cuda, scene_name):  # noqa: F811
    """K1-rgb on 8 cameras pitched up 10-40 degrees and one above the
    canopy, its cells output on (raycast_rgb_cells_launch): the image
    bit-equal to render_rgb and the cells to its plain mirror
    render_rgb_exit's; on the contained scenes the clear exit stops the sky
    rays sooner than the exit on best alone."""
    from chip_smoke import above_canopy, up_poses

    cfg = raycast.make_config(640, 480)
    scene = orchard.make_params(device=cuda, **RAY_SCENES[scene_name])
    pos, cam = up_poses(torch.Generator().manual_seed(3), 8, cuda)
    a_pos, a_cam = above_canopy(cuda)
    pos, cam = torch.cat([pos, a_pos]), torch.cat([cam, a_cam])
    cells = torch.empty((9, 480, 640), dtype=torch.int32, device=cuda)
    got = cuda_raycast._launch_rgb(cfg, scene, pos, cam, cells)
    ref, ref_cells = raycast.render_rgb_exit(cfg, scene, pos, cam)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, raycast.render_rgb(cfg, scene, pos, cam))
    assert torch.equal(cells, ref_cells)
    assert torch.equal(cuda_raycast._launch_rgb(cfg, scene, pos, cam), got)
    before = raycast.render_rgb_exit(cfg, scene, pos, cam, clear=False)[1]
    if scene_name == "loose":
        assert int(cells.min()) == cfg.dda_steps
    else:
        assert float(cells.float().mean()) < 0.8 * float(before.float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["baked", "mixed", "edge"])
@pytest.mark.parametrize("B", [1, 4])
def test_mesh_kernels_bit_equal_to_plain(cuda, scene, B, tmp_path):  # noqa: F811
    """K4 and K4w at 640x480, one launch each for B cameras of random yaw:
    K4's in-kernel strip culling keeps strip_windows' n_vis rows per
    strip, and its codes equal render_strips', render_depth_window's,
    render_depth_window_prepared's and K4w's; on the baked orchard and on
    the scene of primitives and OBJ triangles that chip_smoke.py writes and
    loads, with the frame's 192-row window and a 300-row one (two staged
    chunks), also shuffled (rows in both chunks), and on chip_smoke.py's
    window of edge-case rows (its first B cameras)."""
    from chip_smoke import baked_orchard, edge_rows, mesh_poses, mixed_scene, shuffled_window

    cfg = raycast.make_config(640, 480)
    if scene == "edge":
        windows, pos, cam = (t[:B] for t in edge_rows(cuda))
        cases = [(windows, windows.shape[1])]
    else:
        mesh = baked_orchard(cuda) if scene == "baked" else mixed_scene(cuda, tmp_path)
        pos, cam = mesh_poses(torch.Generator().manual_seed(B), B, cuda)
        reach = cfg.far * meshscene.slant_factor(cfg)
        cases = [(meshscene.select_window(mesh, pos, reach, capacity), min(capacity, mesh.count))
                 for capacity in (192, 300)]
        # the 300-row window's visible rows all lie in its first staged chunk;
        # shuffled, both chunks hold some
        shuffled, _ = shuffled_window(cases[1][0], cases[1][0][..., 0].int())
        cases.append((shuffled, cases[1][1]))
    for windows, rows in cases:
        before = (cuda_meshscene.render_depth_strips_batch.launches,
                  cuda_meshscene.render_depth_window_batch.launches)
        k4 = cuda_meshscene.render_depth_strips_batch(cfg, windows, pos, cam)
        k4w = cuda_meshscene.render_depth_window_batch(cfg, windows, pos, cam)
        torch.cuda.synchronize()
        assert (cuda_meshscene.render_depth_strips_batch.launches,
                cuda_meshscene.render_depth_window_batch.launches) == (before[0] + 1,
                                                                       before[1] + 1)
        nvis = torch.full((B, 480 // cuda_meshscene.TILE_H), -1, dtype=torch.int32, device=cuda)
        again = cuda_meshscene._launch("meshscene_strips_launch", cfg, pos, cam, windows, nvis)
        strips, nvis_r = meshscene.strip_windows(cfg, windows, pos, cam, cuda_meshscene.TILE_H)
        ref4 = meshscene.render_strips(cfg, strips, pos, cam)
        ref4w = meshscene.render_depth_window(cfg, windows, pos, cam)
        assert k4.shape == (B, 480, 640) and windows.shape[1] == rows
        assert torch.equal(nvis, nvis_r) and torch.equal(again, k4)
        assert torch.equal(k4, ref4) and torch.equal(k4w, ref4w) and torch.equal(k4, k4w)
        assert torch.equal(meshscene.render_depth_window_prepared(cfg, windows, pos, cam), ref4w)
        assert k4.unique().numel() > 20 and float(nvis.float().mean()) < 96


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", list(RAY_SCENES))
@pytest.mark.parametrize("B", [1, 16])
def test_raycast_rgb_kernel_bit_equal_to_plain(cuda, B, scene_name):  # noqa: F811
    """K1-rgb at 640x480, one launch for B cameras and one above the canopy
    (every tree it meets lies beyond the far plane, where K1's depth exit
    would stop), bit-equal to render_rgb; a pixel of the sky's colour has
    K1's depth code 255."""
    from chip_smoke import above_canopy, sky_bytes

    cfg = raycast.make_config(640, 480)
    scene = orchard.make_params(device=cuda, **RAY_SCENES[scene_name])
    pos, cam = _poses(B, B, cuda)
    up_pos, up_cam = above_canopy(cuda)
    pos, cam = torch.cat([pos, up_pos]), torch.cat([cam, up_cam])
    before = cuda_raycast.render_rgb_batch.launches
    got = cuda_raycast.render_rgb_batch(cfg, scene, pos, cam)
    ref = raycast.render_rgb(cfg, scene, pos, cam)
    depth = cuda_raycast.render_depth_batch(cfg, scene, pos, cam)
    torch.cuda.synchronize()
    assert cuda_raycast.render_rgb_batch.launches == before + 1
    assert got.shape == (B + 1, 480, 640, 3) and got.dtype == torch.uint8
    assert torch.equal(got, ref)
    assert torch.unique(got[:B].reshape(-1, 3), dim=0).shape[0] > 20
    is_sky = (got == sky_bytes(cfg, cuda)).all(-1)
    assert bool((depth[is_sky] == 255).all())
    assert int(depth[-1].min()) == 255 and int((~is_sky[-1]).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["baked", "mixed", "edge"])
@pytest.mark.parametrize("B", [1, 4])
def test_mesh_rgb_kernel_bit_equal_to_plain(cuda, scene, B, tmp_path):  # noqa: F811
    """K4-rgb at 640x480, one launch for B cameras of random yaw and one
    above the canopy (its window holds rows beyond the far plane), equal
    bit for bit to render_rgb_strips and render_rgb_window, with the
    frame's 192-row window, a 300-row one (two staged chunks) and that one
    shuffled, where rows of both chunks win pixels (the image changes where
    either chunk's rows are dropped); and on chip_smoke.py's edge rows, all
    five cameras (camera 4 meets two rows at the same t: the earlier row
    wins). render_rgb_batch launches it whatever strip_cull says."""
    from chip_smoke import (above_canopy, baked_orchard, edge_rows, mesh_poses, mixed_scene,
                            shuffled_window)

    cfg = raycast.make_config(640, 480)
    if scene == "edge":
        windows, pos, cam = edge_rows(cuda)
        cases = [(windows, torch.where(windows[..., 0] == meshscene.PRIM_CYLINDER,
                                       meshscene.MAT_TRUNK, meshscene.MAT_CANOPY).to(torch.int32))]
    else:
        mesh = baked_orchard(cuda) if scene == "baked" else mixed_scene(cuda, tmp_path)
        pos, cam = mesh_poses(torch.Generator().manual_seed(B), B, cuda)
        up_pos, up_cam = above_canopy(cuda)
        pos, cam = torch.cat([pos, up_pos]), torch.cat([cam, up_cam])
        reach = cfg.far * meshscene.slant_factor(cfg)
        cases = []
        for capacity in (192, 300):
            windows, order, ok = meshscene.select_window(mesh, pos, reach, capacity,
                                                         return_order=True)
            cases.append((windows, meshscene.window_materials(mesh, windows, order, ok)))
        cases.append(shuffled_window(*cases[1]))
        before = cuda_meshscene.render_rgb_strips_batch.launches
        for strip_cull in (None, False):
            got = cuda_meshscene.render_rgb_batch(cfg, mesh, pos, cam, strip_cull=strip_cull)
            assert torch.equal(got, meshscene.render_rgb_strips(cfg, *cases[0], pos, cam))
        assert cuda_meshscene.render_rgb_strips_batch.launches == before + 2
    for windows, mats in cases:
        got = cuda_meshscene.render_rgb_strips_batch(cfg, windows, mats, pos, cam)
        strips = meshscene.render_rgb_strips(cfg, windows, mats, pos, cam)
        plain = meshscene.render_rgb_window(cfg, windows, mats, pos, cam)
        torch.cuda.synchronize()
        assert got.shape == (pos.shape[0], 480, 640, 3) and got.dtype == torch.uint8
        assert torch.equal(got, strips) and torch.equal(got, plain)
        assert torch.unique(got.reshape(-1, 3), dim=0).shape[0] > 20
    if scene != "edge":
        windows, mats = cases[-1]
        for rows in (slice(None, 256), slice(256, None)):
            dropped = windows.clone()
            dropped[:, rows, 0] = 0
            assert not torch.equal(
                cuda_meshscene.render_rgb_strips_batch(cfg, dropped, mats, pos, cam), got)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_mesh_rgb_kernel_ragged_width(cuda, B):  # noqa: F811
    """K4-rgb at 600x480, a width that is not a multiple of the tile's 32
    columns, so that the last tile of each strip is ragged: bit-equal to
    render_rgb_strips and render_rgb_window on the baked orchard."""
    from chip_smoke import above_canopy, baked_orchard, mesh_poses

    cfg = raycast.make_config(600, 480)
    mesh = baked_orchard(cuda)
    pos, cam = mesh_poses(torch.Generator().manual_seed(B), B, cuda)
    up_pos, up_cam = above_canopy(cuda)
    pos, cam = torch.cat([pos, up_pos]), torch.cat([cam, up_cam])
    windows, order, ok = meshscene.select_window(mesh, pos, cfg.far * meshscene.slant_factor(cfg),
                                                 192, return_order=True)
    mats = meshscene.window_materials(mesh, windows, order, ok)
    strips = meshscene.render_rgb_strips(cfg, windows, mats, pos, cam)
    assert torch.equal(strips, meshscene.render_rgb_window(cfg, windows, mats, pos, cam))
    got = cuda_meshscene.render_rgb_strips_batch(cfg, windows, mats, pos, cam)
    torch.cuda.synchronize()
    assert got.shape == (B + 1, 480, 600, 3) and torch.equal(got, strips)


def test_mesh_constants_match_the_kernel_source():
    """cuda_meshscene's strip height, and chip_smoke.py's tile width and
    section names, follow meshscene.cu."""
    from chip_smoke import MESH_SECTIONS, MESH_TILE_W

    src = (CSRC / "meshscene.cu").read_text()
    assert _constant(src, "kTileH") == cuda_meshscene.TILE_H
    assert _constant(src, "kLaneCols") * _constant(src, "kPixels") == MESH_TILE_W
    body = re.search(r"enum Section \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "kNumSections" and len(names) - 1 == len(MESH_SECTIONS)
    assert [n[4:].lower() for n in names[:-1]] == list(MESH_SECTIONS)


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


EVERY_S = list(range(2, cuda_inflate.MAX_SEEDS_PER_PROGRAM + 1))  # K2g's cluster sizes


@pytest.mark.cuda
@pytest.mark.parametrize("S", EVERY_S)
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
@pytest.mark.parametrize("S", EVERY_S)
@pytest.mark.parametrize("kind", ["clutter", "gradient"])
def test_grouped_inflate_kernel_ragged_and_gradient(cuda, kind, S):  # noqa: F811
    """P = 13 seeds with S seeds a cluster (pad rows where S does not divide
    13) on a cluttered and on the blocker-free gradient scene at 320x240,
    with the pooled path's margin."""
    W, H = 320, 240
    params = rappids.make_params(rappids.make_camera(W, H, focal=W / 2.0, device=cuda),
                                 0.116, 0.174)
    img = make_scene(W, H, 8, seed=3) if kind == "clutter" else gradient_scene(W, H)
    rng = np.random.default_rng(13)
    seeds = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(30, W - 30, 13).astype(np.float32),
        rng.integers(30, H - 30, 13).astype(np.float32),
        rng.uniform(1.5, 3.0, 13).astype(np.float32))]
    assert _assert_grouped(params, torch.from_numpy(img).to(cuda), seeds, S, 1) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("S", EVERY_S)
def test_grouped_inflate_kernel_batched(cuda, S):  # noqa: F811
    """Four orchard views x 128 endpoint seeds in one launch."""
    params = rappids.make_params(rappids.make_camera(640, 480, device=cuda), 0.116, 0.174)
    pos = torch.tensor([[5.0, 0.0, 2.5], [12.0, 1.5, 2.0], [20.0, -1.0, 3.0],
                        [30.0, 0.5, 1.5]], device=cuda)
    att = raycast.camera_attitude(rot.identity(cuda).expand(4, 4))
    imgs = cuda_raycast.render_depth_batch(raycast.make_config(640, 480),
                                           orchard.make_params(device=cuda), pos, att)
    assert _assert_grouped(params, imgs, _endpoint_seeds(params, 128, 4, (4,)), S) >= 4


@pytest.mark.cuda
def test_grouped_inflate_refused_launch_raises(cuda):  # noqa: F811
    """A group size with no compiled cluster (S = 9) is refused by the
    launch, and the wrapper raises: no fall back to K2 or the plain version."""
    img = torch.from_numpy(gradient_scene(320, 240)).to(cuda)
    rows = torch.zeros((9, 12), dtype=torch.int32, device=cuda)
    before = cuda_inflate.inflate_pyramids.grouped_launches
    with pytest.raises(RuntimeError, match="inflate_grouped_launch"):
        cuda_inflate._launch_grouped(img, rows, 9)
    assert cuda_inflate.inflate_pyramids.grouped_launches == before


def _env_case(device, B, seed):
    """A fleet of B envs spread apart, a command with every term on and a
    per-env setpoint, and 50 ticks of IMU noise."""
    g = torch.Generator().manual_seed(seed)
    p = env.make_params(device=device)
    pos = torch.rand((B, 3), generator=g) * torch.tensor([4.0, 4.0, 0.0])
    s0 = env.init_state_fleet(p, pos.to(device))
    cmd = env.Command(des_pos=(pos + torch.tensor([0.2, -0.1, 1.2])).to(device),
                      des_vel=torch.tensor([0.05, 0.0, -0.02], device=device),
                      des_acc=torch.tensor([0.1, -0.05, 0.2], device=device),
                      des_yaw=(torch.rand(B, generator=g) - 0.5).to(device),
                      ext_force=torch.tensor([0.01, -0.02, 0.005], device=device),
                      ext_torque=torch.tensor([2e-5, -1e-5, 3e-5], device=device))
    return p, s0, cmd, torch.randn((B, 50, 2, 3), generator=g).to(device)


def _compare_env(got, ref, traj, ref_traj):
    leaves, rebuild = convert.flatten_tensors(ref)
    compare_state(got, rebuild([t.cpu() for t in leaves]))
    for name, a, b in zip(env.StepOutputs._fields, traj, ref_traj):
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            bound = 1e-3 * (b.double().abs() + 1e-3)
            assert float(((a.double() - b.double()).abs() / bound).max()) <= 1.0, name
        else:
            assert torch.equal(a, b), name


def _equal_env(got, ref, traj, ref_traj):
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref)):
        assert torch.equal(a, b), path
    for name, a, b in zip(env.StepOutputs._fields, traj, ref_traj):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("group", cuda_rollout.GROUPS)
@pytest.mark.parametrize("ctrl_mode", ["rates", "position", "idle"])
@pytest.mark.parametrize("use_estimator", [False, True, "gpsimu"])
def test_env_rollout_kernel_matches_plain(cuda, use_estimator, ctrl_mode, group,  # noqa: F811
                                          monkeypatch):
    """K5 with `group` lanes per env against the plain rollout on the card
    in every estimator mode and every ctrl_mode: 25 ticks from the start,
    then 25 from the kernel's mid-flight state (nonzero step, warm
    cadences), B = 37 (not a multiple of a block's 32 envs), one launch
    each, tick criteria; and bit for bit equal to one lane per env."""
    p, s0, cmd, noise = _env_case(cuda, 37, 3)

    def run(state, nz, lanes):
        monkeypatch.setattr(cuda_rollout, "GROUP", lanes)
        return cuda_rollout.rollout(p, state, cmd, nz, use_estimator, ctrl_mode)

    before = cuda_rollout.rollout.launches
    got, traj = run(s0, noise[:, :25], group)
    ref, ref_traj = env.rollout_plain(p, s0, cmd, noise[:, :25], use_estimator, ctrl_mode)
    torch.cuda.synchronize()
    assert cuda_rollout.rollout.launches == before + 1
    _compare_env(got, ref, traj, ref_traj)
    one, one_traj = run(s0, noise[:, :25], 1)
    _equal_env(got, one, traj, one_traj)
    mid, ref_mid = got, ref
    got, traj = run(mid, noise[:, 25:], group)
    ref, ref_traj = env.rollout_plain(p, ref_mid, cmd, noise[:, 25:], use_estimator, ctrl_mode)
    torch.cuda.synchronize()
    assert torch.equal(got.step.cpu(), torch.full((37,), 50, dtype=torch.int32))
    _compare_env(got, ref, traj, ref_traj)
    one, one_traj = run(mid, noise[:, 25:], 1)
    _equal_env(got, one, traj, one_traj)


@pytest.mark.cuda
@pytest.mark.parametrize("group", cuda_rollout.GROUPS)
@pytest.mark.parametrize("use_estimator", [False, True, "gpsimu"])
def test_env_rollout_uwb_kernel_matches_plain(cuda, use_estimator, group,  # noqa: F811
                                              monkeypatch):
    """K5's UWB variant (rollout.cu built with TICK_UWB) in every estimator
    mode, position commands (the onboard-UWB configuration), a network
    with noise, outliers and reported failures: 25 ticks from the start and
    25 from mid-flight, B = 37, one launch each, against the plain rollout
    on the card by the tick criteria, and bit for bit equal to one lane per
    env."""
    from agrifly_tpu_torch.sim import uwb

    p, s0, cmd, noise = _env_case(cuda, 37, 7)
    p = env.with_uwb_anchors(p, [101, 102, 103, 104],
                             [[-3.0, -3.0, 0.1], [3.0, -3.0, 0.2], [3.0, 3.0, 2.0], [-3.0, 3.0, 1.5]],
                             noise_std=0.05, outlier_prob=0.1, outlier_std=2.0, failure_prob=0.05)
    s0 = env.init_state_fleet(p, s0.plant.pos)
    draws = uwb.draw((37, 50), torch.Generator().manual_seed(8)).to(cuda)

    def run(state, k0, lanes):
        monkeypatch.setattr(cuda_rollout, "GROUP", lanes)
        return cuda_rollout.rollout(p, state, cmd, noise[:, k0:k0 + 25], use_estimator, "position",
                                    uwb_draws=draws[:, k0:k0 + 25])

    before = cuda_rollout.rollout.launches
    got, traj = run(s0, 0, group)
    ref, ref_traj = env.rollout_plain(p, s0, cmd, noise[:, :25], use_estimator, "position",
                                      uwb_draws=draws[:, :25])
    torch.cuda.synchronize()
    assert cuda_rollout.rollout.launches == before + 1
    _compare_env(got, ref, traj, ref_traj)
    one, one_traj = run(s0, 0, 1)
    _equal_env(got, one, traj, one_traj)
    got2, traj2 = run(got, 25, group)
    ref2, ref_traj2 = env.rollout_plain(p, ref, cmd, noise[:, 25:], use_estimator, "position",
                                        uwb_draws=draws[:, 25:])
    torch.cuda.synchronize()
    _compare_env(got2, ref2, traj2, ref_traj2)
    one, one_traj = run(got, 25, 1)
    _equal_env(got2, one, traj2, one_traj)
    assert int(got2.logic.uwb_meas_count.sum()) > 0


@pytest.mark.cuda
def test_env_rollout_shared_command_equals_its_per_env_expansion(cuda):  # noqa: F811
    """The kernel reads a shared command leaf through a stride of 0: the
    same rollout as the leaf expanded to every env, bit for bit."""
    p, s0, cmd, noise = _env_case(cuda, 37, 6)
    expanded = env.Command(*(t if t.dim() > base else t.expand((37,) + t.shape).contiguous()
                             for t, base in zip(cmd, env._BASE_DIMS)))
    got = cuda_rollout.rollout(p, s0, cmd, noise, True)
    ref = cuda_rollout.rollout(p, s0, expanded, noise, True)
    torch.cuda.synchronize()
    _equal_env(got[0], ref[0], got[1], ref[1])


def test_rollout_section_names_match_the_kernel_source():
    """chip_smoke.py's K5 section names follow rollout.cu's Section enum."""
    from chip_smoke import ROLLOUT_SECTIONS

    body = re.search(r"enum Section \{([^}]*)\}", (CSRC / "rollout.cu").read_text()).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "kNumSections" and len(names) - 1 == len(ROLLOUT_SECTIONS)


def test_wire_row_layout_matches_the_kernel_source():
    """io/bridge.py's _TB_* columns are rollout.cu's kRow* word offsets (the
    tick block's wire row), in order and without gaps."""
    from agrifly_tpu_torch.io import bridge

    src = (CSRC / "rollout.cu").read_text()
    columns = [("kRowPos", bridge._TB_POS), ("kRowVel", bridge._TB_VEL),
               ("kRowAtt", bridge._TB_ATT), ("kRowAngvel", bridge._TB_ANGVEL),
               ("kRowAccF", bridge._TB_ACCF), ("kRowGyroF", bridge._TB_GYROF),
               ("kRowVelB", bridge._TB_VELB), ("kRowMocapPos", bridge._TB_MPOS),
               ("kRowMocapVel", bridge._TB_MVEL), ("kRowMocapAtt", bridge._TB_MATT),
               ("kRowMocapAngvel", bridge._TB_MANGVEL),
               ("kRowTelNum", slice(bridge._TB_TELNUM, bridge._TB_TELNUM + 1)),
               ("kRowTelD1", bridge._TB_TELD1), ("kRowTelD2", bridge._TB_TELD2)]
    end = 0
    for name, cols in columns:
        assert int(re.search(rf"\b{name} = (\d+)", src).group(1)) == cols.start == end, name
        end = cols.stop
    words = int(re.search(r"\bkRowWords = (\d+)", src).group(1))
    assert words == end == bridge._TB_COLS == cuda_rollout.ROW_WORDS
    assert _constant(src, "kTickBlockGroup") == cuda_rollout.TICK_BLOCK_GROUP


def _wire_masks(n, fires, device):
    fire = torch.zeros(n, dtype=torch.int8)
    fire[list(fires)] = 1
    return fire.to(device)


def _tick_blocks_equal(p, cmd, use_estimator, ctrl_mode, gen, device, uwb_on=False):
    """Blocks of 1, 5, 7 and 40 ticks chained from a cold state through
    K5's wire-row instance and through tick_block_plain on the card,
    telemetry firing on the first tick, the last, both, and on the bridge's
    schedule: the rows and every state leaf bit for bit, one launch a
    block."""
    from agrifly_tpu_torch.sim import uwb

    mine = ref = env.init_state(p)
    before = cuda_rollout.tick_block.launches
    blocks = ((1, [0]), (5, [4]), (7, [0, 6]), (40, list(range(4, 40, 5))))
    for n, fires in blocks:
        noise = torch.randn((n, 2, 3), generator=gen).to(device)
        draws = uwb.draw((n,), gen).to(device) if uwb_on else None
        fire = _wire_masks(n, fires, device)
        mine, rows = cuda_rollout.tick_block(p, mine, cmd, noise, fire, use_estimator, ctrl_mode,
                                             uwb_draws=draws)
        ref, ref_rows = cuda_rollout.tick_block_plain(p, ref, cmd, noise, fire, use_estimator,
                                                      ctrl_mode, uwb_draws=draws)
        torch.cuda.synchronize()
        assert rows.shape == (n, cuda_rollout.ROW_WORDS) and torch.equal(rows, ref_rows), n
        for (path, a), (_, b) in zip(convert.leaves(mine), convert.leaves(ref)):
            assert torch.equal(a, b), (n, path)
    assert cuda_rollout.tick_block.launches == before + len(blocks)
    assert int(mine.logic.tel_counter) == sum(len(f) for _, f in blocks)
    return mine


@pytest.mark.cuda
@pytest.mark.parametrize("use_estimator", [False, True, "gpsimu"])
def test_tick_block_kernel_matches_plain(cuda, use_estimator):  # noqa: F811
    """K5's wire-row instance (env_tick_block_launch) against
    tick_block_plain on the card in every estimator mode, bit for bit."""
    p = env.make_params(noise_scale=1.0, device=cuda)
    cmd = env.hover_command((0.0, 0.0, 1.0), device=cuda)
    _tick_blocks_equal(p, cmd, use_estimator, "rates", torch.Generator().manual_seed(11), cuda)


@pytest.mark.cuda
def test_tick_block_uwb_kernel_matches_plain(cuda):  # noqa: F811
    """The TICK_UWB build's wire-row instance, with anchors, position
    commands and the network's draws, bit for bit against tick_block_plain."""
    p = env.with_uwb_anchors(env.make_params(noise_scale=1.0, device=cuda), [101, 102, 103, 104],
                             [[-3.0, -3.0, 0.1], [3.0, -3.0, 0.2], [3.0, 3.0, 2.0],
                              [-3.0, 3.0, 1.5]], noise_std=0.05)
    cmd = env.hover_command((0.5, -0.5, 1.5), device=cuda)
    end = _tick_blocks_equal(p, cmd, False, "position", torch.Generator().manual_seed(12), cuda,
                             uwb_on=True)
    assert int(end.logic.uwb_meas_count) > 0


@pytest.mark.cuda
def test_tick_block_wrapper_refuses_what_the_kernel_does_not_take(cuda):  # noqa: F811
    """A mask of another length, type or device, and noise of another row
    count or shape, raise before any launch."""
    p = env.make_params(device=cuda)
    s = env.init_state(p)
    cmd = env.hover_command(device=cuda)
    noise = torch.randn((7, 2, 3), device=cuda)
    fire = _wire_masks(7, [0], cuda)
    before = cuda_rollout.tick_block.launches
    cases = [(noise, fire[:6], "mask"), (noise, fire.float(), "mask"),
             (noise, fire.cpu(), "mask"), (noise[:6], fire, "mask"),
             (noise[None], fire, "noise"), (noise[:, :1], fire, "noise")]
    for nz, f, what in cases:
        with pytest.raises(ValueError, match=what):
            cuda_rollout.tick_block(p, s, cmd, nz, f, True)
    assert cuda_rollout.tick_block.launches == before


@pytest.mark.cuda
def test_env_rollout_one_env_and_the_entry_points(cuda):  # noqa: F811
    """One env (no leading B) through env.rollout and rollout_fast on the
    card: the kernel, equal to the plain rollout; rollout_sampled (the true
    state) keeps every 5th output of a rollout's launch."""
    p, _, _, noise = _env_case(cuda, 1, 4)
    s0 = env.init_state(p)
    cmd = env.hover_command((0.0, 0.0, 1.0), device=cuda)
    before = cuda_rollout.rollout.launches
    got, traj = env.rollout(p, s0, cmd, 50, True, noise=noise[0])
    fast, fast_traj = env.rollout_fast(p, s0, cmd, 50, True, noise=noise[0])
    _, sampled = env.rollout_sampled(p, s0, cmd, 50, 5, noise=noise[0])
    _, true_traj = env.rollout(p, s0, cmd, 50, noise=noise[0])
    assert cuda_rollout.rollout.launches == before + 4
    ref, ref_traj = env.rollout_plain(p, s0, cmd, noise[0], True)
    torch.cuda.synchronize()
    assert traj.pos.shape == (50, 3) and got.step.shape == ()
    _compare_env(got, ref, traj, ref_traj)
    _compare_env(fast, ref, fast_traj, ref_traj)
    assert torch.equal(sampled.pos, true_traj.pos[4::5])


@pytest.mark.cuda
def test_env_rollout_wrapper_refuses_what_the_kernel_does_not_take(cuda):  # noqa: F811
    """tick.cuh's leaf table holds every call: a wrong dtype, a wrong
    leading B, a CPU tensor among CUDA ones; nothing falls back."""
    p, s0, cmd, noise = _env_case(cuda, 4, 5)
    noise = noise[:, :5].contiguous()
    before = cuda_rollout.rollout.launches
    cases = [
        (s0._replace(step=s0.step.to(torch.int64)), cmd, noise, p, "step"),
        (s0._replace(plant=s0.plant._replace(pos=s0.plant.pos[:3])), cmd, noise, p, "plant.pos"),
        (s0, cmd, noise[:3], p, "noise"),
        (s0, cmd, noise.double(), p, "noise"),
        (s0._replace(mocap_acc_us=s0.mocap_acc_us.cpu()), cmd, noise, p, "mocap_acc_us"),
        (s0, cmd._replace(des_pos=cmd.des_pos.cpu()), noise, p, "des_pos"),
        (s0, cmd._replace(des_yaw=torch.zeros(3, device=cuda)), noise, p, "des_yaw"),
        (s0, cmd, noise, p._replace(dt_us=p.dt_us.cpu()), "dt_us"),
    ]
    for s, c, n, pp, what in cases:
        with pytest.raises(ValueError, match=what):
            cuda_rollout.rollout(pp, s, c, n)
    # the launch refuses a group it was not built for: the wrapper raises
    entries = [cuda_rollout._accept(kind, tree, noise.device, lambda leaves: None)
               for kind, tree in (("state", s0), ("params", p))]
    with pytest.raises(RuntimeError, match="env_rollout_launch"):
        cuda_rollout._launch(*entries, cuda_rollout._command(cmd, 4, noise.device), noise, False,
                             "rates", group=3)
    # the UWB variant's launch refuses a call without its draws
    with pytest.raises(RuntimeError, match="env_rollout_launch"):
        cuda_rollout._launch(*entries, cuda_rollout._command(cmd, 4, noise.device), noise, False,
                             "rates", launcher=cuda_rollout._launcher(True))
    assert cuda_rollout.rollout.launches == before


def _to(tree, device):
    leaves, rebuild = convert.flatten_tensors(tree)
    return rebuild([t.to(device) for t in leaves])


def _cpu(tree):
    return _to(tree, "cpu")


def test_fleet_kernel_constants_match_the_sources():
    """K6's vehicle and radio caps and the wind build's draw words, as the
    wrappers assume them."""
    src = (CSRC / "fleet_uwb.cu").read_text()
    assert _constant(src, "kMaxVehicles") == cuda_fleet_uwb.MAX_VEHICLES
    assert _constant((CSRC / "tick.cuh").read_text(), "kMaxRadios") == cuda_fleet_uwb.MAX_RADIOS
    assert re.search(r"constexpr int kWindDrawWords = 3;", (CSRC / "rollout.cu").read_text())


def _wind_case(device, B, n, seed, wind=None):
    g = torch.Generator().manual_seed(seed)
    w = wind or dict(mean=(2.0, 0.0, 0.0), gust_std=1.0, force_gain=0.02)
    p = fleet_env.FleetParams(env.make_params(device=device),
                              fleet_env.make_wind(**w, device=device))
    s0 = fleet_env.init_fleet(p, B, spacing=1.5)
    des = (torch.rand((B, 3), generator=g) * 2.0 + torch.tensor([0.0, 0.0, 0.5])).to(device)
    return (p, s0, des, torch.randn((B, n, 2, 3), generator=g).to(device),
            torch.randn((n, B, 3), generator=g).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("use_estimator", [True, False])
def test_fleet_rollout_wind_kernel_matches_plain(cuda, use_estimator):  # noqa: F811
    """fleet_rollout on the card is one launch of K5's wind build, within
    the tick criteria of the plain rollout; every group size equals one
    lane bit for bit."""
    p, s0, des, noise, gusts = _wind_case(cuda, 37, 40, 3)
    before = cuda_rollout.fleet_rollout.launches
    got, _ = fleet_env.fleet_rollout(p, s0, des, 40, use_estimator, noise=noise,
                                     wind_noise=gusts)
    assert cuda_rollout.fleet_rollout.launches == before + 1
    ref = fleet_env.fleet_rollout_plain(p, s0, des, noise, gusts, use_estimator)
    compare_state(got, _cpu(ref))
    assert float((got.wind_vel - p.wind.mean).abs().max()) > 1e-2
    outs = {}
    for group in cuda_rollout.GROUPS:
        monkey = cuda_rollout.GROUP
        cuda_rollout.GROUP = group
        try:
            outs[group] = cuda_rollout.fleet_rollout(p, s0, des, noise, gusts, use_estimator)
        finally:
            cuda_rollout.GROUP = monkey
    for group, out in outs.items():
        for (path, a), (_, b) in zip(convert.leaves(out), convert.leaves(outs[1])):
            assert torch.equal(a, b), (group, path)


@pytest.mark.cuda
def test_fleet_rollout_calm_wind_equals_the_env_rollout(cuda):  # noqa: F811
    """With no wind (sigma 0, gain 0) the wind build flies the env rollout's
    fleet bit for bit."""
    p, s0, des, noise, gusts = _wind_case(cuda, 9, 30, 4, dict(mean=(0.0, 0.0, 0.0),
                                                                gust_std=0.0, force_gain=0.0))
    got, _ = fleet_env.fleet_rollout(p, s0, des, 30, noise=noise, wind_noise=gusts)
    z3 = torch.zeros(3, device=cuda)
    ref, _ = env.rollout(p.base, s0.envs, env.Command(des, z3, z3, z3[0], z3, z3), 30, True,
                         noise=noise)
    for (path, a), (_, b) in zip(convert.leaves(got.envs), convert.leaves(ref)):
        assert torch.equal(a, b), path


def test_wind_uwb_draw_words_match_the_kernel_source():
    """K5's TICK_WIND + TICK_UWB build takes a tick's seven draw words as
    cuda_rollout.fleet_rollout lays them out: the network's four draws
    (sim/uwb.draw's order, read by uwb_step at draws + 0), then the three
    gust normals (read by wind_force after them)."""
    src = (CSRC / "rollout.cu").read_text()
    assert re.search(r"constexpr int kUwbDrawWords = 4;", src)
    assert "constexpr int kDrawWords = kUwbDrawWords + kWindDrawWords;" in src
    assert "wind_force(P, S, draws + kUwbDrawWords)" in src
    assert "uwb_step(P, S, draws)" in (CSRC / "tick.cuh").read_text()
    assert uwb.N_DRAWS == 4
    gusts, draws = torch.randn((5, 3, 3)), torch.randn((3, 5, 4))
    words = cuda_rollout.fleet_draw_words(gusts, draws)
    assert words.shape == (3, 5, 7) and words.is_contiguous()
    assert torch.equal(words[..., :4], draws)
    assert torch.equal(words[..., 4:], gusts.transpose(0, 1))
    assert torch.equal(cuda_rollout.fleet_draw_words(gusts), gusts.transpose(0, 1))


def _wind_uwb_case(device, B, n, seed):
    """`_wind_case`'s fleet with a UWB network on every vehicle
    (tests/test_fleet_and_bridge.py's anchors, noise_std 0.05) and each
    vehicle's network draws (B, n, 4)."""
    p, _, des, noise, gusts = _wind_case(device, B, n, seed)
    p = p._replace(base=env.with_uwb_anchors(
        p.base, [101, 102, 103, 104, 105],
        [[-5.0, -4.0, 0.1], [6.0, -4.0, 3.0], [6.0, 6.0, 0.2], [-5.0, 6.0, 3.0], [0.5, 1.0, 4.0]],
        comm_period=0.005, noise_std=0.05))
    draws = uwb.draw((B, n), torch.Generator().manual_seed(seed + 1)).to(device)
    return p, fleet_env.init_fleet(p, B, spacing=1.5), des, noise, gusts, draws


@pytest.mark.cuda
@pytest.mark.parametrize("use_estimator", [True, False])
def test_fleet_rollout_wind_uwb_kernel_matches_plain(cuda, use_estimator):  # noqa: F811
    """A wind fleet whose vehicles each range their own anchors:
    fleet_rollout on the card is one launch of K5's TICK_WIND + TICK_UWB
    build, bit-equal to the plain rollout on the card and within the tick
    criteria of the plain rollout on the CPU; every group size equals one
    lane bit for bit."""
    p, s0, des, noise, gusts, draws = _wind_uwb_case(cuda, 37, 60, 5)
    before = cuda_rollout.fleet_rollout.launches
    got, _ = fleet_env.fleet_rollout(p, s0, des, 60, use_estimator, noise=noise,
                                     wind_noise=gusts, uwb_draws=draws)
    assert cuda_rollout.fleet_rollout.launches == before + 1
    on_card = fleet_env.fleet_rollout_plain(p, s0, des, noise, gusts, use_estimator, draws)
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(on_card)):
        assert torch.equal(a, b), path
    ref = fleet_env.fleet_rollout_plain(_cpu(p), _cpu(s0), des.cpu(), noise.cpu(), gusts.cpu(),
                                        use_estimator, draws.cpu())
    compare_state(got, ref)
    assert int(got.envs.logic.uwb_meas_count.min()) > 0
    for group in cuda_rollout.GROUPS:
        monkey = cuda_rollout.GROUP
        cuda_rollout.GROUP = group
        try:
            other = cuda_rollout.fleet_rollout(p, s0, des, noise, gusts, use_estimator, draws)
        finally:
            cuda_rollout.GROUP = monkey
        for (path, a), (_, b) in zip(convert.leaves(other), convert.leaves(got)):
            assert torch.equal(a, b), (group, path)


def _uwb_fleet_case(device, n_vehicles, n_anchors, n, seed, wind=True):
    g = torch.Generator().manual_seed(seed)
    ids = list(range(101, 101 + n_anchors))
    pos = (torch.rand((n_anchors, 3), generator=g) * torch.tensor([10.0, 10.0, 4.0])
           - torch.tensor([5.0, 5.0, 0.0])).tolist()
    w = fleet_env.make_wind((1.0, 0.0, 0.0), 0.5, 2.0, 0.01, device=device) if wind else None
    p = fleet_env.make_uwb_fleet_params(n_vehicles, ids, pos, wind=w, comm_period=0.004,
                                        noise_std=0.05, device=device)
    s0 = fleet_env.init_uwb_fleet(p, spacing=1.0)
    des = (torch.rand((n_vehicles, 3), generator=g) * 2.0 + torch.tensor([0.0, 0.0, 1.0]))
    return (p, s0, des.to(device), torch.randn((n_vehicles, n, 2, 3), generator=g).to(device),
            torch.randn((n, n_vehicles, 3), generator=g).to(device),
            torch.cat([torch.rand((n, 1), generator=g), torch.randn((n, 2), generator=g),
                       torch.rand((n, 1), generator=g)], 1).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("n_vehicles,n_anchors", [(3, 5), (28, 5), (1, 2), (32, 1)])
def test_fleet_uwb_kernel_matches_plain(cuda, n_vehicles, n_anchors):  # noqa: F811
    """uwb_fleet_rollout on the card is one launch of K6: the network's state
    and latch_start equal to the plain version's, the vehicles within the
    tick criteria (idle, then position commands); every group size equals
    one lane bit for bit."""
    p, s, des, noise, gusts, draws = _uwb_fleet_case(cuda, n_vehicles, n_anchors, 60, n_vehicles)
    for ctrl in ("idle", "position"):
        before = cuda_fleet_uwb.rollout.launches
        got, _ = fleet_env.uwb_fleet_rollout(p, s, des, 60, ctrl, noise, gusts, draws)
        assert cuda_fleet_uwb.rollout.launches == before + 1
        ref = fleet_env.uwb_fleet_rollout_plain(p, s, des, noise, gusts, draws, ctrl)
        compare_state(got, _cpu(ref))
        for group in cuda_rollout.GROUPS:
            other = cuda_fleet_uwb.rollout(p, s, des, noise, gusts, draws, ctrl, group=group)
            for (path, a), (_, b) in zip(convert.leaves(other), convert.leaves(got)):
                assert torch.equal(a, b), (group, path)
        s = got
    if n_anchors:
        assert int(s.latch_start) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_vehicles,n_anchors", [(3, 5), (28, 5), (32, 1)])
def test_fleet_uwb_kernel_rates_mode_every_group(cuda, n_vehicles, n_anchors):  # noqa: F811
    """K6 in the rates mode after a position leg (120 ticks each), up to
    32 vehicles, where the network's warp is the block's only spare: within
    the tick criteria of the plain version run on the card and of the same
    plain version run on the CPU (the plain code rounds alike on both:
    ops/fmath), every group size bit-equal to the default."""
    p, s, des, noise, gusts, draws = _uwb_fleet_case(cuda, n_vehicles, n_anchors, 120,
                                                     n_vehicles + 7)
    s = cuda_fleet_uwb.rollout(p, s, des, noise, gusts, draws, "position")
    got = cuda_fleet_uwb.rollout(p, s, des, noise, gusts, draws, "rates")
    on_card = fleet_env.uwb_fleet_rollout_plain(p, s, des, noise, gusts, draws, "rates")
    compare_state(got, _cpu(on_card))
    ref = fleet_env.uwb_fleet_rollout_plain(_cpu(p), _cpu(s), des.cpu(), noise.cpu(),
                                            gusts.cpu(), draws.cpu(), "rates")
    compare_state(got, ref)
    for group in cuda_rollout.GROUPS:
        other = cuda_fleet_uwb.rollout(p, s, des, noise, gusts, draws, "rates", group=group)
        for (path, a), (_, b) in zip(convert.leaves(other), convert.leaves(got)):
            assert torch.equal(a, b), (group, path)
    assert int(got.latch_start) > int(s.latch_start)


@pytest.mark.cuda
@pytest.mark.parametrize("use_estimator", [True, False])
def test_plain_rollout_on_the_card_matches_the_cpu(cuda, use_estimator):  # noqa: F811
    """env.rollout_plain on CUDA tensors against the same plain rollout on
    the CPU: 8 envs from rest, a hover command, the closed loop over 250
    ticks (the mocap estimator's prediction and the commands' acos on the
    way), the tick criteria on every leaf and output. The plain code rounds
    alike on both devices: ops/fmath's sin, cos and exp through float64 and
    its exact division by python numbers (on the card torch multiplies by
    the float32 reciprocal)."""
    g = torch.Generator().manual_seed(0)
    p = env.make_params(noise_scale=1.0, device="cpu")
    s0 = env.init_state_fleet(p, torch.rand((8, 3), generator=g) * torch.tensor([4.0, 4.0, 0.0]))
    cmd = env.hover_command((0.0, 0.0, 1.5), device="cpu")
    noise = torch.randn((8, 250, 2, 3), generator=g)
    ref, ref_traj = env.rollout_plain(p, s0, cmd, noise, use_estimator)
    got, traj = env.rollout_plain(_to(p, cuda), _to(s0, cuda), _to(cmd, cuda), noise.to(cuda),
                                  use_estimator)
    torch.cuda.synchronize()
    _compare_env(got, ref, traj, ref_traj)
    assert float(ref.plant.pos[:, 2].min()) > 0.2  # climbing in the loop, no panic
    assert not bool(ref.logic.panic_reason.any())


def _bridge_launches():
    return {"depth": cuda_raycast.render_depth_batch.launches
            + cuda_meshscene.render_depth_strips_batch.launches,
            "rgb": cuda_raycast.render_rgb_batch.launches
            + cuda_meshscene.render_rgb_strips_batch.launches,
            "inflate": cuda_inflate.inflate_pyramids.launches
            + cuda_inflate.inflate_pyramids.cluster_launches,
            "ticks": cuda_frame.frame_ticks.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["procedural", "imported"])
def test_orchard_bridge_kernel_routes(cuda, world, monkeypatch):  # noqa: F811
    """OrchardBridge on the card at 160x112, two frames in one block: each
    frame launches the world's depth kernel twice (the planner's image and
    the published one), the inflation once per planner round, the tick
    kernel once and the RGB kernel once; each published depth image is the
    millimetre image of the planner's own input, and each RGB image the
    plain RGB render of the frame's pre-frame pose, bit for bit."""
    from agrifly_tpu_torch.io import bridge
    from chip_smoke import baked_orchard

    mesh = baked_orchard(cuda) if world == "imported" else None
    p = orchard_env.make_params(width=160, height=112, n_candidates=32, mesh_scene=mesh,
                                device=cuda)
    inputs = []
    plan = rappids.plan
    monkeypatch.setattr(rappids, "plan", lambda prm, depth, *a, **kw: (
        inputs.append(depth.clone()), plan(prm, depth, *a, **kw))[1])
    ob = bridge.OrchardBridge(p, vehicle_id=1, seed=5)
    images = {"depth": [], "rgb": []}
    ob.bus.subscribe("depthImage1", images["depth"].append)
    ob.bus.subscribe("rgbImage1", images["rgb"].append)
    pose = (ob.state.base.plant.pos.clone(), ob.state.base.plant.att.clone())
    before = _bridge_launches()
    ob.fly_frames_block(2)
    torch.cuda.synchronize()
    after = _bridge_launches()
    assert {k: after[k] - before[k] for k in after} == {
        "depth": 4, "rgb": 2, "inflate": 2 * (p.planner_rounds + 1), "ticks": 2}
    poses = [pose, (torch.from_numpy(ob.last_outs["pos"][0]).to(cuda),
                    torch.from_numpy(ob.last_outs["att"][0]).to(cuda))]
    scale = float(p.planner.cam.depth_scale)
    for i, (pos, att) in enumerate(poses):
        depth = np.frombuffer(images["depth"][i].data, "<u2").reshape(112, 160)
        want = bridge.depth_to_mm16(inputs[i][0].cpu().numpy() if inputs[i].dim() == 3
                                    else inputs[i].cpu().numpy(), scale)
        assert np.array_equal(depth, want), i
        cam = raycast.camera_attitude(att)
        plain = (raycast.render_rgb(p.render_cfg, p.scene, pos, cam) if mesh is None
                 else meshscene.render_rgb(p.render_cfg, mesh, pos, cam))
        rgb = np.frombuffer(images["rgb"][i].data, np.uint8).reshape(112, 160, 3)
        assert np.array_equal(rgb, plain.cpu().numpy()), i


@pytest.mark.cuda
def test_sim_bridge_on_the_card_publishes_the_cpu_bag(cuda, tmp_path):  # noqa: F811
    """SimBridge with the mocap estimator for 40 ticks on the card and on the
    CPU from the same draws: the same bag, byte for byte (the plain tick
    rounds alike on both devices); run_blocked on the card publishes the
    same messages with every value but the euler angles equal."""
    import json

    from agrifly_tpu_torch.io import bridge

    noise = torch.randn((40, 2, 3), generator=torch.Generator().manual_seed(9))
    bags = {}
    for name, dev, blocked in (("card", cuda, False), ("cpu", "cpu", False),
                               ("blocked", cuda, True)):
        at = [0]

        def draws(n, dev=dev):
            at[0] += n
            return noise[at[0] - n:at[0]].to(dev)

        br = bridge.SimBridge(env.make_params(noise_scale=1.0, device=dev), draws=draws)
        rec = bridge.MessageRecorder(br.bus, str(tmp_path / f"{name}.jsonl"))
        cmd = env.hover_command((0.0, 0.0, 1.0), device=dev)
        br.run_blocked(40, cmd, block=7) if blocked else br.run(40, cmd)
        rec.close()
        bags[name] = (tmp_path / f"{name}.jsonl").read_text()
    assert bags["card"] == bags["cpu"]
    ypr = ("attyaw", "attpitch", "attroll", "attitudeYPR")
    for a, b in zip(bags["blocked"].splitlines(), bags["card"].splitlines()):
        a, b = json.loads(a), json.loads(b)
        assert a["topic"] == b["topic"]
        for key, va in a["msg"].items():
            vb = b["msg"][key]
            if key in ypr:
                assert np.allclose(va, vb, rtol=0, atol=2e-6), key
            else:
                assert va == vb, key
    assert len(bags["card"].splitlines()) == len(bags["blocked"].splitlines()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("network", [False, True], ids=["mocap", "uwb"])
def test_sim_bridge_tick_on_the_card_equals_tick_plain(cuda, tmp_path, network):  # noqa: F811
    """SimBridge.tick on the card (one launch of K5's wire-row instance a
    tick, the row read once) against tick_plain (env.step) on the card, 40
    ticks with the mocap estimator, a kill after 20 and the telemetry
    firing, with and without a UWB network: the same bag byte for byte, euler
    angles included, the same final state leaf for leaf, one launch a
    tick."""
    from agrifly_tpu_torch.io import bridge, messages, radio
    from agrifly_tpu_torch.models import logic

    p = env.make_params(noise_scale=1.0, device=cuda)
    if network:
        p = env.with_uwb_anchors(p, [101, 102, 103, 104],
                                 [[-3.0, -3.0, 0.1], [3.0, -3.0, 0.2], [3.0, 3.0, 2.0],
                                  [-3.0, 3.0, 1.5]], noise_std=0.05, comm_period=0.01)
    g = torch.Generator().manual_seed(13)
    noise, draws = torch.randn((40, 2, 3), generator=g), uwb.draw((40,), g)
    kill = radio.fields_to_bytes(radio.TYPE_EMERGENCY_KILL, 0, np.zeros(radio.NUM_FIELDS, np.int64))
    bags, states = {}, {}
    for name in ("plain", "kernel"):
        at = [0, 0]

        def take(rows, i, n):
            at[i] += n
            return rows[at[i] - n:at[i]]

        br = bridge.SimBridge(p, draws=lambda n: take(noise, 0, n),
                              uwb_draws=(lambda n: take(draws, 1, n)) if network else None)
        rec = bridge.MessageRecorder(br.bus, str(tmp_path / f"{name}.jsonl"))
        cmd = env.hover_command((0.0, 0.0, 1.0), device=cuda)
        before = cuda_rollout.tick_block.launches
        for k in range(40):
            if k == 20:
                br.bus.publish("radio_command1", messages.RadioCommand(raw=kill))
            br.tick(cmd) if name == "kernel" else br.tick_plain(cmd)
        launches = cuda_rollout.tick_block.launches - before
        rec.close()
        bags[name], states[name] = (tmp_path / f"{name}.jsonl").read_text(), br.state
        assert launches == (40 if name == "kernel" else 0)
    assert bags["kernel"] == bags["plain"] and bags["plain"].count('"telemetry1"') == 7
    for (path, a), (_, b) in zip(convert.leaves(states["kernel"]), convert.leaves(states["plain"])):
        assert torch.equal(a, b), path
    assert int(states["kernel"].logic.fs) == logic.FS_KILLED
    assert not network or int(states["kernel"].logic.uwb_meas_count) > 0


@pytest.mark.cuda
def test_fleet_uwb_refuses_what_the_kernel_does_not_take(cuda):  # noqa: F811
    """Over the caps (33 vehicles; 30 vehicles and 4 anchors), a wrong
    dtype, a CPU tensor among CUDA ones: a ValueError and no launch; a group
    it was not built for: the launch refuses."""
    before = cuda_fleet_uwb.rollout.launches
    for n_vehicles, n_anchors in ((33, 1), (30, 4)):
        p, s, des, noise, gusts, draws = _uwb_fleet_case(cuda, n_vehicles, n_anchors, 5, 1)
        with pytest.raises(ValueError, match="radios"):
            fleet_env.uwb_fleet_rollout(p, s, des, 5, "position", noise, gusts, draws)
    p, s, des, noise, gusts, draws = _uwb_fleet_case(cuda, 3, 2, 5, 2)
    for args in ((noise.double(), gusts, draws), (noise, gusts.cpu(), draws),
                 (noise, gusts, draws[:4])):
        with pytest.raises(ValueError):
            fleet_env.uwb_fleet_rollout(p, s, des, 5, "position", *args)
    with pytest.raises(ValueError, match="latch_start"):
        fleet_env.uwb_fleet_rollout(p, s._replace(latch_start=s.latch_start.long()), des, 5,
                                    "position", noise, gusts, draws)
    assert cuda_fleet_uwb.rollout.launches == before
    with pytest.raises(RuntimeError, match="fleet_uwb_launch"):
        cuda_fleet_uwb.rollout(p, s, des, noise, gusts, draws, group=3)



def _plan_fields(res, core):
    tr, cost, feas, vel_ok, gate, free, pyrs = core
    return dict(found=res.found, best_idx=res.best_idx, best_cost=res.best_cost,
                num_pyramids=res.num_pyramids,
                **{f"winner.{k}": v for k, v in res.traj._asdict().items()},
                cost=cost, feasible=feas, velocity_ok=vel_ok, gate=gate, collision_free=free,
                **{f"candidates.{k}": v for k, v in tr._asdict().items()},
                **{f"pyramids.{k}": v for k, v in pyrs._asdict().items()})


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [40, 42, 43, 45])  # views in the orchard where a plan is found
def test_plan_on_the_card_equals_the_plan_on_the_cpu(cuda, seed):  # noqa: F811
    """rappids.plan at the orchard default (640x480, 256 candidates, two
    rounds and a lazy one, 2x2 pooled inflation) on the card against the same
    plan on the CPU, the same depth codes and draws: found, the winner's
    index, cost and coefficients, every candidate's gates, collision label,
    cost and coefficients, and the pyramids, bit for bit. The plain planner
    rounds alike on both devices: divisions by `fmath.scalar`, sums over
    three axes left to right, the cube root correctly rounded on the card
    (K2c on the card and the plain inflation on the CPU are bit-equal)."""
    p = orchard_env.make_params(device="cpu")
    g = torch.Generator().manual_seed(seed)
    pos, cam = _poses(seed, 1, "cpu")
    depth = raycast.render_depth(p.render_cfg, p.scene, pos, cam)[0]
    u = torch.rand((4, p.n_candidates), generator=g)
    vel = torch.tensor([0.3, -0.2, 1.5 + seed % 3]) + torch.randn(3, generator=g) * 0.2
    acc = torch.randn(3, generator=g) * 0.5
    grav = torch.tensor([0.0, 9.81, 0.0])
    goal = torch.tensor([1.0, 0.0, 20.0]) + torch.randn(3, generator=g)
    kw = dict(pyramid_capacity=p.pyramid_capacity, rounds=p.planner_rounds,
              inflation_downsample=p.inflation_downsample)
    out = {}
    for dev in ("cpu", cuda):
        prm = _to(p.planner, dev)
        args = [t.to(dev) for t in (depth, u, vel, acc, grav, goal)]
        res = rappids.plan(prm, *args, **kw)
        core = rappids.plan_debug(prm, args[0], rappids.samples_from_uniform(prm, args[1]),
                                  *args[2:], **kw)
        out[str(dev)] = {k: v.cpu() for k, v in _plan_fields(res, core).items()}
    ref, got = out["cpu"], out[str(cuda)]
    apart = [k for k in ref if not torch.equal(got[k], ref[k])]
    assert apart == [], apart
    assert bool(ref["found"]) and int(ref["num_pyramids"]) > 4


def _plan_kernel_case(cuda, B, seed):
    """The frame's candidate pass at the orchard default (640x480, 256
    candidates) on B random views: the candidates, gravity and plan_debug's
    final pyramid set, and the lazy re-check's mask (the gated candidates
    the first check fails for want of a pyramid)."""
    p = orchard_env.make_params(device=cuda)
    g = torch.Generator().manual_seed(seed)
    pos, cam = _poses(seed, B, cuda)
    depth = cuda_raycast.render_depth_batch(p.render_cfg, p.scene, pos, cam)
    u = torch.rand((B, 4, p.n_candidates), generator=g).to(cuda)
    vel = (torch.tensor([0.3, -0.2, 1.5]) + torch.randn(B, 3, generator=g) * 0.2).to(cuda)
    acc = (torch.randn(B, 3, generator=g) * 0.5).to(cuda)
    grav = torch.tensor([0.0, 9.81, 0.0], device=cuda).expand(B, 3)
    goal = (torch.tensor([1.0, 0.0, 20.0]) + torch.randn(B, 3, generator=g)).to(cuda)
    tr, _, _, _, gate, _, pyrs = rappids.plan_debug(
        p.planner, depth, rappids.samples_from_uniform(p.planner, u), vel, acc, grav, goal,
        pyramid_capacity=p.pyramid_capacity, rounds=p.planner_rounds,
        inflation_downsample=p.inflation_downsample)
    free, _, _, fail_z = cuda_plan.collision_check(p.planner, pyrs, tr)
    return p.planner, tr, grav[:, None, :], pyrs, gate & ~free & (fail_z > 0)


def _eval_check_case(cuda):
    """The evaluation's 4 x 1024 endpoint check (measure_collision_checking_speed's)."""
    from chip_smoke import eval_draws, eval_state, eval_views

    params, views = eval_views(cuda)
    vel0, acc0, grav = eval_state(cuda)
    tr = rappids.sample_candidates(params, eval_draws(1024, cuda), vel0, acc0)
    return params, tr, grav[:, None, :], rappids._endpoint_pyramids(params, views, tr, 32)


def _same(got, ref):
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def _check_equal(prm, pyrs, tr, enabled):
    """K7 against collision_check_plain on the card, bit for bit, pops
    against the plain count; returns the kernel's outputs and pops."""
    pops, ref_pops = (torch.zeros(tr.tf.shape, dtype=torch.int32, device=tr.tf.device)
                      for _ in range(2))
    got = cuda_plan.collision_check(prm, pyrs, tr, enabled, pops=pops)
    everyone = torch.ones(tr.tf.shape, dtype=torch.bool, device=tr.tf.device)
    ref = rappids.collision_check_plain(prm, pyrs, tr, everyone if enabled is None else enabled,
                                        ref_pops)
    assert _same(got, ref) and torch.equal(pops, ref_pops)
    return got, pops


ADVERSARIAL = ["iteration cap", "budget spent early", "uncovered late"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["B=1", "B=16", "4x1024"] + ADVERSARIAL)
def test_collision_check_kernel_bit_equal_to_plain(cuda, shape):  # noqa: F811
    """K7 against rappids.collision_check_plain on the card, bit for bit
    (free, the three fail values and the pops), one launch each: the first
    check and the lazy re-check of the candidates it failed for want of a
    pyramid; and chip_smoke's adversarial sets at 640x480 against 77 strip
    pyramids in 80 slots (three ballot chunks): candidates that reach the
    budget, five live sections, the budget spent early, uncovered late."""
    from chip_smoke import adversarial_checks, chain_patterns, section_chains

    if shape in ADVERSARIAL:
        prm = orchard_env.make_params(device=cuda).planner
        tr, pyrs = adversarial_checks(prm, cuda)[shape]
        everyone = torch.ones(tr.tf.shape, dtype=torch.bool, device=cuda)
        lazy = everyone.clone()
        lazy[::3] = False
    elif shape == "4x1024":
        prm, tr, _, pyrs = _eval_check_case(cuda)
        free = cuda_plan.collision_check(prm, pyrs, tr)[0]
        lazy = ~free
    else:
        prm, tr, _, pyrs, lazy = _plan_kernel_case(cuda, int(shape[2:]), 42)
    before = cuda_plan.collision_check.launches
    for enabled in (None, lazy):
        got, pops = _check_equal(prm, pyrs, tr, enabled)
    assert cuda_plan.collision_check.launches == before + 2
    assert int(pyrs.valid.sum()) > 0 and bool(got[0].any())
    if shape == "iteration cap":
        assert int(pops.max()) == 24 and pyrs.depth.shape[-1] == 80
    elif shape in ADVERSARIAL:
        counts = chain_patterns(section_chains(prm, pyrs, tr, everyone))
        assert min(counts.values()) > 0, counts


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False])
def test_plan_gates_kernel_bit_equal_to_plain(cuda, strict):  # noqa: F811
    """K8 against traj.check_input_feasibility and check_velocity_feasibility
    on the card, bit for bit, the evaluated sections against the plain
    count: a fleet frame's candidates, random, near-limit and wavy
    trajectories, with the static_max_tf cut and without."""
    from chip_smoke import near_limit_trajs, random_trajs, wavy_trajs

    from agrifly_tpu_torch.planner import traj

    prm, tr, grav, _, _ = _plan_kernel_case(cuda, 16, 43)
    g3 = torch.tensor([0.0, 9.81, 0.0], device=cuda)
    cases = [(tr, grav), (random_trajs(1, 4096, cuda), g3), (near_limit_trajs(1, 4096, cuda), g3),
             (wavy_trajs(0, 4096, cuda), g3)]
    before = cuda_plan.plan_gates.launches
    for trs, gr in cases:
        for static_max_tf in (3.0, None):
            sections, ref_sections = (torch.zeros(trs.tf.shape, dtype=torch.int32, device=cuda)
                                      for _ in range(2))
            got = cuda_plan.plan_gates(trs, gr, prm.fmin, prm.fmax, prm.wmax,
                                       prm.min_section_time, prm.vmax,
                                       static_max_tf=static_max_tf, strict_degenerate=strict,
                                       sections=sections)
            ref = (traj.check_input_feasibility(trs, gr, prm.fmin, prm.fmax, prm.wmax,
                                                prm.min_section_time, static_max_tf=static_max_tf,
                                                sections=ref_sections),
                   traj.check_velocity_feasibility(trs, prm.vmax, strict))
            assert _same(got, ref) and torch.equal(sections, ref_sections)
            if trs is cases[1][0] or trs is cases[2][0]:  # both verdicts occur
                assert bool(got[0].any()) and not bool(got[0].all())
    assert cuda_plan.plan_gates.launches == before + 8


@pytest.mark.cuda
def test_plan_kernels_refuse_what_they_do_not_take(cuda):  # noqa: F811
    """A float64 or CPU tensor among the card's, or a per-candidate gravity:
    a ValueError and no launch."""
    prm, tr, grav, pyrs, _ = _plan_kernel_case(cuda, 1, 40)
    k7, k8 = cuda_plan.collision_check.launches, cuda_plan.plan_gates.launches
    with pytest.raises(ValueError):
        cuda_plan.collision_check(prm, pyrs, tr._replace(alpha=tr.alpha.double()))
    with pytest.raises(ValueError):
        cuda_plan.collision_check(prm, pyrs._replace(depth=pyrs.depth.cpu()), tr)
    with pytest.raises(ValueError):
        cuda_plan.plan_gates(tr, grav + torch.zeros_like(tr.alpha), prm.fmin, prm.fmax,
                             prm.wmax, prm.min_section_time, prm.vmax)
    with pytest.raises(ValueError):
        cuda_plan.plan_gates(tr, grav, 5.0, prm.fmax, prm.wmax, prm.min_section_time, prm.vmax)
    assert (cuda_plan.collision_check.launches, cuda_plan.plan_gates.launches) == (k7, k8)
