"""The raycast kernel's early exit, through its plain mirror, on the CPU.

`raycast.render_depth_exit` repeats `csrc/raycast.cu`'s traversal: after each
cell, a pixel whose ray can no longer reach the next cell before min(best,
256 * far / 256) stops, where `orchard.contained` says every tree lies
inside its own cell. Its codes are held against the plain renderer
`raycast.render_depth` exactly (the tolerance is 0 codes), and against the
JAX package's renderer by the rule of tests/test_torch_render.py (XLA:CPU
may fuse a multiply-add that the port rounds twice, one code apart on at
most 0.05% of pixels), with the early exit adding no pixel to those. The
scenes: the default orchard; one at `make_params`' limit (jitter + 1.2
canopy_radius = half the smaller spacing); one that `make_params` accepts
but whose second canopy sphere leaves its cell, where `contained` must say
no. The kernel itself is held to the plain version on the card in
tests/test_torch_kernels.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrifly_tpu.render import orchard as jorch, raycast as jray
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast
from chip_smoke import RAY_SCENES as SCENES  # scene name -> make_params keywords

W, H = 160, 120
MAX_OFF_BY_ONE = 5e-4  # fraction of pixels allowed one code apart from JAX


def _scene(name):
    return orchard.make_params(device="cpu", **SCENES[name])


def _seeded_poses(seed, n):
    """Positions among the trees, any yaw, small pitch and roll."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, 40, n), rng.uniform(-8, 8, n), rng.uniform(0.5, 3.5, n)],
                   axis=1).astype(np.float32)
    ypr = np.stack([rng.uniform(-math.pi, math.pi, n), rng.uniform(-0.4, 0.4, n),
                    rng.uniform(-0.4, 0.4, n)], axis=1).astype(np.float32)
    return torch.from_numpy(pos), _camera(torch.from_numpy(ypr))


def _camera(ypr):
    return raycast.camera_attitude(rot.from_euler_ypr(ypr[:, 0], ypr[:, 1], ypr[:, 2]))


def _jax_codes(cfg, name, pos, cam):
    cfg_j = jray.make_config(cfg.width, cfg.height, far=cfg.far)
    scene_j = jorch.make_params(**SCENES[name])
    return np.stack([np.asarray(jray.render_depth(cfg_j, scene_j, jnp.asarray(p), jnp.asarray(c)))
                     for p, c in zip(pos.numpy(), cam.numpy())])


def _hold(cfg, name, pos, cam, jax_too=True):
    """The mirror's codes against the plain renderer (exact) and JAX's.
    Returns (codes, cells)."""
    scene = _scene(name)
    got, cells = raycast.render_depth_exit(cfg, scene, pos, cam)
    ref = raycast.render_depth(cfg, scene, pos, cam)
    assert got.shape == cells.shape == (pos.shape[0], cfg.height, cfg.width)
    assert torch.equal(got, ref)
    assert int(cells.min()) >= 1 and int(cells.max()) <= cfg.dda_steps
    if jax_too:
        ref_j = _jax_codes(cfg, name, pos, cam)
        d = np.abs(got.numpy().astype(np.int64) - ref_j)
        assert d.max() <= 1 and (d > 0).sum() <= MAX_OFF_BY_ONE * d.size
        # the early exit adds no pixel to the plain version's
        assert np.array_equal(d > 0, ref.numpy() != ref_j)
    assert got.unique().numel() > 10  # the scene is not empty
    return got, cells


@pytest.mark.parametrize("name", list(SCENES))
def test_exit_matches_plain_and_jax_on_seeded_poses(name):
    cfg = raycast.make_config(W, H)
    pos, cam = _seeded_poses(len(name), 4)
    _, cells = _hold(cfg, name, pos, cam)
    if name == "loose":
        assert int(cells.min()) == cfg.dda_steps  # no early exit without containment


@pytest.mark.parametrize("kw,want", [
    ({}, True),
    (SCENES["limit"], True),
    (SCENES["loose"], False),
    ({"jitter": 0.0, "canopy_radius": 2.5}, False),  # built by hand: make_params refuses
    ({"jitter": float("nan")}, False),
    ({"tree_spacing": -4.0}, False),
])
def test_containment(kw, want):
    """orchard.contained, the kernel's `contained`: make_params' own check
    covers the first canopy sphere only; scenes built by hand skip it."""
    base = dict(row_spacing=6.0, tree_spacing=4.0, presence=0.95, jitter=0.3,
                trunk_radius=0.18, trunk_height=1.2, canopy_radius=1.35, canopy_height=2.6,
                seed=0, clear_radius=3.0)
    base.update(kw)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    scene = orchard.OrchardParams(**{k: (torch.tensor(v, dtype=torch.int32) if k == "seed"
                                         else f32(v)) for k, v in base.items()})
    got = orchard.contained(scene)
    assert got.dtype == torch.bool and got.dim() == 0 and bool(got) is want


def test_exit_on_rays_grazing_cell_boundaries_and_running_along_rows():
    """The limit scene, whose trees touch their cells' edges, from cameras
    on cell boundaries (and 1e-5 m off them), looking along the rows, across
    them and diagonally, level and tilted."""
    cfg = raycast.make_config(W, H)
    xs, ys = (8.0, 8.0 + 1e-5, 12.0 - 1e-5), (0.0, 6.0, 3.0 - 1e-5)
    yaws = (0.0, math.pi / 2, math.pi, -math.pi / 4)
    rows = [(x, y, z, yaw, pitch) for x, y, z in zip(xs, ys, (1.0, 2.2, 3.0))
            for yaw in yaws for pitch in (0.0, 0.15)]
    t = torch.tensor(rows, dtype=torch.float32)
    cam = _camera(torch.stack([t[:, 3], t[:, 4], torch.zeros(len(rows))], dim=1))
    _, cells = _hold(cfg, "limit", t[:, :3].contiguous(), cam, jax_too=False)
    assert float(cells.float().mean()) < cfg.dda_steps
    pos, cam = t[:4, :3].contiguous(), cam[:4]
    _hold(cfg, "limit", pos, cam)  # and a few of them against JAX


def test_exit_where_rays_cross_the_far_clip_inside_the_cells():
    """A 24 m far plane (6 tree cells along a row) from cameras pitched up,
    whose rays miss the ground: their march ends at the far clip."""
    cfg = raycast.make_config(W, H, far=24.0)
    pos = torch.tensor([[2.0, 1.0, 3.5], [10.0, -2.0, 3.0], [21.0, 4.0, 3.2]])
    cam = _camera(torch.tensor([[0.0, -0.35, 0.0], [math.pi / 2, -0.3, 0.1],
                                [0.6, -0.4, -0.1]]))
    codes, cells = _hold(cfg, "default", pos, cam)
    far = codes == 255
    assert float(far.float().mean()) > 0.2
    assert float(cells[far].float().mean()) < cfg.dda_steps


def test_mean_cells_per_pixel_on_the_default_scene():
    """The default orchard at 10 m far: a ray crosses ~2-3 cells before its
    first hit or the far clip, so the march evaluates well under 8."""
    cfg = raycast.make_config(W, H)
    pos, cam = _seeded_poses(7, 6)
    _, cells = raycast.render_depth_exit(cfg, _scene("default"), pos, cam)
    mean = float(cells.float().mean())
    print(f"mean cells per pixel: {mean:.3f} of {cfg.dda_steps}")
    assert 1.0 < mean < 4.0


def test_the_loose_scene_needs_the_containment_test(monkeypatch):
    """Forcing the early exit on the loose scene changes codes: from above
    the second canopy sphere of a tree that overhangs into the cell to its
    left, looking down, the ray meets the overhang before it crosses into
    the tree's own cell. With `contained` as it is, the codes are exact."""
    scene = _scene("loose")
    ix, iy = torch.meshgrid(torch.arange(0, 40, dtype=torch.int32),
                            torch.arange(-20, 20, dtype=torch.int32), indexing="ij")
    f = orchard.tree_fields(scene, ix, iy)
    over = f["present"] & (f["c2x"] - f["c2r"] < ix.to(torch.float32) * 4.0 - 0.15)
    i, j = over.nonzero()[0].tolist()
    x0 = float(ix[i, j]) * 4.0
    pos = torch.tensor([[x0 - dx, float(f["c2y"][i, j]), float(f["c2z"][i, j] + f["c2r"][i, j]) + 0.3]
                        for dx in (0.1, 0.12, 0.14)])
    cam = _camera(torch.tensor([[0.0, math.pi / 2 - 0.005, 0.0]] * 3))
    cfg = raycast.make_config(W, H)
    ref = raycast.render_depth(cfg, scene, pos, cam)
    assert torch.equal(raycast.render_depth_exit(cfg, scene, pos, cam)[0], ref)
    monkeypatch.setattr(orchard, "contained", lambda p: torch.tensor(True))
    forced = raycast.render_depth_exit(cfg, scene, pos, cam)[0]
    assert int((forced != ref).sum()) > 0


def test_scene_table_is_built_once_per_scene():
    """The kernel's scene table: the fields in orchard.FLOAT_FIELDS' order
    and the int32 seed, the same tensors on every call for one unchanged
    scene, built anew for another scene or after an in-place change."""
    scene, other = _scene("default"), _scene("limit")
    a, b = cuda_raycast.scene_table(scene), cuda_raycast.scene_table(scene)
    assert a[0] is b[0] and a[1] is b[1]
    assert torch.equal(a[0], torch.stack([getattr(scene, k) for k in orchard.FLOAT_FIELDS]))
    assert a[1].dtype == torch.int32 and a[1].tolist() == [0]
    assert float(cuda_raycast.scene_table(other)[0][3]) == pytest.approx(0.38)
    other.jitter.fill_(0.25)
    assert float(cuda_raycast.scene_table(other)[0][3]) == pytest.approx(0.25)
    assert torch.equal(cuda_raycast.scene_table(scene)[0], a[0])
