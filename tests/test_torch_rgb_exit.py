"""The RGB kernel's early exit (K1-rgb), through its plain mirror, on the CPU.

`raycast.render_rgb_exit` repeats `csrc/raycast.cu`'s RGB traversal: after
each cell, a pixel stops whose ray can no longer reach the next cell before
min(best, T), T the t past which a climbing ray runs above every tree
(`orchard.canopy_top`), where `orchard.contained` says every tree lies inside
its own cell. Its images are held against the plain renderer
`raycast.render_rgb` exactly (the tolerance is 0), and against the JAX
package's `render_rgb` by tests/test_torch_rgb.py's rule (every channel
within 1 code, except on at most 0.05% of pixels). The cases: seeded poses on
the three scenes of tests/test_torch_raycast_exit.py (the default orchard, the
`make_params` limit scene, and the loose scene, where the exit stays off);
cameras pitched up 10-40 degrees; rays grazing the canopy top. The kernel
itself is held to the plain version on the card in
tests/test_torch_kernels.py. Images are 128x96.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from agrifly_tpu.render import orchard as jorch, raycast as jray
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.render import orchard, raycast
from chip_smoke import RAY_SCENES as SCENES  # scene name -> make_params keywords
from chip_smoke import sky_bytes

W, H = 128, 96
MAX_OFF_BY_ONE = 5e-4  # fraction of pixels allowed more than 1 code apart from JAX


def _scene(name):
    return orchard.make_params(device="cpu", **SCENES[name])


def _poses(seed, n, pitch):
    """n cameras among the trees, any yaw, body pitch uniform in `pitch`
    (radians; negative pitches the camera up), small roll."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, 40, n), rng.uniform(-8, 8, n), rng.uniform(0.5, 3.5, n)],
                   axis=1).astype(np.float32)
    ypr = np.stack([rng.uniform(-math.pi, math.pi, n), rng.uniform(*pitch, n),
                    rng.uniform(-0.1, 0.1, n)], axis=1).astype(np.float32)
    return torch.from_numpy(pos), _camera(torch.from_numpy(ypr))


def _camera(ypr):
    return raycast.camera_attitude(rot.from_euler_ypr(ypr[:, 0], ypr[:, 1], ypr[:, 2]))


@functools.lru_cache(maxsize=None)
def _jax_render(name):
    cfg, scene = jray.make_config(W, H), jorch.make_params(**SCENES[name])
    return jax.jit(lambda p, q: jray.render_rgb(cfg, scene, p, q))


def _hold(name, pos, cam, jax_too=True):
    """The mirror's images against the plain renderer (exact) and JAX's;
    the cells of the exit on best alone (the traversal before the clear
    exit) give the same image. Returns (cells, cells on best alone)."""
    cfg, scene = raycast.make_config(W, H), _scene(name)
    got, cells = raycast.render_rgb_exit(cfg, scene, pos, cam)
    on_best, cells_best = raycast.render_rgb_exit(cfg, scene, pos, cam, clear=False)
    ref = raycast.render_rgb(cfg, scene, pos, cam)
    assert got.shape == (pos.shape[0], H, W, 3) and cells.shape == (pos.shape[0], H, W)
    assert torch.equal(got, ref) and torch.equal(on_best, ref)
    assert int(cells.min()) >= 1 and int(cells.max()) <= cfg.dda_steps
    assert bool((cells <= cells_best).all())  # the clear exit only stops marches earlier
    if jax_too:
        fn = _jax_render(name)
        ref_j = np.stack([np.asarray(fn(jnp.asarray(p), jnp.asarray(c)))
                          for p, c in zip(pos.numpy(), cam.numpy())])
        d = np.abs(got.numpy().astype(np.int64) - ref_j.astype(np.int64))
        far_off = int((d > 1).any(-1).sum())
        print(f"{name}: {far_off} of {d.shape[0] * H * W} pixels more than 1 code from JAX")
        assert far_off <= MAX_OFF_BY_ONE * d.shape[0] * H * W
    assert len(np.unique(got.numpy().reshape(-1, 3), axis=0)) > 20  # not an empty image
    return cells, cells_best


@pytest.mark.parametrize("name", list(SCENES))
def test_rgb_exit_matches_plain_and_jax_on_seeded_poses(name):
    pos, cam = _poses(len(name), 3, (-0.4, 0.4))
    cells, _ = _hold(name, pos, cam)
    if name == "loose":
        assert int(cells.min()) == raycast.make_config(W, H).dda_steps  # no exit uncontained


@pytest.mark.parametrize("name", ["default", "limit"])
def test_rgb_exit_on_cameras_pitched_up(name):
    """Cameras pitched up 10-40 degrees: the sky rays stop once they clear
    the canopy, and fewer cells are evaluated than with the exit on best
    alone, whose sky rays march every cell."""
    pos, cam = _poses(11, 3, (-math.radians(40), -math.radians(10)))
    cells, cells_best = _hold(name, pos, cam)
    assert float(cells.float().mean()) < float(cells_best.float().mean())


def test_rgb_exit_on_rays_grazing_the_canopy_top():
    """Cameras at and around the treetops' height, level, a hair up and a
    hair down, and one above the canopy's bound looking up a little: the
    rays skim the canopy spheres' tops, where the margins matter."""
    scene = _scene("default")
    top = float(orchard.canopy_top(scene))
    rows = [(6.0, 1.0, 4.6, 0.2, 0.0), (18.0, -3.0, 4.9, 1.4, -0.004),
            (30.0, 2.5, 5.3, -2.6, 0.003), (12.0, 0.5, 4.2, 0.0, -0.02),
            (24.0, -1.0, top + 0.01, 2.0, -0.01), (9.0, 4.0, top - 0.01, -0.8, 0.0)]
    t = torch.tensor(rows, dtype=torch.float32)
    cam = _camera(torch.stack([t[:, 3], t[:, 4], torch.zeros(len(rows))], dim=1))
    pos = t[:, :3].contiguous()
    _hold("default", pos, cam, jax_too=False)
    _hold("limit", pos, cam, jax_too=False)
    _hold("default", pos[:2].contiguous(), cam[:2])  # and a few of them against JAX


@pytest.mark.parametrize("kw", [
    {}, SCENES["limit"], SCENES["loose"], {"seed": 7},
    {"trunk_height": 3.0, "canopy_height": 1.0, "canopy_radius": 0.6},  # the trunk on top
    {"canopy_height": 3.4, "canopy_radius": 1.7, "presence": 1.0, "tree_spacing": 5.0},
])
def test_canopy_top_lies_above_every_tree(kw):
    """orchard.canopy_top against the trunk top and both canopy spheres'
    tops of every tree that tree_at_cell gives over 120 x 80 cells, present
    or not (the kernel evaluates absent trees' geometry too)."""
    scene = orchard.make_params(device="cpu", **kw)
    ix, iy = torch.meshgrid(torch.arange(-60, 60, dtype=torch.int32),
                            torch.arange(-40, 40, dtype=torch.int32), indexing="ij")
    tree = orchard.tree_at_cell(scene, ix, iy)
    tops = torch.stack([tree.trunk_height, tree.canopy_center[..., 2] + tree.canopy_radius,
                        tree.canopy2_center[..., 2] + tree.canopy2_radius])
    top = orchard.canopy_top(scene)
    assert top.dtype == torch.float32 and top.dim() == 0
    highest = float(tops.max())
    print(f"{kw}: highest tree top {highest:.4f} m, bound {float(top):.4f} m")
    assert highest < float(top)
    assert highest > 0.75 * float(top)  # and the bound is not far above the trees


def test_mean_cells_per_pixel_fall_on_an_up_pitched_camera():
    """One camera pitched 25 degrees up: the exit on best alone marches
    every cell of a sky ray; the clear exit stops most of them within a few
    cells, and the image stays the same."""
    cfg, scene = raycast.make_config(W, H), _scene("default")
    pos, cam = torch.tensor([[14.0, 1.0, 1.8]]), _camera(torch.tensor([[0.4, -0.44, 0.0]]))
    img, cells = raycast.render_rgb_exit(cfg, scene, pos, cam)
    img_best, cells_best = raycast.render_rgb_exit(cfg, scene, pos, cam, clear=False)
    assert torch.equal(img, img_best)
    sky = (img == sky_bytes(cfg, torch.device("cpu"))).all(-1)
    assert float(sky.float().mean()) > 0.3
    mean, mean_best = float(cells.float().mean()), float(cells_best.float().mean())
    print(f"mean cells per pixel: {mean:.3f} with the clear exit, {mean_best:.3f} on best "
          f"alone, of {cfg.dda_steps}")
    assert mean < 0.75 * mean_best
    assert float(cells_best[sky].float().mean()) == cfg.dda_steps
