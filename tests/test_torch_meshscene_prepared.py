"""The mesh kernels' operation order against the plain renderer, on the CPU.

The window (K4w) and strip-culled (K4) kernels stage each window row in its
camera-relative form (`meshscene.prepare_rows`: the offset camera - p0, a
sphere's or cylinder's cc, a triangle's qv = tv x e1 and qv . e2) and
compute each pixel's own terms once (4a, 2a, 4ca, 2ca), leaving per pixel
and row only the work that depends on both. `render_depth_window_prepared`
is that order in tensor ops. Here it is held bit for bit to
`render_depth_window`, the kernels' plain version, and to the JAX package's
jnp `render_depth_window` and its Pallas window kernel (interpret mode)
within the rule of tests/test_torch_meshscene.py (at most 0.05% of pixels
one code apart: XLA:CPU may fuse a multiply-add that the port rounds
twice). Inputs from numpy seeds: the baked orchard, a scene of spheres,
z-cylinders and triangles, and chip_smoke.py's window of edge-case rows (a
vertical ray against a cylinder, a tangent sphere, triangles with
|det| < 1e-12, a camera inside a sphere and one at z = 0, kind 0 rows).
The kernels themselves are held to the same on the card in
tests/test_torch_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrifly_tpu.ops import rotation as jrot
from agrifly_tpu.render import meshscene as JM, orchard as JO, pallas_meshscene as JP
from agrifly_tpu.render import raycast as JR
from agrifly_tpu_torch.render import meshscene as TM, orchard as TO, raycast as TR
from chip_smoke import edge_rows

W, H = 160, 112
MAX_OFF_BY_ONE = 5e-4  # fraction of pixels allowed one code apart (tests/test_torch_meshscene.py)


def _random_geometry(seed, n):
    rng = np.random.default_rng(seed)
    spheres = [tuple(rng.uniform([0, -8, 0.5, 0.2], [40, 8, 4, 1.5])) for _ in range(n)]
    cylinders = [(*rng.uniform([0, -8], [40, 8]), 0.0, rng.uniform(0.5, 3), rng.uniform(0.1, 0.4))
                 for _ in range(n)]
    centres = rng.uniform([0, -8, 0], [40, 8, 4], (4 * n, 3))
    triangles = [tuple(c + rng.normal(0, 0.8, 3) for _ in range(3)) for c in centres]
    return spheres, cylinders, triangles


def _poses(seed, n):
    """Camera positions over the scenes and world-from-camera attitudes of
    random yaw (small pitch and roll), float32 numpy."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-5, 40, n), rng.uniform(-10, 10, n), rng.uniform(0.5, 4.0, n)],
                   axis=1).astype(np.float32)
    ypr = rng.uniform([-np.pi, -0.3, -0.3], [np.pi, 0.3, 0.3], (n, 3)).astype(np.float32)
    body = np.stack([np.asarray(jrot.from_euler_ypr(*(jnp.float32(v) for v in row)))
                     for row in ypr])
    return pos, np.array(jax.vmap(JR.camera_attitude)(jnp.asarray(body)), np.float32)


@functools.lru_cache(maxsize=None)
def _case(scene):
    """(windows (B, K, 10), cam_pos (B, 3), cam_att (B, 4)) as float32 CPU tensors."""
    if scene == "edge":
        return edge_rows("cpu")
    if scene == "baked":
        mesh = TM.from_orchard(TO.make_params(device="cpu"), (-25, 65), (-25, 25), device="cpu")
    else:
        mesh = TM.build_scene(*_random_geometry(7, 40), device="cpu")
    pos, cam = (torch.from_numpy(a) for a in _poses(11, 3))
    cfg = TR.make_config(W, H)
    return TM.select_window(mesh, pos, cfg.far * TM.slant_factor(cfg), 192), pos, cam


def _check_codes(got, ref, what):
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    n_off = int((d > 0).sum())
    print(f"{what}: {'exact' if n_off == 0 else f'{n_off} of {d.size} pixels one code apart'}")
    assert d.max() <= 1, (what, int(d.max()))
    assert n_off <= MAX_OFF_BY_ONE * d.size, (what, n_off)


@pytest.mark.parametrize("scene", ["baked", "mixed", "edge"])
def test_prepared_order_is_bit_equal_to_the_plain_renderer(scene):
    cfg = TR.make_config(W, H)
    windows, pos, cam = _case(scene)
    got = TM.render_depth_window_prepared(cfg, windows, pos, cam)
    ref = TM.render_depth_window(cfg, windows, pos, cam)
    assert got.dtype == torch.int32 and got.shape == (pos.shape[0], H, W)
    assert torch.equal(got, ref)
    assert got.unique().numel() > 20  # the scene is not empty


@pytest.mark.parametrize("scene", ["baked", "mixed", "edge"])
def test_prepared_order_matches_jax(scene):
    """Against the JAX jnp renderer and the Pallas window kernel (interpret
    mode), camera by camera and batched, within the depth-code rule."""
    cfg_j, cfg_t = JR.make_config(W, H), TR.make_config(W, H)
    windows, pos, cam = _case(scene)
    got = TM.render_depth_window_prepared(cfg_t, windows, pos, cam).numpy()
    win, p, c = (jnp.asarray(t.numpy()) for t in (windows, pos, cam))
    jnp_render = jax.jit(lambda w, p, c: JM.render_depth_window(cfg_j, w, p, c))
    ref = np.stack([np.asarray(jnp_render(win[b], p[b], c[b])) for b in range(len(got))])
    pallas = np.asarray(JP.render_depth_window_batch(cfg_j, win, p, c, interpret=True))
    _check_codes(got, ref, f"{scene}: prepared order vs jnp render_depth_window")
    _check_codes(got, pallas, f"{scene}: prepared order vs Pallas K4w (interpret)")


def test_edge_rows_take_their_edge_cases():
    """The edge scene's camera 0 sees, on the centre pixel's vertical ray,
    the sphere tangent at t = 2 (disc = 0; the cylinder under it, ca = 0,
    and both degenerate triangles miss); camera 1, inside a sphere, sees
    nothing nearer than that sphere; camera 2, at z = 0, has no ground
    hit."""
    cfg = TR.make_config(W, H)
    windows, pos, cam = _case("edge")
    codes = TM.render_depth_window_prepared(cfg, windows, pos, cam)
    scale = cfg.far / 256.0
    assert int(codes[0, H // 2, W // 2]) == int(np.floor(2.0 / scale))
    inside = TM.render_depth_window(cfg, windows[1:2, 7:8], pos[1:2], cam[1:2])
    assert torch.equal(codes[1], inside[0])  # the sphere around camera 1 hides the rest
    assert int(inside.max()) < int(np.floor(1.2 / scale)) + 1
    ground_only = TM.render_depth_window(cfg, windows[2:3, :0], pos[2:3], cam[2:3])
    assert int(ground_only.min()) == 255  # z = 0: the ground plane is never ahead

    # the centre ray of camera 0 is exactly (0, 0, -1): a vertical ray
    kind, prep = TM.prepare_rows(windows[:1], pos[:1])
    assert kind[0].tolist()[:4] == [2, 1, 3, 3] and int(kind[0, 4]) == 0
    ox, oy, oz = (v[0, 1] for v in prep["o"])
    bq = 2.0 * (oz * -1.0)
    assert float(bq * bq - 4.0 * prep["cc_sphere"][0, 1]) == 0.0  # tangent
    e1, e2 = (torch.stack([v[0, 2] for v in prep[k]]) for k in ("e1", "e2"))
    assert float(torch.dot(torch.linalg.cross(torch.tensor([0.0, 0.0, -1.0]), e2), e1)) == 0.0


def test_pixel_terms_equal_the_plain_sums():
    """a = ca + dz^2 is dx^2 + dy^2 + dz^2 summed left to right, and
    (4a) cc is `4 * a * cc`, bit for bit, on random rays and rows."""
    rng = np.random.default_rng(3)
    dx, dy, dz, cc = (torch.from_numpy(rng.normal(0, 2, 10000).astype(np.float32))
                      for _ in range(4))
    ca, a4, a2, ca4, ca2 = TM._pixel_terms((dx, dy, dz))
    a = dx * dx + dy * dy + dz * dz
    assert torch.equal(a4 * cc, 4.0 * a * cc) and torch.equal(a2, 2.0 * a)
    assert torch.equal(ca4 * cc, 4.0 * (dx * dx + dy * dy) * cc) and torch.equal(ca2, 2.0 * ca)
