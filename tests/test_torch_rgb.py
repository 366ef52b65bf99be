"""The port's RGB pass of both worlds against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages:

- the procedural orchard: `orchard.TreeGeom` / `tree_at_cell` field for
  field, `raycast.render_rgb` and `render_rgb_body` (on
  tests/test_torch_render.py's poses and a pose above the canopy whose rays
  meet trees only beyond the far plane), and `render_depth_body`;
- the imported world: `strip_windows`' compaction order without the far
  clip, the window's materials, `meshscene.render_rgb` (both scans) and
  `render_rgb_body` on tests/test_torch_meshscene.py's baked and mixed
  scenes, and `render_depth_body`.

Tolerance: every channel within 1 code, except on at most 0.05% of pixels
(MAX_OFF_BY_ONE). Those are pixels where XLA:CPU's contracted multiply-adds
move a ray's t by an ulp and flip the winning surface at a silhouette, as
for the depth codes; elsewhere a last-bit difference in a colour truncates
to a neighbouring byte. Each test prints its counts. The port's two plain
mesh scans are held bit-equal to each other, and its tie rule (the earlier
window row wins an equal t) on a pair of rows that meet a ray at the same
t. The CUDA kernels (K1-rgb, K4-rgb) are held to these plain versions on
the card in tests/test_torch_kernels.py. Images are 128x96.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from agrifly_tpu.render import meshscene as JM, orchard as JO, raycast as JR
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast, meshscene as TM
from agrifly_tpu_torch.render import orchard as TO, raycast as TR
from chip_smoke import edge_rows
from tests.test_torch_meshscene import _baked, _mixed, _poses as _mesh_poses
from tests.test_torch_render import _poses as _orchard_poses

MAX_OFF_BY_ONE = 5e-4  # fraction of pixels allowed more than 1 code apart
W, H = 128, 96  # the strip scans need H % 16 == 0
ABOVE = (10.0, 3.0, 14.0)  # level camera above the canopy: trees only beyond 10 m


def _check_rgb(got, ref, what):
    assert got.dtype == np.uint8 and got.shape == ref.shape and got.shape[-1] == 3
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    far_off = (d > 1).any(-1)
    n_px = far_off.size
    print(f"{what}: {int(far_off.sum())} of {n_px} pixels more than 1 code apart, "
          f"{int((d > 0).any(-1).sum())} differ at all (max {int(d.max())})")
    assert int(far_off.sum()) <= MAX_OFF_BY_ONE * n_px, (what, int(far_off.sum()))
    assert len(np.unique(ref.reshape(-1, 3), axis=0)) > 20  # the image is not empty


# ----------------------------------------------------------------------
# the procedural orchard
# ----------------------------------------------------------------------


def test_tree_at_cell_matches_jax():
    rng = np.random.default_rng(0)
    ix = rng.integers(-60, 60, (9, 7)).astype(np.int32)
    iy = rng.integers(-40, 40, (9, 7)).astype(np.int32)
    ix[0, 0] = iy[0, 0] = 0  # a cell inside the cleared radius
    got = TO.tree_at_cell(TO.make_params(device="cpu", seed=3), torch.from_numpy(ix),
                          torch.from_numpy(iy))
    ref = JO.tree_at_cell(JO.make_params(seed=3), jnp.asarray(ix), jnp.asarray(iy))
    assert got._fields == ref._fields
    for name, g in zip(got._fields, got):
        r = np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert 0 < int(got.present.sum()) < got.present.numel()


@functools.lru_cache(maxsize=None)
def _orchard_case():
    """Poses over the orchard (tests/test_torch_render.py's, and ABOVE)
    and JAX's RGB and depth images of them. JAX's render_*_body is
    render_*(camera_attitude(body)), and the poses' attitudes are JAX's
    camera_attitude of their body attitudes, so these images are also
    JAX's render_rgb_body and render_depth_body of the bodies."""
    pos, body, cam = _orchard_poses(1, 4)
    above_body = np.asarray([[1.0, 0.0, 0.0, 0.0]], np.float32)
    above_cam = np.asarray(JR.camera_attitude(jnp.asarray(above_body[0])), np.float32)[None]
    pos = np.concatenate([pos, np.asarray([ABOVE], np.float32)])
    body, cam = np.concatenate([body, above_body]), np.concatenate([cam, above_cam])
    cfg, scene = JR.make_config(W, H), JO.make_params()
    rgb = jax.jit(lambda p, q: JR.render_rgb(cfg, scene, p, q))
    depth = jax.jit(lambda p, q: JR.render_depth(cfg, scene, p, q))
    return pos, body, cam, _jax_each(rgb, pos, cam), _jax_each(depth, pos, cam)


def _jax_each(fn, pos, att):
    return np.stack([np.asarray(fn(jnp.asarray(p), jnp.asarray(q))) for p, q in zip(pos, att)])


def test_render_rgb_matches_jax():
    """render_rgb on the world-from-camera attitudes and render_rgb_body on
    the body attitudes, against JAX's images."""
    pos, body, cam, ref, _ = _orchard_case()
    cfg, scene = TR.make_config(W, H), TO.make_params(device="cpu")
    pos_t, body_t, cam_t = (torch.from_numpy(a) for a in (pos, body, cam))
    got = TR.render_rgb(cfg, scene, pos_t, cam_t).numpy()
    assert got.shape == (len(pos), H, W, 3)
    _check_rgb(got, ref, "orchard render_rgb")
    _check_rgb(TR.render_rgb_body(cfg, scene, pos_t, body_t).numpy(), ref,
               "orchard render_rgb_body")
    # above the canopy every tree lies beyond the far plane: the depth image
    # is all 255, while the RGB image still shows the (hazed) trees
    depth = TR.render_depth(cfg, scene, pos_t[-1:], cam_t[-1:])
    assert int(depth.min()) == 255
    colours = np.unique(got[-1].reshape(-1, 3), axis=0)
    sky = np.clip(np.asarray(TR.COLORS[TR.MAT_SKY], np.float32) * 255.0, 0, 255).astype(np.uint8)
    assert len(colours) > 20 and (colours != sky).any(-1).sum() > 20


def test_render_depth_body_matches_jax():
    """render_depth_body: the mount, then render_depth (the same codes),
    against JAX's."""
    pos, body, cam, _, ref = _orchard_case()
    cfg, scene = TR.make_config(W, H), TO.make_params(device="cpu")
    pos_t, body_t, cam_t = (torch.from_numpy(a) for a in (pos, body, cam))
    depth = TR.render_depth_body(cfg, scene, pos_t, body_t)
    assert torch.equal(depth, TR.render_depth(cfg, scene, pos_t, cam_t))
    d = np.abs(depth.numpy().astype(np.int64) - ref)
    print(f"render_depth_body: {int((d > 0).sum())} of {d.size} pixels one code apart")
    assert d.max() <= 1 and (d > 0).sum() <= MAX_OFF_BY_ONE * d.size


# ----------------------------------------------------------------------
# the imported world
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_mesh(scene, name):
    jm = (_baked() if scene == "baked" else _mixed())[0]
    cfg = JR.make_config(W, H)
    fn = getattr(JM, name)
    return jax.jit(lambda p, q: fn(cfg, jm, p, q))


def _mesh_case(seed, n):
    """Camera poses over the scenes, and one above the canopy whose window
    holds rows beyond the far plane."""
    pos, cam = _mesh_poses(seed, n)
    above = TR.camera_attitude(torch.tensor([[1.0, 0.0, 0.0, 0.0]])).numpy()
    return (np.concatenate([pos, np.asarray([ABOVE], np.float32)]),
            np.concatenate([cam, above]))


def test_strip_order_and_far_clip_match_jax():
    """strip_windows with return_order and without the far clip: strips,
    n_vis and the compaction order equal JAX's; the far clip only drops
    rows; and the window's materials equal JAX render_rgb's."""
    jm, tm = _baked()
    cfg_j, cfg_t = JR.make_config(W, H), TR.make_config(W, H)
    pos, cam = _mesh_case(5, 1)
    pos_t, cam_t = torch.from_numpy(pos), torch.from_numpy(cam)
    reach = cfg_t.far * TM.slant_factor(cfg_t)
    windows, order, ok = TM.select_window(tm, pos_t, reach, 192, return_order=True)
    mats = TM.window_materials(tm, windows, order, ok)
    strips, nvis, slots = TM.strip_windows(cfg_t, windows, pos_t, cam_t, 16, return_order=True,
                                           far_clip=False)
    _, nvis_clip = TM.strip_windows(cfg_t, windows, pos_t, cam_t, 16)
    assert bool((nvis_clip <= nvis).all()) and int((nvis_clip < nvis).sum()) > 0
    jax_strips = jax.jit(lambda w, p, c: JM.strip_windows(cfg_j, w, p, c, 16, return_order=True,
                                                          far_clip=False))
    for b in range(len(pos)):
        p = jnp.asarray(pos[b])
        d_w = jnp.linalg.norm(jm.center_xy - p[:2][None, :], axis=-1)
        reach_b = d_w - jm.radius
        visible = reach_b < reach
        order_j = jnp.argsort(jnp.where(visible, reach_b, jnp.inf))[:192]
        mats_j = jnp.where(visible[order_j], jm.material[order_j], JR.MAT_CANOPY)
        np.testing.assert_array_equal(order[b].numpy(), np.asarray(order_j))
        np.testing.assert_array_equal(mats[b].numpy(), np.asarray(mats_j))
        strips_j, nvis_j, slots_j = jax_strips(jnp.asarray(windows[b].numpy()), p,
                                               jnp.asarray(cam[b]))
        np.testing.assert_array_equal(strips[b].numpy(), np.asarray(strips_j))
        np.testing.assert_array_equal(nvis[b].numpy(), np.asarray(nvis_j))
        np.testing.assert_array_equal(slots[b].numpy(), np.asarray(slots_j))


@pytest.mark.parametrize("scene", ["baked", "mixed"])
def test_mesh_render_rgb_matches_jax(scene):
    """Both plain scans (bit-equal to each other, the strip scan the
    default) against JAX's render_rgb; render_rgb_body from the body
    attitudes too (JAX's render_rgb_body is render_rgb of their
    camera_attitude, the attitudes here)."""
    tm = (_baked() if scene == "baked" else _mixed())[1]
    cfg = TR.make_config(W, H)
    pos, cam = _mesh_case(11, 1)
    pos_t, cam_t = torch.from_numpy(pos), torch.from_numpy(cam)
    assert TM._strip_cull_default()
    strips = TM.render_rgb(cfg, tm, pos_t, cam_t)  # the default: the strip scan
    assert torch.equal(TM.render_rgb(cfg, tm, pos_t, cam_t, strip_cull=False), strips)
    ref = _jax_each(_jax_mesh(scene, "render_rgb"), pos, cam)
    _check_rgb(strips.numpy(), ref, f"{scene}: meshscene.render_rgb")
    body = rot.qmul(cam_t, rot.qinv(TR.mount_quaternion(cam_t)))
    _check_rgb(TM.render_rgb_body(cfg, tm, pos_t, body).numpy(), ref,
               f"{scene}: meshscene.render_rgb_body")
    if scene == "baked":
        depth = TM.render_depth_body(cfg, tm, pos_t, body).numpy()
        ref = _jax_each(_jax_mesh(scene, "render_depth"), pos, cam)
        d = np.abs(depth.astype(np.int64) - ref)
        print(f"meshscene.render_depth_body: {int((d > 0).sum())} of {d.size} pixels one code "
              f"apart")
        assert d.max() <= 1 and (d > 0).sum() <= MAX_OFF_BY_ONE * d.size


def test_mesh_scans_keep_the_earlier_row_on_a_tie():
    """On chip_smoke.edge_rows' window the two plain scans are bit-equal.
    Its camera 4 meets a cylinder and, later in the window, a sphere of the
    same axis and radius at the same t along the image's middle row: both
    scans shade the cylinder there (the earlier row), as the cylinder
    alone does."""
    cfg = TR.make_config(W, H)
    windows, pos, cam = edge_rows("cpu")
    mats = torch.where(windows[..., 0] == TM.PRIM_CYLINDER, TM.MAT_TRUNK,
                       TM.MAT_CANOPY).to(torch.int32)
    strips = TM.render_rgb_strips(cfg, windows, mats, pos, cam)
    assert torch.equal(strips, TM.render_rgb_window(cfg, windows, mats, pos, cam))
    pair = windows[4:5, -2:]
    cyl = TM.render_rgb_window(cfg, pair[:, :1], mats[4:5, -2:-1], pos[4:5], cam[4:5])[0]
    ball = TM.render_rgb_window(cfg, pair[:, 1:], mats[4:5, -1:], pos[4:5], cam[4:5])[0]
    mid = H // 2
    tied = (cyl[mid] != ball[mid]).any(-1)
    assert int(tied.sum()) > 10  # the two rows meet the middle row, in different colours
    assert torch.equal(strips[4, mid][tied], cyl[mid][tied])


# ----------------------------------------------------------------------
# the wrappers on the CPU
# ----------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    cfg = TR.make_config(64, 48)
    scene = TO.make_params(device="cpu")
    pos, body, cam = (torch.from_numpy(a) for a in _orchard_poses(3, 2))
    before = cuda_raycast.render_rgb_batch.launches
    assert torch.equal(cuda_raycast.render_rgb_batch(cfg, scene, pos, cam),
                       TR.render_rgb(cfg, scene, pos, cam))
    assert torch.equal(cuda_raycast.render_rgb_body_batch(cfg, scene, pos, body),
                       TR.render_rgb(cfg, scene, pos, cam))
    assert cuda_raycast.render_rgb_batch.launches == before

    _, tm = _baked()
    mcfg = TR.make_config(64, 48)
    mpos, mcam = (torch.from_numpy(a) for a in _mesh_poses(2, 2))
    before = cuda_meshscene.render_rgb_strips_batch.launches
    ref = TM.render_rgb(mcfg, tm, mpos, mcam)
    for strip_cull in (None, True, False):
        assert torch.equal(cuda_meshscene.render_rgb_batch(mcfg, tm, mpos, mcam,
                                                           strip_cull=strip_cull), ref)
    windows, order, ok = TM.select_window(tm, mpos, mcfg.far * TM.slant_factor(mcfg), 192,
                                          return_order=True)
    mats = TM.window_materials(tm, windows, order, ok)
    assert torch.equal(cuda_meshscene.render_rgb_strips_batch(mcfg, windows, mats, mpos, mcam),
                       ref)
    mbody = rot.qmul(mcam, rot.qinv(TR.mount_quaternion(mcam)))
    assert torch.equal(cuda_meshscene.render_rgb_body_batch(mcfg, tm, mpos, mbody),
                       TM.render_rgb_body(mcfg, tm, mpos, mbody))
    assert cuda_meshscene.render_rgb_strips_batch.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "materials"])
def test_rgb_wrappers_reject_bad_inputs(bad):
    cfg = TR.make_config(64, 48)
    scene = TO.make_params(device="cpu")
    pos, cam = torch.zeros(2, 3), torch.tensor([[1.0, 0, 0, 0]] * 2)
    windows, mats = torch.zeros(2, 5, 10), torch.zeros(2, 5, dtype=torch.int32)
    if bad == "shape":
        pos = pos[:, :2]
    elif bad == "dtype":
        cam = cam.double()
    elif bad == "device":
        cam = cam.to("meta")
    else:
        mats = mats.to(torch.int64)
    if bad != "materials":
        with pytest.raises(ValueError):
            cuda_raycast.render_rgb_batch(cfg, scene, pos, cam)
    with pytest.raises(ValueError):
        cuda_meshscene.render_rgb_strips_batch(cfg, windows, mats, pos, cam)
