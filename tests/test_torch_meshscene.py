"""The port's imported-world depth path against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages:

- the loaders (`build_scene`, `load_obj`, `load_primitives`,
  `from_orchard`) give the JAX tables exactly;
- the windowing (`select_window`, `strip_windows`) gives the JAX windows,
  per-strip tables and n_vis exactly, for a batch of poses at once;
- the plain renderers (`render_depth_window`, K4w's plain version, and
  `render_strips`, K4's) are held against the JAX Pallas kernels in
  interpret mode and against the jnp `meshscene.render_depth`: equal codes,
  or at most 0.05% of pixels one code apart (XLA:CPU may fuse a
  multiply-add that the port rounds twice, moving a ray's t by an ulp at a
  quantization edge; ROADMAP Queue 3);
- one mid-flight frame through the baked orchard, and a three-vehicle
  fleet frame row by row, against JAX `frame_step` with `mesh_scene`
  (`use_pallas=False`, `fused_ticks=False`), to the tick criteria of
  tests/_torch_parity.py.

Images are 160x112: the strip renderers need H % 16 == 0. The kernels
themselves are held to the plain versions on the card in
tests/test_torch_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import compare_state
from agrifly_tpu.ops import rotation as jrot
from agrifly_tpu.render import meshscene as JM, orchard as JO, pallas_meshscene as JP
from agrifly_tpu.render import raycast as JR
from agrifly_tpu.sim import orchard_env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.render import cuda_meshscene, meshscene as TM, orchard as TO
from agrifly_tpu_torch.render import raycast as TR
from agrifly_tpu_torch.sim import orchard_env as T

W, H = 160, 112
X_RANGE, Y_RANGE = (-25, 65), (-25, 25)
MAX_OFF_BY_ONE = 5e-4  # fraction of pixels allowed one code apart
KW = dict(goal_world=(60.0, 0.0, 2.0), takeoff_height=2.0, start_flight_time=1.0,
          n_candidates=96, pyramid_capacity=16, width=W, height=H)
WARM = (40, 12, 0)  # frames flown by each fleet vehicle; planning starts at frame 32
COUNTERS = ("plan_found", "num_collision_free", "num_pyramids", "num_feasible",
            "num_velocity_admissible", "flight_state", "panic")

# an axis-aligned box 2..4 x, -1..1 y, 0..2 z, six quads, one with a
# negative index and one with v/vt/vn references
BOX_OBJ = ("v 2 -1 0\nv 2 1 0\nv 4 1 0\nv 4 -1 0\n"
           "v 2 -1 2\nv 2 1 2\nv 4 1 2\nv 4 -1 2\n"
           "f 1 2 3 4\nf 5 6 7 8\nf 1/1 2/2 6/3 5/4\nf 2 3 7 6\nf 3 4 8 7\nf -5 -8 -4 -1\n")
PRIMS_TXT = ("# test scene\nsphere 3 0 1.5 0.5\ncylinder 5 1 0 2 0.2\n\n"
             "tree 8 -1 0.25 1.8 8 -1 2.5 1.2  # trunk and canopy\n")


def _same_scene(mine, theirs):
    assert mine.count == theirs.count
    for name in ("prims", "center_xy", "radius", "material"):
        ref = np.asarray(getattr(theirs, name))
        got = getattr(mine, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def _random_geometry(seed, n):
    rng = np.random.default_rng(seed)
    spheres = [tuple(rng.uniform([0, -8, 0.5, 0.2], [40, 8, 4, 1.5])) for _ in range(n)]
    cylinders = [(*rng.uniform([0, -8], [40, 8]), 0.0, rng.uniform(0.5, 3), rng.uniform(0.1, 0.4))
                 for _ in range(n)]
    centres = rng.uniform([0, -8, 0], [40, 8, 4], (4 * n, 3))
    triangles = [tuple(c + rng.normal(0, 0.8, 3) for _ in range(3)) for c in centres]
    return spheres, cylinders, triangles


@functools.lru_cache(maxsize=None)
def _baked():
    """The procedural orchard baked into primitives: (JAX, port)."""
    return (JM.from_orchard(JO.make_params(seed=0), X_RANGE, Y_RANGE),
            TM.from_orchard(TO.make_params(device="cpu"), X_RANGE, Y_RANGE, device="cpu"))


@functools.lru_cache(maxsize=None)
def _mixed():
    """Spheres, z-cylinders and triangles in front of the cameras: (JAX, port)."""
    spheres, cylinders, triangles = _random_geometry(7, 40)
    return (JM.build_scene(spheres, cylinders, triangles),
            TM.build_scene(spheres, cylinders, triangles, device="cpu"))


def _poses(seed, n):
    """Camera positions over the scenes and world-from-camera attitudes of
    random yaw (small pitch and roll), as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-5, 40, n), rng.uniform(-10, 10, n), rng.uniform(0.5, 4.0, n)],
                   axis=1).astype(np.float32)
    ypr = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-0.3, 0.3, n),
                    rng.uniform(-0.3, 0.3, n)], axis=1).astype(np.float32)
    body = np.stack([np.asarray(jrot.from_euler_ypr(*(jnp.float32(v) for v in row)))
                     for row in ypr])
    cam = np.array(jax.vmap(JR.camera_attitude)(jnp.asarray(body)), np.float32)
    return pos, cam


def _check_codes(got, ref, what):
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    n_off = int((d > 0).sum())
    print(f"{what}: {'exact' if n_off == 0 else f'{n_off} of {d.size} pixels one code apart'}")
    assert d.max() <= 1, (what, int(d.max()))
    assert n_off <= MAX_OFF_BY_ONE * d.size, (what, n_off)


# ----------------------------------------------------------------------
# loaders
# ----------------------------------------------------------------------


@pytest.mark.parametrize("with_mats", [False, True])
def test_build_scene_matches_jax(with_mats):
    spheres, cylinders, triangles = _random_geometry(3, 5)
    mats = {}
    if with_mats:
        rng = np.random.default_rng(4)
        mats = {f"{k}_mats": rng.integers(0, 4, n).tolist() for k, n in
                (("sphere", 5), ("cylinder", 5), ("triangle", 20))}
    _same_scene(TM.build_scene(spheres, cylinders, triangles, device="cpu", **mats),
                JM.build_scene(spheres, cylinders, triangles, **mats))


def test_load_obj_matches_jax(tmp_path):
    obj = tmp_path / "box.obj"
    obj.write_text(BOX_OBJ)
    mine = TM.load_obj(str(obj), device="cpu")
    assert mine.count == 12  # 6 quads fan-triangulated
    _same_scene(mine, JM.load_obj(str(obj)))


def test_load_primitives_matches_jax(tmp_path):
    f = tmp_path / "scene.txt"
    f.write_text(PRIMS_TXT)
    mine = TM.load_primitives(str(f), device="cpu")
    assert mine.count == 4
    _same_scene(mine, JM.load_primitives(str(f)))
    bad = tmp_path / "bad.txt"
    bad.write_text("sphere 1 2\n")
    with pytest.raises(ValueError, match="bad record"):
        TM.load_primitives(str(bad), device="cpu")


def test_from_orchard_matches_jax():
    theirs, mine = _baked()
    assert mine.count > 500
    _same_scene(mine, theirs)


def test_loaders_build_on_the_card_or_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj = tmp_path / "box.obj"
    obj.write_text(BOX_OBJ)
    prims = tmp_path / "scene.txt"
    prims.write_text(PRIMS_TXT)
    for build in (lambda: TM.load_obj(str(obj)), lambda: TM.load_primitives(str(prims)),
                  lambda: TM.from_orchard(TO.make_params(device="cpu"), (0, 10), (0, 10)),
                  lambda: TM.build_scene(spheres=[(0, 0, 1, 1)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


# ----------------------------------------------------------------------
# windowing
# ----------------------------------------------------------------------


@pytest.mark.parametrize("scene", ["baked", "mixed"])
def test_windows_and_strips_match_jax(scene):
    """Six poses in one batched call of the port, each against the JAX
    function on its pose: windows, per-strip tables and n_vis equal."""
    jm, tm = _baked() if scene == "baked" else _mixed()
    cfg_j, cfg_t = JR.make_config(W, H), TR.make_config(W, H)
    reach = cfg_t.far * TM.slant_factor(cfg_t)
    assert reach == cfg_j.far * JM.slant_factor(cfg_j)
    pos, cam = _poses(5, 6)
    windows = TM.select_window(tm, torch.from_numpy(pos), reach, 192)
    strips, nvis = TM.strip_windows(cfg_t, windows, torch.from_numpy(pos), torch.from_numpy(cam),
                                    cuda_meshscene.TILE_H)
    assert windows.shape == (6, 192, 10) and strips.shape == (6, H // 16, 192, 10)
    for b in range(6):
        win_j = JM.select_window(jm, jnp.asarray(pos[b]), reach, 192)
        np.testing.assert_array_equal(windows[b].numpy(), np.asarray(win_j))
        strips_j, nvis_j = JM.strip_windows(cfg_j, win_j, jnp.asarray(pos[b]),
                                            jnp.asarray(cam[b]), JP.TILE_H)
        np.testing.assert_array_equal(nvis[b].numpy(), np.asarray(nvis_j))
        np.testing.assert_array_equal(strips[b].numpy(), np.asarray(strips_j))
    assert 0 < float(nvis.float().mean()) < 96  # the culling keeps some rows, drops most


def test_small_scene_window_is_shorter_than_capacity():
    _, tm = _mixed()
    small = tm._replace(prims=tm.prims[:7], center_xy=tm.center_xy[:7], radius=tm.radius[:7],
                        material=tm.material[:7], count=7)
    window = TM.select_window(small, torch.zeros(2, 3), 20.0, 192)
    assert window.shape == (2, 7, 10)


# ----------------------------------------------------------------------
# plain renderers
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jnp_render(scene):
    """The JAX package's jnp renderer on `scene`, compiled once for every pose
    (eager, it dispatches op by op)."""
    jm = (_baked() if scene == "baked" else _mixed())[0]
    cfg = JR.make_config(W, H)
    return jax.jit(lambda p, c: JM.render_depth(cfg, jm, p, c))


@pytest.mark.parametrize("scene", ["baked", "mixed"])
def test_plain_renderers_match_jax(scene):
    """K4w's and K4's plain versions against the JAX Pallas kernels
    (interpret mode) and the jnp renderer, on four poses."""
    jm, tm = _baked() if scene == "baked" else _mixed()
    cfg_j, cfg_t = JR.make_config(W, H), TR.make_config(W, H)
    pos, cam = _poses(11, 4)
    pos_t, cam_t = torch.from_numpy(pos), torch.from_numpy(cam)
    reach = cfg_t.far * TM.slant_factor(cfg_t)
    windows = TM.select_window(tm, pos_t, reach, 192)
    strips, _ = TM.strip_windows(cfg_t, windows, pos_t, cam_t, cuda_meshscene.TILE_H)
    window_codes = TM.render_depth_window(cfg_t, windows, pos_t, cam_t).numpy()
    strip_codes = TM.render_strips(cfg_t, strips, pos_t, cam_t).numpy()
    assert window_codes.dtype == np.int32 and window_codes.shape == (4, H, W)
    np.testing.assert_array_equal(strip_codes, window_codes)  # culling is conservative
    assert len(np.unique(window_codes)) > 20  # the scene is not empty

    win_j = jnp.asarray(windows.numpy())
    k4w = np.asarray(JP.render_depth_window_batch(cfg_j, win_j, jnp.asarray(pos),
                                                  jnp.asarray(cam), interpret=True))
    k4 = np.asarray(JP.render_depth_strips_batch(cfg_j, win_j, jnp.asarray(pos),
                                                 jnp.asarray(cam), interpret=True))
    jnp_codes = np.stack([np.asarray(_jnp_render(scene)(jnp.asarray(p), jnp.asarray(c)))
                          for p, c in zip(pos, cam)])
    _check_codes(window_codes, k4w, f"{scene}: render_depth_window vs Pallas K4w (interpret)")
    _check_codes(strip_codes, k4, f"{scene}: render_strips vs Pallas K4 (interpret)")
    _check_codes(window_codes, jnp_codes, f"{scene}: render_depth_window vs jnp render_depth")


def test_cpu_tensors_take_the_plain_versions():
    _, tm = _baked()
    cfg = TR.make_config(W, H)
    pos, cam = (torch.from_numpy(a) for a in _poses(2, 2))
    before = (cuda_meshscene.render_depth_strips_batch.launches,
              cuda_meshscene.render_depth_window_batch.launches)
    culled = cuda_meshscene.render_depth_batch(cfg, tm, pos, cam)
    plain = cuda_meshscene.render_depth_batch(cfg, tm, pos, cam, strip_culling=False)
    ref = TM.render_depth(cfg, tm, pos, cam, strip_cull=False)
    assert torch.equal(culled, ref) and torch.equal(plain, ref)
    body = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2)
    assert torch.equal(cuda_meshscene.render_depth_body_batch(cfg, tm, pos, body),
                       TM.render_depth_body(cfg, tm, pos, body))
    assert (cuda_meshscene.render_depth_strips_batch.launches,
            cuda_meshscene.render_depth_window_batch.launches) == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "height", "rows"])
def test_wrappers_reject_bad_inputs(bad):
    cfg = TR.make_config(64, 48)
    pos, cam = torch.zeros(2, 3), torch.tensor([[1.0, 0, 0, 0]] * 2)
    windows = torch.zeros(2, 5, 10)
    if bad == "shape":
        pos = pos[:, :2]
    elif bad == "dtype":
        windows = windows.double()
    elif bad == "height":
        cfg = TR.make_config(64, 40)
    else:
        windows = windows[:, :, :9]
    for render in (cuda_meshscene.render_depth_window_batch,
                   cuda_meshscene.render_depth_strips_batch):
        with pytest.raises(ValueError):
            render(cfg, windows, pos, cam)


# ----------------------------------------------------------------------
# the frame and the fleet frame through the baked orchard
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX params with the baked orchard, its jitted frame_step, and three
    vehicles' states (one compiled program serves every JAX frame here)."""
    jp = J.make_params(use_pallas=False, fused_ticks=False, mesh_scene=_baked()[0], **KW)
    step = jax.jit(lambda s: J.frame_step(jp, s))
    states = []
    for b, frames in enumerate(WARM):
        pos = (0.0, 3.0 * b, 0.0) if frames == 0 else (0.0, 0.0, 0.0)
        s = J.init_state(jp, jax.random.PRNGKey(b), pos=pos)
        for _ in range(frames):
            s, _ = step(s)
        states.append(s)
    return jp, step, states


def _draws(js):
    """The planner's uniform block and the IMU noise that JAX frame_step
    draws from this state's key."""
    _, sub, k_noise = jax.random.split(js.base.key, 3)
    return (np.array(jax.random.uniform(sub, (4, KW["n_candidates"]), jnp.float32)),
            np.array(jax.random.normal(k_noise, (16, 2, 3), jnp.float32)))


def _params(jp):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def test_params_with_mesh_carry_across():
    jp, _, _ = _jax()
    theirs = _params(jp)
    mine = T.make_params(fused_ticks=False, mesh_scene=_baked()[1], device="cpu", **KW)
    assert theirs.mesh.count == mine.mesh.count == _baked()[0].count
    assert dict(convert.leaves(theirs)).keys() == dict(convert.leaves(mine)).keys()
    theirs_leaves = dict(convert.leaves(theirs))
    for path, t in convert.leaves(mine):
        np.testing.assert_allclose(t.numpy(), theirs_leaves[path].numpy(), rtol=2e-7, atol=0,
                                   err_msg=str(path))
        assert t.dtype == theirs_leaves[path].dtype, path
    for path in (("mesh", "prims"), ("mesh", "material")):
        assert torch.equal(dict(convert.leaves(mine))[path], theirs_leaves[path])
    # a mesh without a material column stays without one
    bare = jp._replace(mesh=jp.mesh._replace(material=None))
    assert _params(bare).mesh.material is None


def test_orchard_env_carries_the_mesh_as_buffers():
    p = T.make_params(mesh_scene=_baked()[1], device="cpu", **KW)
    env = T.OrchardEnv(p)
    names = {id(b) for b in env.buffers()}
    assert id(env.params.mesh.prims) in names and id(env.params.mesh.material) in names
    assert env.params.mesh.count == p.mesh.count
    assert torch.equal(env.params.mesh.prims, p.mesh.prims)


def test_one_mesh_frame_from_mid_flight_matches_jax():
    jp, step, states = _jax()
    js = states[0]
    assert int(js.plan_count) > 0  # the planner is live in this state
    u, noise = _draws(js)
    ref, ref_out = step(js)
    got, out = T.frame_step(_params(jp), convert.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js)), draws=(torch.from_numpy(u),
                                                        torch.from_numpy(noise)))
    compare_state(got, ref)
    for k in COUNTERS:
        assert int(out[k]) == int(ref_out[k]), k
    np.testing.assert_allclose(float(out["best_cost"]), float(ref_out["best_cost"]), rtol=1e-5)


def test_mesh_fleet_frame_matches_jax_per_vehicle():
    jp, step, states = _jax()
    assert int(states[0].plan_count) > 0 and int(states[1].plan_count) == 0
    stacked = jax.tree_util.tree_map(lambda *x: np.stack([np.asarray(a) for a in x]), *states)
    draws = [_draws(s) for s in states]
    u = torch.from_numpy(np.stack([d[0] for d in draws]))
    noise = torch.from_numpy(np.stack([d[1] for d in draws]))
    got, out = T.frame_step_fleet(_params(jp), convert.state_from_numpy(stacked),
                                  draws=(u, noise))
    assert out["pos"].shape == (3, 3) and out["best_cost"].shape == (3,)
    leaves, rebuild = convert.flatten_tensors(got)
    for b, js in enumerate(states):
        ref, ref_out = step(js)
        compare_state(rebuild([t[b] for t in leaves]), ref)
        for k in COUNTERS:
            assert int(out[k][b]) == int(ref_out[k]), (b, k)
        np.testing.assert_allclose(float(out["best_cost"][b]), float(ref_out["best_cost"]),
                                   rtol=1e-5)
    assert bool(out["plan_found"][0])  # the tracking vehicle plans
