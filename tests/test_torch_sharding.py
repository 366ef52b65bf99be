"""The port's multi-device path (`parallel/sharding`) against the JAX package's.

JAX runs its sharded programs on `jax.devices()[:W]` of the virtual CPU
mesh (tests/conftest.py); the port runs W = 2 ranks over gloo, each a
subprocess with one torch thread (tests/_torch_mesh.py), fed the same
inputs: the JAX initial states through `convert` (each rank takes its rows
with `shard_rows`) and the draws the JAX package makes from its keys, as
the global blocks the port's steps take.

- The fleet step: 16 envs x 10 substeps, the true state and the mocap
  estimator, every row to the tick criteria (`compare_state`); mean_pos
  and mean_speed within 1e-5 of JAX's, num_panicked equal, max_tilt_cos
  within 1e-6.
- The candidate-sharded planner: 160x120, 32 candidates, capacity 4, on
  the open image and one with an obstacle band; found and the four counts
  equal, best_cost and the winner's coefficients within 1e-5 (the
  planner-under-jit bound of tests/test_torch_planner.py).
- The orchard fleet step: 4 vehicles x 2 frames from the spawn at 64x48
  (16 candidates, capacity 4, 1 round: tests/test_multihost.py's orchard);
  floats to the tick criteria, integers and the four metrics equal.
- Layout: W = 2 equals a world of one bit for bit, row by row; every
  rank's metrics are bit-equal; a world of one's metrics equal this
  process's reduction of its rows. A world of one made in this process
  (`make_mesh` on the CPU) shards and gathers rows as the identity.

The ranks start before the JAX programs compile and run beside them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh
from _torch_parity import compare_state, jax_frame_draws, jax_tick_draws
from agrifly_tpu.parallel import sharding as J
from agrifly_tpu.sim import env as J_env, orchard_env as J_orchard
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.parallel import sharding
from agrifly_tpu_torch.planner import rappids as trp

W = 2
N_ENVS, SUBSTEPS = 16, 10
MODES = (False, "mocap")
PLAN_W, PLAN_H, N_CAND, CAP = 160, 120, 32, 4
IMAGES = ("open", "band")
ORCHARD = dict(width=64, height=48, n_candidates=16, pyramid_capacity=4, planner_rounds=1,
               start_flight_time=0.2, fused_ticks=False)
N_ORCHARD, ORCHARD_FRAMES = 4, 2
MEAN_ATOL, TILT_ATOL, PLAN_RTOL = 1e-5, 1e-6, 1e-5


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fleet_inputs():
    jp = J_env.make_params(noise_scale=1.0)
    keys = jax.random.split(jax.random.PRNGKey(0), N_ENVS)
    states = _host(jax.vmap(lambda k: J_env.init_state(jp, k))(keys))
    noise, _ = jax_tick_draws(states.key, SUBSTEPS)
    cmd = J_env.hover_command((0.0, 0.0, 1.0))
    port = dict(params=convert.env_params_from_numpy(_host(jp)),
                state=convert.env_state_from_numpy(states),
                cmd=convert.command_from_numpy(_host(cmd)), noise=torch.tensor(noise),
                n_substeps=SUBSTEPS)
    return jp, states, cmd, port


def _jax_fleet(jp, states, cmd, mode):
    mesh = J.make_mesh(jax.devices()[:W])
    shard = J.env_sharding(mesh)
    cmds = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (N_ENVS,) + x.shape), cmd)
    put = lambda t: jax.device_put(t, jax.tree_util.tree_map(lambda _: shard, t))  # noqa: E731
    step = J.make_fleet_step(jp, mesh, N_ENVS, n_substeps=SUBSTEPS, use_estimator=mode)
    out, metrics = step(put(jax.tree_util.tree_map(jnp.asarray, states)), put(cmds))
    return _host(out), _host(metrics)


def _image(kind):
    img = np.full((PLAN_H, PLAN_W), 230, np.int32)
    if kind == "band":
        img[:, 70:100] = 60  # a wall 2.3 m ahead across the middle of the view
    return img


def _plan_inputs(kind, seed):
    """The JAX planner's inputs and the global uniform block its per-device
    keys draw (split(key, W), uniform(k_d, (4, n_local)) on device d)."""
    key = jax.random.PRNGKey(seed)
    n_local = N_CAND // W
    u = np.concatenate([np.asarray(jax.random.uniform(k, (4, n_local), jnp.float32))
                        for k in jax.random.split(key, W)], axis=1)
    vecs = [np.array(v, np.float32) for v in ((0.3, 0.0, 0.5), (0.0, 0.2, 0.0),
                                              (0.0, 9.81, 0.0), (0.0, 0.0, 20.0))]
    return _image(kind), key, u, vecs


def _planner_params(device_kw):
    cam = dict(focal=80.0, depth_scale=10 / 256)
    if device_kw is None:
        from agrifly_tpu.planner import rappids as jrp

        return jrp.make_params(jrp.make_camera(PLAN_W, PLAN_H, **cam), 0.116, 0.174)
    return trp.make_params(trp.make_camera(PLAN_W, PLAN_H, **cam, device="cpu"), 0.116, 0.174)


def _jax_planner():
    return J.make_sharded_planner(_planner_params(None), J.make_mesh(jax.devices()[:W]),
                                  N_CAND, CAP)


def _orchard_inputs():
    jp = J_orchard.make_params(use_pallas=False, **ORCHARD)
    states = _host(J.init_orchard_fleet(jp, J.make_mesh(jax.devices()[:W]), N_ORCHARD,
                                        base_seed=5))
    draws = [jax_frame_draws(k, ORCHARD_FRAMES, ORCHARD["n_candidates"])
             for k in states.base.key]
    u = np.stack([d[0] for d in draws], axis=1)  # (frames, B, 4, C)
    noise = np.stack([d[1] for d in draws], axis=1)  # (frames, B, 16, 2, 3)
    port = dict(params=convert.params_from_numpy(_host(jp)),
                state=convert.state_from_numpy(states),
                draws=(torch.from_numpy(u), torch.from_numpy(noise)))
    return jp, states, port


def _jax_orchard(jp, states):
    mesh = J.make_mesh(jax.devices()[:W])
    shard = J.env_sharding(mesh)
    step = J.make_orchard_fleet_step(jp, mesh, N_ORCHARD, n_frames=ORCHARD_FRAMES)
    out, metrics = step(jax.device_put(jax.tree_util.tree_map(jnp.asarray, states),
                                       jax.tree_util.tree_map(lambda _: shard, states)))
    return _host(out), _host(metrics)


def _runs(directory):
    """Every job on W ranks (started first), the JAX references meanwhile,
    then the same jobs on a world of one in this process."""
    jp, states, cmd, fleet_port = _fleet_inputs()
    plans = {kind: _plan_inputs(kind, 0) for kind in IMAGES}  # the same candidates
    ojp, ostates, orchard_port = _orchard_inputs()
    pp = _planner_params("cpu")
    jobs = [("fleet", dict(fleet_port, mode=mode)) for mode in MODES]
    jobs += [("planner", dict(params=pp, depth=torch.from_numpy(img), u=torch.from_numpy(u),
                              vel0=torch.from_numpy(v[0]), acc0=torch.from_numpy(v[1]),
                              grav=torch.from_numpy(v[2]), goal=torch.from_numpy(v[3]),
                              capacity=CAP)) for img, _, u, v in plans.values()]
    jobs.append(("orchard", orchard_port))
    handles = [_torch_mesh.start_jobs(w, jobs, directory, f"w{w}") for w in (W, 1)]
    ref = {mode: _jax_fleet(jp, states, cmd, mode) for mode in MODES}
    plan = _jax_planner()
    ref.update({kind: _host(plan(jnp.asarray(img), key, *(jnp.asarray(x) for x in v)))
                for kind, (img, key, _, v) in plans.items()})
    ref["orchard"] = _jax_orchard(ojp, ostates)
    ranks, (one,) = (_torch_mesh.finish_jobs(h) for h in handles)
    names = list(MODES) + list(IMAGES) + ["orchard"]
    return (ref, dict(zip(names, one)), [dict(zip(names, r)) for r in ranks])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(tmp_path_factory.mktemp("mesh"))


def _rows(ranks, key):
    """The global state from the ranks' rows, in rank order."""
    parts = [convert.flatten_tensors(r[key]["state"]) for r in ranks]
    return parts[0][1]([torch.cat(ls) for ls in zip(*(p[0] for p in parts))])


def _same_tree(a, b):
    la, lb = convert.flatten_tensors(a)[0], convert.flatten_tensors(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _same_metrics(ranks, key):
    first = ranks[0][key]["metrics"]
    return all(_same_tree(r[key]["metrics"], first) for r in ranks[1:])


@pytest.mark.parametrize("mode", MODES)
def test_fleet_step_matches_jax(runs, mode):
    ref, _, ranks = runs
    jax_state, jax_metrics = ref[mode]
    compare_state(_rows(ranks, mode), jax_state)
    m = ranks[0][mode]["metrics"]
    np.testing.assert_allclose(m.mean_pos.numpy(), jax_metrics.mean_pos, rtol=0, atol=MEAN_ATOL)
    np.testing.assert_allclose(float(m.mean_speed), float(jax_metrics.mean_speed), rtol=0,
                               atol=MEAN_ATOL)
    assert int(m.num_panicked) == int(jax_metrics.num_panicked) == 0
    np.testing.assert_allclose(float(m.max_tilt_cos), float(jax_metrics.max_tilt_cos), rtol=0,
                               atol=TILT_ATOL)


@pytest.mark.parametrize("kind", IMAGES)
def test_sharded_planner_matches_jax(runs, kind):
    ref, _, ranks = runs
    j = ref[kind]
    res = ranks[0][kind]
    for r in ranks[1:]:  # the result is the same on every rank
        assert _same_tree(r[kind], res)
    assert bool(res.found) == bool(j.found)
    for name in ("num_feasible", "num_velocity_admissible", "num_collision_free",
                 "num_pyramids"):
        assert int(getattr(res, name)) == int(getattr(j, name)), name
    assert res.num_candidates == int(j.num_candidates) == N_CAND
    np.testing.assert_allclose(float(res.best_cost), float(j.best_cost), rtol=PLAN_RTOL)
    for name in ("alpha", "beta", "gamma", "a0", "v0", "p0", "tf"):
        np.testing.assert_allclose(getattr(res.traj, name).numpy(), getattr(j.traj, name),
                                   rtol=PLAN_RTOL, atol=PLAN_RTOL, err_msg=name)
    if kind == "open":
        assert bool(res.found) and int(res.num_collision_free) > 0
    else:  # the wall blocks some candidates the open image frees
        assert int(res.num_collision_free) < int(ref["open"].num_collision_free)


def test_orchard_fleet_step_matches_jax(runs):
    ref, _, ranks = runs
    jax_state, jax_metrics = ref["orchard"]
    got = _rows(ranks, "orchard")
    compare_state(got, jax_state)
    m = ranks[0]["orchard"]["metrics"]
    np.testing.assert_allclose(m.mean_pos.numpy(), jax_metrics.mean_pos, rtol=0, atol=MEAN_ATOL)
    for name in ("num_panicked", "num_plans", "num_landed"):
        assert int(getattr(m, name)) == int(getattr(jax_metrics, name)), name
    assert int(m.num_panicked) == 0 and float(m.mean_pos[2]) > 0.0  # spooling up, off the ground
    assert int(got.frame_count[0]) == ORCHARD_FRAMES


@pytest.mark.parametrize("key", list(MODES) + ["orchard"])
def test_two_ranks_equal_a_world_of_one(runs, key):
    _, one, ranks = runs
    assert _same_tree(_rows(ranks, key), one[key]["state"])
    assert _same_metrics(ranks, key)
    # a world of one's reduction is this process's reduction of its rows
    s, m = one[key]["state"], one[key]["metrics"]
    pos = (s.base if key == "orchard" else s).plant.pos
    assert torch.equal(m.mean_pos, pos.sum(0) * (1.0 / pos.shape[0]))
    # two ranks sum two partial sums: the same mean within float rounding
    np.testing.assert_allclose(ranks[0][key]["metrics"].mean_pos.numpy(), m.mean_pos.numpy(),
                               rtol=0, atol=1e-6)


def test_rows_and_gather_round_trip():
    mesh = sharding.make_mesh(torch.device("cpu"))
    try:
        tree = sharding.init_orchard_fleet(
            convert.params_from_numpy(_host(J_orchard.make_params(use_pallas=False, **ORCHARD))),
            mesh, 3)
        assert sharding.rows(mesh, 6) == slice(0, 6)
        assert _same_tree(sharding.gather_rows(tree, mesh), tree)
        assert _same_tree(sharding.shard_rows(tree, mesh), tree)
        with pytest.raises(ValueError, match="divide"):
            sharding.rows(mesh._replace(world=2), 3)
    finally:
        sharding.close_mesh(mesh)
    assert not torch.distributed.is_initialized()
