"""The port's RAPPIDS planner against the JAX package's.

Both plan on the same depth image with the same candidates (injected
samples, or the JAX package's uniform draws for `plan`): feasibility gates
bit-equal, costs within rtol 1e-5, collision labels equal, the same chosen
candidate.

The JAX side runs under jit, as the JAX package's frame does: op-by-op
dispatch rounds some sums differently from the compiled program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrifly_tpu.planner import rappids as jrp
from agrifly_tpu.render import orchard as jorch, raycast as jray
from agrifly_tpu_torch.planner import rappids as trp
from _torch_parity import make_scene

W, H, N, CAP = 160, 120, 96, 16


def _params():
    # the orchard env's planner: radii from the CF mini-quad's arm length
    arm = 0.058
    jp = jrp.make_params(jrp.make_camera(W, H, focal=W / 2.0), 2 * arm, 3 * arm, 0.5)
    tp = trp.make_params(trp.make_camera(W, H, focal=W / 2.0, device="cpu"), 2 * arm, 3 * arm, 0.5)
    return jp, tp


def _orchard_frame(seed):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray([rng.uniform(2, 20), rng.uniform(-3, 3), 2.0], jnp.float32)
    cam = jray.camera_attitude(jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32))
    return np.array(jray.render_depth(jray.make_config(W, H), jorch.make_params(), pos, cam))


def _scene(kind, seed):
    return _orchard_frame(seed) if kind == "orchard" else make_scene(W, H, 5, seed)


def _motion(seed):
    rng = np.random.default_rng(100 + seed)
    vel = (rng.standard_normal(3) * [0.3, 0.3, 1.0]).astype(np.float32)
    acc = (rng.standard_normal(3) * 0.5).astype(np.float32)
    grav = np.array([0.0, 9.81, 0.0], np.float32)
    goal = np.array([0.0, 0.0, 30.0], np.float32) + rng.standard_normal(3).astype(np.float32)
    return vel, acc, grav, goal


def _samples(seed, n=N):
    rng = np.random.default_rng(200 + seed)
    return (rng.uniform(0.1 * W, 0.9 * W, n).astype(np.float32),
            rng.uniform(0.1 * H, 0.9 * H, n).astype(np.float32),
            rng.uniform(1.5, 3.0, n).astype(np.float32),
            rng.uniform(2.0, 3.0, n).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_plan_debug(downsample):
    jp, _ = _params()
    return jax.jit(lambda img, samples, vel, acc, grav, goal: jrp.plan_debug(
        jp, img, None, vel, acc, grav, goal, pyramid_capacity=CAP,
        inflation_downsample=downsample, samples=samples))


@pytest.mark.parametrize("kind,seed", [("orchard", 0), ("orchard", 1), ("clutter", 2)])
@pytest.mark.parametrize("downsample", [1, 2])
def test_plan_debug_matches_jax(kind, seed, downsample):
    jp, tp = _params()
    img = _scene(kind, seed)
    vel, acc, grav, goal = _motion(seed)
    samples = _samples(seed)
    j = _jax_plan_debug(downsample)(jnp.asarray(img), tuple(jnp.asarray(x) for x in samples),
                                    *(jnp.asarray(x) for x in (vel, acc, grav, goal)))
    t = trp.plan_debug(tp, torch.from_numpy(img), tuple(torch.from_numpy(s) for s in samples),
                       torch.from_numpy(vel), torch.from_numpy(acc), torch.from_numpy(grav),
                       torch.from_numpy(goal), pyramid_capacity=CAP,
                       inflation_downsample=downsample)
    _, cost_j, feas_j, vel_j, gate_j, free_j, pyrs_j = j
    _, cost_t, feas_t, vel_t, gate_t, free_t, pyrs_t = t
    np.testing.assert_array_equal(feas_t.numpy(), np.asarray(feas_j))
    np.testing.assert_array_equal(vel_t.numpy(), np.asarray(vel_j))
    np.testing.assert_array_equal(gate_t.numpy(), np.asarray(gate_j))
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j), rtol=1e-5)
    np.testing.assert_array_equal(free_t.numpy(), np.asarray(free_j))
    np.testing.assert_array_equal(pyrs_t.valid.numpy(), np.asarray(pyrs_j.valid))
    assert np.asarray(gate_j).sum() > 10 and np.asarray(pyrs_j.valid).sum() > 0

    ok = np.asarray(gate_j) & np.asarray(free_j)
    best_j = np.argmin(np.where(ok, np.asarray(cost_j), np.inf))
    best_t = np.argmin(np.where(ok, cost_t.numpy(), np.inf))
    assert best_j == best_t


def test_plan_with_injected_uniform_draws_matches_jax():
    jp, tp = _params()
    img = _orchard_frame(3)
    vel, acc, grav, goal = _motion(3)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (4, N), jnp.float32))
    j = jax.jit(lambda img, key, vel, acc, grav, goal: jrp.plan(
        jp, img, key, vel, acc, grav, goal, n_candidates=N, pyramid_capacity=CAP,
        inflation_downsample=2))(jnp.asarray(img), key,
                                 *(jnp.asarray(x) for x in (vel, acc, grav, goal)))
    t = trp.plan(tp, torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(vel),
                 torch.from_numpy(acc), torch.from_numpy(grav), torch.from_numpy(goal),
                 pyramid_capacity=CAP, inflation_downsample=2)
    assert bool(j.found) and bool(t.found)
    assert int(j.best_idx) == int(t.best_idx)
    np.testing.assert_allclose(float(t.best_cost), float(j.best_cost), rtol=1e-5)
    for name in ("num_feasible", "num_velocity_admissible", "num_collision_free", "num_pyramids"):
        assert int(getattr(t, name)) == int(getattr(j, name)), name
    np.testing.assert_allclose(t.traj.alpha.numpy(), np.asarray(j.traj.alpha), rtol=1e-5, atol=1e-6)
