"""The port's orchard fleet frame against the JAX package, on the CPU.

A fleet is B vehicles sharing one `OrchardEnvParams`, with a leading B axis
on every state leaf. Three vehicles in different mission states (tracking a
plan, climbing before planning starts, cold at a lateral spawn) are built
with the JAX package's jitted `frame_step` and stacked into one state; one
`frame_step_fleet` of the port, with each vehicle's planner draws and IMU
noise rebuilt from its own key split, is held row by row against the JAX
`frame_step` of that vehicle to the tick criteria of tests/_torch_parity.py
(the JAX package holds `frame_step_fleet` equal to `jax.vmap(frame_step)`
bit for bit, tests/test_pallas_frame.py). The batched planner and the
batched plain inflation are held against their per-image calls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import compare_state, gradient_scene, make_scene
from agrifly_tpu.sim import orchard_env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.planner import cuda_inflate, rappids as trp
from agrifly_tpu_torch.sim import orchard_env as T

KW = dict(goal_world=(60.0, 0.0, 2.0), takeoff_height=2.0, start_flight_time=1.0,
          n_candidates=96, pyramid_capacity=16, width=160, height=120)
N = KW["n_candidates"]
WARM = (40, 12, 0)  # frames flown by each vehicle; planning starts at frame 32
COUNTERS = ("plan_found", "num_collision_free", "num_pyramids", "num_feasible",
            "num_velocity_admissible", "flight_state", "panic")


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX params, the jitted frame_step, and the three vehicles' states
    (one compiled program serves every JAX frame of this file)."""
    jp = J.make_params(use_pallas=False, fused_ticks=False, **KW)
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
    return (np.asarray(jax.random.uniform(sub, (4, N), jnp.float32)),
            np.asarray(jax.random.normal(k_noise, (16, 2, 3), jnp.float32)))


def _fleet(jp, states):
    """The port's params and the three states stacked on a leading axis."""
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    stacked = jax.tree_util.tree_map(lambda *x: np.stack([np.asarray(a) for a in x]), *states)
    return tp, convert.state_from_numpy(stacked)


def _row(state, b):
    leaves, rebuild = convert.flatten_tensors(state)
    return rebuild([t[b] for t in leaves])


@pytest.mark.parametrize("fused", [False, True])
def test_fleet_frame_matches_jax_per_vehicle(fused):
    jp, step, states = _jax()
    assert int(states[0].plan_count) > 0 and int(states[1].plan_count) == 0
    tp, ts = _fleet(jp, states)
    tp = tp._replace(fused_ticks=fused)  # fused on CPU tensors: the plain fleet ticks
    draws = [_draws(s) for s in states]
    u = torch.from_numpy(np.stack([d[0] for d in draws]))
    noise = torch.from_numpy(np.stack([d[1] for d in draws]))
    before = T.frame_ticks_plain.calls
    got, out = T.frame_step_fleet(tp, ts, draws=(u, noise))
    assert T.frame_ticks_plain.calls == before + len(states)
    assert out["pos"].shape == (3, 3) and out["best_cost"].shape == (3,)

    for b, js in enumerate(states):
        ref, ref_out = step(js)
        compare_state(_row(got, b), ref)
        for k in COUNTERS:
            assert int(out[k][b]) == int(ref_out[k]), (b, k)
        np.testing.assert_allclose(float(out["best_cost"][b]), float(ref_out["best_cost"]),
                                   rtol=1e-5)
    assert bool(out["plan_found"][0])  # the tracking vehicle plans


@pytest.mark.slow
def test_fleet_frame_matches_jax_frame_step_fleet():
    jp, _, states = _jax()
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    ref, ref_out = jax.jit(lambda s: J.frame_step_fleet(jp, s))(stacked)
    tp, ts = _fleet(jp, states)
    draws = [_draws(s) for s in states]
    got, out = T.frame_step_fleet(tp, ts, draws=(
        torch.from_numpy(np.stack([d[0] for d in draws])),
        torch.from_numpy(np.stack([d[1] for d in draws]))))
    compare_state(got, ref)
    for k in COUNTERS:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref_out[k]), err_msg=k)


def _plan_inputs(B, seed):
    """Planner inputs for B vehicles: a cluttered scene, a uniform block
    and a camera-frame motion and goal each."""
    rng = np.random.default_rng(seed)
    W, H = KW["width"], KW["height"]
    imgs = np.stack([make_scene(W, H, 5, seed + b) for b in range(B)])
    u = rng.uniform(size=(B, 4, N)).astype(np.float32)
    vel = (rng.standard_normal((B, 3)) * [0.3, 0.3, 1.0]).astype(np.float32)
    acc = (rng.standard_normal((B, 3)) * 0.5).astype(np.float32)
    grav = np.tile(np.array([0.0, 9.81, 0.0], np.float32), (B, 1))
    goal = (np.array([0.0, 0.0, 30.0]) + rng.standard_normal((B, 3))).astype(np.float32)
    return [torch.from_numpy(a) for a in (imgs, u, vel, acc, grav, goal)]


@pytest.mark.parametrize("downsample", [1, 2])
def test_batched_plan_equals_per_image_plan(downsample):
    W, H = KW["width"], KW["height"]
    params = trp.make_params(trp.make_camera(W, H, focal=W / 2.0, device="cpu"), 0.116, 0.174, 0.5)
    inputs = _plan_inputs(3, seed=11)
    kw = dict(pyramid_capacity=KW["pyramid_capacity"], inflation_downsample=downsample)
    batched = trp.plan(params, *inputs, **kw)
    found = 0
    for b in range(3):
        one = trp.plan(params, *(x[b] for x in inputs), **kw)
        for name in ("found", "best_idx", "num_feasible", "num_velocity_admissible",
                     "num_collision_free", "num_pyramids"):
            assert torch.equal(getattr(batched, name)[b], getattr(one, name)), (b, name)
        torch.testing.assert_close(batched.best_cost[b], one.best_cost, rtol=1e-6, atol=0)
        for x, y in zip(batched.traj, one.traj):
            torch.testing.assert_close(x[b], y, rtol=1e-6, atol=0)
        found += int(one.found)
    assert found >= 2


def _inflation_batch(W, H, P):
    imgs = np.stack([make_scene(W, H, 8, seed=3), make_scene(W, H, 8, seed=4),
                     gradient_scene(W, H)])
    rng = np.random.default_rng(W)
    seeds = (rng.integers(2, W - 2, (3, P)).astype(np.float32),
             rng.integers(2, H - 2, (3, P)).astype(np.float32),
             rng.uniform(1.5, 3.0, (3, P)).astype(np.float32))
    return torch.from_numpy(imgs), [torch.from_numpy(a) for a in seeds]


@pytest.mark.parametrize("shrink_extra", [0, 1])
def test_batched_plain_inflation_equals_per_image(shrink_extra):
    W, H = 160, 120
    params = trp.make_params(trp.make_camera(W, H, focal=W / 2.0, device="cpu"), 0.116, 0.174)
    imgs, seeds = _inflation_batch(W, H, 16)
    batched = trp.inflate_pyramid(params, imgs, *seeds, shrink_extra)
    via_wrapper = cuda_inflate.inflate_pyramids(params, imgs, *seeds, shrink_extra)
    assert batched[0].shape == (3, 16) and batched[2].shape == (3, 16, 4)
    for b in range(3):
        one = trp.inflate_pyramid(params, imgs[b], *(s[b] for s in seeds), shrink_extra)
        for x, y, z in zip(batched, via_wrapper, one):
            assert torch.equal(x[b], z) and torch.equal(y[b], z)
    assert int(batched[0][2].sum()) >= 1 and int(batched[0][:2].sum()) >= 1


@pytest.mark.parametrize("downsample", [1, 2])
def test_batched_pyramid_set_and_prefilter_equal_per_image(downsample):
    W, H = 160, 120
    params = trp.make_params(trp.make_camera(W, H, focal=W / 2.0, device="cpu"), 0.116, 0.174)
    imgs, (px, py, md) = _inflation_batch(W, H, 12)
    valid = torch.ones(px.shape, dtype=torch.bool)
    valid[:, 3] = False
    keep = trp.prefilter_seeds(params, imgs, px, py, md, valid, downsample=downsample)
    pyrs = trp.build_pyramid_set(params, imgs, px, py, md, valid, 8, downsample=downsample)
    for b in range(3):
        one = trp.prefilter_seeds(params, imgs[b], px[b], py[b], md[b], valid[b],
                                  downsample=downsample)
        assert torch.equal(keep[b], one)
        one = trp.build_pyramid_set(params, imgs[b], px[b], py[b], md[b], valid[b], 8,
                                    downsample=downsample)
        for x, y in zip(pyrs, one):
            assert torch.equal(x[b], y)


def test_fly_fleet_on_cpu():
    # a smaller camera and candidate set: the flight's shapes and take-off, not the plans
    p = T.make_params(device="cpu", **{**KW, "start_flight_time": 0.3, "width": 80, "height": 60,
                                       "n_candidates": 32, "pyramid_capacity": 8})
    env = T.OrchardEnv(p)
    s0 = env.init_state_fleet([[0.0, -3.0, 0.0], [0.0, 0.0, 0.0], [0.0, 3.0, 0.0]])
    s, outs = env.fly_fleet(s0, 10, torch.Generator().manual_seed(0))
    assert outs["pos"].shape == (10, 3, 3) and outs["plan_found"].shape == (10, 3)
    assert torch.isfinite(outs["pos"]).all()
    assert not (outs["panic"] != 0).any()
    assert torch.equal(s.frame_count, s0.frame_count + 10)
    assert (outs["pos"][-1, :, 2] > 0.1).all()  # every vehicle took off
