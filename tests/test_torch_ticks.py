"""The port's 16-tick block against the JAX package's `frame_ticks_jnp`.

From one state and the same IMU noise block, every discrete leaf (flight
state, panic, ring slots and counters, estimator counters) must be equal
and every float leaf within |d| <= 1e-3 (|ref| + 1e-3); commanded body
rates and their wire codes are held to the command floor documented in
tests/_torch_parity.py. The cases cover every mission stage of the tick:
cold, takeoff, tracking a plan, the landing descent (from its start, and
reaching touchdown mid-block) and the idled complete stage.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import compare_state
from agrifly_tpu.planner import traj as jtraj
from agrifly_tpu.render import raycast as jray
from agrifly_tpu.sim import orchard_env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.sim import orchard_env as T

KW = dict(goal_world=(60.0, 0.0, 2.0), takeoff_height=2.0, start_flight_time=0.3,
          n_candidates=96, pyramid_capacity=16, width=160, height=120)


@functools.lru_cache(maxsize=None)
def _jax():
    jp = J.make_params(use_pallas=False, fused_ticks=False, **KW)
    return jp, jax.jit(lambda s, n: J.frame_ticks_jnp(jp, s, n))


def _noise(seed):
    return np.random.default_rng(seed).standard_normal((16, 2, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _warm_state():
    """The vehicle after 0.8 s of takeoff (25 tick blocks)."""
    jp, ticks = _jax()
    s = J.init_state(jp, jax.random.PRNGKey(0))
    for i in range(25):
        s = ticks(s, jnp.asarray(_noise(i)))
    return s


def _with_plan(s):
    """Adopt a camera-frame trajectory at the current estimate, as
    _frame_percept does after a successful plan."""
    est_att = s.base.mocap.att
    vel_cam = jnp.asarray([0.05, -0.4, 0.3], jnp.float32)
    tr = jtraj.generate(jnp.zeros(3, jnp.float32), vel_cam, jnp.zeros(3, jnp.float32),
                        jnp.float32(2.5), goal_pos=jnp.asarray([0.3, -0.2, 2.5], jnp.float32),
                        goal_vel=jnp.zeros(3, jnp.float32), goal_acc=jnp.zeros(3, jnp.float32))
    planned = s.planned._replace(
        planned=jnp.bool_(True), alpha=tr.alpha, beta=tr.beta, gamma=tr.gamma, a0=tr.a0,
        v0=tr.v0, p0=tr.p0, tf=tr.tf, att=jray.camera_attitude(est_att),
        offset=s.base.mocap.pos, start_step=s.base.step - 40,
        grav_cam=jnp.asarray([0.0, 9.81, 0.0], jnp.float32))
    return s._replace(planned=planned)


def _landing(s, stage, since_steps):
    """The landing stage entered at the current position `since_steps`
    ticks ago (tests/test_pallas_frame.py's landing state for 0)."""
    return s._replace(mstage=jnp.int32(stage), land_pos=jnp.asarray(s.base.plant.pos),
                      land_start_step=s.base.step - since_steps)


def _touchdown_steps(z0):
    """Ticks since landing entry that put touchdown (the descent with its
    blend-in reaching z = 0) eight ticks into the block."""
    t = 0.0
    while z0 - T.LANDING_SPEED * min(t / T.LANDING_BLEND_TIME, 1.0) * t >= 0.0:
        t += 0.002
    return round(t / 0.002) - 8


@pytest.mark.parametrize("case", ["cold", "takeoff", "tracking", "landing", "touchdown",
                                  "complete"])
def test_tick_block_matches_jax(case):
    jp, ticks = _jax()
    if case == "cold":
        s = J.init_state(jp, jax.random.PRNGKey(1))
    else:
        s = _warm_state()
        if case == "tracking":
            s = _with_plan(s)
        elif case == "landing":
            s = _landing(s, J.MSTAGE_LANDING, 0)
        elif case == "touchdown":
            s = _landing(s, J.MSTAGE_LANDING, _touchdown_steps(float(s.base.plant.pos[2])))
        elif case == "complete":
            s = _landing(s, J.MSTAGE_COMPLETE, 0)
    noise = _noise(99)
    ref = ticks(s, jnp.asarray(noise))

    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    ts = convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, s))
    got = T.frame_ticks(tp, ts, torch.from_numpy(noise))
    worst = compare_state(got, ref)
    print(case, worst[:3])
    assert int(got.base.step) == int(s.base.step) + 16
    if case in ("takeoff", "tracking"):
        assert float(got.base.plant.pos[2]) > 0.1  # airborne
    if case in ("touchdown", "complete"):
        assert int(ref.mstage) == T.MSTAGE_COMPLETE
        # the idle command went into the ring
        assert (np.asarray(ref.base.ring.types) == 6).any()
    if case == "landing":
        assert int(ref.mstage) == T.MSTAGE_LANDING
