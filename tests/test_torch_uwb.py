"""UWB ranging and the onboard-UWB configuration in the port, against the
JAX package, on the CPU: `ekf.update_range`, `sim/uwb.step`, the logic's
range update, and `sim/env` with anchors (`with_uwb_anchors`, a UWB
override, the rollouts).

The JAX package draws the network's randomness from its own key
(`split(key, 5)` each tick); `_torch_parity.jax_uwb_draws` rebuilds those
draws and the port takes them as its (4,) draw rows (and the IMU noise
from the env's key, `_torch_parity.jax_tick_draws`). Tolerances: discrete leaves equal; float leaves within the tick
criteria of tests/_torch_parity.py, except where a test states otherwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import FLOAT_FLOOR, FLOAT_REL, compare_state, jax_uwb_draws
from agrifly_tpu.models import ekf as jekf
from agrifly_tpu.models import logic as jlogic
from agrifly_tpu.sim import env as J
from agrifly_tpu.sim import uwb as juwb
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.models import ekf as tekf
from agrifly_tpu_torch.models import logic as tlogic
from agrifly_tpu_torch.sim import env as T
from agrifly_tpu_torch.sim import uwb as tuwb
from _torch_parity import jax_tick_draws

ANCHOR_IDS = [101, 102, 103, 104]  # tests/test_uwb.py's
ANCHOR_POS = [[-3.0, -3.0, 0.1], [3.0, -3.0, 0.2], [3.0, 3.0, 2.0], [-3.0, 3.0, 1.5]]
SETPOINT = (0.5, -0.5, 1.5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _env_draws(s, n):
    """The IMU noise and the UWB draws a JAX EnvState's keys give n ticks."""
    return torch.from_numpy(np.array(jax_tick_draws(s.key, n)[0])), jax_uwb_draws(s.uwb.key, n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ekf_cases():
    """Eight onboard filters (numpy leaves): an SPD covariance each, and
    cases for accept, accept in full-EKF mode, reject, the fifth reject in a
    row (a hard reset), apply=False, a non-finite range, a filter without
    an IMU sample, and a target at the filter's position."""
    rng = np.random.default_rng(0)
    n = 8
    A = rng.standard_normal((n, 9, 9)) * 0.3
    cov = (A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(9)).astype(np.float32)
    q = rng.standard_normal((n, 4)) * [1.0, 0.1, 0.1, 0.1]
    s = dict(pos=rng.uniform(-2, 2, (n, 3)), vel=rng.uniform(-1, 1, (n, 3)),
             att=q / np.linalg.norm(q, axis=1, keepdims=True), angvel=rng.uniform(-1, 1, (n, 3)),
             cov=cov, imu_init=np.ones(n, bool), uwb_init=np.arange(n) == 1,
             last_att_corr=rng.uniform(-0.01, 0.01, (n, 3)), num_rejected=np.full(n, 3),
             num_rejected_seq=np.where(np.arange(n) == 3, 4, 0), num_resets=np.full(n, 2))
    s = {k: v.astype(np.float32) if v.dtype.kind == "f" else
         (v.astype(np.int32) if v.dtype.kind == "i" else v) for k, v in s.items()}
    s["imu_init"][6] = False
    target = (s["pos"] + rng.uniform(-3, 3, (n, 3))).astype(np.float32)
    target[7] = s["pos"][7]
    expected = np.linalg.norm(s["pos"] - target, axis=1)
    meas = (expected + rng.uniform(-0.05, 0.05, n)).astype(np.float32)
    meas[2:4] += 5.0  # far outside 3 sigma
    meas[5] = np.nan
    apply = np.arange(n) != 4
    return s, target, meas, apply


def test_update_range_matches_jax():
    s, target, meas, apply = _ekf_cases()
    ref = _np(jax.vmap(jekf.update_range)(jekf.EkfState(**s), target, meas, apply))
    got = torch.func.vmap(tekf.update_range)(tekf.EkfState(**{k: _t(v) for k, v in s.items()}),
                                             _t(target), _t(meas), _t(apply))
    compare_state(got, ref)
    # the cases did what they name
    np.testing.assert_array_equal(ref.uwb_init, [True, True, True, False, False, False, False, True])
    np.testing.assert_array_equal(ref.num_rejected_seq, [0, 0, 1, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(ref.num_resets, [2, 2, 2, 3, 2, 2, 2, 2])
    assert not ref.imu_init[3] and (ref.pos[0] != s["pos"][0]).any()


# tests/test_uwb.py's networks: round robin with noise, all outliers, all
# reported failed, and silence beyond max_range
_NETWORKS = {
    "noise": dict(ids=[1, 101, 102], kw=dict(noise_std=0.1),
                  pos=[[0.0, 0.0, 1.0], [5.0, 0.0, 1.0], [0.0, 5.0, 1.0]]),
    "outliers": dict(ids=[1, 101], kw=dict(outlier_prob=1.0, outlier_std=1.0),
                     pos=[[0.0, 0.0, 0.0], [10.0, 0.0, 0.0]]),
    "failures": dict(ids=[1, 101], kw=dict(failure_prob=1.0),
                     pos=[[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]]),
    "silence": dict(ids=[1, 101], kw=dict(noise_std=0.1, max_range=4.0),
                    pos=[[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]]),
}


@pytest.mark.parametrize("name", sorted(_NETWORKS))
def test_network_step_matches_jax(name):
    """60 ticks of `uwb.step` with the JAX package's draws: the state and
    the measurement equal (the range within the tick criterion) at every
    tick, and the network does what tests/test_uwb.py says it does."""
    net = _NETWORKS[name]
    jp = juwb.make_params(net["ids"], comm_period=0.01, **net["kw"])
    tp = tuwb.make_params(net["ids"], comm_period=0.01, **net["kw"])
    positions = np.asarray(net["pos"], np.float32)
    targets = np.zeros(len(net["ids"]), np.int32)
    targets[0] = 101
    js = juwb.init_state(jax.random.PRNGKey(len(name)))
    draws = jax_uwb_draws(js.key, 60).numpy()
    jstep = jax.jit(lambda s: juwb.step(jp, s, jnp.asarray(positions), jnp.asarray(targets),
                                        jnp.int32(2000)))
    ts = tuwb.init_state()
    ranges = []
    for k in range(60):
        js, jm = jstep(js)
        ts, tm = tuwb.step(tp, ts, _t(positions), _t(targets), torch.tensor(2000, dtype=torch.int32),
                           _t(draws[k]))
        for a, b in zip(tuple(ts) + tuple(tm), tuple(js)[:4] + tuple(jm)):
            a, b = a.numpy(), np.asarray(b)
            if b.dtype.kind == "f":
                assert abs(float(a) - float(b)) <= FLOAT_REL * (abs(float(b)) + FLOAT_FLOOR), (k, a, b)
            else:
                assert a == b, (k, a, b)
        if bool(tm.valid):
            ranges.append((float(tm.range), bool(tm.failure), int(tm.responder_id)))
    if name == "silence":
        assert not ranges
    else:
        assert 4 <= len(ranges) <= 9 and all(r[2] == 101 for r in ranges)
        assert all(f for _, f, _ in ranges) == (name == "failures")
        if name == "noise":
            assert all(abs(r - 5.0) < 0.5 for r, _, _ in ranges)
        if name == "outliers":
            assert max(abs(r) for r, _, _ in ranges) < 6.0


@pytest.mark.parametrize("failure", [True, False])
def test_logic_step_range_matches_jax(failure):
    """tests/test_uwb.py:71-107's onboard consumption: a range reported
    failed resets the no-UWB timer and advances the target but never reaches
    the EKF; a good one is taken by the range update (a filter that has its
    first IMU sample)."""
    jp = J.with_uwb_anchors(J.make_params(noise_scale=0.0), ANCHOR_IDS, ANCHOR_POS)
    lp = jp.logic
    ls = jlogic.init_state(lp)._replace(us_since_uwb=jnp.int32(10 ** 6))
    inputs = jlogic.null_inputs()._replace(
        acc=jnp.array([0.0, 0.0, 9.81], jnp.float32), batt_voltage=lp.batt_critical * 1.2,
        uwb_new=jnp.bool_(True), uwb_range=jnp.float32(4.2),
        uwb_responder_id=jnp.int32(102), uwb_failure=jnp.bool_(failure))
    step = jax.jit(jlogic.logic_step)
    ls1, _ = step(lp, ls, inputs)  # phase A: the first IMU sample
    ref, _ = step(lp, ls1, inputs)
    tp = convert.env_params_from_numpy(_np(jp), "cpu").logic
    tin = tlogic.LogicInputs(**{f: _t(np.asarray(getattr(inputs, f))) for f in inputs._fields})
    got = convert.from_numpy(tlogic.LogicState, _np(ls), "cpu")
    for _ in range(2):
        got, _ = tlogic.logic_step(tp, got, tin)
    compare_state(got, _np(ref))
    assert int(got.us_since_uwb) == 0 and int(got.next_target_idx) == 2
    assert bool(got.kf.uwb_init) == (not failure)
    assert int(got.uwb_meas_count) == (0 if failure else 2)


# ---------------------------------------------------------------------------
# the onboard-UWB configuration (tests/test_uwb.py:48-68) through sim/env
# ---------------------------------------------------------------------------

N_FLIGHT = 150  # ticks of the onboard-UWB flight held against JAX
N_OPEN = 20  # its ticks before the first position command reaches the vehicle
# After tick 20 (a 100 Hz command through the 30 ms radio delay) the
# onboard position loop flies on the EKF's full phase; the state is held to
# the tick criteria all the same. Measured at 150 ticks: discrete leaves
# equal, the worst float leaf (the onboard covariance) at 0.60 of its bound,
# positions within 1.3e-6 m.


@functools.lru_cache(maxsize=None)
def _jax_uwb_flight(n):
    """(params, start, final state, trajectory) of the JAX package's
    onboard-UWB flight over n ticks (numpy leaves but the params')."""
    jp = J.with_uwb_anchors(J.make_params(), ANCHOR_IDS, ANCHOR_POS, noise_std=0.05,
                            comm_period=0.01)
    s0 = J.init_state(jp, jax.random.PRNGKey(3), pos=(0.5, -0.5, 0.0))
    final, traj = jax.jit(lambda s: J.rollout(jp, s, J.hover_command(SETPOINT), n, False,
                                              "position"))(s0)
    return jp, s0, _np(final), _np(traj)


def _port_inputs(jp, s0, n):
    noise, draws = _env_draws(s0, n)
    return (convert.env_params_from_numpy(_np(jp), "cpu"), convert.env_state_from_numpy(_np(s0), "cpu"),
            T.hover_command(SETPOINT, device="cpu"), noise, draws)


def test_onboard_uwb_flight_matches_jax():
    jp, s0, ref, ref_traj = _jax_uwb_flight(N_FLIGHT)
    p, s, cmd, noise, draws = _port_inputs(jp, s0, N_FLIGHT)
    got, traj = T.rollout(p, s, cmd, N_FLIGHT, False, "position", noise=noise, uwb_draws=draws)
    for name in ("flight_state", "panic_reason", "warnings"):  # every tick
        np.testing.assert_array_equal(getattr(traj, name).numpy(), getattr(ref_traj, name))
    for name in ("pos", "vel", "att", "angvel", "motor_speeds"):  # the open loop's ticks
        a, b = getattr(traj, name).numpy()[:N_OPEN], getattr(ref_traj, name)[:N_OPEN]
        assert (np.abs(a - b) <= FLOAT_REL * (np.abs(b) + FLOAT_FLOOR)).all(), name
    compare_state(got, ref)
    assert np.abs(traj.pos.numpy() - ref_traj.pos).max() < 1e-4
    # the configuration did what it names: ranges taken, the EKF past its
    # complementary phase, the vehicle flying on its own position loop
    assert int(got.logic.uwb_meas_count) > 15 and bool(got.logic.kf.uwb_init)
    assert int(got.logic.fs) == tlogic.FS_FULLY_AUTONOMOUS


def test_physics_tick_with_an_override_matches_jax():
    """A range from a network stepped outside (`uwb_override`) in place of
    the params' own network, from the onboard-UWB flight's final state: the
    logic takes it, and the network's state is left as it was."""
    jp, _, s, _ = _jax_uwb_flight(N_FLIGHT)
    s = jax.tree_util.tree_map(jnp.asarray, s)
    override = (jnp.bool_(True), jnp.float32(3.9), jnp.int32(103), jnp.bool_(False))
    half = jax.jit(lambda s: J.physics_tick(s, jp, jnp.zeros(3), jnp.zeros(3), False,
                                            uwb_override=override))(s)
    tp = convert.env_params_from_numpy(_np(jp), "cpu")
    ts = convert.env_state_from_numpy(_np(s), "cpu")
    got = T.physics_tick(ts, tp, torch.zeros(3), torch.zeros(3), False,
                         uwb_override=tuple(_t(np.asarray(x)) for x in override),
                         noise=_env_draws(s, 1)[0][0])
    compare_state(got["logic"], _np(half["logic"]))
    compare_state(got["plant"], _np(half["plant"]))
    compare_state(got["uwb"], _np(half["uwb"]))
    assert int(got["logic"].uwb_meas_count) == int(ts.logic.uwb_meas_count) + 1


def test_rollout_fast_and_sampled_with_anchors():
    """rollout_fast equals rollout with anchors; rollout_sampled (the true
    state and rates commands, as in JAX) keeps every 8th tick and matches
    the JAX package's."""
    jp = J.with_uwb_anchors(J.make_params(), ANCHOR_IDS, ANCHOR_POS, noise_std=0.05)
    s0 = J.init_state(jp, jax.random.PRNGKey(5), pos=(0.5, -0.5, 0.0))
    cmd = J.hover_command(SETPOINT)
    ref, ref_traj = jax.jit(lambda s: J.rollout_sampled(jp, s, cmd, 43, 8))(s0)
    p, s, _, noise, draws = _port_inputs(jp, s0, 40)
    tcmd = convert.command_from_numpy(_np(cmd), "cpu")
    got, traj = T.rollout_sampled(p, s, tcmd, 43, 8, noise=noise, uwb_draws=draws)
    assert traj.pos.shape == (5, 3) and int(got.step) == 40
    compare_state(got, _np(ref))
    np.testing.assert_array_equal(traj.flight_state.numpy(), np.asarray(ref_traj.flight_state))
    full, _ = T.rollout(p, s, tcmd, 40, noise=noise, uwb_draws=draws)
    fast, _ = T.rollout_fast(p, s, tcmd, 40, noise=noise, uwb_draws=draws)
    for (path, a), (_, b) in zip(convert.leaves(fast), convert.leaves(full)):
        assert torch.equal(a, b), path
    assert int(got.logic.uwb_meas_count) > 0


def test_anchors_and_draws_are_checked():
    p = T.make_params(device="cpu")
    pu = T.with_uwb_anchors(p, ANCHOR_IDS, ANCHOR_POS)
    cmd = T.hover_command(device="cpu")
    noise = torch.zeros(4, 2, 3)
    with pytest.raises(ValueError, match="draws"):
        T.rollout(pu, T.init_state(pu), cmd, 4, noise=noise)
    with pytest.raises(ValueError, match="no UWB network"):
        T.rollout(p, T.init_state(p), cmd, 4, noise=noise, uwb_draws=torch.zeros(4, 4))
    with pytest.raises(ValueError, match="UWB"):
        T.rollout(pu, T.init_state(p), cmd, 4, noise=noise, uwb_draws=torch.zeros(4, 4))
    out, traj = T.rollout(pu, T.init_state(pu), cmd, 4, gen=torch.Generator().manual_seed(0))
    assert traj.pos.shape == (4, 3) and out.uwb is not None
    # the radio table: the vehicle, then the anchors; the target table
    assert pu.uwb.radio_ids.tolist() == [1] + ANCHOR_IDS and int(pu.logic.num_targets) == 4
