"""`sim/env`'s rollout family in the port against the JAX package, on the CPU.

The same inputs, made with numpy or drawn by the JAX package, go through
both packages. The JAX package draws each tick's IMU noise from the state's
key (`key, sub = split(key)`, then `k1, k2 = split(sub)`, gyro from k1 and
acc from k2); `_torch_parity.jax_tick_draws` rebuilds that chain and the port
gets its draws.
Tolerances:

- up to 60 steps, the tick criteria of tests/_torch_parity.py: discrete
  leaves equal, float leaves within 1e-3 (|ref| + 1e-3), the commanded body
  rates within the command floor;
- beyond that, the JAX package's own terms for rollout_fast
  (tests/test_extra_components.py): discrete outputs equal at every step,
  final position within 0.05 m.

The port's plain rollout runs here (CPU tensors); the kernel it stands for
runs on the card (tests/test_torch_kernels.py, chip_smoke.py). The long
flights (test_hover.py's envelopes, the self-golden) are in
tests/test_torch_env_flights.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (COMMAND_FLOOR, FLOAT_FLOOR, FLOAT_REL,  # noqa: F401 (one thread)
                           NO_FMA_FLAGS, compare_state, jax_tick_draws)
from agrifly_tpu.io import radio as jradio
from agrifly_tpu.models import constants as jconst
from agrifly_tpu.models import logic as jlogic
from agrifly_tpu.models import plant as jplant
from agrifly_tpu.offboard import controller as jctrl
from agrifly_tpu.sim import env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.io import radio as tradio
from agrifly_tpu_torch.models import constants as tconst
from agrifly_tpu_torch.models import plant as tplant
from agrifly_tpu_torch.offboard import controller as tctrl
from agrifly_tpu_torch.sim import cuda_rollout
from agrifly_tpu_torch.sim import env as T

B = 3  # envs of the vmapped rollouts
N = 60  # steps held to the tick criteria
CTRL = ("rates", "position", "idle")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jparams(noise_scale=1.0):
    return J.make_params(noise_scale=noise_scale)


def _tparams(noise_scale=1.0):
    return convert.env_params_from_numpy(_np(_jparams(noise_scale)), "cpu")


def _jcommand():
    """A command that reaches every term: a setpoint off the start, velocity
    and acceleration feed-forward, yaw, wind force and torque."""
    return J.Command(des_pos=jnp.asarray([0.2, -0.1, 1.0], jnp.float32),
                     des_vel=jnp.asarray([0.05, 0.0, -0.02], jnp.float32),
                     des_acc=jnp.asarray([0.1, -0.05, 0.2], jnp.float32),
                     des_yaw=jnp.float32(0.3),
                     ext_force=jnp.asarray([0.01, -0.02, 0.005], jnp.float32),
                     ext_torque=jnp.asarray([2e-5, -1e-5, 3e-5], jnp.float32))


def _compare_traj(got, ref, until=None):
    """Trajectories: discrete outputs equal; floats within the tick
    criterion over the first `until` steps (all where None)."""
    for name in T.StepOutputs._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            a, b = a[..., :until, :], b[..., :until, :]
            ratio = np.abs(a.astype(np.float64) - b) / (FLOAT_REL * (np.abs(b) + FLOAT_FLOOR))
            assert ratio.max(initial=0.0) <= 1.0, (name, ratio.max())


# ---------------------------------------------------------------------------
# faults of the port's modules, each against the JAX package
# ---------------------------------------------------------------------------

def test_make_params_and_hover_command_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="env.make_params"):
        T.make_params()
    with pytest.raises(RuntimeError, match="env.hover_command"):
        T.hover_command()
    p = T.make_params(device="cpu")
    assert T.init_state(p).step.device.type == "cpu"


def test_plant_step_with_external_force_matches_jax():
    rng = np.random.default_rng(0)
    n = 64
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = dict(pos=rng.uniform(-2, 2, (n, 3)), vel=rng.uniform(-1, 1, (n, 3)), att=q,
                 angvel=rng.uniform(-2, 2, (n, 3)), motor_speeds=rng.uniform(1500, 2500, (n, 4)))
    state = {k: np.asarray(v, np.float32) for k, v in state.items()}
    cmds = rng.uniform(1000, 3000, (n, 4)).astype(np.float32)
    force = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    torque = rng.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32)
    v = jconst.vehicle_params(jconst.QC_TYPE_CF_MINIQUAD)
    jp = jplant.make_params(v)
    jstep = jax.jit(jax.vmap(lambda s, c, f, t: jplant.step(jp, s, c, f, t, 1.0 / 500.0)))
    ref, ref_acc = jstep(jplant.PlantState(**state), cmds, force, torque)
    tp = tplant.make_params(tconst.vehicle_params(tconst.QC_TYPE_CF_MINIQUAD), "cpu")
    dt = torch.tensor(1.0 / 500.0)
    tstep = torch.func.vmap(lambda s, c, f, t: tplant.step(tp, s, c, f, t, dt))
    got, got_acc = tstep(tplant.PlantState(**{k: _t(x) for k, x in state.items()}), _t(cmds),
                         _t(force), _t(torque))
    free, _ = tstep(tplant.PlantState(**{k: _t(x) for k, x in state.items()}), _t(cmds),
                    torch.zeros(n, 3), torch.zeros(n, 3))
    for name, a, b in zip(got._fields + ("acc",), tuple(got) + (got_acc,), tuple(ref) + (ref_acc,)):
        b = np.asarray(b, np.float64)
        ratio = np.abs(a.numpy() - b) / (FLOAT_REL * (np.abs(b) + FLOAT_FLOOR))
        assert ratio.max() <= 1.0, (name, ratio.max())
    # the force and the torque move the state (the port used to leave them out)
    assert float((free.vel - got.vel).abs().max()) > 1e-4
    assert float((free.angvel - got.angvel).abs().max()) > 1e-3


def test_offboard_run_with_acceleration_and_yaw_matches_jax():
    rng = np.random.default_rng(1)
    n = 64
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q[:, 1:] *= 0.2
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos, vel, des_pos, des_vel, des_acc = (
        rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(5))
    yaw = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    v = jconst.vehicle_params(jconst.QC_TYPE_CF_MINIQUAD)
    jp = jctrl.make_params(v)
    jrun = jax.jit(jax.vmap(lambda *a: jctrl.run(jp, *a)))
    ref_w, ref_t = jrun(pos, vel, q, des_pos, des_vel, des_acc, yaw)
    tp = tctrl.make_params(tconst.vehicle_params(tconst.QC_TYPE_CF_MINIQUAD), device="cpu")
    trun = torch.func.vmap(lambda *a: tctrl.run(tp, *a))
    args = [_t(x) for x in (pos, vel, q, des_pos, des_vel, des_acc, yaw)]
    got_w, got_t = trun(*args)
    ref_w, ref_t = np.asarray(ref_w, np.float64), np.asarray(ref_t, np.float64)
    assert (np.abs(got_t.numpy() - ref_t) <= FLOAT_REL * (np.abs(ref_t) + FLOAT_FLOOR)).all()
    assert (np.abs(got_w.numpy() - ref_w) <= COMMAND_FLOOR + FLOAT_REL * np.abs(ref_w)).all()
    # yaw and feed-forward move the command (the port used to drop them)
    no_yaw, _ = trun(*args[:5], torch.zeros(n, 3), torch.zeros(n))
    assert float((no_yaw - got_w).abs().max()) > 1.0


def test_position_command_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        vals = [rng.uniform(-40, 40, 3).astype(np.float32) for _ in range(3)]
        jt, jf, jfields = jradio.make_position_command(*vals)
        tt, tf, tfields = tradio.make_position_command(*map(_t, vals))
        assert int(tt) == int(jt) == tradio.TYPE_POSITION_CMD and int(tf) == int(jf) == 0
        np.testing.assert_array_equal(tfields.numpy(), np.asarray(jfields))
        assert int(tfields[9]) == 0


def test_modes_are_checked_and_uwb_params_convert():
    """An unknown estimator or ctrl_mode raises; the JAX package's UWB
    network converts (its key dropped), radio table and target table as
    they are."""
    p = T.make_params(device="cpu")
    s = T.init_state(p)
    cmd = T.hover_command(device="cpu")
    noise = torch.zeros(2, 3)
    for bad in ("kalman", 2, None, [True]):
        with pytest.raises(ValueError, match="use_estimator"):
            T.step(p, s, cmd, bad, noise=noise)
    # the JAX package's spellings: False / "true", True / "mocap", "gpsimu"
    for same, name in ((False, "true"), (True, "mocap")):
        for got, ref in zip(T.step(p, s, cmd, name, noise=noise),
                            T.step(p, s, cmd, same, noise=noise)):
            for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref)):
                assert torch.equal(a, b), (name, path)
        assert cuda_rollout.EST[T._est_mode(same)] == cuda_rollout.EST[name]
    assert [T._est_mode(m) for m in (False, "true", True, "mocap", "gpsimu")] == [
        "true", "true", "mocap", "mocap", "gpsimu"]
    with pytest.raises(ValueError, match="ctrl_mode"):
        T.step(p, s, cmd, "gpsimu", "hover", noise=noise)
    jp = J.with_uwb_anchors(_jparams(), [7, 9], [[1.0, 0, 0], [0, 2.0, 1.0]], noise_std=0.1)
    tp = convert.env_params_from_numpy(_np(jp), "cpu")
    ref = T.with_uwb_anchors(T.make_params(device="cpu"), [7, 9], [[1.0, 0, 0], [0, 2.0, 1.0]],
                             noise_std=0.1)
    for (path, a), (_, b) in zip(convert.leaves(tp), convert.leaves(ref)):
        assert torch.equal(a, b), path
    ts = convert.env_state_from_numpy(_np(J.init_state(jp, jax.random.PRNGKey(0))), "cpu")
    assert ts.uwb is not None and not hasattr(ts.uwb, "key")


# ---------------------------------------------------------------------------
# step and the rollouts against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fleet_run(use_estimator):
    """B envs from PRNGKey(10 + b) spawned apart, N steps of JAX rollout
    under vmap with _jcommand. Returns (start, final, traj) as numpy trees."""
    return _jax_runs(use_estimator)[0]


@functools.lru_cache(maxsize=None)
def _jax_runs(use_estimator):
    """The fleet run and, for the default modes (use_estimator=False),
    env 0's rollout_sampled over 43 steps keeping every 8th (one program)."""
    jp = _jparams()
    keys = jax.random.split(jax.random.PRNGKey(10), B)
    spawns = jnp.asarray([[0.0, 0.0, 0.0], [1.0, -0.5, 0.0], [-0.5, 2.0, 0.0]], jnp.float32)
    s0 = jax.vmap(lambda k, p: J.init_state(jp, k, pos=p))(keys, spawns)

    def runs(s0):
        fleet = jax.vmap(lambda s: J.rollout(jp, s, _jcommand(), N, use_estimator))(s0)
        if use_estimator:
            return fleet, None
        first = jax.tree_util.tree_map(lambda x: x[0], s0)
        return fleet, J.rollout_sampled(jp, first, _jcommand(), 43, 8)

    (final, traj), sampled = jax.jit(runs)(s0)
    return (_np(s0), _np(final), _np(traj)), (None if sampled is None else _np(sampled))


@pytest.mark.parametrize("use_estimator", [False, True, "gpsimu"])
def test_rollout_of_a_fleet_matches_jax(use_estimator):
    """N steps of three envs (vmapped in both packages), every term of the
    command on; the rebuilt key chain ends where the JAX rollout's does.
    With the GPS-IMU estimator the accelerometer filter's leaves are held to
    the closed loop's floor (tests/_torch_parity.py)."""
    s0, ref, ref_traj = _jax_fleet_run(use_estimator)
    noise, last_keys = jax_tick_draws(s0.key, N)
    np.testing.assert_array_equal(last_keys, ref.key)
    got, traj = T.rollout(_tparams(), convert.env_state_from_numpy(s0, "cpu"),
                          convert.command_from_numpy(_np(_jcommand()), "cpu"), N,
                          use_estimator, noise=_t(noise))
    compare_state(got, ref, closed_loop=use_estimator == "gpsimu")
    _compare_traj(traj, ref_traj)
    assert (ref_traj.flight_state[:, -1] == jlogic.FS_EXTERNAL_RATES_CONTROL).all()


# the witness's JAX side: (noise, start, final, traj) of the GPS-IMU fleet run
_NO_FMA_RUN = """
import pickle
import sys
sys.path[:0] = sys.argv[2:]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import test_torch_env as te
run = te._jax_fleet_run("gpsimu")
with open(sys.argv[1], "wb") as f:
    pickle.dump((te.jax_tick_draws(run[0].key, te.N)[0],) + run, f)
"""


def test_gpsimu_fleet_without_fma_matches_jax(tmp_path):
    """The witness for the closed loop's floor: the GPS-IMU fleet run of
    test_rollout_of_a_fleet_matches_jax, its JAX side (the draws too)
    compiled in a process of its own without FMA instructions, so that
    XLA:CPU contracts no multiply-add, as the port rounds; then every leaf
    meets the tick criteria."""
    import os
    import pathlib
    import pickle
    import subprocess
    import sys

    out = tmp_path / "run.pkl"
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA_FLAGS}".strip())
    run = subprocess.Popen([sys.executable, "-c", _NO_FMA_RUN, str(out), str(here),
                            str(here.parent)], env=env)
    try:
        p, cmd = _tparams(), convert.command_from_numpy(_np(_jcommand()), "cpu")  # meanwhile
        assert run.wait(timeout=120) == 0
    finally:
        run.kill()
    noise, s0, ref, ref_traj = pickle.loads(out.read_bytes())
    got, traj = T.rollout(p, convert.env_state_from_numpy(s0, "cpu"), cmd, N, "gpsimu",
                          noise=_t(noise))
    compare_state(got, ref)
    _compare_traj(traj, ref_traj)


@functools.lru_cache(maxsize=None)
def _jax_ctrl_modes(use_estimator):
    """From env 0 of the fleet run: 10 steps of the JAX package's `step` in
    each ctrl_mode. One program: the tick's physics, then the offboard
    block of the ctrl_mode the traced index picks (as `step` composes
    them)."""
    _, warm, _ = _jax_fleet_run(use_estimator)
    s = jax.tree_util.tree_map(lambda x: x[0], warm)
    jp, cmd = _jparams(), _jcommand()

    def tick(s, i):
        half = J.physics_tick(s, jp, cmd.ext_force, cmd.ext_torque, use_estimator)
        return jax.lax.switch(i, [functools.partial(J._offboard_and_finish, jp, s, cmd,
                                                    use_estimator=use_estimator, ctrl_mode=c)
                                  for c in CTRL], half)

    run = jax.jit(lambda s, i: jax.lax.scan(lambda c, _: tick(c, i), s, None, length=10))
    return s, [_np(run(s, i)) for i in range(len(CTRL))]


@pytest.mark.parametrize("ctrl_mode", CTRL)
@pytest.mark.parametrize("use_estimator", [False, True, "gpsimu"])
def test_step_matches_jax(use_estimator, ctrl_mode):
    """`step` ten times from a warm state (step 60) in each (estimator,
    ctrl_mode) pair against ten steps of the JAX package's step."""
    s, runs = _jax_ctrl_modes(use_estimator)
    ref, ref_traj = runs[CTRL.index(ctrl_mode)]
    noise, _ = jax_tick_draws(s.key, 10)
    p = _tparams()
    cmd = convert.command_from_numpy(_np(_jcommand()), "cpu")
    state = convert.env_state_from_numpy(s, "cpu")
    outs = []
    for k in range(10):
        state, out = T.step(p, state, cmd, use_estimator, ctrl_mode, noise=_t(noise[k]))
        outs.append(out)
    compare_state(state, ref)
    _compare_traj(T.StepOutputs(*(torch.stack(x) for x in zip(*outs))), ref_traj)
    last = (int(state.ring.head) + int(state.ring.count) - 1) % 32  # the newest message
    assert int(state.ring.types[last]) == {
        "rates": tradio.TYPE_EXTERNAL_RATES_CMD, "position": tradio.TYPE_POSITION_CMD,
        "idle": tradio.TYPE_IDLE_CMD}[ctrl_mode]


def test_rollout_sampled_matches_jax():
    """env 0 of the fleet: 43 steps keeping every 8th (5 samples, 40 ticks)."""
    (s0, _, _), (ref, ref_traj) = _jax_runs(False)
    first = jax.tree_util.tree_map(lambda x: x[0], s0)
    noise, _ = jax_tick_draws(first.key, 40)
    got, traj = T.rollout_sampled(_tparams(), convert.env_state_from_numpy(first, "cpu"),
                                  convert.command_from_numpy(_np(_jcommand()), "cpu"), 43, 8,
                                  noise=_t(noise))
    assert traj.pos.shape == (5, 3) and int(got.step) == 40
    compare_state(got, ref)
    _compare_traj(traj, ref_traj)


# ---------------------------------------------------------------------------
# rollout_fast against the port's own rollout
# ---------------------------------------------------------------------------

def _fleet(p, n=2):
    return T.init_state_fleet(p, torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.2]][:n]))


def _same(a, b):
    for (path, x), (_, y) in zip(convert.leaves(a), convert.leaves(b)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("use_estimator", [False, True, "gpsimu"])
def test_rollout_fast_equals_rollout_and_resumes_mid_flight(use_estimator):
    """The cadence-specialized plain rollout skips the silent ticks' work
    and gives `rollout`'s results: from the start, and resumed mid-flight
    (entry_phase) at an off-block step."""
    p = _tparams()
    cmd = T.hover_command((0.0, 0.0, 1.0), device="cpu")
    noise = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 24, 2, 3))
                             .astype(np.float32))
    s0 = _fleet(p)
    # step_static with the flags of step 0 is step
    one, one_out = T.step(p, s0, cmd, use_estimator, noise=noise[:, 0])
    stat, stat_out = T.step_static(p, s0, cmd, use_estimator, "rates",
                                   *T.fast_flags(p, s0, 1)[0], noise=noise[:, 0])
    _same(stat, one)
    _same(stat_out, one_out)
    ref, ref_traj = T.rollout(p, s0, cmd, 24, use_estimator, noise=noise)
    fast, fast_traj = T.rollout_fast(p, s0, cmd, 24, use_estimator, noise=noise)
    _same(fast, ref)
    _same(fast_traj, ref_traj)
    # resume after 13 ticks: the accumulators' phase, as the caller asserts it
    mid, _ = T.rollout(p, s0, cmd, 13, use_estimator, noise=noise[:, :13])
    phase = (int(mid.mocap_acc_us[0]), int(mid.offboard_acc_us[0]))
    flags = T.fast_flags(p, mid, 11, entry_phase=phase)
    macc, oacc = phase
    for m, o in flags:  # the flags are the accumulators' own decisions
        macc, oacc = macc + 2000, oacc + 2000
        assert o == (oacc > 10000)
        oacc -= 10000 * o
        if use_estimator is True:  # without mocap the mocap accumulator never wraps
            assert m == (macc > 5000)
            macc -= 5000 * m
    got, got_traj = T.rollout_fast(p, mid, cmd, 11, use_estimator, entry_phase=phase,
                                   noise=noise[:, 13:])
    _same(got, ref)
    np.testing.assert_array_equal(got_traj.pos.numpy(), ref_traj.pos[:, 13:].numpy())


def test_rollout_fast_falls_back_where_its_cadence_is_unknown():
    p = _tparams()
    s = _fleet(p)
    assert T.fast_flags(p, s, 10) is not None
    moved = s._replace(step=torch.tensor([0, 3], dtype=torch.int32))
    assert T.fast_flags(p, moved, 10) is None  # a nonzero step in any env
    assert T.fast_flags(p._replace(mocap_period_us=torch.tensor(4000, dtype=torch.int32)),
                        s, 10) is None
    # J's own pattern helper and the port's agree
    assert J._cadence_patterns(12, macc0=3000, oacc0=6000) == T._cadence_patterns(
        12, macc0=3000, oacc0=6000)


def test_rollout_checks_its_inputs():
    p = _tparams()
    s = _fleet(p)
    cmd = T.hover_command(device="cpu")
    with pytest.raises(ValueError, match="noise"):
        T.rollout(p, s, cmd, 5, noise=torch.zeros(2, 4, 2, 3))
    with pytest.raises(ValueError, match="gen"):
        T.rollout(p, s, cmd, 5)
    bad = s._replace(step=s.step.to(torch.int64))
    with pytest.raises(ValueError, match="step"):
        T.rollout(p, bad, cmd, 5, noise=torch.zeros(2, 5, 2, 3))
    with pytest.raises(ValueError, match="des_pos"):
        T.rollout(p, s, cmd._replace(des_pos=torch.zeros(3, 3)), 5,
                  noise=torch.zeros(2, 5, 2, 3))
    before = cuda_rollout.rollout.launches
    out, traj = T.rollout(p, s, cmd, 5, gen=torch.Generator().manual_seed(0))
    assert cuda_rollout.rollout.launches == before  # CPU tensors: the plain version
    assert traj.pos.shape == (2, 5, 3) and torch.equal(out.step, torch.tensor([5, 5],
                                                                              dtype=torch.int32))


# ---------------------------------------------------------------------------
# the kernel's wrapper: its cached leaf check and the shared command
# ---------------------------------------------------------------------------

def _rotate_layout(t):
    """The same shape and values, not contiguous any more (in place)."""
    strides = list(reversed(torch.empty(tuple(reversed(t.shape))).stride()))
    t.as_strided_(t.shape, strides)


# each changes a (3, 3) leaf after a first accepted call: in place, or (a
# tensor cannot move to another device in place) in a copy of its tree
_LEAF_CHANGES = {
    "dtype": lambda t: setattr(t, "data", t.data.to(torch.float64)),
    "shape": lambda t: t.resize_(t.numel() + 1),
    "layout": _rotate_layout,
    "device": lambda t: t.to("meta"),
}


@pytest.mark.parametrize("change", sorted(_LEAF_CHANGES))
@pytest.mark.parametrize("tree", ["state", "params"])
def test_rollout_cached_check_refuses_a_leaf_changed_after_a_call(tree, change, monkeypatch):
    """A call with the same trees as the last accepted one skips the full
    leaf check; a leaf whose dtype, shape, layout or device changed since
    then is still refused, and nothing runs."""
    p = T.make_params(device="cpu")
    s = T.init_state_fleet(p, torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.2], [1.0, 0.0, 0.1]]))
    cmd = T.hover_command(device="cpu")
    noise = torch.zeros(3, 1, 2, 3)
    checks = []
    real_check = cuda_rollout.cuda_build.check_leaves
    monkeypatch.setattr(cuda_rollout.cuda_build, "check_leaves",
                        lambda specs, *a: checks.append(a[2]) or real_check(specs, *a))
    cuda_rollout.rollout(p, s, cmd, noise)
    cuda_rollout.rollout(p, s, cmd, noise)
    assert checks == ["state", "params"]  # the second call: the cached signatures
    moved = _LEAF_CHANGES[change](s.plant.vel if tree == "state" else p.plant.inertia)
    if moved is not None and tree == "state":
        s = s._replace(plant=s.plant._replace(vel=moved))
    elif moved is not None:
        p = p._replace(plant=p.plant._replace(inertia=moved))
    before = cuda_rollout.rollout.launches
    with pytest.raises(ValueError, match="plant.vel" if tree == "state" else "plant.inertia"):
        cuda_rollout.rollout(p, s, cmd, noise)
    assert checks[-1] == tree and cuda_rollout.rollout.launches == before


def test_shared_command_equals_its_per_env_expansion():
    """A command leaf the fleet shares and its per-env expansion give the
    same rollout; the kernel reads the shared leaf in place through a stride
    of 0 and the expanded one row by row."""
    p = T.make_params(device="cpu")
    s = _fleet(p, 2)
    cmd = T.Command(des_pos=torch.tensor([[0.2, -0.1, 1.0], [0.6, 0.4, 1.2]]),
                    des_vel=torch.tensor([0.05, 0.0, -0.02]),
                    des_acc=torch.tensor([0.1, -0.05, 0.2]), des_yaw=torch.tensor(0.3),
                    ext_force=torch.tensor([0.01, -0.02, 0.005]),
                    ext_torque=torch.tensor([2e-5, -1e-5, 3e-5]))
    expanded = T.Command(*(t if t.dim() > base else t.expand((2,) + t.shape).contiguous()
                           for t, base in zip(cmd, T._BASE_DIMS)))
    noise = torch.randn(2, 6, 2, 3, generator=torch.Generator().manual_seed(4))
    got, traj = T.rollout(p, s, cmd, 6, noise=noise)
    ref, ref_traj = T.rollout(p, s, expanded, 6, noise=noise)
    _same(got, ref)
    _same(traj, ref_traj)
    leaves, strides = cuda_rollout._command(cmd, 2, torch.device("cpu"))
    assert strides == [3, 0, 0, 0, 0, 0]
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(leaves[1:], cmd[1:]))
    assert cuda_rollout._command(expanded, 2, torch.device("cpu"))[1] == [3, 3, 3, 1, 3, 3]


def test_rollout_takes_inference_tensors_and_checks_them_every_call(monkeypatch):
    """The plain rollout's outputs are inference tensors, which keep no
    version counter: a state made of them is taken, and checked in full at
    every call, since an in-place change to it could not be seen."""
    p = T.make_params(device="cpu")
    cmd = T.hover_command(device="cpu")
    noise = torch.zeros(2, 1, 2, 3)
    s, _ = cuda_rollout.rollout(p, _fleet(p), cmd, noise)
    assert s.step.is_inference()
    checks = []
    real_check = cuda_rollout.cuda_build.check_leaves
    monkeypatch.setattr(cuda_rollout.cuda_build, "check_leaves",
                        lambda specs, *a: checks.append(a[2]) or real_check(specs, *a))
    for _ in range(2):
        out, _ = cuda_rollout.rollout(p, s, cmd, noise)
    assert checks.count("state") == 2 and torch.equal(out.step, torch.tensor([2, 2],
                                                                             dtype=torch.int32))
