"""sim/mission, offboard/safetynet, sim/aruco and sim/test_trajectories in
the port against the JAX package, on the CPU.

mission: tests/test_mission.py's four drives (50 Hz ticks on a synthetic
pose) through both packages, every state leaf and the command at every
tick. Tolerances: discrete leaves (stage, timers, waypoint index, flags)
and the message (type, flags, field codes) equal; float leaves within the
tick criteria of tests/_torch_parity.py. safetynet: test_estimator_loop's
cases, equal. aruco: 250 ticks with the JAX package's noise draws, within
the tick criteria. test_trajectories: every id at 50 times, within 4 ulp
of JAX's values (sin and cos are correctly rounded here, within an ulp
there).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import compare_state
from agrifly_tpu.models import constants as jconst
from agrifly_tpu.offboard import controller as jctrl
from agrifly_tpu.offboard import safetynet as jsafety
from agrifly_tpu.ops import rotation as jrot
from agrifly_tpu.sim import aruco as jaruco
from agrifly_tpu.sim import mission as jmission
from agrifly_tpu.sim import test_trajectories as jtt
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.io import radio as tradio
from agrifly_tpu_torch.models import constants as tconst
from agrifly_tpu_torch.offboard import controller as tctrl
from agrifly_tpu_torch.offboard import safetynet as tsafety
from agrifly_tpu_torch.ops import rotation as trot
from agrifly_tpu_torch.sim import aruco as taruco
from agrifly_tpu_torch.sim import mission as tmission
from agrifly_tpu_torch.sim import orchard_env
from agrifly_tpu_torch.sim import test_trajectories as ttt


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _jax_step(should_start, should_stop):
    """The JAX mission step, compiled once per (should_start, should_stop)."""
    return jax.jit(lambda *a: jmission.step(*a, should_start=should_start,
                                            should_stop=should_stop))


def _setup():
    """tests/test_mission.py's setup in both packages."""
    wps = ((5.0, 0.0, 2.0), (10.0, 0.0, 2.0))
    jp = jmission.make_params(desired_position=(0.0, 0.0, 2.0), waypoints=wps)
    tp = tmission.make_params(desired_position=(0.0, 0.0, 2.0), waypoints=wps, device="cpu")
    jc = jctrl.make_params(jconst.vehicle_params(jconst.QC_TYPE_CF_MINIQUAD))
    tc = tctrl.make_params(tconst.vehicle_params(tconst.QC_TYPE_CF_MINIQUAD), device="cpu")
    return (jp, jc, jmission.init_state(jp)), (tp, tc, tmission.init_state(tp))


def _drive(j, t, est_pos, seconds, now, **kw):
    """tests/test_mission.py's drive in both packages at once: 50 Hz ticks
    on an ideal pose, each tick's state and command held leaf by leaf."""
    (jp, jc, js), (tp, tc, ts) = j, t
    z3 = jnp.zeros(3, jnp.float32)
    jrefs = (z3, z3, z3, jnp.float32(9.81), z3)
    tz3 = torch.zeros(3)
    trefs = (tz3, tz3, tz3, torch.tensor(9.81), tz3)
    flags = {k: kw.get(k, d) for k, d in (("tracking_ready", False), ("is_safe", True),
                                          ("low_battery", False))}
    jstep = _jax_step(kw.get("should_start", True), kw.get("should_stop", False))
    cmds = []
    for _ in range(int(seconds * 50)):
        now += 20000
        js, jcmd = jstep(jp, jc, js, jnp.int32(now), jnp.asarray(est_pos, jnp.float32), z3,
                         jrot.identity(), jnp.bool_(flags["tracking_ready"]), jrefs,
                         jnp.bool_(flags["is_safe"]), jnp.bool_(flags["low_battery"]))
        ts, tcmd = tmission.step(tp, tc, ts, torch.tensor(now, dtype=torch.int32),
                                 _t(est_pos), tz3, trot.identity(),
                                 torch.tensor(flags["tracking_ready"]), trefs,
                                 torch.tensor(flags["is_safe"]), torch.tensor(flags["low_battery"]),
                                 should_start=kw.get("should_start", True),
                                 should_stop=kw.get("should_stop", False))
        compare_state(ts, _np(js))
        for name, a, b in zip(tcmd._fields, tcmd, _np(jcmd)):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        cmds.append(tcmd)
    return ((jp, jc, js), (tp, tc, ts)), now, cmds


def test_mission_progression_to_flight_matches_jax():
    j, t = _setup()
    (j, t), now, _ = _drive(j, t, (0.0, 0.0, 0.0), 0.1, 0)
    (j, t), now, _ = _drive(j, t, (0.0, 0.0, 0.5), 1.0, now)
    assert int(t[2].stage) == tmission.STAGE_TAKEOFF
    (j, t), now, _ = _drive(j, t, (0.0, 0.0, 2.0), 2.5, now)
    assert int(t[2].stage) == tmission.STAGE_HOVER
    (j, t), now, _ = _drive(j, t, (0.0, 0.0, 2.0), 3.5, now)
    assert int(t[2].stage) == tmission.STAGE_FLIGHT and bool(t[2].start_plan)


def test_mission_waypoints_landing_complete_matches_jax():
    j, t = _setup()
    (j, t), now, _ = _drive(j, t, (0.0, 0.0, 2.0), 7.0, 0)
    (j, t), now, _ = _drive(j, t, (4.8, 0.0, 2.0), 0.1, now)
    assert int(t[2].waypoint_idx) == 1
    (j, t), now, _ = _drive(j, t, (9.8, 0.0, 2.0), 0.1, now)
    assert int(t[2].stage) == tmission.STAGE_LANDING
    (j, t), now, cmds = _drive(j, t, (9.8, 0.0, 1.0), 7.0, now)
    assert int(t[2].stage) == tmission.STAGE_COMPLETE and bool(t[2].ready_to_exit)
    assert int(cmds[-1].msg_type) == tradio.TYPE_IDLE_CMD


def test_mission_emergency_on_unsafe_matches_jax():
    j, t = _setup()
    (j, t), now, _ = _drive(j, t, (0.0, 0.0, 2.0), 4.0, 0)
    (j, t), now, cmds = _drive(j, t, (0.0, 0.0, 2.0), 0.1, now, is_safe=False)
    assert int(t[2].stage) == tmission.STAGE_EMERGENCY
    assert int(cmds[-1].msg_type) == tradio.TYPE_EMERGENCY_KILL


def test_mission_low_battery_lands_matches_jax():
    j, t = _setup()
    (j, t), now, _ = _drive(j, t, (0.0, 0.0, 2.0), 7.0, 0)
    (j, t), now, _ = _drive(j, t, (0.0, 0.0, 2.0), 0.1, now, low_battery=True)
    assert int(t[2].stage) == tmission.STAGE_LANDING


def test_mission_params_convert_and_constants_are_shared():
    """convert's module trees, STAGE_NAMES, and orchard_env's constants are
    mission's own."""
    jp = jmission.make_params(waypoints=((1.0, 2.0, 3.0),))
    tp = convert.module_from_numpy("mission_params", _np(jp), "cpu")
    compare_state(tp, _np(jp))
    compare_state(convert.module_from_numpy("mission_state", _np(jmission.init_state(jp)), "cpu"),
                  _np(jmission.init_state(jp)))
    compare_state(tmission.init_state(tp), _np(jmission.init_state(jp)))
    assert tmission.STAGE_NAMES == jmission.STAGE_NAMES
    for name in ("MAX_WAYPOINTS", "WAYPOINT_RADIUS", "LANDING_SPEED", "LANDING_BLEND_TIME"):
        assert getattr(orchard_env, name) is getattr(tmission, name) == getattr(jmission, name)
    for name in ("SPOOL_UP_TIME", "SPOOL_UP_THRUST_FRAC", "TAKEOFF_TIME", "HOVER_TIME",
                 "COMPLETE_EXIT_TIME"):
        assert getattr(tmission, name) == getattr(jmission, name)


def test_load_trajectory_file_matches_jax(tmp_path):
    good = tmp_path / "trajectory.txt"
    good.write_text("# waypoints\n1.0,2.0,3.0\n\n4,5,6,7  # a fourth column is ignored\n")
    assert tmission.load_trajectory_file(good) == jmission.load_trajectory_file(good) == [
        (1.0, 2.0, 3.0), (4.0, 5.0, 6.0)]
    cases = {"short.txt": "1.0,2.0\n", "empty.txt": "# nothing\n\n",
             "many.txt": "0,0,1\n" * (tmission.MAX_WAYPOINTS + 1), "bad.txt": "1,a,3\n"}
    for name, text in cases.items():
        path = tmp_path / name
        path.write_text(text)
        with pytest.raises(ValueError) as want:
            jmission.load_trajectory_file(path)
        with pytest.raises(ValueError) as got:
            tmission.load_trajectory_file(path)
        assert str(got.value) == str(want.value), name


def test_kill_and_idle_commands_match_jax():
    from agrifly_tpu.io import radio as jradio

    for jfn, tfn in ((jradio.make_kill_command, tradio.make_kill_command),
                     (jradio.make_idle_command, tradio.make_idle_command)):
        for flags in (0, 3):
            for a, b in zip(tfn(flags=flags), jfn(flags)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _safety_cases():
    """test_estimator_loop.py::test_safetynet's cases: (pos, att, us)."""
    flip = np.asarray(jrot.from_axis_angle(jnp.array([1.0, 0.0, 0.0]), jnp.pi))
    ident = np.asarray(jrot.identity())
    return [((0.0, 0.0, 1.0), ident, 1000), ((10.0, 0.0, 1.0), ident, 1000),
            ((0.0, 0.0, 1.0), ident, 10 ** 6), ((0.0, 0.0, 0.5), flip, 1000),
            ((0.0, 0.0, 1.5), flip, 1000), ((1.9, 0.0, 1.0), ident, 500_001)]


@pytest.mark.parametrize("which", ["lab", "wide"])
def test_safetynet_matches_jax(which):
    jp = jsafety.lab_params() if which == "lab" else jsafety.wide_params(5.0)
    tp = (tsafety.lab_params(device="cpu") if which == "lab"
          else tsafety.wide_params(5.0, device="cpu"))
    compare_state(tp, _np(jp))
    compare_state(convert.module_from_numpy("safetynet_params", _np(jp), "cpu"), _np(jp))
    js, ts = jsafety.init_state(), tsafety.init_state()
    compare_state(ts, _np(js))
    seen = []
    for pos, att, us in _safety_cases():
        jn = jsafety.update(jp, js, jnp.asarray(pos, jnp.float32), jnp.asarray(att),
                            jnp.int32(us))
        tn = tsafety.update(tp, ts, _t(pos), _t(att), torch.tensor(us, dtype=torch.int32))
        compare_state(tn, _np(jn))
        assert bool(tn.is_safe) == bool(jn.is_safe)
        seen.append(bool(tn.is_safe))
    if which == "lab":  # the cases did what they name
        assert seen == [True, False, False, False, True, False]


def test_aruco_matches_jax():
    """250 ticks of 2 ms with position noise drawn from JAX keys."""
    jp = jaruco.make_params(period=0.1, noise_std_pos=0.05)
    tp = taruco.make_params(period=0.1, noise_std_pos=0.05, device="cpu")
    compare_state(tp, _np(jp))
    keys = jax.random.split(jax.random.PRNGKey(4), 250)
    noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,), jnp.float32))(keys))
    rng = np.random.default_rng(0)
    pos = rng.uniform(-3, 3, (250, 3)).astype(np.float32)
    att = rng.standard_normal((250, 4)).astype(np.float32)
    att /= np.linalg.norm(att, axis=1, keepdims=True)
    jstep = jax.jit(jaruco.step)
    js, ts = jaruco.init_state(), taruco.init_state()
    fires = 0
    for k in range(250):
        js = jstep(jp, js, pos[k], att[k], jnp.int32(2000), keys[k])
        ts = taruco.step(tp, ts, _t(pos[k]), _t(att[k]), torch.tensor(2000, dtype=torch.int32),
                         torch.from_numpy(noise[k].copy()))
        compare_state(ts, _np(js))
        fires += bool(ts.has_new)
    assert fires == 4  # at 102, 202, 302 and 402 ms (the "> period, then subtract" rule)
    compare_state(convert.module_from_numpy("aruco_state", _np(js), "cpu"), _np(js))
    # without noise the pose passes through exactly
    ts = taruco.step(tp, taruco.init_state(), _t(pos[0]), _t(att[0]), torch.tensor(200000))
    np.testing.assert_array_equal(ts.meas_pos.numpy(), pos[0])


@pytest.mark.parametrize("traj_id", range(6))
def test_test_trajectories_match_jax(traj_id):
    """Each id at 50 times over 0..8 s (the 2 s blend and beyond), within 4
    ulp of the largest term summed into each output: cmd_pos blends the
    setpoint and a position up to 1 m from it, so its ulp is that of |des| +
    1 (one ulp of a sine, which XLA's sin may be off by, survives the
    blend's cancellation at that scale); the other outputs are products, held
    to 4 ulp of their own value. Trajectory 4 keeps the missing 4x
    chain-rule factor on z."""
    des, yaw0 = np.float32([0.3, -0.2, 1.7]), np.float32(0.25)
    jeval = jax.jit(lambda t: jtt.evaluate(traj_id, t, des, yaw0))
    for t in np.linspace(0.0, 8.0, 50, dtype=np.float32):
        want = [np.asarray(x) for x in jeval(t)]
        got = [x.numpy() for x in ttt.evaluate(traj_id, torch.tensor(t), torch.from_numpy(des),
                                               torch.tensor(yaw0))]
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            scale = np.maximum(np.abs(b), np.abs(des) + 1.0 if i == 0 else np.float32(1e-30))
            ulps = np.abs(a - b) / np.spacing(scale.astype(np.float32))
            assert (ulps <= 4).all(), (traj_id, float(t), a, b)
    if traj_id == ttt.TRAJ_CIRCLE_SIN_HEIGHT_YAW:  # vel_z = -r w sin(4 w t), no 4x
        _, vel, _, _ = ttt.evaluate(traj_id, torch.tensor(3.0), torch.from_numpy(des))
        assert abs(float(vel[2]) + 0.25 * np.sin(6.0)) < 1e-6
    with pytest.raises(ValueError):
        ttt.evaluate(6, torch.tensor(0.0), torch.from_numpy(des))


def test_small_module_params_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults build there")
    for fn in (tsafety.lab_params, tsafety.wide_params, taruco.make_params,
               tmission.make_params):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()

