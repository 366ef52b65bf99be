"""The port against the compiled reference C++ goldens, the quick tiers.

The goldens `tests/golden/cpp_{hover_est,hover_truth,step_est}_v1.npz` are
traces of the reference C++ stack (tests/test_golden_cpp.py says how they
were made), loaded through `tests/_golden_cpp.load`. Its four quick tiers
run here on the port's primitives, with the same bounds:

  plant      the port's plant stepped from the C++'s f64 state with its
             exact f32 motor commands, one tick, all three configs;
  logic      the port's onboard logic fed the C++'s exact IMU readings and
             radio packets for 600 ticks (`_run_logic_replay`, the port's
             copy of `_golden_cpp.run_logic_replay`), its stages against the
             logicdbg dump and its telemetry wire codes (io/telemetry)
             against the C++'s packets;
  estimator  the port's MocapStateEstimator fed the C++'s exact truth poses
             and commands for 600 ticks, its internals against the estdbg
             dump;
  closed     the port's plant, logic, estimator, controller and radio codec
             driven through the C++ demo loop (`_run_framework`, the port's
             copy of `_golden_cpp.run_framework`) with the C++'s exact IMU
             noise draws, 600 ticks: trajectory, radio packets (headers
             equal, codes within a few LSB), commands.

"""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from agrifly_tpu_torch.io import radio, telemetry
from agrifly_tpu_torch.models import constants as tconst
from agrifly_tpu_torch.models import logic as onboard
from agrifly_tpu_torch.models import plant as plant_mod
from agrifly_tpu_torch.offboard import controller as offboard_ctrl
from agrifly_tpu_torch.offboard import estimators
from agrifly_tpu_torch.ops import rotation as rot
from tests import _golden_cpp as G
from tests.test_golden_cpp import (CLOSED_KW, CLOSED_TOL, EST_TOL, LOGIC_EXACT, LOGIC_TOL,
                                   PLANT_TOL)

DT = torch.tensor(1.0 / 500.0)


def _load(config):
    try:
        return G.load(config)
    except FileNotFoundError:  # pragma: no cover
        pytest.skip(f"golden npz for {config} not generated")


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def _i32(x):
    return torch.tensor(int(x), dtype=torch.int32)


def _vehicle():
    return tconst.vehicle_params(tconst.QC_TYPE_CF_MINIQUAD)


@pytest.mark.parametrize("config", G.CONFIGS)
def test_plant_teacher_forced(config):
    tr = _load(config)
    truth = np.asarray(tr["truth"])
    speeds = np.asarray(tr["mot_speeds"])
    cmds = np.asarray(tr["mot_cmds"])
    flags = np.asarray(tr["flags"])
    p = plant_mod.make_params(_vehicle(), "cpu")

    ks = np.nonzero(flags[1:, 0] == 1)[0]  # tick k+1 integrated: step k->k+1
    assert len(ks) > 2000
    state = plant_mod.PlantState(
        pos=_f32(truth[ks, 0:3]), vel=_f32(truth[ks, 3:6]), att=_f32(truth[ks, 6:10]),
        angvel=_f32(truth[ks, 10:13]), motor_speeds=_f32(speeds[ks]))
    z3 = torch.zeros(3)
    step = torch.func.vmap(lambda s, c: plant_mod.step(p, s, c, z3, z3, DT)[0])
    out = step(state, _f32(cmds[ks]))

    ref = truth[ks + 1]
    for name, got, want in [("pos", out.pos, ref[:, 0:3]), ("vel", out.vel, ref[:, 3:6]),
                            ("att", out.att, ref[:, 6:10]), ("angvel", out.angvel, ref[:, 10:13])]:
        d = np.abs(got.numpy().astype(np.float64) - want).max()
        assert d < PLANT_TOL[name], f"{config}/{name}: {d:.3e}"
    # motor speeds reproduce the f64 chain bit-exactly (f32-representable)
    d = np.abs(out.motor_speeds.numpy().astype(np.float64) - speeds[ks + 1]).max()
    assert d == 0.0, f"{config}/speeds: {d:.3e}"


def _run_logic_replay(trace, n_ticks):
    """`_golden_cpp.run_logic_replay` on the port's logic and telemetry: the
    C++'s exact raw f32 IMU measurements, its radio wire bytes delivered at
    its delivery ticks and its telemetry readout cadence; every internal
    stage at the logicdbg ticks, and the telemetry wire codes."""
    flags = np.asarray(trace["flags"])
    cmds = np.asarray(trace["mot_cmds"])
    gyro = np.asarray(trace["imu_gyro"])
    acc = np.asarray(trace["imu_acc"])
    off_raw = np.asarray(trace["off_raw"])
    dbg_at = {int(k): row for k, row in zip(np.asarray(trace["ldbg_k"]),
                                            np.asarray(trace["ldbg"]))}
    tel_at = {int(k): row for k, row in zip(np.asarray(trace["tel_k"]),
                                            np.asarray(trace["tel_raw"]))}
    n = min(n_ticks, len(flags))
    logic_p = onboard.make_params(_vehicle(), onboard_period=1.0 / 500.0, device="cpu")
    batt_v = _f32(float(logic_p.batt_critical) * 1.2)
    no_fields = torch.zeros(10, dtype=torch.int32)

    logic = onboard.init_state(logic_p)
    pending, fi = None, 0
    got, want, tel_got, tel_want = [], [], [], []
    for k in range(n):
        _, lf, _, tf, of, df = flags[k]
        if lf:
            mtype, mflags, fields = pending if pending is not None else (0, 0, no_fields)
            inputs = onboard.null_inputs("cpu")._replace(
                gyro=_f32(gyro[k]), acc=_f32(acc[k]), batt_voltage=batt_v,
                radio_new=torch.tensor(pending is not None), radio_type=_i32(mtype),
                radio_flags=_i32(mflags), radio_fields=torch.as_tensor(fields, dtype=torch.int32))
            logic = onboard.logic_step(logic_p, logic, inputs)[0]
            pending = None
            if k in dbg_at:
                got.append(np.concatenate([
                    [float(logic.fs)], logic.radio_floats[:4].numpy(), logic.gyro_lp.ym1.numpy(),
                    logic.acc_lp.ym1.numpy(), logic.gyro_bias.numpy(), logic.kf.angvel.numpy(),
                    logic.kf.att.numpy(), logic.kf.pos.numpy(), logic.kf.vel.numpy(),
                    logic.des_motor_speeds.numpy()]).astype(np.float64))
                want.append(np.concatenate([dbg_at[k], cmds[k].astype(np.float64)]))
        if tf:
            pkts, logic = telemetry.encode_from_logic(logic)
            if k in tel_at:
                tel_got.append(np.concatenate([[int(pkts.packet_number)], pkts.data1.numpy(),
                                               pkts.data2.numpy()]).astype(np.int64))
                p1, p2 = tel_at[k][:30], tel_at[k][30:]
                d1 = np.frombuffer(p1[2:].tobytes(), "<u2").astype(np.int64)
                d2 = np.frombuffer(p2[2:].tobytes(), "<u2").astype(np.int64).copy()
                # data2[12]/[13] carry panic/warnings u8s in the low byte;
                # the high bytes are uninitialized stack in the reference
                d2[12] &= 0xFF
                d2[13] &= 0xFF
                tel_want.append(np.concatenate([[int(p1[1])], d1, d2]))
        if of:
            _, logic = telemetry.encode_from_logic(logic)
        if df:
            pending = radio.bytes_to_fields(bytes(off_raw[fi]))
            fi += 1
    sl = {"fstate": slice(0, 1), "radio": slice(1, 5), "gyro_lp": slice(5, 8),
          "acc_lp": slice(8, 11), "bias": slice(11, 14), "kf_angvel": slice(14, 17),
          "kf_att": slice(17, 21), "kf_pos": slice(21, 24), "kf_vel": slice(24, 27),
          "cmds": slice(27, 31)}
    return np.array(got), np.array(want), sl, np.array(tel_got), np.array(tel_want)


def test_logic_teacher_forced_quick():
    """The JAX test's bounds: LOGIC_EXACT stages bit-exact, LOGIC_TOL for the
    rest; telemetry packet numbers equal and codes within 32 LSB, on fewer
    than 1% of codes apart (FMA-level low-pass deltas flip codes at bin
    boundaries)."""
    with torch.inference_mode():
        got, want, sl, tg, tw = _run_logic_replay(_load("hover_est"), 600)
    assert len(got) > 50 and len(tg) > 5
    for name in LOGIC_EXACT:
        d = np.abs(got[:, sl[name]] - want[:, sl[name]]).max()
        assert d == 0.0, f"hover_est/{name} not bit-exact: {d:.3e}"
    for name, tol in LOGIC_TOL.items():
        d = np.abs(got[:, sl[name]] - want[:, sl[name]]).max()
        assert d < tol, f"hover_est/{name}: {d:.3e} >= {tol}"
    assert (tg[:, 0] == tw[:, 0]).all(), "telemetry packet numbers differ"
    dd = np.abs(tg[:, 1:] - tw[:, 1:])
    print(f"telemetry: {len(tg)} packet pairs, code delta max {dd.max()}, "
          f"{(dd > 0).mean():.4f} of codes apart")
    assert dd.max() <= 32, f"telemetry code delta {dd.max()}"
    assert (dd > 0).mean() < 0.01, f"telemetry code mismatch fraction {(dd > 0).mean():.4f}"


def _run_estimator_replay(trace, n_ticks):
    """`_golden_cpp.run_estimator_replay` on the port's estimator."""
    flags = np.asarray(trace["flags"])
    truth = np.asarray(trace["truth"])
    off_est = np.asarray(trace["off_est"])
    off_cmd = np.asarray(trace["off_cmd"])
    edbg_k = np.asarray(trace["edbg_k"])
    edbg = np.asarray(trace["edbg"])
    n = min(n_ticks, len(flags))
    dbg_at = {int(k): edbg[i] for i, k in enumerate(edbg_k)}
    g3, e3 = _f32([0.0, 0.0, -9.81]), _f32([0.0, 0.0, 1.0])
    push = torch.tensor(True)

    mocap = estimators.mocap_init("cpu")
    master, ei = 0, 0
    got, want = [], []
    for k in range(n):
        _, _, mf, _, of, _ = flags[k]
        master += G.DT_US
        if mf:
            mocap = estimators.mocap_update(mocap, _i32(master), _f32(truth[k, 0:3]),
                                            _f32(truth[k, 6:10]), _i32(G.MOCAP_PERIOD_US))
            if k in dbg_at:
                vp, va = mocap.var_pos.numpy(), mocap.var_att.numpy()
                got.append(np.concatenate([
                    mocap.pos.numpy(), mocap.vel.numpy(), mocap.att.numpy(), mocap.angvel.numpy(),
                    [vp[0, 0], vp[0, 1], vp[1, 1], va[0, 0], va[0, 1], va[1, 1]]]).astype(np.float64))
                want.append(dbg_at[k][:19])
        if of:
            # the C++'s exact SetPredictedValues inputs (main.cpp:647-649)
            ea, th, w = _f32(off_est[ei, 6:10]), _f32(off_cmd[ei, 0]), _f32(off_cmd[ei, 1:4])
            mocap = estimators.mocap_set_predicted_values(
                mocap, _i32(master), _i32(G.EST_LATENCY_US), w, rot.rotate(ea, e3) * th + g3, push)
            ei += 1
    sl = {"pos": slice(0, 3), "vel": slice(3, 6), "att": slice(6, 10),
          "angvel": slice(10, 13), "var_pos": slice(13, 16), "var_att": slice(16, 19)}
    return np.array(got), np.array(want), sl


def test_estimator_teacher_forced_quick():
    with torch.inference_mode():
        got, want, sl = _run_estimator_replay(_load("hover_est"), 600)
    assert len(got) > 100
    for name, tol in EST_TOL.items():
        d = np.abs(got[:, sl[name]] - want[:, sl[name]]).max()
        assert d < tol, f"hover_est/{name}: {d:.3e} >= {tol}"


def _run_framework(trace, mode, n_ticks, des_pos=(0.0, 0.0, 3.5), step_t_us=None,
                   step_pos=None):
    """`_golden_cpp.run_framework` on the port's components: the C++ demo
    loop's statement order (main.cpp:330-760), the C++'s exact IMU noise
    draws. Returns the truth trajectory, commands, estimates and radio
    packets as that function does."""
    v = _vehicle()
    plant_p = plant_mod.make_params(v, "cpu")
    logic_p = onboard.make_params(v, onboard_period=1.0 / 500.0, device="cpu")
    ctrl_p = offboard_ctrl.make_params(v, device="cpu")
    flags = np.asarray(trace["flags"])
    noise = np.asarray(trace["noise"], np.float32)
    n = min(n_ticks, len(flags))

    batt_v = _f32(float(logic_p.batt_critical) * 1.2)
    z3, g3, e3 = torch.zeros(3), _f32([0.0, 0.0, -9.81]), _f32([0.0, 0.0, 1.0])
    no_fields = torch.zeros(10, dtype=torch.int32)

    def tick_logic(logic, plant, acc_imu, n6, pending):
        # noise.csv rows are in DRAW order; g++ evaluates the Vec3f(d(g),
        # d(g), d(g)) constructor arguments right-to-left, so draw k lands on
        # component 2-k (Quadcopter_T.cpp:170-181)
        gyro, acc_b = plant_mod.imu_measurements(plant_p, plant, acc_imu,
                                                 (n6[:3].flip(0), n6[3:].flip(0)))
        mtype, mflags, fields = pending if pending is not None else (_i32(0), _i32(0), no_fields)
        inputs = onboard.LogicInputs(
            gyro=gyro, acc=acc_b, temperature=_f32(25.0), batt_voltage=batt_v,
            batt_current=_f32(-1.0), radio_new=torch.tensor(pending is not None),
            radio_type=mtype, radio_flags=mflags, radio_fields=fields)
        return onboard.logic_step(logic_p, logic, inputs)[0]

    def telem_readout(logic):
        return telemetry.encode_from_logic(logic)[1]

    plant = plant_mod.init_state((0.0, 0.0, 0.0), "cpu")
    logic = onboard.init_state(logic_p)
    mocap = estimators.mocap_init("cpu")
    acc_imu = torch.zeros(3)
    master, noise_idx = 0, 0
    pending, queue = None, []
    out_truth = np.zeros((n, 13), np.float64)
    out_cmd, out_raw, out_est = [], [], []
    for k in range(n):
        integrated, logic_f, mocap_f, telem_f, off_f, _ = flags[k]
        if integrated:
            plant, acc_imu = plant_mod.step(plant_p, plant, logic.des_motor_speeds, z3, z3, DT)
        if logic_f:
            logic = tick_logic(logic, plant, acc_imu, torch.from_numpy(noise[noise_idx]), pending)
            noise_idx += 1
            pending = None
        master += G.DT_US

        if mocap_f and mode == "est":
            mocap = estimators.mocap_update(mocap, _i32(master), plant.pos, plant.att,
                                            _i32(G.MOCAP_PERIOD_US))
        if telem_f:
            logic = telem_readout(logic)
        if off_f:
            if mode == "est":
                est_pos, est_vel, est_att, _ = estimators.mocap_get_prediction(
                    mocap, _i32(master), _i32(G.EST_LATENCY_US))
            else:
                est_pos, est_vel, est_att = plant.pos, plant.vel, plant.att
            des = des_pos if step_t_us is None or master <= step_t_us else step_pos
            cmd_angvel, cmd_thrust = offboard_ctrl.run(ctrl_p, est_pos, est_vel, est_att,
                                                       _f32(des), None)
            mtype, mflags, fields = radio.make_rates_command(cmd_thrust, cmd_angvel)
            if mode == "est":
                # main.cpp:647-649: acc = att * e3 * thrust - (0,0,9.81)
                mocap = estimators.mocap_set_predicted_values(
                    mocap, _i32(master), _i32(G.EST_LATENCY_US), cmd_angvel,
                    rot.rotate(est_att, e3) * cmd_thrust + g3, torch.tensor(True))
            logic = telem_readout(logic)  # main.cpp:667-673 (stateful)
            queue.append((master + G.RADIO_DELAY_US, (mtype, mflags, fields)))
            out_cmd.append((k, float(cmd_thrust), cmd_angvel.numpy().astype(np.float64)))
            out_est.append((k, est_pos.numpy().astype(np.float64)))
            out_raw.append(radio.fields_to_bytes(int(mtype), int(mflags), fields.numpy()))
        if queue and queue[0][0] <= master:
            pending = queue.pop(0)[1]
        out_truth[k] = np.concatenate([plant.pos.numpy(), plant.vel.numpy(), plant.att.numpy(),
                                       plant.angvel.numpy()])
    return dict(truth=out_truth, cmd=out_cmd, est=out_est, raw=out_raw)


def test_closed_loop_quick():
    config = "hover_est"
    tr = _load(config)
    mode, kw = CLOSED_KW[config]
    with torch.inference_mode():
        res = _run_framework(tr, mode, 600, **kw)
    n = len(res["truth"])
    ref = np.asarray(tr["truth"])[:n]
    fw = res["truth"]
    for name, s in [("pos", slice(0, 3)), ("vel", slice(3, 6)), ("att", slice(6, 10)),
                    ("angvel", slice(10, 13))]:
        d = np.abs(fw[:, s] - ref[:, s]).max()
        assert d < CLOSED_TOL[name], f"{config}/{name}: {d:.3e}"

    # radio command wire packets: headers bit-equal, codes within a few LSB
    off_k = np.asarray(tr["off_k"])
    sel = off_k < n
    m = min(len(res["raw"]), int(sel.sum()))
    assert m > 50
    raw_ref = np.asarray(tr["off_raw"])[sel][:m]
    raw_fw = np.array([np.frombuffer(r, np.uint8) for r in res["raw"][:m]])
    assert (raw_ref[:, :3] == raw_fw[:, :3]).all(), "radio headers differ"
    # CreateRatesCommand writes fields 0..3 (RadioTypes.hpp:159-172);
    # bytes 11..22 are uninitialized stack in the reference
    c_ref = ((raw_ref[:, 3:11:2].astype(np.int32) << 8) | raw_ref[:, 4:12:2].astype(np.int32))
    c_fw = ((raw_fw[:, 3:11:2].astype(np.int32) << 8) | raw_fw[:, 4:12:2].astype(np.int32))
    dc = np.abs(c_ref - c_fw)
    assert dc.max() <= 96, f"radio code delta {dc.max()}"
    assert dc.mean() <= 12, f"radio mean code delta {dc.mean():.2f}"

    # command stream
    off_cmd = np.asarray(tr["off_cmd"])[sel][:m]
    fw_thrust = np.array([c[1] for c in res["cmd"]])[:m]
    fw_ang = np.array([c[2] for c in res["cmd"]])[:m]
    assert np.abs(fw_thrust - off_cmd[:, 0]).max() < 4e-2
    assert np.abs(fw_ang - off_cmd[:, 1:4]).max() < 1e-1

    off_est = np.asarray(tr["off_est"])[sel][:m]
    ep = np.array([e[1] for e in res["est"]])[:m]
    assert np.abs(ep - off_est[:, 0:3]).max() < CLOSED_TOL["pos"]
