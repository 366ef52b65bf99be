"""The port's SimBridge (`agrifly_tpu_torch/io/bridge.py`) against the JAX
package's, on the CPU.

Both bridges fly the same vehicle on the same IMU noise: the JAX bridge
draws it from its state's key, and the port's bridge takes those draws
through its `draws` hook (`_torch_parity.jax_tick_draws`). Each records its
bus with its MessageRecorder, and the bags are compared line by line:
topics and order identical, stamps and integers equal, floats to the tick
criteria of tests/_torch_parity.py, telemetry values within one wire code.
The JAX bridge runs `env.step` under jit (no Pallas kernel: the step has
none). The blocked path is held to the per-tick path in the port, and the
wall-clock-paced loops run at rates the CPU's eager tick holds.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import bag_bound, compare_bags, jax_tick_draws, read_bag
from agrifly_tpu.io import bridge as jbridge
from agrifly_tpu.io import messages as jmsgs
from agrifly_tpu.io import radio as jradio
from agrifly_tpu.models import logic as jlogic
from agrifly_tpu.sim import env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.io import bridge as tbridge
from agrifly_tpu_torch.io import messages as tmsgs
from agrifly_tpu_torch.io import radio as tradio
from agrifly_tpu_torch.models import logic as tlogic
from agrifly_tpu_torch.sim import env as T

HOVER = (0.0, 0.0, 1.0)
N_BEFORE, N_AFTER = 120, 40  # ticks before and after the kill
YPR_FIELDS = ("attyaw", "attpitch", "attroll", "attitudeYPR")


def _draws_from(noise):
    """A bridge `draws` hook serving the rows of `noise` (n, 2, 3) in order."""
    noise = np.asarray(noise, np.float32)
    at = [0]

    def draws(n):
        out = noise[at[0]:at[0] + n]
        assert out.shape[0] == n, "the test drew too few JAX draws"
        at[0] += n
        return torch.from_numpy(out.copy())
    return draws


def _kill(bus, msgs_mod, radio_mod):
    raw = radio_mod.fields_to_bytes(radio_mod.TYPE_EMERGENCY_KILL, 0, np.zeros(10, np.int64))
    bus.publish("radio_command1", msgs_mod.RadioCommand(raw=raw + b"\x00" * 9))


def test_sim_bridge_bag_matches_jax(tmp_path):
    """120 ticks with the mocap estimator and IMU noise, a kill on
    radio_command1, 40 more: the two bags agree message for message
    (_torch_parity.bag_bound: the tick criteria over the first 60 ticks,
    then the long-rollout terms; telemetry within one code, integers and
    stamps equal throughout), and both vehicles reach FS_KILLED on the same
    tick."""
    jb = jbridge.SimBridge(J.make_params(noise_scale=1.0), vehicle_id=1, seed=0)
    noise, _ = jax_tick_draws(jb.state.key, N_BEFORE + N_AFTER)
    tp = convert.env_params_from_numpy(jax.tree_util.tree_map(np.asarray, jb.params), "cpu")
    tb = tbridge.SimBridge(tp, vehicle_id=1, draws=_draws_from(noise))
    bags = {}
    fs = {"theirs": [], "mine": []}
    for who, br, msgs_mod, radio_mod, cmd in (
            ("theirs", jb, jmsgs, jradio, J.hover_command(HOVER)),
            ("mine", tb, tmsgs, tradio, T.hover_command(HOVER, device="cpu"))):
        bags[who] = tmp_path / f"{who}.jsonl"
        rec = (jbridge if who == "theirs" else tbridge).MessageRecorder(br.bus, str(bags[who]))
        br.run(N_BEFORE, cmd)
        _kill(br.bus, msgs_mod, radio_mod)
        for _ in range(N_AFTER):
            br.tick(cmd)
            fs[who].append(int(br.state.logic.fs))
        rec.close()
    mine, theirs = read_bag(bags["mine"]), read_bag(bags["theirs"])
    worst = compare_bags(mine, theirs, bag_bound)
    print(f"{len(mine)} messages; worst float {worst:.4g} x the tick bound")
    assert fs["mine"] == fs["theirs"]
    assert fs["mine"][-1] == tlogic.FS_KILLED == jlogic.FS_KILLED
    assert fs["mine"][0] != tlogic.FS_KILLED  # it flew until the kill crossed the wire
    topics = {line["topic"] for line in mine}
    assert {"simulator_truth1", "imu_output1", "mocap_output1", "gps_output1", "telemetry1",
            "estimator1", "/camera/t265/odom/sample", "radio_command1"} == topics
    tel = [line["msg"] for line in mine if line["topic"] == "telemetry1"]
    assert [m["packetNumber"] for m in tel] == list(range(len(tel)))
    assert tb.t_us == jb.t_us == (N_BEFORE + N_AFTER) * 2000


def _spun_bridge():
    """A port SimBridge whose plant spins (angvel visibly nonzero on
    simulator_truth, so a path that drops angvel fails the compare)."""
    br = tbridge.SimBridge(T.make_params(noise_scale=1.0, device="cpu"), vehicle_id=1, seed=4)
    st = br.state
    br.state = st._replace(plant=st.plant._replace(angvel=torch.tensor([0.3, -0.2, 0.1])))
    return br


def test_run_blocked_matches_per_tick(tmp_path):
    """The blocked path (n env.steps queued per dispatch, the (n, 64) rows
    read back once, published from the host rows) publishes message for
    message what the per-tick path publishes, from the same draws: every
    value the two paths read from the same tensors is equal (the states,
    the filtered IMU, the body-frame velocity, the telemetry packets and
    their decode), and the euler angles, which the tick takes on the
    device in float32 and the block on the host in float64, agree within
    2e-6 rad. A per-tick run then resumes from the blocked bridge's state."""
    cmd = T.hover_command(device="cpu")
    bags = {}
    bridges = {"run": _spun_bridge(), "blocked": _spun_bridge()}
    for name, br in bridges.items():
        bags[name] = tmp_path / f"{name}.jsonl"
        rec = tbridge.MessageRecorder(br.bus, str(bags[name]))
        if name == "run":
            br.run(40, cmd)
        else:
            br.run_blocked(40, cmd, block=7)  # deliberately not a divisor of 40
            counts = dict(br.bus.counts)
            state = br.state
            br.run(3, cmd)  # a per-tick run resumes from the blocked bridge's state
        rec.close()
    a, b = read_bag(bags["run"]), read_bag(bags["blocked"])
    assert dict(bridges["run"].bus.counts) == counts
    compare_bags(b[:len(a)], a, lambda topic, name, stamp, ref: 2e-6 if name in YPR_FIELDS else 0.0)
    for (_, x), (_, y) in zip(convert.leaves(bridges["run"].state), convert.leaves(state)):
        assert torch.equal(x, y)
    truth = np.array([[m["msg"]["angvelx"], m["msg"]["angvely"], m["msg"]["angvelz"]]
                      for m in a if m["topic"] == "simulator_truth1"])
    assert truth.shape == (40, 3) and np.any(truth != 0.0)
    # telemetry fires at ticks 6, 11, ..., 36 (10 ms, `> period`)
    assert sum(m["topic"] == "telemetry1" for m in a) == 7
    assert bridges["blocked"].bus.counts["simulator_truth1"] == 43
    assert b[len(a)]["msg"]["header"]["stamp"] == 41 * 2000 * 1e-6


def _skip_if_overloaded(report):
    if report["late_quanta"] > 0.2 * report["n_quanta"]:
        pytest.skip(f"host overloaded: {report['late_quanta']}/{report['n_quanta']} quanta late")


@pytest.mark.parametrize("device_blocks", [False, True])
def test_sim_bridge_run_realtime_paced(device_blocks):
    """run_realtime at 12.5 ticks a second of wall time (the CPU's eager
    tick takes tens of ms), 2 ticks a quantum, 2.4 s: the achieved rate
    within 2.5% of the target, the wall-clock mocap and telemetry rates in
    the reference bands scaled by rate / 500 Hz, and a kill published in
    the first quantum reaches the onboard FSM (through the pipelined
    device blocks too)."""
    br = tbridge.SimBridge(T.make_params(noise_scale=0.0, device="cpu"), vehicle_id=1)

    def on_quantum(b, k):
        if k == 1:
            _kill(b.bus, tmsgs, tradio)

    report = br.run_realtime(2.4, T.hover_command(device="cpu"), rate_hz=12.5, block=2,
                             on_quantum=on_quantum, device_blocks=device_blocks)
    _skip_if_overloaded(report)
    target = report["target_tick_hz"]
    assert abs(report["achieved_tick_hz"] - target) / target < 0.025, report
    assert report["rate_scale"] == 12.5 / 500.0
    assert report["bands_ok"]["mocap"] and report["bands_ok"]["telemetry"], report
    assert report["bands_ok"].get("cmd") is False  # one kill is not a 50 Hz commander
    assert report["ticks"] == 30
    warm = 10 if not device_blocks else 2
    assert br.bus.counts["simulator_truth1"] == report["ticks"] + warm
    assert int(br.state.logic.fs) == tlogic.FS_KILLED
