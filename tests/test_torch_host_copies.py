"""The port's copies of the host-only modules against their originals.

The port imports nothing of the JAX package, so it keeps its own
`io/messages` (the AIFS_ROS message mirrors), `utils/monitor` (the vehicle
monitor, on the port's `models/logic`), `io/teleop`, `io/miniros`,
`io/ros_adapter`, `utils/perf`, `io/native` and `utils/simlog`. These tests
hold each copy to the original: the same classes, fields, defaults and
`to_dict`; the same bands and, fed the same stamped messages, the same
monitor status; the same joystick messages from the same key stream, js
events and script; the same md5sums and serialized bytes of every ROS
schema, and a publisher of one package heard by a subscriber of the other
over localhost; the same topic table and message copies; the same counter
summaries; codec bytes and CSV files from the port's build of
`native/wire_runtime.cpp` equal to the original's; the same CSV rows.
"""

import dataclasses
import io
import struct
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import COMMAND_FLOOR  # noqa: F401 (one torch thread)
from agrifly_tpu.io import bridge as jbridge
from agrifly_tpu.io import messages as jmsgs
from agrifly_tpu.io import miniros as jminiros
from agrifly_tpu.io import native as jnative
from agrifly_tpu.io import ros_adapter as jros
from agrifly_tpu.io import teleop as jteleop
from agrifly_tpu.utils import monitor as jmonitor
from agrifly_tpu.utils import perf as jperf
from agrifly_tpu.utils import simlog as jsimlog
import agrifly_tpu_torch
from agrifly_tpu_torch.io import bridge as tbridge
from agrifly_tpu_torch.io import messages as tmsgs
from agrifly_tpu_torch.io import miniros as tminiros
from agrifly_tpu_torch.io import native as tnative
from agrifly_tpu_torch.io import ros_adapter as tros
from agrifly_tpu_torch.io import teleop as tteleop
from agrifly_tpu_torch.utils import monitor as tmonitor
from agrifly_tpu_torch.utils import perf as tperf
from agrifly_tpu_torch.utils import simlog as tsimlog


def _classes(mod):
    return {name: obj for name, obj in vars(mod).items()
            if dataclasses.is_dataclass(obj) and obj.__module__ == mod.__name__}


def _field_spec(cls):
    """(name, default or the default factory's value's dict) per field."""
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:
            value = f.default_factory()
            default = dataclasses.asdict(value) if dataclasses.is_dataclass(value) else value
        else:
            default = "required"
        out.append((f.name, str(f.type), default))
    return out


def _filled(cls, mod, k=0):
    """An instance of `cls` (from module `mod`) with every field set to a
    value of its default's kind: nested messages filled the same way."""
    kw = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        j = k + i
        if dataclasses.is_dataclass(default):
            kw[f.name] = _filled(getattr(mod, type(default).__name__), mod, 10 * (j + 1))
        elif isinstance(default, bool):
            kw[f.name] = j % 2 == 0
        elif isinstance(default, int):
            kw[f.name] = j + 3
        elif isinstance(default, float):
            kw[f.name] = 0.25 * j - 1.5
        elif isinstance(default, str):
            kw[f.name] = f"s{j}"
        elif isinstance(default, bytes):
            kw[f.name] = bytes(range(j % 7 + 1))
        elif isinstance(default, tuple):
            kw[f.name] = tuple(0.5 * (j + m) for m in range(len(default)))
        else:
            kw[f.name] = default
    return cls(**kw)


def test_message_classes_and_fields_equal_the_original():
    theirs, mine = _classes(jmsgs), _classes(tmsgs)
    assert sorted(mine) == sorted(theirs)
    assert len(mine) > 15
    for name, cls in theirs.items():
        assert _field_spec(mine[name]) == _field_spec(cls), name


@pytest.mark.parametrize("name", sorted(_classes(jmsgs)))
def test_to_dict_equal_on_every_message(name):
    """to_dict of a default and of a filled message of each class."""
    theirs, mine = getattr(jmsgs, name), getattr(tmsgs, name)
    assert tmsgs.to_dict(mine()) == jmsgs.to_dict(theirs())
    assert tmsgs.to_dict(_filled(mine, tmsgs)) == jmsgs.to_dict(_filled(theirs, jmsgs))


def test_monitor_bands_and_names_equal_the_original():
    assert tmonitor.BANDS == jmonitor.BANDS
    for ok, warn in ((True, False), (False, False), (False, True)):
        assert tmonitor.colorize("x", ok, warn) == jmonitor.colorize("x", ok, warn)


def _stream(msgs_mod, publish):
    """A stamped message sequence over 2 s of sim time: mocap at 200 Hz,
    telemetry at 100 Hz whose panic reason and warnings change, commands at
    50 Hz that stop after 1.2 s, joystick values at 100 Hz, and vehicle 2's
    mocap for 0.3 s."""
    for k in range(2000):
        t = 0.001 * (k + 1)
        if k % 5 == 0:
            publish("mocap_output1", msgs_mod.MocapOutput(header=msgs_mod.Header(stamp=t)))
        if k % 10 == 0:
            panic = 0 if k < 1200 else (3 if k < 1600 else 7)
            publish("telemetry1", msgs_mod.Telemetry(header=msgs_mod.Header(stamp=t),
                                                     panicReason=panic, warnings=k % 3))
            publish("joystick_values", msgs_mod.JoystickValues(header=msgs_mod.Header(stamp=t)))
        if k % 20 == 0 and t < 1.2:
            publish("radio_command1", msgs_mod.RadioCommand(header=msgs_mod.Header(stamp=t)))
        if k % 5 == 0 and t < 0.3:
            publish("mocap_output2", msgs_mod.MocapOutput(header=msgs_mod.Header(stamp=t)))


def test_vehicle_monitor_status_equals_the_original():
    """The same stamped sequence into both VehicleMonitors (sim time): the
    same status() and render() at several instants, and the same fleet and
    joystick renders."""
    buses = {"theirs": jbridge.TopicBus(), "mine": tbridge.TopicBus()}
    mods = {"theirs": (jmsgs, jmonitor), "mine": (tmsgs, tmonitor)}
    mons = {}
    for who, bus in buses.items():
        msgs_mod, mon_mod = mods[who]
        mons[who] = (mon_mod.VehicleMonitor(bus, 1, use_sim_time=True),
                     mon_mod.JoystickMonitor(bus, use_sim_time=True),
                     mon_mod.FleetMonitor(bus, ids=range(1, 4), use_sim_time=True))
        _stream(msgs_mod, bus.publish)
    for now in (0.5, 1.0, 1.5, 2.0):
        (v_j, js_j, f_j), (v_t, js_t, f_t) = mons["theirs"], mons["mine"]
        assert v_t.status(now) == v_j.status(now), now
        assert v_t.render(now) == v_j.render(now)
        assert js_t.status(now) == js_j.status(now)
        assert js_t.render(now) == js_j.render(now)
        assert f_t.render(now) == f_j.render(now)
    status = mons["mine"][0].status(2.0)
    assert status["panic"][1] is False and status["mocap"][1] is True


# ---- io/teleop ----------------------------------------------------------------


def test_teleop_constants_equal_the_original():
    for name in ("KEY_BINDINGS", "RATE_HZ", "JS_EVENT_BUTTON", "JS_EVENT_AXIS", "JS_EVENT_INIT",
                 "XBOX_AXIS_THRUST", "XBOX_AXIS_YAW", "XBOX_AXIS_PITCH", "XBOX_AXIS_ROLL",
                 "XBOX_SIGNS", "XBOX_BUTTONS"):
        assert getattr(tteleop, name) == getattr(jteleop, name), name


def test_scripted_joystick_equals_the_original():
    spec = "scripted:0.25:buttonStart,0.5:buttonRed,0.5:buttonBlue,1.75:buttonYellow"
    theirs, mine = jteleop.make(spec), tteleop.make(spec)
    for k in range(25):
        t = 0.1 * k
        assert tmsgs.to_dict(mine.poll(t)) == jmsgs.to_dict(theirs.poll(t)), t
    with pytest.raises(SystemExit):
        tteleop.make("wheel")


def test_keyboard_joystick_equals_the_original():
    keys = "sxQab yS"
    polls = {}
    for name, mod in (("theirs", jteleop), ("mine", tteleop)):
        stream = io.StringIO(keys)
        kb = mod.KeyboardJoystick(stream=stream)  # a StringIO is not a TTY: no raw mode
        kb._read_keys = lambda stream=stream: list(stream.read(3).lower())
        polls[name] = [mod.__name__ and kb.poll(0.01 * k) for k in range(4)]
    for a, b in zip(polls["mine"], polls["theirs"]):
        assert tmsgs.to_dict(a) == jmsgs.to_dict(b)
    assert polls["mine"][0].buttonStart == 1


def _js_events(mod):
    def ev(etype, number, value):
        return struct.pack("<IhBB", 0, value, etype, number)

    return (ev(mod.JS_EVENT_AXIS | mod.JS_EVENT_INIT, mod.XBOX_AXIS_THRUST, 0)
            + ev(mod.JS_EVENT_AXIS, mod.XBOX_AXIS_THRUST, -(1 << 14))
            + ev(mod.JS_EVENT_AXIS, mod.XBOX_AXIS_YAW, 1 << 13)
            + ev(mod.JS_EVENT_AXIS, mod.XBOX_AXIS_PITCH, -(1 << 15) + 1)
            + ev(mod.JS_EVENT_AXIS, mod.XBOX_AXIS_ROLL, 12345)
            + ev(mod.JS_EVENT_BUTTON, 7, 1) + ev(mod.JS_EVENT_BUTTON, 1, 1)
            + ev(mod.JS_EVENT_BUTTON, 3, 1) + ev(mod.JS_EVENT_BUTTON, 7, 0))


def test_linux_joystick_equals_the_original():
    assert _js_events(tteleop) == _js_events(jteleop)
    theirs = jteleop.LinuxJoystick(stream=io.BytesIO(_js_events(jteleop)))
    mine = tteleop.LinuxJoystick(stream=io.BytesIO(_js_events(tteleop)))
    for t in (0.1, 0.2):
        assert tmsgs.to_dict(mine.poll(t)) == jmsgs.to_dict(theirs.poll(t))
    assert mine.poll(0.3).buttonRed == 1


def test_publish_loop_equals_the_original():
    got = {}
    for name, mod, bus in (("theirs", jteleop, jbridge.TopicBus()),
                           ("mine", tteleop, tbridge.TopicBus())):
        seen = []
        bus.subscribe("joystick_values", seen.append)
        mod.publish_loop(bus, mod.ScriptedJoystick([(0.25, "buttonStart"), (0.5, "buttonRed")]),
                         duration_s=1.0)
        got[name] = seen
    assert len(got["mine"]) == len(got["theirs"]) == 100
    assert ([tmsgs.to_dict(m) for m in got["mine"]]
            == [jmsgs.to_dict(m) for m in got["theirs"]])


# ---- io/miniros ---------------------------------------------------------------


def _fill_ros(mod, cls, rng):
    """A message of a generated class with every field drawn from rng
    (the same draws for the same schema in either module)."""
    m = cls()
    for f in cls._fields:
        code = mod._BUILTIN.get(f.type, ("",))[0]
        if f.is_array:
            n = f.array_len if f.array_len is not None else int(rng.integers(0, 5))
            if f.type == "uint8":
                val = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            elif f.type in mod._BUILTIN:
                if code in "fd":
                    val = tuple(float(np.float32(x)) for x in rng.uniform(-10, 10, n))
                else:
                    val = tuple(int(x) for x in rng.integers(0, 100, n))
            else:
                val = tuple(_fill_ros(mod, mod.message_class(f.type), rng) for _ in range(n))
        elif f.type == "string":
            val = f"s{int(rng.integers(0, 1000))}"
        elif f.type in ("time", "duration"):
            val = mod.Time(int(rng.integers(0, 1000)), int(rng.integers(0, 10 ** 9)))
        elif f.type == "bool":
            val = bool(rng.integers(0, 2))
        elif f.type in mod._BUILTIN:
            val = (float(np.float32(rng.uniform(-10, 10))) if code in "fd"
                   else int(rng.integers(0, 100)))
        else:
            val = _fill_ros(mod, mod.message_class(f.type), rng)
        setattr(m, f.name, val)
    return m


def test_miniros_schemas_md5_and_bytes_equal_the_original():
    assert tminiros.SCHEMAS == jminiros.SCHEMAS
    assert tminiros._BUILTIN == jminiros._BUILTIN
    for full_type in jminiros.SCHEMAS:
        assert tminiros.compute_md5(full_type) == jminiros.compute_md5(full_type), full_type
        assert tminiros.full_text(full_type) == jminiros.full_text(full_type), full_type
        mine = _fill_ros(tminiros, tminiros.message_class(full_type), np.random.default_rng(7))
        theirs = _fill_ros(jminiros, jminiros.message_class(full_type), np.random.default_rng(7))
        data = tminiros.serialize(mine, full_type)
        assert data == jminiros.serialize(theirs, full_type), full_type
        assert jminiros.serialize(tminiros.deserialize(data, full_type), full_type) == data


def _wait(pred, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_miniros_cross_wire_with_the_original():
    """The original's master; the port's node publishes simulator_truth1 to
    an original subscriber, and an original node publishes radio_command1
    to a port subscriber, over localhost TCPROS."""
    master = jminiros.MiniMaster()
    mine = tminiros.MiniNode("port_node", master.uri)
    theirs = jminiros.MiniNode("original_node", master.uri)
    try:
        truth_t = "hiperlab_rostools/simulator_truth"
        heard = []
        theirs.subscribe("simulator_truth1", jminiros.message_class(truth_t), heard.append)
        pub = mine.advertise("simulator_truth1", tminiros.message_class(truth_t))
        assert _wait(lambda: pub.get_num_connections() == 1)
        msg = tminiros.message_class(truth_t)(vehicleID=7, posx=1.5, velz=0.125)
        msg.header.stamp = tminiros.Time.from_sec(12.5)
        pub.publish(msg)
        assert _wait(lambda: len(heard) == 1)
        assert heard[0].vehicleID == 7 and heard[0].posx == 1.5
        assert heard[0].header.stamp.to_sec() == 12.5

        cmd_t = "hiperlab_rostools/radio_command"
        back = []
        mine.subscribe("radio_command1", tminiros.message_class(cmd_t), back.append)
        pub2 = theirs.advertise("radio_command1", jminiros.message_class(cmd_t))
        assert _wait(lambda: pub2.get_num_connections() == 1)
        pub2.publish(jminiros.message_class(cmd_t)(raw=bytes(range(32)), debugtype=3))
        assert _wait(lambda: len(back) == 1)
        assert bytes(back[0].raw) == bytes(range(32)) and back[0].debugtype == 3
    finally:
        mine.close()
        theirs.close()
        master.close()


# ---- io/ros_adapter -----------------------------------------------------------


def test_ros_adapter_table_equals_the_original():
    assert ([(p, c.__name__, pkg, n) for p, c, pkg, n in tros.TOPIC_TABLE]
            == [(p, c.__name__, pkg, n) for p, c, pkg, n in jros.TOPIC_TABLE])
    assert ([c.__name__ for c in tros.NESTED_MIRRORS]
            == [c.__name__ for c in jros.NESTED_MIRRORS])
    assert tros.RosAdapter.INBOUND == jros.RosAdapter.INBOUND
    for topic in ("radio_command3", "simulator_truth1", "joystick_values", "depthImage2",
                  "imagePoll", "/camera/t265/odom/sample", "pose_euler", "nothing1"):
        a, b = tros.lookup(topic), jros.lookup(topic)
        assert (a is None) == (b is None), topic
        if a is not None:
            assert (a[0].__name__, a[1:]) == (b[0].__name__, b[1:]), topic
        assert tros.RosAdapter.is_inbound(topic) == jros.RosAdapter.is_inbound(topic)


@pytest.mark.parametrize("topic", ["simulator_truth1", "mocap_output1", "gps_output1",
                                   "imu_output1", "telemetry1", "estimator1", "radio_command1",
                                   "joystick_values", "depthImage1"])
def test_ros_adapter_copies_equal_the_original(topic):
    """copy_to_ros of a filled mirror onto the ROS class of its topic (the
    original's miniros classes), serialized; and copy_from_ros back. (The
    diagnostics mirrors hold vectors as tuples where the ROS types nest
    messages: the field copy serves the flat topics, in both packages.)"""
    cls_t, pkg, name = tros.lookup(topic)
    cls_j = jros.lookup(topic)[0]
    full = f"{pkg}/{name}"
    ros_cls = jminiros.message_class(full)
    mine = tros.copy_to_ros(_filled(cls_t, tmsgs), ros_cls(), jminiros.Time.from_sec)
    theirs = jros.copy_to_ros(_filled(cls_j, jmsgs), ros_cls(), jminiros.Time.from_sec)
    assert jminiros.serialize(mine, full) == jminiros.serialize(theirs, full)
    assert (tmsgs.to_dict(tros.copy_from_ros(mine, cls_t))
            == jmsgs.to_dict(jros.copy_from_ros(theirs, cls_j)))


def test_ros_adapter_odometry_equals_the_original():
    full = "nav_msgs/Odometry"
    ros_cls = jminiros.message_class(full)
    mine = tros.odometry_to_ros(_filled(tmsgs.Odometry, tmsgs), ros_cls(), jminiros.Time.from_sec)
    theirs = jros.odometry_to_ros(_filled(jmsgs.Odometry, jmsgs), ros_cls(),
                                  jminiros.Time.from_sec)
    assert jminiros.serialize(mine, full) == jminiros.serialize(theirs, full)
    assert tmsgs.to_dict(tros.odometry_from_ros(mine)) == jmsgs.to_dict(jros.odometry_from_ros(theirs))


def test_ros_adapter_over_the_wire():
    """The port's RosAdapter on the port's miniros against the original's
    master: a bus publish reaches an original subscriber, and an original
    publisher's radio_command1 reaches the bus as the port's mirror."""
    master = jminiros.MiniMaster()
    bus = tbridge.TopicBus()
    ros = tminiros.make_ros(master.uri)
    adapter = tros.RosAdapter(bus, vehicle_ids=(1,), ros=ros)
    ext = jminiros.MiniNode("external", master.uri)
    try:
        assert adapter.active
        got = []
        ext.subscribe("simulator_truth1", jminiros.message_class(
            "hiperlab_rostools/simulator_truth"), got.append)
        truth = tmsgs.SimulatorTruth(vehicleID=1, posx=3.25, angvelz=-0.5)
        truth.header.stamp = 1.75
        bus.publish("simulator_truth1", truth)
        assert _wait(lambda: "/simulator_truth1" in ros[0].node._pubs and
                     ros[0].node._pubs["/simulator_truth1"].get_num_connections() == 1)
        bus.publish("simulator_truth1", truth)
        assert _wait(lambda: len(got) >= 1)
        assert got[-1].posx == 3.25 and got[-1].header.stamp.to_sec() == 1.75

        inbound = []
        bus.subscribe("radio_command1", inbound.append)
        cmd_cls = jminiros.message_class("hiperlab_rostools/radio_command")
        ext_pub = ext.advertise("radio_command1", cmd_cls)
        assert _wait(lambda: ext_pub.get_num_connections() == 1)
        ext_pub.publish(cmd_cls(raw=bytes(range(32)), debugtype=3))
        assert _wait(lambda: len(inbound) == 1)
        assert isinstance(inbound[0], tmsgs.RadioCommand)
        assert bytes(inbound[0].raw) == bytes(range(32)) and inbound[0].debugtype == 3
    finally:
        ext.close()
        ros[0].close()
        master.close()


# ---- utils/perf ---------------------------------------------------------------


def test_perf_counters_equal_the_original(capsys):
    summaries = {}
    for name, mod in (("theirs", jperf), ("mine", tperf)):
        mod.reset_all()
        c = mod.alloc(mod.PC_COUNT, "events")
        c.bump()
        c.bump(3)
        e = mod.alloc(mod.PC_ELAPSED, "block")
        for dt in (0.002, 0.0005, 0.004):
            e._accumulate(dt)
        iv = mod.alloc(mod.PC_INTERVAL, "tick")
        iv._accumulate(0.01)
        assert mod.alloc(mod.PC_COUNT, "events") is c
        with mod.timed("timed") as t:
            pass
        summaries[name] = [c.summary(), e.summary(), iv.summary(), e.mean, e.min, e.max,
                           t.count]
        mod.print_all()
        summaries[name + " printed"] = capsys.readouterr().out.splitlines()[:2]
        mod.reset_all()
    assert (tperf.PC_COUNT, tperf.PC_ELAPSED, tperf.PC_INTERVAL) == (
        jperf.PC_COUNT, jperf.PC_ELAPSED, jperf.PC_INTERVAL)
    assert summaries["mine"] == summaries["theirs"]
    assert summaries["mine printed"] == summaries["theirs printed"]


# ---- io/native ----------------------------------------------------------------


def test_native_builds_into_the_port_and_equals_the_original(tmp_path):
    assert jnative.available()
    tnative.get_lib()  # builds on first use; a failed build raises
    assert tnative.LIB == Path(agrifly_tpu_torch.__file__).parent / "_build" / "libwire_runtime.so"
    assert tnative.LIB.exists() and tnative.SRC.name == "wire_runtime.cpp"
    rng = np.random.default_rng(0)
    thrust = rng.uniform(-5, 40, 64).astype(np.float32)
    angvel = rng.uniform(-40, 40, (64, 3)).astype(np.float32)
    raw = tnative.radio_encode_rates(thrust, angvel, 3)
    assert np.array_equal(raw, jnative.radio_encode_rates(thrust, angvel, 3))
    for a, b in zip(tnative.radio_decode(raw), jnative.radio_decode(raw)):
        assert np.array_equal(a, b)
    types = rng.integers(0, 2, 16).astype(np.uint8)
    nums = rng.integers(0, 256, 16).astype(np.uint8)
    data = rng.integers(0, 65536, (16, 14)).astype(np.uint16)
    packed = tnative.telemetry_pack(types, nums, data)
    assert np.array_equal(packed, jnative.telemetry_pack(types, nums, data))
    for a, b in zip(tnative.telemetry_unpack(packed), (types, nums, data)):
        assert np.array_equal(a, b)
    rows = rng.normal(0, 100, (50, 7))
    rows[3, 2] = np.inf
    for mod, name in ((tnative, "mine.csv"), (jnative, "theirs.csv")):
        with mod.NativeCsvLogger(tmp_path / name, "a,b,c,d,e,f,g") as lg:
            lg.write_rows(rows[:20])
            lg.write_rows(rows[20:])
    assert (tmp_path / "mine.csv").read_bytes() == (tmp_path / "theirs.csv").read_bytes()


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "LIB", tmp_path / "_build" / "libbad.so")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error"):
        tnative.get_lib()


# ---- utils/simlog -------------------------------------------------------------

EULER_RAD = 1e-6  # the euler columns: float32 atan2/asin of the port and of XLA:CPU


def test_simlog_rows_equal_the_original(tmp_path):
    """The same stacked outputs (numpy for the original, CPU tensors for
    the port): the same header and shape; every column equal but the euler
    angles, within EULER_RAD."""
    import types

    rng = np.random.default_rng(4)
    T = 40
    q = rng.normal(size=(T, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    traj = dict(pos=rng.normal(size=(T, 3)).astype(np.float32),
                vel=rng.normal(size=(T, 3)).astype(np.float32), att=q,
                angvel=rng.normal(size=(T, 3)).astype(np.float32),
                motor_speeds=rng.uniform(0, 3000, (T, 4)).astype(np.float32),
                panic_reason=(np.arange(T) % 3).astype(np.int32))
    est = tuple(rng.normal(size=(T, 3)) for _ in range(4))
    kw = dict(dt=0.032, des_pos=(0.0, 1.0, 2.0), est=est, last_cmd=rng.normal(size=(T, 4)))
    theirs = jsimlog.write_rollout_csv(tmp_path / "theirs.csv", types.SimpleNamespace(**traj), **kw)
    mine = tsimlog.write_rollout_csv(
        tmp_path / "mine.csv",
        types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in traj.items()}), **kw)
    assert tsimlog.HEADER == jsimlog.HEADER and mine == theirs == (T, 40)
    read = {}
    for name in ("mine", "theirs"):
        lines = (tmp_path / f"{name}.csv").read_text().splitlines()
        assert lines[0] == jsimlog.HEADER
        read[name] = np.array([[float(x) for x in line.split(",")] for line in lines[1:]])
    euler = [jsimlog.HEADER.split(",").index(c) for c in ("attY", "attP", "attR")]
    rest = [i for i in range(40) if i not in euler]
    np.testing.assert_array_equal(read["mine"][:, rest], read["theirs"][:, rest])
    np.testing.assert_allclose(read["mine"][:, euler], read["theirs"][:, euler], rtol=0,
                               atol=EULER_RAD)
