"""The port's copies of two host-only modules against their originals.

The port imports nothing of the JAX package, so it keeps its own
`io/messages` (the AIFS_ROS message mirrors) and `utils/monitor` (the
vehicle monitor, on the port's `models/logic`). These tests hold each copy
to the original: the same classes, fields, defaults and `to_dict`; the same
bands and, fed the same stamped messages, the same monitor status.
"""

import dataclasses

import pytest

from _torch_parity import COMMAND_FLOOR  # noqa: F401 (one torch thread)
from agrifly_tpu.io import bridge as jbridge
from agrifly_tpu.io import messages as jmsgs
from agrifly_tpu.utils import monitor as jmonitor
from agrifly_tpu_torch.io import bridge as tbridge
from agrifly_tpu_torch.io import messages as tmsgs
from agrifly_tpu_torch.utils import monitor as tmonitor


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
