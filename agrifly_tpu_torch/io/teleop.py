"""Teleoperation: keyboard/joystick front-end for mission control.

Equivalent of AIFS_ROS/hiperlab_hardware (joystickmain.cpp /
keyboardmain.cpp): maps operator input onto `joystick_values` messages at
100 Hz. The keyboard variant reads single characters (termios raw mode
when attached to a TTY) with the reference's bindings — 's' = start,
'a'/'b'/'x'/'y' = the four buttons (keyboardmain.cpp:26-30,63-78) — and is
"NOT for actual flight, only for testing in simulation", like the
original. A ScriptedJoystick replays a button/axis timeline for tests and
headless runs.

A copy of `agrifly_tpu/io/teleop.py` on the port's `io/messages`
(tests/test_torch_host_copies.py holds the two equal).
"""

from __future__ import annotations

import select
import sys
from typing import Iterable, Tuple

from agrifly_tpu_torch.io import messages as msgs

KEY_BINDINGS = {
    "s": "buttonStart",
    "a": "buttonGreen",
    "b": "buttonRed",
    "x": "buttonBlue",
    "y": "buttonYellow",
}

RATE_HZ = 100


def make(spec: str):
    """Operator front-end from a CLI spec: 'keyboard', 'joystick', or
    'scripted:T:BUTTON,...' (e.g. 'scripted:0.5:buttonStart,3:buttonRed').
    The one parser behind every --teleop flag (demo, launch)."""
    if spec == "keyboard":
        return KeyboardJoystick()
    if spec == "joystick":
        return LinuxJoystick()
    if spec.startswith("scripted:"):
        presses = []
        for part in spec[len("scripted:"):].split(","):
            t_s, name = part.split(":")
            presses.append((float(t_s), name))
        return ScriptedJoystick(presses)
    raise SystemExit(f"unknown --teleop mode: {spec}")


class ScriptedJoystick:
    """Deterministic joystick: a list of (time_s, button_name) presses."""

    def __init__(self, presses: Iterable[Tuple[float, str]] = ((0.5, "buttonStart"),)):
        self.presses = sorted(presses)
        self._i = 0

    def poll(self, t: float) -> msgs.JoystickValues:
        msg = msgs.JoystickValues(header=msgs.Header(stamp=t))
        while self._i < len(self.presses) and self.presses[self._i][0] <= t:
            setattr(msg, self.presses[self._i][1], 1)
            self._i += 1
        return msg


class KeyboardJoystick:
    """Non-blocking keyboard poller emitting joystick_values."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stdin
        self._raw = False
        if hasattr(self.stream, "fileno") and self.stream.isatty():
            import termios, tty  # noqa

            self._fd = self.stream.fileno()
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
            self._raw = True

    def close(self):
        if self._raw:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
            self._raw = False

    def _read_keys(self):
        keys = []
        while True:
            r, _, _ = select.select([self.stream], [], [], 0)
            if not r:
                break
            ch = self.stream.read(1)
            if not ch:
                break
            keys.append(ch.lower())
        return keys

    def poll(self, t: float) -> msgs.JoystickValues:
        msg = msgs.JoystickValues(header=msgs.Header(stamp=t))
        for ch in self._read_keys():
            attr = KEY_BINDINGS.get(ch)
            if attr:
                setattr(msg, attr, 1)
        return msg


# Linux joystick API (linux/joystick.h): struct js_event is
# { u32 time_ms; s16 value; u8 type; u8 number } — 8 bytes little-endian.
JS_EVENT_BUTTON = 0x01
JS_EVENT_AXIS = 0x02
JS_EVENT_INIT = 0x80
_JS_EVENT_FMT = "<IhBB"
_JS_EVENT_SIZE = 8

# Xbox-360 mapping identified with joystick_identification
# (joystickmain.cpp:28-42)
XBOX_AXIS_THRUST = 1
XBOX_AXIS_YAW = 0
XBOX_AXIS_PITCH = 4
XBOX_AXIS_ROLL = 3
XBOX_SIGNS = {XBOX_AXIS_THRUST: -1.0, XBOX_AXIS_YAW: +1.0,
              XBOX_AXIS_PITCH: -1.0, XBOX_AXIS_ROLL: +1.0}
XBOX_BUTTONS = {7: "buttonStart", 1: "buttonRed", 3: "buttonYellow",
                0: "buttonGreen", 2: "buttonBlue"}


class LinuxJoystick:
    """/dev/input/jsN reader (joystickmain.cpp parity): non-blocking
    js_event stream decoded with the Xbox-360 axis map, axes normalized to
    [-1, 1], published as joystick_values axes (thrust, yaw, pitch, roll).

    `stream` overrides the device for tests (any object with .read());
    otherwise devices js0..js99 are probed like the reference."""

    def __init__(self, stream=None, device=None):
        self._owns_fd = False
        if stream is not None:
            self._read = stream.read
        else:
            import os

            fd = None
            paths = [device] if device else [f"/dev/input/js{i}" for i in range(100)]
            for path in paths:
                try:
                    fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
                    break
                except OSError:
                    continue
            if fd is None:
                raise OSError("no joystick device found (tried /dev/input/js0..99)")
            self._fd = fd
            self._owns_fd = True
            self._read = lambda n: self._read_fd(n)
        self._axes = {}
        self._buttons = {}

    def _read_fd(self, n):
        import os

        try:
            return os.read(self._fd, n)
        except BlockingIOError:
            return b""

    def close(self):
        if self._owns_fd:
            import os

            os.close(self._fd)
            self._owns_fd = False

    def _drain(self):
        import struct

        while True:
            buf = self._read(_JS_EVENT_SIZE)
            if not buf or len(buf) < _JS_EVENT_SIZE:
                break
            _, value, etype, number = struct.unpack(_JS_EVENT_FMT, buf)
            kind = etype & ~JS_EVENT_INIT
            if kind == JS_EVENT_AXIS:
                self._axes[number] = value
            elif kind == JS_EVENT_BUTTON:
                self._buttons[number] = value

    def poll(self, t: float) -> msgs.JoystickValues:
        self._drain()

        def axis(n):
            return self._axes.get(n, 0) / float(1 << 15) * XBOX_SIGNS[n]

        msg = msgs.JoystickValues(
            header=msgs.Header(stamp=t),
            axes=(axis(XBOX_AXIS_THRUST), axis(XBOX_AXIS_YAW),
                  axis(XBOX_AXIS_PITCH), axis(XBOX_AXIS_ROLL)),
        )
        for number, attr in XBOX_BUTTONS.items():
            setattr(msg, attr, int(bool(self._buttons.get(number, 0))))
        return msg


def publish_loop(bus, joystick, duration_s, dt=1.0 / RATE_HZ, topic="joystick_values"):
    """Pump joystick_values onto a TopicBus at 100 Hz of *sim* time."""
    t = 0.0
    n = int(duration_s / dt)
    for _ in range(n):
        t += dt
        bus.publish(topic, joystick.poll(t))
