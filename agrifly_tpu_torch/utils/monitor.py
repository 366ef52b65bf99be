"""Vehicle monitor: terminal dashboard with topic-rate health bands.

Host CLI equivalent of AIFS_ROS/hiperlab_rostools/src/VehicleMonitor
(VehicleMonitor.cpp:32-53): tracks per-vehicle message rates against the
reference acceptance bands (mocap 195-205 Hz, cmd 45-55 Hz, telemetry
50-170 Hz), battery voltage, panic reason and warning bits, and renders a
colored status table. Subscribes to a TopicBus (io.bridge), so it monitors
the simulator exactly like the ROS node monitors topics.

A copy of `agrifly_tpu/utils/monitor.py` on the port's `models/logic`
(tests/test_torch_host_copies.py holds the two equal).
"""

from __future__ import annotations

import collections
import time
from typing import Dict

from agrifly_tpu_torch.models import logic as onboard

# acceptance bands (VehicleMonitor.cpp:32-53)
BANDS = {
    "mocap": (195.0, 205.0),
    "cmd": (45.0, 55.0),
    "telemetry": (50.0, 170.0),
    "joystick": (95.0, 105.0),
}

# ANSI colors (Common/Common/Misc/TerminalColors.hpp equivalent)
RESET = "\033[0m"
RED = "\033[31m"
GREEN = "\033[32m"
YELLOW = "\033[33m"


def colorize(text, ok, warn=False):
    if ok:
        return f"{GREEN}{text}{RESET}"
    return f"{YELLOW}{text}{RESET}" if warn else f"{RED}{text}{RESET}"


class RateTracker:
    """Sliding-window message rate estimate."""

    def __init__(self, window=1.0):
        self.window = window
        self.stamps = collections.deque()

    def tick(self, t=None):
        t = time.monotonic() if t is None else t
        self.stamps.append(t)
        self._trim(t)

    def rate(self, now=None):
        now = time.monotonic() if now is None else now
        self._trim(now)
        return len(self.stamps) / self.window

    def _trim(self, now):
        while self.stamps and self.stamps[0] < now - self.window:
            self.stamps.popleft()


class VehicleMonitor:
    """Aggregates one vehicle's health from bridge topics."""

    def __init__(self, bus, vehicle_id, use_sim_time=True):
        self.vehicle_id = vehicle_id
        self.use_sim_time = use_sim_time
        self.rates: Dict[str, RateTracker] = {
            k: RateTracker() for k in ("mocap", "cmd", "telemetry")
        }
        self.batt_voltage = float("nan")
        self.panic_reason = 0
        self.warnings = 0
        self.last_seen = None
        bus.subscribe(f"mocap_output{vehicle_id}", self._on("mocap"))
        bus.subscribe(f"telemetry{vehicle_id}", self._on_telemetry)
        bus.subscribe(f"radio_command{vehicle_id}", self._on("cmd"))

    def _now(self, msg):
        return msg.header.stamp if self.use_sim_time else None

    def _on(self, name):
        def cb(msg):
            t = self._now(msg)
            self.rates[name].tick(t)
            self.last_seen = t
        return cb

    def _on_telemetry(self, msg):
        t = self._now(msg)
        self.rates["telemetry"].tick(t)
        self.panic_reason = int(msg.panicReason)
        self.warnings = int(msg.warnings)
        self.last_seen = t

    def status(self, now=None):
        out = {}
        for k, tr in self.rates.items():
            r = tr.rate(now)
            lo, hi = BANDS[k]
            out[k] = (r, lo <= r <= hi)
        out["panic"] = (
            onboard.PANIC_REASON_NAMES.get(self.panic_reason, "?"),
            self.panic_reason == 0,
        )
        out["warnings"] = (self.warnings, self.warnings == 0)
        return out

    def render(self, now=None):
        st = self.status(now)
        parts = [f"veh {self.vehicle_id:3d}"]
        for k in ("mocap", "cmd", "telemetry"):
            r, ok = st[k]
            parts.append(colorize(f"{k}:{r:6.1f}Hz", ok))
        name, ok = st["panic"]
        parts.append(colorize(f"panic:{name}", ok))
        w, ok = st["warnings"]
        parts.append(colorize(f"warn:{w:#04x}", ok, warn=True))
        return "  ".join(parts)


class JoystickMonitor:
    """The VehicleMonitor node's joystick companion (JoystickMonitor.cpp):
    tracks the `joystick_values` rate against the 95-105 Hz band and
    renders 'No joystick!' when nothing has been heard in the window."""

    def __init__(self, bus, use_sim_time=True):
        self.use_sim_time = use_sim_time
        self.tracker = RateTracker()
        self.seen = False
        bus.subscribe("joystick_values", self._on)

    def _on(self, msg):
        self.seen = True
        self.tracker.tick(msg.header.stamp if self.use_sim_time else None)

    def status(self, now=None):
        r = self.tracker.rate(now)
        lo, hi = BANDS["joystick"]
        return r, self.seen and r > 0, lo <= r <= hi

    def render(self, now=None):
        r, seen, ok = self.status(now)
        if not seen or r == 0:
            return colorize("  No joystick!", False)
        return "  JS @" + colorize(f"{int(0.5 + r):3d}", ok) + "Hz"


class FleetMonitor:
    """Scans vehicle IDs like the reference's main (ids 1..50)."""

    def __init__(self, bus, ids=range(1, 51), use_sim_time=True):
        self.monitors = {i: VehicleMonitor(bus, i, use_sim_time) for i in ids}

    def render(self, now=None, active_only=True):
        lines = []
        for i, m in sorted(self.monitors.items()):
            if active_only and m.last_seen is None:
                continue
            lines.append(m.render(now))
        return "\n".join(lines) if lines else "(no vehicles seen)"
