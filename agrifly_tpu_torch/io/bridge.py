"""Host-side topic bridge: stream the simulator over the AIFS_ROS schema.

Port of `agrifly_tpu/io/bridge.py`. It plays the role of the reference's ROS
simulator node (AIFS_ROS/hiperlab_rostools/src/Simulator/main.cpp:163-234 +
publish loop): a pub/sub bus without the ROS dependency — register python
callbacks per topic (a rospy adapter can forward them 1:1), drive the sim
tick by tick, and messages are published at the reference cadences:

    simulator_truth  500 Hz     mocap_output  200 Hz
    gps_output       100 Hz     imu_output    500 Hz
    telemetry        100 Hz     estimator_output 100 Hz

Incoming radio_command messages are queued and injected into the sim's
delay line, exactly like the node's radio-command subscriber.

The sim runs where its params are: on the card (the default of
`env.make_params` / `orchard_env.make_params`, which raise without one) or on
the CPU (params built with `device="cpu"`). SimBridge's ticks and blocks run
`cuda_rollout.tick_block`: on the card one launch of the env rollout
kernel's wire-row instance a tick (`tick`) or a block, where the JAX package
runs one jit call a tick and one lax.scan under jit a block. On the CPU
`tick` runs `env.step` (plain torch; `tick_plain`, which is also the card
tick's plain version) and a block `tick_block_plain`. `OrchardBridge`
flies `orchard_env.fly_diag` (the raycast or mesh kernel, the inflation
kernel and the tick kernel on the card) and renders its image topics through
the same batch wrappers as the frame (the depth kernel and the RGB kernel).

Randomness: the port's states carry no PRNG key. Each bridge owns a
`torch.Generator` on the params' device, seeded from `seed`; a `draws`
callable can supply the noise instead, and for an env with a UWB network a
`uwb_draws` callable the network's draws (the parity tests feed the JAX
package's draws through them). The per-tick and the blocked paths consume
the same draws in the same order.

A blocked dispatch (`SimBridge._dispatch_tick_block`,
`OrchardBridge._dispatch_block`) reads nothing back to the host: it queues
the block's work, which writes each tick's or frame's row into one float32
matrix on the device, and starts one copy of it to pinned host memory,
recording a CUDA event after it. The publish waits on that event, so a paced loop
publishes block k-1 while block k computes.
"""

from __future__ import annotations

import collections
import math
import types
from typing import Callable, Dict, List

import numpy as np
import torch

from agrifly_tpu_torch.io import messages as msgs
from agrifly_tpu_torch.io import radio as radio_codec
from agrifly_tpu_torch.io import telemetry as tel_codec
from agrifly_tpu_torch.ops import filters
from agrifly_tpu_torch.ops import rotation as rot_ops
from agrifly_tpu_torch.sim import cuda_rollout, delayline, env as env_mod
from agrifly_tpu_torch.sim import uwb as uwb_mod

RATE_TRUTH = 500
RATE_MOCAP = 200
RATE_GPS = 100
RATE_IMU = 500
RATE_TELEMETRY = 100
RATE_ESTIMATOR = 100
RATE_ODOMETRY = 250
RATE_CMD = 50  # offboard command stream (vehicle_monitor band 45-55 Hz)

NOISE_CHUNK = 64  # ticks of draws a SimBridge takes from its generator at once

# per-element (a, b) range vectors for quantizing one whole telemetry row
# in a single wire_quantize_np call: [acc3, gyro3, forces4, pos3, batt1,
# vel3, att3, debug6] (the PT1+PT2 payload layout, io/telemetry.py)
_TEL_ROW_RANGES = tuple(
    np.array(
        [tel_codec.RANGE_ACC[i]] * 3 + [tel_codec.RANGE_GYRO[i]] * 3
        + [tel_codec.RANGE_FORCE[i]] * 4 + [tel_codec.RANGE_POS[i]] * 3
        + [tel_codec.RANGE_BATT[i]] + [tel_codec.RANGE_VEL[i]] * 3
        + [tel_codec.RANGE_ATT[i]] * 3 + [tel_codec.RANGE_GENERIC[i]] * 6,
        np.float64)
    for i in (0, 1))


class TopicBus:
    """Minimal in-process pub/sub."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = collections.defaultdict(list)
        self._wildcard: List[Callable] = []
        self.counts: Dict[str, int] = collections.defaultdict(int)

    def subscribe(self, topic: str, cb: Callable):
        self._subs[topic].append(cb)

    def subscribe_all(self, cb: Callable):
        """cb(topic, msg) for every publish on any topic (recorder hook)."""
        self._wildcard.append(cb)

    def publish(self, topic: str, msg):
        self.counts[topic] += 1
        for cb in self._subs[topic]:
            cb(msg)
        for cb in self._wildcard:
            cb(topic, msg)


def _ypr_np(q):
    """Host-numpy 3-2-1 euler (rot_ops.to_euler_ypr convention) for the
    row-publishing paths, which publish from host rows."""
    w, x, y, z = (float(v) for v in np.asarray(q, np.float64).reshape(-1)[:4])
    yaw = math.atan2(2 * x * y + 2 * w * z, x * x + w * w - z * z - y * y)
    pitch = -math.asin(max(-1.0, min(1.0, 2 * x * z - 2 * w * y)))
    roll = math.atan2(2 * y * z + 2 * w * x, z * z - y * y - x * x + w * w)
    return yaw, pitch, roll


def _angles_f64(quats, vector_parts=()):
    """SimBridge's blocks' euler angles, float64 on the host (_ypr_np):
    (yaw, pitch, roll) of each quaternion, then of each attitude rebuilt
    from its vector part (w >= 0)."""
    rebuilt = [[math.sqrt(max(0.0, 1.0 - float(v @ v))), *v] for v in vector_parts]
    return [_ypr_np(q) for q in list(quats) + rebuilt]


def _angles_f32(quats, vector_parts=()):
    """_angles_f64's angles as SimBridge's ticks take them: rot_ops.to_euler_ypr
    (and rot_ops.from_vector_part) in float32 on CPU tensors, in one call,
    so a card tick publishes the values its plain version computes on the
    card (the plain tick rounds alike on the card and the CPU)."""
    q = torch.tensor(np.array(quats), dtype=torch.float32).reshape(-1, 4)
    if len(vector_parts):
        v = torch.tensor(np.array(vector_parts), dtype=torch.float32)
        q = torch.cat([q, rot_ops.from_vector_part(v)])
    return torch.stack(rot_ops.to_euler_ypr(q), dim=-1).double().tolist()


# Blocked-tick wire row layout (SimBridge._dispatch_tick_block): one f32
# row per tick carries everything the per-tick publisher reads from the
# state, so a whole block crosses to the host as ONE (n, 64) matrix.
# Telemetry rides as its RAW u16 codes (exact in f32) and is decoded
# host-side with the same f32 arithmetic as io/telemetry.decode.
_TB_POS = slice(0, 3)
_TB_VEL = slice(3, 6)
_TB_ATT = slice(6, 10)
_TB_ANGVEL = slice(10, 13)
_TB_ACCF = slice(13, 16)
_TB_GYROF = slice(16, 19)
_TB_VELB = slice(19, 22)
_TB_MPOS = slice(22, 25)
_TB_MVEL = slice(25, 28)
_TB_MATT = slice(28, 32)
_TB_MANGVEL = slice(32, 35)
_TB_TELNUM = 35
_TB_TELD1 = slice(36, 50)
_TB_TELD2 = slice(50, 64)
_TB_COLS = 64


def _tel_from_codes_np(codes, rng):
    """Host-side io/telemetry.decode for one field group: u16 codes ->
    floats with the device's exact f32 arithmetic (decode_ones then
    _from_ones), widened to f64 only at the end like the per-tick
    publisher's np.asarray(dec.x, np.float64)."""
    codes = np.asarray(codes).astype(np.int32)
    val = np.where(codes == 0, np.float32(np.nan),
                   (codes.astype(np.float32) - np.float32(32768.0))
                   / np.float32(32768.0)).astype(np.float32)
    a, b = rng
    out = (((val + np.float32(1.0)) / np.float32(2.0))
           * np.float32(b - a) + np.float32(a))
    return out.astype(np.float64)


def _to_host(mat: torch.Tensor):
    """Start one copy of a device matrix to the host: (host tensor, event).
    On the card the copy goes to pinned memory without blocking the host,
    and the event is recorded after it; on the CPU the matrix is the host
    copy (event None)."""
    if not mat.is_cuda:
        return mat, None
    host = torch.empty(mat.shape, dtype=mat.dtype, pin_memory=True)
    host.copy_(mat, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _to_device(mask, device):
    """A host bool mask as an int8 tensor on `device`; on the card copied
    from pinned memory without blocking the host."""
    host = torch.from_numpy(np.asarray(mask, np.int8))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _host_numpy(host: torch.Tensor, event):
    """Wait for a _to_host copy and return its numpy view."""
    if event is not None:
        event.synchronize()
    return host.numpy()


def _read_back(named: dict) -> dict:
    """Named device tensors read back in ONE transfer: float64 numpy
    arrays of their values (the integers among them exact in float32)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in named.values()])
    host = flat.cpu().numpy().astype(np.float64)
    sizes = [t.numel() for t in named.values()]
    return dict(zip(named, np.split(host, np.cumsum(sizes)[:-1])))


def _radio_tensors(raw: bytes, device):
    """A radio packet's (type, flags, fields) as int32 tensors on `device`."""
    mtype, mflags, fields = radio_codec.bytes_to_fields(raw)
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(mtype, **i32), torch.tensor(mflags, **i32),
            torch.tensor(np.asarray(fields, np.int32), **i32))


def _push_radio(ring, step, raw: bytes):
    """The ring with one received radio packet pushed at `step`."""
    mtype, mflags, fields = _radio_tensors(raw, ring.count.device)
    return delayline.push(ring, mtype, mflags, fields, step,
                          torch.ones((), dtype=torch.bool, device=ring.count.device))


class SimBridge:
    """Drives one vehicle's env and publishes the topic schema.

    draws: None (the bridge's generator, seeded from `seed`, draws the IMU
    noise) or a callable draws(n) that returns the next n ticks' (n, 2, 3)
    float32 unit normals (gyro, then acc). uwb_draws: where the params have
    a UWB network (`env.with_uwb_anchors`), None (the generator draws them)
    or a callable uwb_draws(n) that returns the next n ticks' (n, 4) float32
    draws in `sim/uwb.py`'s order (u_outlier, n_outlier, n_noise, u_fail).

    On the card `tick` is one launch of the env rollout kernel's wire-row
    instance (`cuda_rollout.tick_block` over one tick) and one read of its
    row, and it raises where the launch does; `tick_plain` is its plain
    version (`env.step`), which `tick` runs on the CPU."""

    def __init__(self, params: env_mod.EnvParams, vehicle_id=1, seed=0,
                 use_estimator=True, bus: TopicBus | None = None, draws=None,
                 uwb_draws=None):
        self.params = params
        self.vehicle_id = int(vehicle_id)
        self.bus = bus if bus is not None else TopicBus()
        self._use_estimator = use_estimator
        self._dev = params.dt_us.device
        self._dt_us = int(params.dt_us)
        self._draws = draws
        self._uwb_draws = uwb_draws
        self._gen = torch.Generator(device=self._dev).manual_seed(int(seed))
        self._noise_buf = torch.empty((0, 2, 3), device=self._dev)
        self._uwb_buf = torch.empty((0, uwb_mod.N_DRAWS), device=self._dev)
        if self._dev.type == "cuda":
            # the card tick's telemetry masks (fire / not) and its row's host copy
            self._tick_fire = [torch.full((1,), f, dtype=torch.int8, device=self._dev)
                               for f in (0, 1)]
            self._tick_row = torch.empty((1, cuda_rollout.ROW_WORDS), pin_memory=True)
        self.state = env_mod.init_state(params)
        self._pending_radio: collections.deque = collections.deque()
        self._accum = {k: 0 for k in
                       ("mocap", "gps", "telemetry", "estimator", "odometry")}
        self._init_pos = self.state.plant.pos.cpu().numpy().astype(np.float64)
        self.t_us = 0
        self.bus.subscribe(f"radio_command{self.vehicle_id}", self._on_radio)

    @property
    def state(self) -> env_mod.EnvState:
        """The live EnvState, on the params' device."""
        return self._state

    @state.setter
    def state(self, s):
        self._state = s

    # ---- subscribers ----
    def _on_radio(self, msg: msgs.RadioCommand):
        self._pending_radio.append(msg.raw[: radio_codec.RAW_PACKET_SIZE])

    def _inject_radio(self):
        """Push the received radio commands into the sim's delay line."""
        while self._pending_radio:
            raw = self._pending_radio.popleft()
            s = self.state
            self.state = s._replace(ring=_push_radio(s.ring, s.step, raw))

    def _noise(self, n: int):
        """The next n ticks' IMU unit normals (n, 2, 3) and, where the params
        have a UWB network, its draws (n, 4) (else None), on the device. The
        generator draws NOISE_CHUNK ticks at a time, the noise and then the
        network's draws (`uwb.draw`), and the two buffers are taken in step,
        so a tick and a block take the same values in the same order; a
        hook's values replace the generator's."""
        uwb = self.params.uwb is not None
        if self._draws is None or (uwb and self._uwb_draws is None):
            while self._noise_buf.shape[0] < n:
                more = torch.randn((NOISE_CHUNK, 2, 3), generator=self._gen, device=self._dev)
                self._noise_buf = torch.cat([self._noise_buf, more])
                if uwb:
                    more = uwb_mod.draw((NOISE_CHUNK,), self._gen, self._dev)
                    self._uwb_buf = torch.cat([self._uwb_buf, more])
            noise, self._noise_buf = self._noise_buf[:n], self._noise_buf[n:]
            draws, self._uwb_buf = self._uwb_buf[:n], self._uwb_buf[n:]
        if self._draws is not None:
            noise = torch.as_tensor(self._draws(n), dtype=torch.float32).to(self._dev)
        if not uwb:
            return noise, None
        if self._uwb_draws is not None:
            draws = torch.as_tensor(self._uwb_draws(n), dtype=torch.float32).to(self._dev)
        return noise, draws

    # ---- main loop ----
    def run(self, n_steps: int, cmd: env_mod.Command):
        for _ in range(n_steps):
            self.tick(cmd)

    def run_realtime(self, duration_s: float, cmd: env_mod.Command,
                     rate_hz: float = 500.0, block: int = 5,
                     on_quantum: Callable | None = None,
                     device_blocks: bool = False):
        """Wall-clock-paced sim loop — the reference's real-time simulator
        node (HardwareTimer + ros::Rate(500), AIFS_ROS/hiperlab_rostools/
        src/Simulator/main.cpp:231,310), vs. the step-indexed lockstep
        default (sync_simulator).

        Runs `block` ticks per scheduling quantum, then sleeps until the
        ABSOLUTE deadline t0 + k*block/rate_hz — drift-free like
        ros::Rate / Timer::AdjustTimeBySeconds: a late quantum shortens
        the next sleep instead of shifting every later deadline. Topic
        cadences ride sim time (unchanged), so at rate_hz=500 the wire
        rates hit the vehicle_monitor health bands in wall time too; at a
        reduced rate they scale by rate_hz/nominal.

        `cmd` may be a Command or a zero-arg callable returning one
        (re-read each tick — the teleop hook can retarget mid-run).
        `on_quantum(bridge, k)` runs after each quantum's ticks (before
        the sleep) — the hook for teleop polling / live monitor rendering
        at operator rates.

        device_blocks=True queues each quantum's `block` ticks as one
        device block (_dispatch_tick_block) and publishes from its stacked
        wire rows, pipelined one quantum deep (quantum k publishes block
        k-1 while block k computes). Consequences: cmd is re-read per
        QUANTUM (not per tick), the topic surface lags one quantum, and an
        injected radio command lands at most two quanta later — bounded,
        and analogous in kind to the reference's own transport latency
        (30 ms radio wire + ROS queues).

        Returns a report dict: achieved tick rate, lateness stats, and
        wall-clock topic rates with in-band checks (utils/monitor.BANDS,
        scaled to the requested rate).
        """
        import time as _time

        block = max(1, int(block))
        period = block / float(rate_hz)
        nominal_hz = 1e6 / float(self._dt_us)
        scale = float(rate_hz) / nominal_hz

        get_cmd = cmd if callable(cmd) else (lambda: cmd)
        if device_blocks:
            return self._run_realtime_blocked(
                duration_s, get_cmd, float(rate_hz), block, on_quantum,
                scale)
        # warm the tick outside the paced region (these are still real sim
        # ticks — the reference node similarly only promises its rate once
        # running). Every publish cadence fires within 10 ticks (slowest
        # are the 100 Hz telemetry/estimator paths, every 5th tick at dt=2
        # ms), so 10 warm ticks run every branch.
        for _ in range(10):
            self.tick(get_cmd())
        # warm the radio-injection path too (discarded: no state change)
        _push_radio(self.state.ring, self.state.step,
                    bytes(radio_codec.RAW_PACKET_SIZE))
        counts0 = dict(self.bus.counts)
        n_quanta = max(1, int(round(duration_s * rate_hz / block)))
        late = 0
        max_late = 0.0
        t0 = _time.perf_counter()
        for k in range(1, n_quanta + 1):
            for _ in range(block):
                self.tick(get_cmd())
            if on_quantum is not None:
                on_quantum(self, k)
            deadline = t0 + k * period
            now = _time.perf_counter()
            if now < deadline:
                _time.sleep(deadline - now)
            else:
                late += 1
                max_late = max(max_late, now - deadline)
        wall = _time.perf_counter() - t0
        ticks = n_quanta * block
        return self._realtime_report(ticks, wall, float(rate_hz), late,
                                     n_quanta, max_late, scale, counts0)

    def _realtime_report(self, ticks, wall, rate_hz, late, n_quanta,
                         max_late, scale, counts0):
        from agrifly_tpu_torch.utils import monitor as monitor_mod

        vid = self.vehicle_id
        topic_hz = {}
        for name, topic in (("mocap", f"mocap_output{vid}"),
                            ("telemetry", f"telemetry{vid}"),
                            ("cmd", f"radio_command{vid}"),
                            ("truth", f"simulator_truth{vid}"),
                            ("imu", f"imu_output{vid}"),
                            ("gps", f"gps_output{vid}")):
            topic_hz[name] = (self.bus.counts.get(topic, 0)
                              - counts0.get(topic, 0)) / wall
        bands_ok = {}
        for name in ("mocap", "telemetry", "cmd"):
            lo, hi = monitor_mod.BANDS[name]
            r = topic_hz[name]
            if name == "cmd" and r == 0.0:
                continue  # no commander attached — band not applicable
            bands_ok[name] = bool(lo * scale <= r <= hi * scale)
        return {
            "ticks": ticks,
            "wall_s": wall,
            "target_tick_hz": rate_hz,
            "achieved_tick_hz": ticks / wall,
            "late_quanta": late,
            "n_quanta": n_quanta,
            "max_late_s": max_late,
            "rate_scale": scale,
            "topic_hz": topic_hz,
            "bands_ok": bands_ok,
        }

    def _run_realtime_blocked(self, duration_s, get_cmd, rate_hz, block,
                              on_quantum, scale):
        """run_realtime's device-block path: `block` ticks per dispatch,
        pipelined one quantum deep (see run_realtime's docstring). Split
        out so the paced loop stays free of per-tick host dispatch."""
        import time as _time

        period = block / rate_hz
        # warm outside the paced region: one full dispatch+publish round
        # (real ticks) and the radio push, discarded (no state change)
        self._publish_tick_block(self._dispatch_tick_block(block, get_cmd()))
        _push_radio(self.state.ring, self.state.step,
                    bytes(radio_codec.RAW_PACKET_SIZE))
        counts0 = dict(self.bus.counts)
        n_quanta = max(1, int(round(duration_s * rate_hz / block)))
        late = 0
        max_late = 0.0
        pending = None
        t0 = _time.perf_counter()
        for k in range(1, n_quanta + 1):
            if pending is not None:
                self._publish_tick_block(pending)  # block k-1's topics
            pending = self._dispatch_tick_block(block, get_cmd())
            if on_quantum is not None:
                on_quantum(self, k)
            deadline = t0 + k * period
            now = _time.perf_counter()
            if now < deadline:
                _time.sleep(deadline - now)
            else:
                late += 1
                max_late = max(max_late, now - deadline)
        self._publish_tick_block(pending)  # the final in-flight block
        wall = _time.perf_counter() - t0
        return self._realtime_report(n_quanta * block, wall, rate_hz, late,
                                     n_quanta, max_late, scale, counts0)

    def run_blocked(self, n_steps: int, cmd: env_mod.Command,
                    block: int = 10):
        """run() with `block` ticks per dispatch (synced — each block's
        rows are read and published before the next dispatch): one read of
        the device a block instead of one a tick."""
        done = 0
        while done < n_steps:
            b = min(block, n_steps - done)
            self._publish_tick_block(self._dispatch_tick_block(b, cmd))
            done += b

    def _fire_schedule(self, n: int):
        """Advance the cadence accumulators by n ticks on the host (each
        topic fires on the tick its accumulator passes its period, which is
        then subtracted), returning one bool fire mask per topic."""
        dt = self._dt_us
        out = {}
        for name, rate in (("mocap", RATE_MOCAP), ("gps", RATE_GPS),
                           ("odometry", RATE_ODOMETRY),
                           ("telemetry", RATE_TELEMETRY),
                           ("estimator", RATE_ESTIMATOR)):
            period = 10 ** 6 // rate
            acc = self._accum[name]
            f = np.zeros(n, np.bool_)
            for i in range(n):
                acc += dt
                if acc > period:
                    acc -= period
                    f[i] = True
            self._accum[name] = acc
            out[name] = f
        return out

    @torch.inference_mode()
    def _dispatch_tick_block(self, n: int, cmd: env_mod.Command):
        """Inject pending radio commands, then queue one n-tick block:
        `cuda_rollout.tick_block`, one launch of the env rollout kernel's
        wire-row instance on the card (its plain version, the SAME env.step
        tick_plain() runs, on the CPU), each tick's wire row (_TB_* layout) built
        on the device. The telemetry encode runs on the ticks the host-known
        fire mask selects, so the logic-state mutation — packet counter
        advance, warnings clear — happens at exactly the per-tick path's
        points. The (n, 64) rows start one copy to the host; nothing is
        read back. Returns an opaque pending record for _publish_tick_block
        (the split lets a paced loop publish block k-1 while block k
        computes)."""
        self._inject_radio()
        fires = self._fire_schedule(n)
        noise, draws = self._noise(n)
        self.state, rows = cuda_rollout.tick_block(
            self.params, self.state, cmd, noise, _to_device(fires["telemetry"], self._dev),
            self._use_estimator, uwb_draws=draws)
        host, event = _to_host(rows)
        t_us0 = self.t_us
        self.t_us += n * self._dt_us
        return (n, host, event, fires, t_us0)

    def _publish_tick_block(self, pending, angles=_angles_f64):
        """Wait for a dispatched tick block's row matrix (ONE transfer) and
        publish every tick's topic set — message-for-message what n
        calls of tick_plain() publish, with host-side euler/telemetry decode
        (same f32 wire arithmetic; see _tel_from_codes_np). The euler
        angles: `angles` (float64 for a block; the card tick's
        _angles_f32)."""
        n, host, event, fires, t_us0 = pending
        mat = _host_numpy(host, event)
        dt_us = self._dt_us
        vid = self.vehicle_id
        for i in range(n):
            r = mat[i].astype(np.float64)
            t = (t_us0 + (i + 1) * dt_us) * 1e-6
            pos = r[_TB_POS]
            att = r[_TB_ATT]
            angvel = r[_TB_ANGVEL]
            est = [r[_TB_MATT]] if fires["estimator"][i] else []
            tel = ([_tel_from_codes_np(r[_TB_TELD2][3:6], tel_codec.RANGE_ATT)]
                   if fires["telemetry"][i] else [])
            ypr = angles([att] + est, tel)
            yaw, pitch, roll = ypr[0]
            vel = r[_TB_VEL]
            self.bus.publish(
                f"simulator_truth{vid}",
                msgs.SimulatorTruth(
                    header=msgs.Header(stamp=t), vehicleID=vid,
                    posx=pos[0], posy=pos[1], posz=pos[2],
                    velx=vel[0], vely=vel[1], velz=vel[2],
                    attyaw=yaw, attpitch=pitch, attroll=roll,
                    attq0=att[0], attq1=att[1], attq2=att[2], attq3=att[3],
                    angvelx=angvel[0], angvely=angvel[1],
                    angvelz=angvel[2],
                ),
            )
            acc_f = r[_TB_ACCF]
            gyro_f = r[_TB_GYROF]
            self.bus.publish(
                f"imu_output{vid}",
                msgs.ImuOutput(
                    header=msgs.Header(stamp=t), vehicleID=vid,
                    accmeasx=acc_f[0], accmeasy=acc_f[1], accmeasz=acc_f[2],
                    gyromeasx=gyro_f[0], gyromeasy=gyro_f[1],
                    gyromeasz=gyro_f[2],
                ),
            )
            if fires["mocap"][i]:
                self.bus.publish(
                    f"mocap_output{vid}",
                    msgs.MocapOutput(
                        header=msgs.Header(stamp=t), vehicleID=vid,
                        posx=pos[0], posy=pos[1], posz=pos[2],
                        attyaw=yaw, attpitch=pitch, attroll=roll,
                        attq0=att[0], attq1=att[1], attq2=att[2],
                        attq3=att[3],
                    ),
                )
            if fires["gps"][i]:
                self.bus.publish(
                    f"gps_output{vid}",
                    msgs.GpsOutput(
                        header=msgs.Header(stamp=t), vehicleID=vid,
                        posx=pos[0], posy=pos[1], posz=pos[2],
                    ),
                )
            if fires["odometry"][i]:
                vel_b = r[_TB_VELB]
                rel = pos - self._init_pos
                self.bus.publish(
                    "/camera/t265/odom/sample",
                    msgs.Odometry(
                        header=msgs.Header(stamp=t, frame_id="odom"),
                        child_frame_id="base_link",
                        position=tuple(rel),
                        orientation=(att[0], att[1], att[2], att[3]),
                        linear_B=tuple(vel_b),
                        angular_B=(angvel[0], angvel[1], angvel[2]),
                    ),
                )
            if fires["telemetry"][i]:
                self._publish_telemetry_codes(
                    int(r[_TB_TELNUM]), r[_TB_TELD1].astype(np.int32),
                    r[_TB_TELD2].astype(np.int32), t, ypr[-1])
            if fires["estimator"][i]:
                e_pos = r[_TB_MPOS]
                e_vel = r[_TB_MVEL]
                e_att = r[_TB_MATT]
                e_av = r[_TB_MANGVEL]
                ey, ep, er = ypr[1]
                self.bus.publish(
                    f"estimator{vid}",
                    msgs.EstimatorOutput(
                        header=msgs.Header(stamp=t), vehicleID=vid,
                        posx=e_pos[0], posy=e_pos[1], posz=e_pos[2],
                        velx=e_vel[0], vely=e_vel[1], velz=e_vel[2],
                        attyaw=ey, attpitch=ep, attroll=er,
                        attq0=e_att[0], attq1=e_att[1], attq2=e_att[2],
                        attq3=e_att[3],
                        angvelx=e_av[0], angvely=e_av[1], angvelz=e_av[2],
                    ),
                )

    def _publish_telemetry_codes(self, num, d1, d2, t, ypr):
        """One telemetry message from raw wire codes — field-for-field
        tick_plain()'s encode_from_logic + decode publish, decoded
        host-side; `ypr`: the euler angles of the attitude rebuilt from the
        wire's vector part (w >= 0), as the reference publisher takes them
        (SyncSimulator:595-602)."""
        vid = self.vehicle_id
        accel = _tel_from_codes_np(d1[0:3], tel_codec.RANGE_ACC)
        gyro = _tel_from_codes_np(d1[3:6], tel_codec.RANGE_GYRO)
        forces = _tel_from_codes_np(d1[6:10], tel_codec.RANGE_FORCE)
        position = _tel_from_codes_np(d1[10:13], tel_codec.RANGE_POS)
        batt = _tel_from_codes_np(d1[13:14], tel_codec.RANGE_BATT)[0]
        velocity = _tel_from_codes_np(d2[0:3], tel_codec.RANGE_VEL)
        att_v = _tel_from_codes_np(d2[3:6], tel_codec.RANGE_ATT)
        debug = _tel_from_codes_np(d2[6:12], tel_codec.RANGE_GENERIC)
        self.bus.publish(
            f"telemetry{vid}",
            msgs.Telemetry(
                header=msgs.Header(stamp=t), vehicleID=vid,
                type=tel_codec.PACKET_TYPE_PT1, packetNumber=int(num),
                accelerometer=tuple(accel), rateGyro=tuple(gyro),
                position=tuple(position), attitude=tuple(att_v),
                velocity=tuple(velocity),
                attitudeYPR=tuple(float(x) for x in ypr),
                motorForces=tuple(forces), debugVals=tuple(debug),
                batteryVoltage=float(batt),
                panicReason=int(d2[12]), warnings=int(d2[13]),
            ),
        )

    @torch.inference_mode()
    def tick(self, cmd: env_mod.Command):
        """One tick and its topics. On the card: the pending radio commands
        injected, the cadences decided on the host, one launch of the wire-row
        instance (`cuda_rollout.tick_block` over one tick; it raises where
        the launch does), the tick's row read in one transfer (the tick's
        one synchronizing call) into pinned memory kept for it, and the
        topics published from the row as `tick_plain` publishes them. On
        the CPU: `tick_plain`."""
        if self._dev.type != "cuda":
            return self.tick_plain(cmd)
        self._inject_radio()
        fires = self._fire_schedule(1)
        noise, draws = self._noise(1)
        self.state, rows = cuda_rollout.tick_block(
            self.params, self.state, cmd, noise, self._tick_fire[int(fires["telemetry"][0])],
            self._use_estimator, uwb_draws=draws)
        self._tick_row.copy_(rows)
        t_us0 = self.t_us
        self.t_us += self._dt_us
        self._publish_tick_block((1, self._tick_row, None, fires, t_us0), _angles_f32)

    @torch.inference_mode()
    def tick_plain(self, cmd: env_mod.Command):
        """`tick`'s plain version: `env.step` (plain torch), the telemetry
        encoded and decoded where it fires, the tick's values read back in
        one transfer, on any device."""
        # inject externally received radio commands into the delay line
        self._inject_radio()
        noise, draws = self._noise(1)
        self.state, out = env_mod.step(self.params, self.state, cmd, self._use_estimator,
                                       noise=noise[0],
                                       uwb_draws=None if draws is None else draws[0])
        dt_us = self._dt_us
        self.t_us += dt_us
        t = self.t_us * 1e-6
        vid = self.vehicle_id
        # the cadences are host counters: decide them first, then read the
        # tick's values back in ONE transfer
        fire = {name: bool(f[0]) for name, f in self._fire_schedule(1).items()}
        logic = self.state.logic
        vals = dict(pos=out.pos, vel=out.vel, att=out.att, angvel=out.angvel,
                    ypr=torch.stack(rot_ops.to_euler_ypr(out.att)),
                    acc_f=filters.lp2_value(logic.acc_lp),
                    gyro_f=filters.lp2_value(logic.gyro_lp))
        if fire["odometry"]:
            vals["vel_b"] = rot_ops.rotate_back(out.att, out.vel)
        if fire["telemetry"]:
            pkts, new_logic = tel_codec.encode_from_logic(logic)
            self.state = self.state._replace(logic=new_logic)
            dec = tel_codec.decode(pkts)
            vals.update({"tel_" + k: v for k, v in dec._asdict().items()})
            vals["tel_num"] = pkts.packet_number
            # YPR rebuilt from the wire attitude's vector part, exactly like
            # the reference publisher (SyncSimulator/main.cpp:595-602)
            vals["tel_ypr"] = torch.stack(rot_ops.to_euler_ypr(
                rot_ops.from_vector_part(dec.attitude)))
        if fire["estimator"]:
            m = self.state.mocap
            vals.update(e_pos=m.pos, e_vel=m.vel, e_att=m.att, e_av=m.angvel,
                       e_ypr=torch.stack(rot_ops.to_euler_ypr(m.att)))
        h = _read_back(vals)
        pos, vel, att, angvel = h["pos"], h["vel"], h["att"], h["angvel"]
        yaw, pitch, roll = (float(x) for x in h["ypr"])

        # 500 Hz truth + imu
        self.bus.publish(
            f"simulator_truth{vid}",
            msgs.SimulatorTruth(
                header=msgs.Header(stamp=t), vehicleID=vid,
                posx=pos[0], posy=pos[1], posz=pos[2],
                velx=vel[0], vely=vel[1], velz=vel[2],
                attyaw=yaw, attpitch=pitch, attroll=roll,
                attq0=att[0], attq1=att[1], attq2=att[2], attq3=att[3],
                angvelx=angvel[0], angvely=angvel[1], angvelz=angvel[2],
            ),
        )
        acc_f, gyro_f = h["acc_f"], h["gyro_f"]
        self.bus.publish(
            f"imu_output{vid}",
            msgs.ImuOutput(
                header=msgs.Header(stamp=t), vehicleID=vid,
                accmeasx=acc_f[0], accmeasy=acc_f[1], accmeasz=acc_f[2],
                gyromeasx=gyro_f[0], gyromeasy=gyro_f[1], gyromeasz=gyro_f[2],
            ),
        )
        if fire["mocap"]:
            self.bus.publish(
                f"mocap_output{vid}",
                msgs.MocapOutput(
                    header=msgs.Header(stamp=t), vehicleID=vid,
                    posx=pos[0], posy=pos[1], posz=pos[2],
                    attyaw=yaw, attpitch=pitch, attroll=roll,
                    attq0=att[0], attq1=att[1], attq2=att[2], attq3=att[3],
                ),
            )
        if fire["gps"]:
            self.bus.publish(
                f"gps_output{vid}",
                msgs.GpsOutput(
                    header=msgs.Header(stamp=t), vehicleID=vid,
                    posx=pos[0], posy=pos[1], posz=pos[2],
                ),
            )
        if fire["odometry"]:
            # T265-style odometry (Simulator/main.cpp:358-394): pose is
            # relative to the initial position; twist is body-frame.
            self.bus.publish(
                "/camera/t265/odom/sample",
                msgs.Odometry(
                    header=msgs.Header(stamp=t, frame_id="odom"),
                    child_frame_id="base_link",
                    position=tuple(pos - self._init_pos),
                    orientation=(att[0], att[1], att[2], att[3]),
                    linear_B=tuple(h["vel_b"]),
                    angular_B=(angvel[0], angvel[1], angvel[2]),
                ),
            )
        if fire["telemetry"]:
            self.bus.publish(
                f"telemetry{vid}",
                msgs.Telemetry(
                    header=msgs.Header(stamp=t), vehicleID=vid,
                    type=tel_codec.PACKET_TYPE_PT1, packetNumber=int(h["tel_num"][0]),
                    accelerometer=tuple(h["tel_accel"]), rateGyro=tuple(h["tel_gyro"]),
                    position=tuple(h["tel_position"]), attitude=tuple(h["tel_attitude"]),
                    velocity=tuple(h["tel_velocity"]),
                    attitudeYPR=tuple(float(x) for x in h["tel_ypr"]),
                    motorForces=tuple(h["tel_motor_forces"]), debugVals=tuple(h["tel_debug"]),
                    batteryVoltage=float(h["tel_batt_voltage"][0]),
                    panicReason=int(h["tel_panic_reason"][0]),
                    warnings=int(h["tel_warnings"][0]),
                ),
            )
        if fire["estimator"]:
            e_pos, e_vel, e_att, e_av = h["e_pos"], h["e_vel"], h["e_att"], h["e_av"]
            ey, ep, er = (float(x) for x in h["e_ypr"])
            self.bus.publish(
                f"estimator{vid}",
                msgs.EstimatorOutput(
                    header=msgs.Header(stamp=t), vehicleID=vid,
                    posx=e_pos[0], posy=e_pos[1], posz=e_pos[2],
                    velx=e_vel[0], vely=e_vel[1], velz=e_vel[2],
                    attyaw=ey, attpitch=ep, attroll=er,
                    attq0=e_att[0], attq1=e_att[1], attq2=e_att[2], attq3=e_att[3],
                    angvelx=e_av[0], angvely=e_av[1], angvelz=e_av[2],
                ),
            )


class MessageRecorder:
    """rosbag_record_airsim.sh equivalent: record every published message
    to a JSONL file. With topics=None (default) it records bus-wide —
    `rosbag record -a` parity — excluding image topics exactly like the
    script's compressed-image exclusion. Pass record_images=True to keep
    them (byte buffers are base64-encoded in the JSONL)."""

    def __init__(self, bus: TopicBus, path, topics=None,
                 exclude=("depthImage", "rgbImage"), record_images=False):
        import json

        self._json = json
        self._f = open(path, "w")
        self._bus = bus
        self._exclude = () if record_images else tuple(exclude)
        self.count = 0
        if topics is None:
            bus.subscribe_all(self._on_any)
        else:
            for t in topics:
                if not any(x in t for x in self._exclude):
                    self.record_topic(t)

    def _on_any(self, topic, msg):
        if any(x in topic for x in self._exclude):
            return
        self._write(topic, msg)

    @staticmethod
    def _default(o):
        # numpy scalars / 0-d arrays inside message tuples
        if hasattr(o, "item"):
            return o.item()
        if isinstance(o, (bytes, bytearray)):  # image data buffers
            import base64

            return base64.b64encode(bytes(o)).decode("ascii")
        raise TypeError(f"not JSON serializable: {type(o)}")

    def _write(self, topic, msg):
        self.count += 1
        self._f.write(
            self._json.dumps({"topic": topic, "msg": msgs.to_dict(msg)},
                             default=self._default) + "\n"
        )

    def record_topic(self, topic):
        self._bus.subscribe(topic, lambda msg: self._write(topic, msg))

    def close(self):
        self._f.close()


def plan_result_to_diagnostics(res, seed, vel_cam, acc_cam, grav_cam, goal_world,
                               reset_time, stamp) -> msgs.PlannerDiagnostics:
    """PlanResult -> planner_diagnostics message (schema parity with
    QuadRappidsPlannerAndController's publisher)."""
    tr = res.traj
    coeffs = [
        tuple(np.asarray(tr.alpha) / 120.0),
        tuple(np.asarray(tr.beta) / 24.0),
        tuple(np.asarray(tr.gamma) / 6.0),
        tuple(np.asarray(tr.a0) / 2.0),
        tuple(np.asarray(tr.v0)),
        tuple(np.asarray(tr.p0)),
    ]
    return msgs.PlannerDiagnostics(
        header=msgs.Header(stamp=stamp),
        input=msgs.PlannerInput(
            random_seed=int(seed),
            velocity_D=tuple(np.asarray(vel_cam)),
            acceleration_D=tuple(np.asarray(acc_cam)),
            gravity_D=tuple(np.asarray(grav_cam)),
            goal_W=tuple(np.asarray(goal_world)),
        ),
        output=msgs.PlannerOutput(
            trajectory_id=int(seed),
            planner_statistics=msgs.PlannerStatistics(
                trajectory_found=bool(res.found),
                NumCollisionFree=int(res.num_collision_free),
                NumPyramids=int(res.num_pyramids),
                NumVelocityChecks=int(res.num_velocity_admissible),
                NumCollisionChecks=int(res.num_velocity_admissible),
                NumCostChecks=int(res.num_feasible),
                NumTrajectoriesGenerated=int(res.num_candidates),
            ),
            trajectory_parameters_D=msgs.PolynomialTrajectory(
                coeff0=coeffs[0], coeff1=coeffs[1], coeff2=coeffs[2],
                coeff3=coeffs[3], coeff4=coeffs[4], coeff5=coeffs[5],
                duration=float(tr.tf),
            ),
            trajectory_reset_time=float(reset_time),
        ),
    )


def controller_diagnostics(est_pos, est_vel, est_att, traj_id, traj_time,
                           ref_pos, ref_vel, ref_acc, ref_angvel_b,
                           ref_thrust, cmd_angvel_b, cmd_thrust, batt,
                           stamp, desired_yaw=0.0) -> msgs.ControllerDiagnostics:
    """controller_diagnostics message (publisher parity with
    ExampleVehicleStateMachine.cpp:666-696)."""
    t3 = lambda v: tuple(float(x) for x in np.asarray(v).reshape(-1)[:3])  # noqa: E731
    t4 = lambda v: tuple(float(x) for x in np.asarray(v).reshape(-1)[:4])  # noqa: E731
    return msgs.ControllerDiagnostics(
        header=msgs.Header(stamp=stamp),
        input=msgs.ControllerInput(
            desired_yaw=float(desired_yaw),
            position_estimate_W=t3(est_pos),
            velocity_estimate_W=t3(est_vel),
            attitude_estimate_W=t4(est_att),
            trajectory_id=int(traj_id),
            trajectory_time=float(traj_time),
            position_reference_W=t3(ref_pos),
            velocity_reference_W=t3(ref_vel),
            acceleration_reference_W=t3(ref_acc),
            angular_velocity_reference_B=t3(ref_angvel_b),
            thrust_reference_B=float(ref_thrust),
            current_battery=float(batt),
        ),
        output=msgs.ControllerOutput(
            angular_velocity_command_B=t3(cmd_angvel_b),
            thrust_command_B=float(cmd_thrust),
        ),
    )


def depth_to_mm16(depth_codes, depth_scale):
    """Renderer depth codes -> 16UC1 millimeter image (np.uint16)."""
    codes = np.asarray(depth_codes)
    mm = np.round(codes.astype(np.float64) * float(depth_scale) * 1000.0)
    return np.clip(mm, 0, 65535).astype(np.uint16)


def image_message(arr, encoding, stamp, seq=0, frame_id="camera") -> msgs.Image:
    """Wrap a numpy image as a sensor_msgs/Image mirror.

    arr: (H, W) uint16 for '16UC1' or (H, W, 3) uint8 for 'rgb8'.
    16UC1 data is little-endian (is_bigendian=0), matching sensor_msgs.
    """
    arr = np.ascontiguousarray(arr)
    if encoding == "16UC1":
        if arr.dtype != np.uint16 or arr.ndim != 2:
            raise ValueError(f"16UC1 needs an (H, W) uint16 image, got {arr.dtype} {arr.shape}")
        arr = arr.astype("<u2")
        step = arr.shape[1] * 2
    elif encoding == "rgb8":
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"rgb8 needs an (H, W, 3) uint8 image, got {arr.dtype} {arr.shape}")
        step = arr.shape[1] * 3
    else:
        raise ValueError(f"unsupported encoding {encoding}")
    return msgs.Image(
        header=msgs.Header(stamp=stamp, frame_id=frame_id, seq=seq),
        height=arr.shape[0], width=arr.shape[1], encoding=encoding,
        is_bigendian=0, step=step, data=arr.tobytes(),
    )


def _flatten_outputs(outs: dict, n: int):
    """fly_diag's stacked outputs as one (n, D) float32 matrix, and the
    specs that split it back: (key, field or None, trailing shape, numpy
    dtype, columns) per leaf. Every integer of a row is exact in f32 (steps
    < 2^24, counters small)."""
    cols, specs, start = [], [], 0
    for key, val in outs.items():
        items = zip(val._fields, val) if isinstance(val, tuple) else ((None, val),)
        for field, t in items:
            cols.append(t.reshape(n, -1).to(torch.float32))
            stop = start + cols[-1].shape[1]
            specs.append((key, field, tuple(t.shape[1:]),
                          torch.empty((), dtype=t.dtype).numpy().dtype, slice(start, stop)))
            start = stop
    return torch.cat(cols, dim=1), specs


def _unflatten_outputs(mat, specs, n: int):
    """The host outputs dict of _flatten_outputs' matrix: numpy arrays of
    the original dtypes; the planned-trajectory subtree as its NamedTuple."""
    from agrifly_tpu_torch.sim import orchard_env

    outs, planned = {}, {}
    for key, field, sh, dt, cols in specs:
        arr = mat[:, cols].reshape((n,) + sh).astype(dt)
        if field is None:
            outs[key] = arr
        else:
            planned.setdefault(key, {})[field] = arr
    for key, fields in planned.items():
        outs[key] = orchard_env.PlannedTraj(**fields)
    return outs


class OrchardBridge:
    """Flies the orchard perception-plan-act env and publishes the RAPPIDS
    node's diagnostics topics (ExampleVehicleStateMachine.cpp:259-307
    planner_diagnostics, :666-696 controller_diagnostics) plus
    simulator_truth, one set per ~32 ms frame (the reference publishes
    planner diagnostics per depth image at <= 30 Hz).

    Image topics (AirSimBridge/main.cpp:126-163, 195-215 parity): every
    `image_throttle`-th frame, the depth image the planner consumed is
    republished on `depthImage{id}` (16UC1 millimeters) and — for worlds
    with a color pass — an RGB render on `rgbImage{id}` ('rgb8'), followed
    by `imageReceivedFlag{id}` (a bare Header, the reference's handshake
    flag consumed by SyncSimulator/main.cpp:401-412). `image_downsample`
    stride-samples rows/cols before publishing. The depth frame is
    re-rendered from the same pre-frame true pose frame_step rendered
    from, through the same batch wrapper (the raycast kernel, or the
    strip-culled mesh kernel in an imported world), so it is the planner's
    input bit for bit; the RGB image goes through the RGB kernel of the
    world.

    frame() publishes one frame at a time; fly_frames_block(n) flies n
    frames in one dispatch (orchard_env.fly_diag) and publishes every
    frame from the stacked outputs, read back as one matrix.

    draws: None (the bridge's generator, seeded from `seed`, draws each
    frame's planner uniforms and IMU noise) or a callable draws(n) that
    returns the next n frames' (u (n, 4, n_candidates), noise (n,
    steps_per_frame, 2, 3))."""

    def __init__(self, params, vehicle_id=1, seed=0, bus: TopicBus | None = None,
                 publish_images=True, publish_rgb=None, image_downsample=1,
                 image_throttle=1, publish_wire=True, draws=None):
        from agrifly_tpu_torch.sim import orchard_env

        self._oe = orchard_env
        self.params = params
        self.vehicle_id = int(vehicle_id)
        self.bus = bus if bus is not None else TopicBus()
        self._dev = params.waypoints.device
        # host copies of the scalars the publisher reads every frame
        self._dt_us = int(params.base.dt_us)
        self._depth_scale = float(params.planner.cam.depth_scale)
        self._batt = float(params.base.logic.batt_critical) * 1.2
        self._draws = draws
        self._gen = torch.Generator(device=self._dev).manual_seed(int(seed))
        self._state = orchard_env.init_state(params)
        self.frame_count = 0
        self.last_outs = None
        # inbound radio_command{id} -> onboard delay line (sync_simulator's
        # radio subscriber, SyncSimulator/main.cpp:101-118): an external
        # kill/idle/rates command reaches the onboard FSM through the real
        # codec + 30 ms wire even while the autonomous mission flies
        self._pending_radio: collections.deque = collections.deque()
        self.bus.subscribe(f"radio_command{self.vehicle_id}", self._on_radio)
        # wire-topic surface (agrifly.launch parity): the reference
        # bringup has mocap_output at 200 Hz, telemetry at 100 Hz and the
        # offboard node's radio_command at 50 Hz sim time flowing next to
        # the frame topics. The orchard loop runs all three paths
        # on-device inside the tick, so the bridge reconstructs the wire
        # from frame rows — see _publish_wire_row for fidelity notes.
        self.publish_wire = bool(publish_wire)
        # own-stream publish counters: run_realtime band-checks these
        # instead of bus counts (the radio_command topic also carries
        # external operator commands — a kill must not tip the 50 Hz band)
        self.wire_counts = {"mocap": 0, "telemetry": 0, "cmd": 0}
        self._wire_accum = {"mocap": 0, "telemetry": 0, "cmd": 0}
        self._tel_counter = 0
        self._prev_pose = None  # (pos, att) at the previous frame's end
        self._publishing_cmd = False  # reentrancy guard vs _on_radio
        self.publish_images = bool(publish_images)
        # RGB pass exists for the procedural world (render/raycast.render_rgb)
        # and imported mesh worlds (render/meshscene.render_rgb)
        self.publish_rgb = (bool(publish_rgb) if publish_rgb is not None
                            else self.publish_images)
        self.image_downsample = max(1, int(image_downsample))
        self.image_throttle = max(1, int(image_throttle))

    @property
    def state(self):
        """The live OrchardEnvState, on the params' device."""
        return self._state

    @state.setter
    def state(self, s):
        self._state = s
        self._prev_pose = None  # wire interpolation must reseed

    def _render_depth(self, pos, att):
        """Depth codes (B, H, W) of vehicle poses (B, 3), (B, 4): the route
        `orchard_env._frame_percept` renders the planner's input through."""
        from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast, raycast

        p = self.params
        cam_att = raycast.camera_attitude(att)
        if p.mesh is not None:
            return cuda_meshscene.render_depth_batch(p.render_cfg, p.mesh, pos, cam_att)
        return cuda_raycast.render_depth_batch(p.render_cfg, p.scene, pos, cam_att)

    def _render_rgb(self, pos, att):
        """RGB images (B, H, W, 3) of vehicle poses (the world's RGB kernel
        on the card)."""
        from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast

        p = self.params
        if p.mesh is not None:
            return cuda_meshscene.render_rgb_body_batch(p.render_cfg, p.mesh, pos, att)
        return cuda_raycast.render_rgb_body_batch(p.render_cfg, p.scene, pos, att)

    def fly_frames(self, n: int, block: int = 1):
        """Fly n frames; block > 1 dispatches `block` frames at a time
        (fly_frames_block)."""
        if block <= 1:
            for _ in range(n):
                self.frame()
            return
        done = 0
        while done < n:
            b = min(block, n - done)
            self.fly_frames_block(b)
            done += b

    def run_realtime(self, duration_s: float, rate_hz: float | None = None,
                     block: int = 1, on_quantum: Callable | None = None):
        """Wall-clock-paced full perception-plan-act loop — the
        reference's real-time simulator pacing (HardwareTimer +
        ros::Rate, AIFS_ROS Simulator/main.cpp:231,310) applied to the
        RAPPIDS pipeline workload the lockstep demo flies: render → plan
        → track in the loop, topic surface per frame, paced against the
        wall clock. The reference can only run this pipeline lockstep
        (sync_simulator waits on AirSim images).

        One scheduling quantum = `block` frames flown in one dispatch (one
        outputs-matrix readback), then sleep until the ABSOLUTE deadline
        t0 + k*block/rate_hz — drift-free; a late quantum shortens the
        next sleep instead of shifting later deadlines. The loop is
        PIPELINED one quantum deep: quantum k reads and publishes block
        k-1's outputs, then dispatches block k. Consequences: the topic
        surface lags real time by one quantum, and an operator command
        (radio kill) injected in on_quantum lands two quanta later — both
        bounded and analogous to the reference's transport latency (30 ms
        radio wire + ROS queues).

        rate_hz defaults to the params' own frame rate (1e6 / (dt_us *
        steps_per_frame); 31.25 Hz at reference cadences). Reduce it on
        slow hosts — sim-time topic cadences then scale by
        rate_hz/nominal. `on_quantum(bridge, k)` runs after quantum k's
        publishes (the teleop/monitor hook; an injected radio command
        reaches the onboard FSM in the next quantum's block).

        Returns a report dict mirroring SimBridge.run_realtime: achieved
        frame rate, lateness stats, wall-clock topic rates, and in-band
        checks (the per-frame topics — truth, planner/controller
        diagnostics — must hold the frame rate within ±10%)."""
        import time as _time

        block = max(1, int(block))
        spf = int(self.params.steps_per_frame)
        nominal_hz = 1e6 / (float(self._dt_us) * spf)
        rate = float(rate_hz) if rate_hz is not None else nominal_hz
        period = block / rate

        # warm outside the paced region (the reference node likewise only
        # promises its rate once running): one real block, and the radio
        # push, discarded (no state change)
        self.fly_frames_block(block)
        _push_radio(self.state.base.ring, self.state.base.step,
                    bytes(radio_codec.RAW_PACKET_SIZE))
        counts0 = dict(self.bus.counts)
        wire0 = dict(self.wire_counts)
        frames0 = self.frame_count
        n_quanta = max(1, int(round(duration_s * rate / block)))
        late = 0
        max_late = 0.0
        pending = None
        t0 = _time.perf_counter()
        for k in range(1, n_quanta + 1):
            if pending is not None:
                self._publish_block(pending)  # block k-1's topic surface
            pending = self._dispatch_block(block)  # block k in flight
            if on_quantum is not None:
                on_quantum(self, k)
            deadline = t0 + k * period
            now = _time.perf_counter()
            if now < deadline:
                _time.sleep(deadline - now)
            else:
                late += 1
                max_late = max(max_late, now - deadline)
        self._publish_block(pending)  # the final in-flight block
        wall = _time.perf_counter() - t0

        vid = self.vehicle_id
        topic_hz = {}
        for name, topic in (("truth", f"simulator_truth{vid}"),
                            ("planner", f"planner_diagnostics{vid}"),
                            ("controller", f"controller_diagnostics{vid}"),
                            ("depth", f"depthImage{vid}"),
                            ("mocap", f"mocap_output{vid}"),
                            ("telemetry", f"telemetry{vid}"),
                            ("cmd", f"radio_command{vid}")):
            topic_hz[name] = (self.bus.counts.get(topic, 0)
                              - counts0.get(topic, 0)) / wall
        bands_ok = {}
        for name in ("truth", "planner", "controller"):
            bands_ok[name] = bool(
                0.9 * rate <= topic_hz[name] <= 1.1 * rate)
        if self.publish_wire:
            # wire-topic health bands (vehicle_monitor): checked against
            # SIM time — the cadences ride sim time by construction, and
            # at full rate sim time IS wall time (pacing itself is proven
            # by the wall-clock frame-topic bands above). Only the
            # bridge's own stream counts (wire_counts): the
            # radio_command topic also carries external operator
            # commands, which must not tip the 50 Hz band.
            from agrifly_tpu_torch.utils import monitor as monitor_mod

            sim_s = ((self.frame_count - frames0) * spf * float(self._dt_us) * 1e-6)
            for name in ("mocap", "telemetry", "cmd"):
                lo, hi = monitor_mod.BANDS[name]
                r = (self.wire_counts[name] - wire0[name]) / sim_s
                bands_ok[name] = bool(lo <= r <= hi)
        return {
            "frames": self.frame_count - frames0,
            "wall_s": wall,
            "target_frame_hz": rate,
            "achieved_frame_hz": (self.frame_count - frames0) / wall,
            "late_quanta": late,
            "n_quanta": n_quanta,
            "max_late_s": max_late,
            "rate_scale": rate / nominal_hz,
            "topic_hz": topic_hz,
            "bands_ok": bands_ok,
        }

    @torch.inference_mode()
    def _publish_images(self, pos, att, stamp, seq):
        """Publish the image topics for ONE frame, rendered from its
        pre-frame pose (pos (3,), att (4,) on the device: what frame_step
        consumed — bit for bit the planner's input)."""
        vid = self.vehicle_id
        ds = self.image_downsample
        depth = self._render_depth(pos[None], att[None])[0].cpu().numpy()[::ds, ::ds]
        mm = depth_to_mm16(depth, self._depth_scale)
        self.bus.publish(
            f"depthImage{vid}",
            image_message(mm, "16UC1", stamp, seq=seq))
        if self.publish_rgb:
            rgb = self._render_rgb(pos[None], att[None])[0].cpu().numpy()[::ds, ::ds]
            self.bus.publish(
                f"rgbImage{vid}",
                image_message(rgb.astype(np.uint8), "rgb8", stamp, seq=seq))
        self.bus.publish(
            f"imageReceivedFlag{vid}",
            msgs.Header(stamp=stamp, seq=seq))

    def _on_radio(self, msg: msgs.RadioCommand):
        if self._publishing_cmd:
            # our own 50 Hz command-stream publish (_publish_wire_row):
            # the device tick already applied these commands through the
            # in-sim delay line — re-injecting would double-command
            return
        self._pending_radio.append(msg.raw[: radio_codec.RAW_PACKET_SIZE])

    def frame(self):
        self.fly_frames_block(1)

    def fly_frames_block(self, n: int):
        """Fly `n` frames in one dispatch (orchard_env.fly_diag) and publish
        every frame's topic set from the stacked outputs. Inbound radio
        commands are injected before the block, so their latency is <= one
        block. Image topics render from each frame's PRE-frame pose (row
        i-1's end pose) through the same batch wrapper frame_step used —
        the published depth stays the planner's input bit for bit."""
        self._publish_block(self._dispatch_block(n))

    def fly_frames_pipelined(self, frames: int, blk: int, on_block=None):
        """Fly `frames` frames in `blk`-frame blocks, pipelined one deep:
        block k is queued on the device before block k-1's topic surface
        publishes on the host.

        on_block(outs, frames_done) runs after each block's publish with
        that block's stacked output rows; return False to stop (the
        in-flight block is still published — same ≤1-block abort latency
        as the teleop kill path). Radio commands injected between blocks
        land on the NEXT dispatch, so operator latency is ≤ 2 blocks
        (vs ≤ 1 for the synced fly_frames_block loop)."""
        done_disp = 0
        done_pub = 0
        pending = None
        stop = False
        while done_disp < frames and not stop:
            b = min(blk, frames - done_disp)
            nxt = self._dispatch_block(b)
            done_disp += b
            if pending is not None:
                nb = pending[0]
                self._publish_block(pending)
                done_pub += nb
                if on_block is not None and \
                        on_block(self.last_outs, done_pub) is False:
                    stop = True
            pending = nxt
        if pending is not None:
            nb = pending[0]
            self._publish_block(pending)
            done_pub += nb
            if on_block is not None and not stop:
                on_block(self.last_outs, done_pub)
        return done_pub

    @torch.inference_mode()
    def _dispatch_block(self, n: int):
        """Inject pending radio commands into the state's delay line, then
        queue one n-frame fly_diag block and start the copy of its
        flattened outputs to the host. Nothing is read back: the
        pre-frame pose stays on the device. Returns an opaque pending
        record for _publish_block (the split lets a paced loop read block
        k-1's outputs while block k computes)."""
        s = self.state
        while self._pending_radio:
            raw = self._pending_radio.popleft()
            base = s.base
            s = s._replace(base=base._replace(ring=_push_radio(base.ring, base.step, raw)))
        self._state = s  # the pose is unchanged: keep the wire interpolation
        pre_pos = pre_att = None
        if self.publish_images:
            pre_pos, pre_att = s.base.plant.pos.clone(), s.base.plant.att.clone()
        draws = None
        if self._draws is not None:
            u, noise = self._draws(n)
            draws = (torch.as_tensor(u, dtype=torch.float32).to(self._dev),
                     torch.as_tensor(noise, dtype=torch.float32).to(self._dev))
        s2, outs = self._oe.fly_diag(self.params, s, n, self._gen, draws)
        self._state = s2
        mat, specs = _flatten_outputs(outs, n)
        host, event = _to_host(mat)
        return (n, host, event, mat, specs, pre_pos, pre_att)

    def _publish_block(self, pending):
        """Wait for a dispatched block's outputs matrix (ONE transfer) and
        publish every frame's topic set from the stacked rows."""
        n, host, event, mat_dev, specs, pre_pos, pre_att = pending
        outs = _unflatten_outputs(_host_numpy(host, event), specs, n)
        # host status without touching the state: callers read flight
        # status from the block's own output rows
        self.last_outs = outs

        if self.publish_images:
            # pre-frame pose of frame i = end pose of frame i-1, on the
            # device (the columns of the device matrix hold its values)
            cols = {key: c for key, field, _, _, c in specs if field is None}
            pos_seq = torch.cat([pre_pos[None], mat_dev[:-1, cols["pos"]]], 0)
            att_seq = torch.cat([pre_att[None], mat_dev[:-1, cols["att"]]], 0)
            dt = self._dt_us * 1e-6
            spf = int(self.params.steps_per_frame)
            for i in range(n):
                seq = self.frame_count + i
                if seq % self.image_throttle == 0:
                    pre_t = (int(outs["step"][i]) - spf) * dt
                    self._publish_images(pos_seq[i], att_seq[i], pre_t, seq)

        for i in range(n):
            row = {k: (type(v)(*(x[i] for x in v)) if isinstance(v, tuple) else v[i])
                   for k, v in outs.items()}
            self.frame_count += 1
            if self.publish_wire:
                self._publish_wire_row(row)
            self._publish_row(row)

    def _publish_wire_row(self, row):
        """Reconstruct the wire-topic surface for one frame: mocap_output
        at 200 Hz, telemetry at 100 Hz and the offboard command stream on
        radio_command at 50 Hz sim time (the reference bringup's
        cadences — Simulator/main.cpp mocap, QuadcopterLogic telemetry,
        ExampleVehicleStateMachine's rates commands), each message
        stamped at its true tick time within the frame.

        Fidelity: the orchard loop runs these paths on-device inside the
        tick, so the bridge reconstructs them from frame rows. The mocap
        pose is linearly interpolated between the frame-boundary truth
        poses (worst-case midpoint error over a 32 ms frame is a*T^2/8
        ≈ 1.3 mm at 10 m/s² — under the mocap noise the estimator
        consumed); telemetry and command VALUES are the frame-end onboard
        snapshot held for up to one frame (zero-order hold), and the
        telemetry packet counter advances host-side (the in-sim logic
        counter is untouched — the orchard tick never encodes packets).
        All values cross the real wire quantization (telemetry
        ±range→u16 map, the 23-byte rates-command codec), so bag
        consumers see wire-accurate resolution."""
        vid = self.vehicle_id
        dt_us = self._dt_us
        spf = int(self.params.steps_per_frame)
        step_end = int(row["step"])
        pos1 = np.asarray(row["pos"], np.float64)
        att1 = np.asarray(row["att"], np.float64)
        if self._prev_pose is None:
            pos0, att0 = pos1, att1
        else:
            pos0, att0 = self._prev_pose
        if float(att0 @ att1) < 0.0:
            att0 = -att0  # same rotation; take the short lerp arc
        acc = self._wire_accum

        def fires(name, rate):
            period = 10 ** 6 // rate
            acc[name] += dt_us
            if acc[name] > period:
                acc[name] -= period
                self.wire_counts[name] += 1
                return True
            return False

        for k in range(1, spf + 1):
            t = (step_end - spf + k) * dt_us * 1e-6
            if fires("mocap", RATE_MOCAP):
                w = k / spf
                pos = pos0 + (pos1 - pos0) * w
                att = att0 + (att1 - att0) * w
                att = att / float(np.linalg.norm(att))
                yaw, pitch, roll = _ypr_np(att)
                self.bus.publish(
                    f"mocap_output{vid}",
                    msgs.MocapOutput(
                        header=msgs.Header(stamp=t), vehicleID=vid,
                        posx=pos[0], posy=pos[1], posz=pos[2],
                        attyaw=yaw, attpitch=pitch, attroll=roll,
                        attq0=att[0], attq1=att[1], attq2=att[2],
                        attq3=att[3],
                    ),
                )
            if fires("cmd", RATE_CMD):
                mtype, mflags, fields = radio_codec.make_rates_command_np(
                    float(row["last_cmd_thrust"]),
                    np.asarray(row["last_cmd_angvel"], np.float64))
                raw = radio_codec.fields_to_bytes(mtype, mflags, fields)
                # reentrancy guard: _on_radio must not re-inject our own
                # stream (the tick already applied these commands)
                self._publishing_cmd = True
                try:
                    self.bus.publish(
                        f"radio_command{vid}",
                        msgs.RadioCommand(header=msgs.Header(stamp=t),
                                          raw=raw))
                finally:
                    self._publishing_cmd = False
            if fires("telemetry", RATE_TELEMETRY):
                self._publish_telemetry_row(row, t)
        self._prev_pose = (pos1, att1)

    def _publish_telemetry_row(self, row, t):
        """One telemetry message from a frame row, through the host wire
        quantization (io/telemetry.wire_quantize_np) — field-for-field
        what SimBridge publishes from encode_from_logic + decode."""
        vid = self.vehicle_id
        att = np.asarray(row["tel_kf_att"], np.float64)
        sign = 1.0 if att[0] > 0 else -1.0  # ops/rotation.to_vector_part
        # the whole 26-value row quantizes in ONE vectorized call
        vals = np.concatenate([
            np.asarray(row["tel_acc"], np.float64).ravel(),
            np.asarray(row["tel_gyro"], np.float64).ravel(),
            np.asarray(row["tel_motor_forces"], np.float64).ravel(),
            np.asarray(row["tel_kf_pos"], np.float64).ravel(),
            np.atleast_1d(np.asarray(row["tel_batt"], np.float64)),
            np.asarray(row["tel_kf_vel"], np.float64).ravel(),
            sign * att[1:4],
            np.asarray(row["tel_debug"], np.float64).ravel(),
        ])
        qv = tel_codec.wire_quantize_np(vals, _TEL_ROW_RANGES)
        acc, gyro, forces = qv[0:3], qv[3:6], qv[6:10]
        kf_pos, batt, kf_vel = qv[10:13], qv[13], qv[14:17]
        att_v, debug = qv[17:20], qv[20:26]
        # YPR rebuilt from the wire attitude's vector part (w >= 0),
        # exactly like the reference publisher (SyncSimulator:595-602)
        w = float(np.sqrt(max(0.0, 1.0 - float(att_v @ att_v))))
        ypr = _ypr_np(np.array([w, att_v[0], att_v[1], att_v[2]]))
        num = self._tel_counter % 256
        self._tel_counter += 1
        self.bus.publish(
            f"telemetry{vid}",
            msgs.Telemetry(
                header=msgs.Header(stamp=t), vehicleID=vid,
                type=tel_codec.PACKET_TYPE_PT1, packetNumber=num,
                accelerometer=tuple(acc), rateGyro=tuple(gyro),
                position=tuple(kf_pos), attitude=tuple(att_v),
                velocity=tuple(kf_vel),
                attitudeYPR=tuple(float(x) for x in ypr),
                motorForces=tuple(forces), debugVals=tuple(debug),
                batteryVoltage=float(batt),
                panicReason=int(row["panic"]),
                warnings=int(row["tel_warnings"]),
            ),
        )

    def _publish_row(self, row):
        """Publish one frame's truth + planner/controller diagnostics
        from a (host) fly_diag output row."""
        vid = self.vehicle_id
        p = self.params
        dt_us = self._dt_us
        t = int(row["step"]) * dt_us * 1e-6

        pos = np.asarray(row["pos"], np.float64)
        vel = np.asarray(row["vel"], np.float64)
        att = np.asarray(row["att"], np.float64)
        yaw, pitch, roll = _ypr_np(att)
        self.bus.publish(
            f"simulator_truth{vid}",
            msgs.SimulatorTruth(
                header=msgs.Header(stamp=t), vehicleID=vid,
                posx=pos[0], posy=pos[1], posz=pos[2],
                velx=vel[0], vely=vel[1], velz=vel[2],
                attyaw=yaw, attpitch=pitch, attroll=roll,
                attq0=att[0], attq1=att[1], attq2=att[2], attq3=att[3],
            ),
        )

        # ---- planner_diagnostics (per frame = per depth image) ----
        planned = row["planned"]
        traj_shim = types.SimpleNamespace(
            alpha=planned.alpha, beta=planned.beta, gamma=planned.gamma,
            a0=planned.a0, v0=planned.v0, p0=planned.p0, tf=planned.tf)
        res_shim = types.SimpleNamespace(  # PlanResult's consumed fields
            found=bool(row["plan_found"]),
            traj=traj_shim,
            num_collision_free=int(row["num_collision_free"]),
            num_pyramids=int(row["num_pyramids"]),
            num_velocity_admissible=int(row["num_velocity_admissible"]),
            num_feasible=int(row["num_feasible"]),
            num_candidates=p.n_candidates,
        )
        diag = plan_result_to_diagnostics(
            res_shim, seed=self.frame_count,
            vel_cam=row["plan_vel_cam"], acc_cam=row["plan_acc_cam"],
            grav_cam=row["plan_grav_cam"], goal_world=row["goal_world"],
            reset_time=int(planned.start_step) * dt_us * 1e-6, stamp=t,
        )
        diag.output.trajectory_transform = msgs.Transform(
            translation=tuple(np.asarray(planned.offset, np.float64)),
            rotation=tuple(np.asarray(planned.att, np.float64)),
        )
        self.bus.publish(f"planner_diagnostics{vid}", diag)

        # ---- controller_diagnostics (tracking snapshot at frame end) ----
        traj_time = (int(row["step"]) - int(planned.start_step)) * dt_us * 1e-6
        cdiag = controller_diagnostics(
            row["est_pos"], row["est_vel"], row["est_att"],
            traj_id=int(row["plan_count"]), traj_time=traj_time,
            ref_pos=row["ref_pos"], ref_vel=row["ref_vel"],
            ref_acc=row["ref_acc"], ref_angvel_b=row["ref_angvel_b"],
            ref_thrust=float(row["ref_thrust"]),
            cmd_angvel_b=row["last_cmd_angvel"],
            cmd_thrust=float(row["last_cmd_thrust"]),
            batt=self._batt, stamp=t,
        )
        self.bus.publish(f"controller_diagnostics{vid}", cdiag)
