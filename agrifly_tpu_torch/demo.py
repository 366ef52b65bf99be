"""End-to-end demo: the agrifly.launch equivalent, on the port.

`python -m agrifly_tpu_torch.demo` flies the full perception-plan-act loop —
takeoff, RAPPIDS planning against the rendered orchard, receding-horizon
tracking — and prints a vehicle_monitor-style status line per ~4 s of sim
time. Optionally writes the demo CSV log, an RGB frame and a checkpoint.
The port of `agrifly_tpu/demo.py`: the same flags and the same printed
lines.

It runs on the card (the raycast or mesh kernel, the inflation kernel and
the tick kernel each frame) and raises where there is none; `--cpu` builds
every tensor on the CPU, where each kernel's wrapper runs its plain
version.

Flags:
  --frames N        number of 32 ms frames to fly (default 300 ~ 10 s)
  --goal X Y Z      goal in world frame (default 120 0 3.5)
  --seed S          orchard world seed (and the seed of the draws)
  --image WxH       depth image size (default 640x480)
  --candidates N    RAPPIDS candidates per frame (default 256)
  --csv PATH        write flight CSV
  --ckpt PATH       write final-state checkpoint (state and generator)
  --cpu             run on the CPU (small image recommended)
  --traj-file PATH  waypoint file (trajectory.txt format: 'x,y,z' lines,
                    agrifly.launch traj_file parity); lands after the last
  --land            descend + idle motors after the last waypoint
  --mesh            with --fleet N: split the fleet over the process group's
                    devices (parallel/sharding), one process per device;
                    a single process is a mesh of one, `torchrun
                    --nproc-per-node=W` or the AGRIFLY_* variables
                    (parallel/multihost) make it span W; only rank 0 prints

Block sizes. On the CPU they are the JAX package's own, so scripted
operator events land on the same frames: 4-frame teleop blocks, 1-frame
quanta of the paced orchard loop, 1-frame record blocks, and the paced
tick loop's ~100 Hz quanta. On the card a frame is host-bound (tens of
thousands of eager launches, PERF.md), so a block's own cost is small
against its frames: the teleop loop polls the operator every frame, the
paced orchard loop paces 1-frame quanta, the recorder publishes 8-frame
blocks, and the paced tick loop queues its ~100 Hz quanta as device
blocks (`SimBridge.run_realtime(device_blocks=True)`).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple, Optional

import torch

FRAMES_PER_BLOCK = 31  # the default path's fly block: ~1 s of sim time
READ_EVERY = 4  # the default path reads one status vector every READ_EVERY blocks
TELEOP_BLOCK = {"cpu": 4, "cuda": 1}  # frames per operator poll
RECORD_BLOCK = {"cpu": 1, "cuda": 8}  # frames per published block under --record
ORCHARD_QUANTUM = 1  # frames per quantum of --realtime-orchard, on either device
DISARMED = 2 ** 30  # start_flight_step of a mission the operator has not armed


class Flight(NamedTuple):
    """What `run` returns: the exit code and, where the path flew the
    orchard env, its params, final state and the generator that continues
    it (the default path's checkpoint holds the same state and generator)."""

    rc: int
    params: Optional[object] = None
    state: Optional[object] = None
    gen: Optional[torch.Generator] = None


def _device(args) -> torch.device:
    from agrifly_tpu_torch import card_or_raise

    return torch.device("cpu") if args.cpu else card_or_raise("cuda", "agrifly_tpu_torch.demo")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _int32(value, dev):
    return torch.tensor(value, dtype=torch.int32, device=dev)


def _status_copy(values):
    """Start the copy of a small status vector to the host: a pending
    (host, event) pair that `_status_read` waits on. Nothing blocks here."""
    from agrifly_tpu_torch.io.bridge import _to_host

    return _to_host(torch.stack([v.to(torch.float32) for v in values]))


def _status_read(pending):
    from agrifly_tpu_torch.io.bridge import _host_numpy

    return _host_numpy(*pending)


def _teleop_loop(args, params, dev):
    """Operator-in-the-loop flight: start button arms the mission, red
    button kills through the real radio wire (codec -> 30 ms delay line ->
    onboard decode -> FS_KILLED), mirroring the reference's keyboard/
    joystick operator flow (hiperlab_hardware keyboardmain.cpp:26-78,
    VehicleMonitor/main.cpp:92-143)."""
    from agrifly_tpu_torch.io import radio as radio_codec
    from agrifly_tpu_torch.io import teleop
    from agrifly_tpu_torch.models import logic as onboard
    from agrifly_tpu_torch.sim import delayline, orchard_env

    js = teleop.make(args.teleop)

    # Fly BLK frames per call and poll the operator between blocks; a kill
    # lands within one block (the 30 ms radio delay is 15 ticks < 1 frame,
    # so the onboard FSM sees it inside the block it was pushed in).
    BLK = TELEOP_BLOCK[dev.type]
    # disarmed: planning/flight gated out until the start button
    cur = params._replace(start_flight_step=_int32(DISARMED, dev))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = orchard_env.init_state(params)
    dt = float(params.base.dt_us) * 1e-6
    armed = killed = False
    print(f"teleop ({args.teleop}): press start to arm, red to kill "
          f"({BLK} frames per block)")
    # Pipelined: dispatch block b, read block b-1's status, whose copy to
    # the host started after its block. Operator time is known statically
    # (start step + frames flown so far), so polls never touch the device.
    # The first block (it builds the kernels on first use) is timed out of
    # the steady figure.
    steps_per_frame = int(params.steps_per_frame)
    start_step = int(state.base.step)
    prev = None
    ran = n_excl = 0
    frames_done = 0
    t_excl = 0.0
    t_wall = time.perf_counter()
    b = 0
    total = max(BLK, args.frames)
    while frames_done < total:
        blk = min(BLK, total - frames_done)
        t = (start_step + frames_done * steps_per_frame) * dt
        jsv = js.poll(t)
        if jsv.buttonStart and not armed:
            armed = True
            cur = params._replace(start_flight_step=_int32(
                start_step + frames_done * steps_per_frame + 1, dev))
            print(f"t={t:6.2f}s ARMED — mission start (start button)")
        if jsv.buttonRed and not killed:
            killed = True
            ktype, kflags, kfields = radio_codec.make_kill_command(dev)
            base = state.base
            state = state._replace(base=base._replace(ring=delayline.push(
                base.ring, ktype, kflags, kfields, base.step,
                torch.ones((), dtype=torch.bool, device=dev))))
            print(f"t={t:6.2f}s KILL — emergency-kill on the radio "
                  f"(red button)")
        t_blk = time.perf_counter()
        state, _ = orchard_env.fly(cur, state, blk, gen)
        status = _status_copy([state.base.logic.fs, *state.base.plant.pos.unbind(),
                               state.base.logic.panic_reason])
        ran += 1
        frames_done += blk
        b += 1
        if b == 1:
            _sync(dev)
            t_excl += time.perf_counter() - t_blk
            n_excl += 1
        fs = None
        if prev is not None and (b % 8 == 0 or killed):
            v = _status_read(prev)
            fs = int(v[0])
            panic = int(v[4])
            print(f"t={t:6.2f}s pos=({v[1]:7.2f},{v[2]:6.2f},"
                  f"{v[3]:5.2f}) fs={fs} "
                  f"panic={onboard.PANIC_REASON_NAMES.get(panic, panic)}")
        prev = status
        if fs == onboard.FS_KILLED:
            break
    if hasattr(js, "close"):
        js.close()
    _sync(dev)
    wall = time.perf_counter() - t_wall
    if int(state.base.logic.fs) == onboard.FS_KILLED:
        print("vehicle KILLED — motors off")
    sim_time = (int(state.base.step) - start_step) * dt
    msg = (f"teleop flew {sim_time:.1f}s of sim time in {wall:.1f}s wall "
           f"({sim_time / wall:.2f}x realtime incl. compile)")
    if ran > n_excl:
        blk_sim = BLK * steps_per_frame * dt
        steady = (wall - t_excl) / (ran - n_excl)
        msg += (f"; steady state {blk_sim / steady:.2f}x "
                f"realtime (poll every {blk_sim * 1e3:.0f} ms of sim)")
    print(msg)
    return Flight(0, cur, state, gen)


def _realtime_loop(args, dev):
    """Wall-clock real-time sim (the reference's `simulator` ROS node:
    HardwareTimer + ros::Rate(500), Simulator/main.cpp:231,310): pace the
    500 Hz vehicle loop against the wall clock, publish the full topic
    surface at reference cadences, render a live vehicle_monitor line
    each second, and (with --teleop) poll the operator at ~100 Hz — start
    arms a hover, red kills through the real radio wire."""
    from agrifly_tpu_torch.io import bridge as bridge_mod
    from agrifly_tpu_torch.io import messages as msgs
    from agrifly_tpu_torch.io import radio as radio_codec
    from agrifly_tpu_torch.io import teleop as teleop_mod
    from agrifly_tpu_torch.sim import env as env_mod
    from agrifly_tpu_torch.utils import monitor as monitor_mod

    params = env_mod.make_params(noise_scale=1.0, device=dev)
    br = bridge_mod.SimBridge(params, vehicle_id=1, seed=args.seed)
    mon = monitor_mod.VehicleMonitor(br.bus, 1, use_sim_time=False)

    js = teleop_mod.make(args.teleop) if args.teleop else None

    ground = env_mod.hover_command(des_pos=(0.0, 0.0, 0.0), device=dev)
    hover = env_mod.hover_command(des_pos=(0.0, 0.0, 1.5), device=dev)
    ctl = {"cmd": hover if js is None else ground,
           "armed": js is None, "killed": False}
    rate = float(args.rate)
    block = max(1, int(round(rate / 100.0)))  # ~100 Hz operator quanta
    quanta_per_s = max(1, int(round(rate / block)))
    # on the card each quantum's ticks are queued as one device block and
    # published from their stacked wire rows, pipelined one quantum deep;
    # the CPU keeps per-tick granularity (cmd re-read every tick)
    device_blocks = dev.type == "cuda"

    def on_quantum(b, k):
        t = k * block / rate
        if js is not None:
            jsv = js.poll(t)
            if jsv.buttonStart and not ctl["armed"]:
                ctl["armed"] = True
                ctl["cmd"] = hover
                print(f"t={t:6.2f}s ARMED — hover setpoint (start button)")
            if jsv.buttonRed and not ctl["killed"]:
                ctl["killed"] = True
                raw = radio_codec.fields_to_bytes(
                    *radio_codec.make_kill_command())
                b.bus.publish("radio_command1", msgs.RadioCommand(raw=raw))
                print(f"t={t:6.2f}s KILL — emergency-kill on the radio "
                      f"(red button)")
        if k % quanta_per_s == 0:
            pos = b.state.plant.pos.cpu().numpy()
            print(f"[{t:5.1f}s wall] {mon.render()}  "
                  f"z={pos[2]:5.2f}m")

    print(f"realtime sim: {rate:.0f} Hz wall-clock pacing, "
          f"block={block} ticks/quantum"
          + (" (device blocks)" if device_blocks else "")
          + f", duration {args.duration}s")
    report = br.run_realtime(
        args.duration, lambda: ctl["cmd"], rate_hz=rate, block=block,
        on_quantum=on_quantum, device_blocks=device_blocks)
    if js is not None and hasattr(js, "close"):
        js.close()
    # pass/fail on the sim's own cadences; the cmd band reflects the
    # attached commander (a teleop kill is not a 50 Hz commander)
    ok = all(report["bands_ok"].get(k, False) for k in ("mocap", "telemetry"))
    print(f"achieved {report['achieved_tick_hz']:.1f} Hz "
          f"(target {rate:.0f}), late {report['late_quanta']}/"
          f"{report['n_quanta']} quanta (max {report['max_late_s']*1e3:.2f} ms)")
    print("topic rates (wall): " + "  ".join(
        f"{k}={v:.1f}Hz" for k, v in report["topic_hz"].items()))
    print("bands " + ("OK" if ok else "VIOLATED") + f": {report['bands_ok']}")
    return Flight(0 if ok else 1)


def _realtime_orchard_loop(args, params, dev):
    """Wall-clock-paced full perception-plan-act loop
    (OrchardBridge.run_realtime): the reference's real-time pacing
    (Simulator/main.cpp:231,310) applied to the RAPPIDS pipeline — which
    the reference itself can only run lockstep (sync_simulator waits on
    AirSim images). Frames are paced at --rate/steps_per_frame (31.25 Hz
    at the reference 500 Hz), the topic surface publishes live, and
    --teleop polls each quantum: start arms the mission, red kills through
    the radio wire."""
    from agrifly_tpu_torch.io import bridge as bridge_mod
    from agrifly_tpu_torch.io import messages as msgs
    from agrifly_tpu_torch.io import radio as radio_codec
    from agrifly_tpu_torch.io import teleop as teleop_mod
    from agrifly_tpu_torch.models import logic as onboard

    js = teleop_mod.make(args.teleop) if args.teleop else None
    # operator-armed missions hold planning until the start button
    if js is not None:
        params = params._replace(start_flight_step=_int32(DISARMED, dev))
    ob = bridge_mod.OrchardBridge(params, vehicle_id=1, seed=args.seed,
                                  publish_images=False)
    frame_hz = 1e6 / (float(params.base.dt_us) * int(params.steps_per_frame))
    # --rate is the TICK rate (reference 500 Hz); frames pace at
    # rate / steps_per_frame (31.25 Hz at reference cadences)
    rate = float(args.rate) / int(params.steps_per_frame)
    block = ORCHARD_QUANTUM
    ctl = {"armed": js is None, "killed": False}
    vid = ob.vehicle_id
    quanta_per_s = max(1, int(round(rate / block)))

    def on_quantum(b, k):
        t = k * block / rate
        last = {key: b.last_outs[key][-1] for key in
                ("pos", "panic", "step", "flight_state", "plan_count")}
        if js is not None:
            jsv = js.poll(t)
            if jsv.buttonStart and not ctl["armed"]:
                ctl["armed"] = True
                # the arm moves the params' scalar; the next block reads it
                b.params = b.params._replace(
                    start_flight_step=_int32(int(last["step"]) + 1, dev))
                print(f"t={t:6.2f}s ARMED — mission start (start button)")
            if jsv.buttonRed and not ctl["killed"]:
                ctl["killed"] = True
                raw = radio_codec.fields_to_bytes(
                    *radio_codec.make_kill_command())
                b.bus.publish(f"radio_command{vid}",
                              msgs.RadioCommand(raw=raw))
                print(f"t={t:6.2f}s KILL — emergency-kill on the radio "
                      f"(red button)")
        if k % quanta_per_s == 0:
            pos = last["pos"]
            panic = int(last["panic"])
            print(f"[{t:5.1f}s wall] t_sim={int(last['step']) * 0.002:6.2f}s "
                  f"pos=({pos[0]:7.2f},{pos[1]:6.2f},{pos[2]:5.2f}) "
                  f"fs={int(last['flight_state'])} "
                  f"panic={onboard.PANIC_REASON_NAMES.get(panic, panic)} "
                  f"plans={int(last['plan_count'])}")

    print(f"realtime orchard sim: {rate:.2f} Hz frame pacing "
          f"(nominal {frame_hz:.2f}), {block} frames/quantum, "
          f"duration {args.duration}s"
          + (f", teleop {args.teleop}" if js else ""))
    report = ob.run_realtime(args.duration, rate_hz=rate, block=block,
                             on_quantum=on_quantum)
    if js is not None and hasattr(js, "close"):
        js.close()
    ok = all(report["bands_ok"].values())
    print(f"achieved {report['achieved_frame_hz']:.2f} Hz frames "
          f"(target {rate:.2f}), late {report['late_quanta']}/"
          f"{report['n_quanta']} quanta "
          f"(max {report['max_late_s'] * 1e3:.2f} ms)")
    print("topic rates (wall): " + "  ".join(
        f"{k}={v:.2f}Hz" for k, v in report["topic_hz"].items()))
    print("bands " + ("OK" if ok else "VIOLATED") + f": {report['bands_ok']}")
    return Flight(0 if ok else 1, ob.params, ob.state)


def _record(args, params, dev, w, h):
    """rosbag_record_airsim.sh workflow: drive the orchard loop through the
    topic bridge and bus-record everything it publishes."""
    from agrifly_tpu_torch.io import bridge as bridge_mod

    # image topics are opt-in here: the recorder drops them anyway
    # (rosbag_record_airsim.sh parity)
    ob = bridge_mod.OrchardBridge(params, vehicle_id=1, seed=args.seed,
                                  publish_images=args.record_images)
    rec = bridge_mod.MessageRecorder(ob.bus, args.record,
                                     record_images=args.record_images)
    # publish-per-frame fidelity, flown in blocks pipelined one deep
    # (block k is queued before block k-1's topics publish); recording is
    # not interactive, so the <= 2-block command latency is fine
    BLK = RECORD_BLOCK[dev.type]
    print(f"agrifly_tpu_torch demo (recording): {dev.type} backend, {w}x{h} depth, "
          f"{BLK} frames/block -> {args.record}")
    t_wall = time.perf_counter()

    def on_block(outs, done):
        # status from the block's own output rows, already on the host
        if int(outs["panic"][-1]) != 0:
            print("PANIC — aborting")
            return False
        if done % 32 < outs["step"].shape[0]:
            pos = outs["pos"][-1]
            print(f"t={int(outs['step'][-1]) * 0.002:6.2f}s "
                  f"pos=({pos[0]:7.2f},{pos[1]:6.2f},{pos[2]:5.2f}) "
                  f"plans={int(outs['plan_count'][-1])}")

    ob.fly_frames_pipelined(args.frames, BLK, on_block)
    rec.close()
    wall = time.perf_counter() - t_wall
    sim_s = int(ob.state.base.step) * 0.002
    print(f"recorded {rec.count} messages over {sim_s:.1f}s sim in "
          f"{wall:.1f}s wall ({sim_s / wall:.2f}x realtime incl. compile)")
    return Flight(0, params, ob.state)


def _status_values(s, fleet, mesh=None):
    """The printed status as one small vector (one host read a line); on a
    mesh, the whole fleet's: the minima, maxima and sums reduced over the
    ranks (the vehicles step in lockstep, so every rank has the same step)."""
    if fleet == 1:
        return [s.base.step, *s.base.plant.pos.unbind(), s.base.logic.fs,
                s.base.logic.panic_reason, s.plan_count, s.waypoint_idx, s.mstage]
    pos = s.base.plant.pos
    lo = torch.stack([pos[:, 0].min(), pos[:, 2].min()])
    hi = torch.stack([pos[:, 0].max(), pos[:, 2].max()])
    n = torch.stack([(s.base.logic.panic_reason != 0).sum(), s.plan_count.sum(),
                     (s.mstage == 2).sum()])
    if mesh is not None:
        import torch.distributed as dist

        for t, op in ((lo, dist.ReduceOp.MIN), (hi, dist.ReduceOp.MAX), (n, dist.ReduceOp.SUM)):
            dist.all_reduce(t, op=op, group=mesh.group)
    return [s.base.step[0], lo[0], hi[0], lo[1], hi[1], *n]


def _write_ppm(path, rgb):
    rgb = rgb.cpu().numpy()
    with open(path, "wb") as f:
        f.write(f"P6\n{rgb.shape[1]} {rgb.shape[0]}\n255\n".encode())
        f.write(rgb.tobytes())


def final_rgb(params, state):
    """The RGB frame the demo writes under --rgb: the world's RGB kernel
    (K1-rgb, or K4-rgb in an imported world) from the final pose of the
    (first) vehicle. Returns (H, W, 3) uint8."""
    from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast

    pos = state.base.plant.pos.reshape(-1, 3)[:1]
    att = state.base.plant.att.reshape(-1, 4)[:1]
    if params.mesh is not None:
        return cuda_meshscene.render_rgb_body_batch(params.render_cfg, params.mesh, pos, att)[0]
    return cuda_raycast.render_rgb_body_batch(params.render_cfg, params.scene, pos, att)[0]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--goal", type=float, nargs=3, default=(120.0, 0.0, 3.5))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image", type=str, default="640x480")
    ap.add_argument("--candidates", type=int, default=256)
    ap.add_argument("--csv", type=str, default=None)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--traj-file", type=str, default=None,
                    help="waypoint file, one 'x,y,z' per line "
                         "(trajectory.txt format); implies landing after "
                         "the last waypoint")
    ap.add_argument("--land", action="store_true",
                    help="descend and idle after the last waypoint")
    ap.add_argument("--fleet", type=int, default=1,
                    help="fly N vehicles abreast as one batched program "
                         "(independent full perception-plan-act loops)")
    ap.add_argument("--mesh", action="store_true",
                    help="with --fleet N: shard the fleet over the process "
                         "group's devices, one process per device (a single "
                         "process is a mesh of one; torchrun or the AGRIFLY_* "
                         "variables span W); NCCL on the card, gloo on the CPU")
    ap.add_argument("--record-images", action="store_true",
                    help="with --record: also publish + record the depth/"
                         "rgb image topics (base64 in the JSONL; the "
                         "reference's rosbag script excludes images too)")
    ap.add_argument("--record", type=str, default=None,
                    help="record every published topic (truth + planner/"
                         "controller diagnostics) to a JSONL file — the "
                         "rosbag_record workflow; flies pipelined blocks "
                         "through the topic bridge with per-frame topic "
                         "fidelity (single vehicle)")
    ap.add_argument("--teleop", type=str, default=None,
                    help="operator-in-the-loop mission control "
                         "(keyboardmain.cpp / VehicleMonitor parity): "
                         "'keyboard' ('s' arms, 'b' = red button kills), "
                         "'joystick' (Linux js device: Start arms, B "
                         "kills), or 'scripted:T:BUTTON,...' (e.g. "
                         "'scripted:0.5:buttonStart,3:buttonRed'). The "
                         "mission is NOT auto-started: the start button "
                         "arms it; the red button sends an emergency-kill "
                         "through the real radio codec + delay line")
    ap.add_argument("--realtime-orchard", action="store_true",
                    help="wall-clock real-time FULL perception-plan-act "
                         "loop (OrchardBridge.run_realtime): frames paced "
                         "at --rate/steps_per_frame Hz (31.25 at the "
                         "reference 500 Hz), live topic surface + status "
                         "line; combine with --teleop (start arms, red "
                         "kills). The reference can only run this "
                         "pipeline lockstep")
    ap.add_argument("--realtime", action="store_true",
                    help="wall-clock real-time sim (Simulator/main.cpp "
                         "HardwareTimer + ros::Rate(500) parity): pace "
                         "the 500 Hz vehicle loop against the wall clock, "
                         "publish the topic surface at reference "
                         "cadences, live vehicle_monitor line per "
                         "second; combine with --teleop for operator "
                         "arm/kill at ~100 Hz polls. On the card each "
                         "quantum's ticks run as one device block, so "
                         "operator/radio injection lands on the quantum "
                         "grid (<= 2 quanta late)")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="--realtime flight duration in wall seconds")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="--realtime tick rate target in Hz (the "
                         "reference's 500; reduce on slow hosts)")
    ap.add_argument("--rgb", type=str, default=None,
                    help="write a shaded RGB frame (binary PPM) rendered "
                         "from the final pose — Scene-image parity for both "
                         "the procedural orchard and imported worlds")
    ap.add_argument("--scene-file", type=str, default=None,
                    help="explicit world geometry: .obj (Helios-export "
                         "triangles) or a primitives text file "
                         "(render/meshscene.py); default = procedural "
                         "hashed orchard")
    return ap.parse_args(argv)


def _open_mesh(args):
    """The mesh of `--mesh --fleet N`: the process group the launch
    environment names (torchrun, the AGRIFLY_* variables), else a world of
    one on this process's device. The demo owns either and closes it."""
    from agrifly_tpu_torch.parallel import multihost, sharding

    if multihost.initialize_from_env(cpu=args.cpu):
        return sharding.make_mesh(torch.device("cpu") if args.cpu else None)._replace(owner=True)
    return sharding.make_mesh(_device(args))


def run(args) -> Flight:
    """Fly what the parsed flags ask for; see `Flight`. Under `--mesh
    --fleet N` the state of the flight is this rank's rows, and only rank 0
    prints."""
    if not (args.mesh and args.fleet > 1):
        return _run(args, None)
    import contextlib
    import os

    from agrifly_tpu_torch.parallel import sharding

    mesh = _open_mesh(args)
    try:
        if mesh.rank == 0:
            return _run(args, mesh)
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            return _run(args, mesh)
    finally:
        sharding.close_mesh(mesh)


def _run(args, mesh):
    dev = _device(args) if mesh is None else mesh.device
    if args.realtime:
        return _realtime_loop(args, dev)

    from agrifly_tpu_torch.sim import orchard_env

    w, h = (int(x) for x in args.image.split("x"))
    waypoints = None
    if args.traj_file:
        from agrifly_tpu_torch.sim import mission

        waypoints = mission.load_trajectory_file(args.traj_file)
        print(f"loaded {len(waypoints)} waypoints from {args.traj_file}")
    mesh_scene = None
    if args.scene_file:
        from agrifly_tpu_torch.render import meshscene

        if args.scene_file.endswith(".obj"):
            mesh_scene = meshscene.load_obj(args.scene_file, device=dev)
        else:
            mesh_scene = meshscene.load_primitives(args.scene_file, device=dev)
        print(f"loaded explicit scene: {mesh_scene.count} primitives "
              f"from {args.scene_file}")
    # the tick kernel (K3, K3b for a fleet) in every path; on the CPU the
    # wrapper runs the plain ticks
    params = orchard_env.make_params(
        goal_world=tuple(args.goal), width=w, height=h, n_candidates=args.candidates,
        seed=args.seed, waypoints=waypoints, land=args.land or args.traj_file is not None,
        mesh_scene=mesh_scene, device=dev)
    if args.realtime_orchard:
        return _realtime_orchard_loop(args, params, dev)
    if args.record:
        return _record(args, params, dev, w, h)
    if args.teleop:
        return _teleop_loop(args, params, dev)
    return _fly_default(args, params, dev, w, h, mesh)


def _fly_default(args, params, dev, w, h, mesh=None):
    """The default path: FRAMES_PER_BLOCK-frame fly blocks, one status
    vector read every READ_EVERY blocks; then --csv, --rgb and --ckpt.
    mesh: a fleet split over the mesh's ranks (`--mesh`)."""
    from agrifly_tpu_torch.models import logic as onboard
    from agrifly_tpu_torch.sim import orchard_env

    fleet = max(1, args.fleet)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if fleet == 1:
        state = orchard_env.init_state(params)

        def fly_block(s, g):
            return orchard_env.fly(params, s, FRAMES_PER_BLOCK, g)
    elif mesh is not None:
        # the vehicle axis split over the mesh (the full perception loop on
        # every rank's rows; the draws are the whole fleet's, so the flight
        # equals --fleet N's); the status vector is reduced over the ranks
        from agrifly_tpu_torch.parallel import sharding

        if fleet % mesh.world:
            raise SystemExit(f"--fleet {fleet} must divide the {mesh.world}-device mesh")
        state = sharding.init_orchard_fleet(params, mesh, fleet)
        mesh_step = sharding.make_orchard_fleet_step(params, mesh, fleet, FRAMES_PER_BLOCK)

        def fly_block(s, g):
            return mesh_step(s, gen=g)[0], None
        print(f"mesh: {mesh.world} devices, {fleet // mesh.world} vehicles/device")
    else:
        # one batched program, N independent vehicles abreast of each other
        from agrifly_tpu_torch.parallel.sharding import lane_spawns

        state = orchard_env.init_state_fleet(params, lane_spawns(fleet))

        # fly_fleet: one render launch, one inflation launch per planner
        # round and one tick launch a frame for all vehicles
        def fly_block(s, g):
            return orchard_env.fly_fleet(params, s, FRAMES_PER_BLOCK, g)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"agrifly_tpu_torch demo: {dev.type} backend ({name}), "
          f"{w}x{h} depth, goal {tuple(args.goal)}"
          + (f", fleet of {fleet}" if fleet > 1 else ""))

    def _status(v):
        """Print one status line from a read status vector; returns
        (panicked, done)."""
        sim_t = v[0] * 0.002
        if fleet == 1:
            panic = int(v[5])
            mstage = {0: "cruise", 1: "landing", 2: "complete"}[int(v[8])]
            print(
                f"t={sim_t:6.2f}s pos=({v[1]:7.2f},{v[2]:6.2f},{v[3]:5.2f}) "
                f"fs={int(v[4])} "
                f"panic={onboard.PANIC_REASON_NAMES.get(panic, panic)} "
                f"plans={int(v[6])} wp={int(v[7])} {mstage}"
            )
            return panic != 0, int(v[8]) == 2
        print(
            f"t={sim_t:6.2f}s x=[{v[1]:6.2f},{v[2]:6.2f}] "
            f"z=[{v[3]:4.2f},{v[4]:4.2f}] "
            f"panics={int(v[5])}/{fleet} plans={int(v[6])} "
            f"landed={int(v[7])}/{fleet}"
        )
        return int(v[5]) != 0, int(v[7]) == fleet

    # Pipelined block loop: queue block b, then read the status vector of
    # block b - READ_EVERY, whose copy to the host started right after that
    # block (pinned memory and an event on the card), so the read waits for
    # that block only. Status, panic-abort and landing-exit run up to
    # READ_EVERY blocks (~4 s of sim) late.
    t_wall = time.perf_counter()
    blocks = max(1, args.frames // FRAMES_PER_BLOCK)
    state, _ = fly_block(state, gen)
    vec = _status_copy(_status_values(state, fleet, mesh))
    _status_read(vec)  # the first block builds the kernels: the steady figure starts here
    t_compiled = time.perf_counter()
    prev_vec = vec
    ran = 1
    for b in range(1, blocks):
        state, _ = fly_block(state, gen)
        vec = _status_copy(_status_values(state, fleet, mesh))
        ran += 1
        if b % READ_EVERY == 0:
            panicked, done = _status(_status_read(prev_vec))
            if panicked:
                print("PANIC — aborting")
                break
            if done:
                print("landed — mission complete")
                break
        prev_vec = vec
    _sync(dev)
    t_end = time.perf_counter()
    wall = t_end - t_wall
    _status(_status_read(vec))
    sim_time = int(state.base.step.reshape(-1)[0]) * 0.002
    msg = (f"flew {sim_time:.1f}s of sim time in {wall:.1f}s wall "
           f"({sim_time / wall:.2f}x realtime incl. compile)")
    if ran > 1:
        # the first block builds the kernels; the rest are steady state
        steady_wall = t_end - t_compiled
        steady_sim = FRAMES_PER_BLOCK * params.steps_per_frame * 0.002 * (ran - 1)
        msg += (f"; steady state {steady_sim / steady_wall:.2f}x realtime "
                f"({steady_wall / (ran - 1) / FRAMES_PER_BLOCK * 1e3:.1f} ms/frame)")
        if fleet > 1:
            msg += (f"; aggregate {fleet * steady_sim / steady_wall:.1f}x realtime over "
                    f"{fleet} vehicles")
    print(msg)

    if args.csv and mesh is not None:
        print("--csv is not supported with --mesh (metrics-only outputs)")
        args.csv = None
    if args.csv:
        # re-fly a block from the final state, recording its outputs; its
        # draws come from a copy of the generator, so the checkpoint's
        # generator continues the saved state exactly as this block did
        from agrifly_tpu_torch.utils import simlog

        gen_csv = torch.Generator(device=dev)
        gen_csv.set_state(gen.get_state())
        _, outs = fly_block(state, gen_csv)
        if fleet > 1:  # log vehicle 0 (fly_fleet stacks outputs (frames, B, ...))
            outs = {k: v[:, 0] for k, v in outs.items()}
        import types

        n = outs["pos"].shape[0]
        traj = types.SimpleNamespace(
            pos=outs["pos"], vel=outs["vel"], att=outs["att"],
            angvel=torch.zeros((n, 3)), motor_speeds=torch.zeros((n, 4)),
            panic_reason=outs["panic"],
        )
        simlog.write_rollout_csv(args.csv, traj, dt=params.steps_per_frame * 0.002)
        print(f"wrote {args.csv}")
    rank0 = mesh is None or mesh.rank == 0
    if args.rgb and rank0:  # rank 0 holds vehicle 0
        rgb = final_rgb(params, state)
        _write_ppm(args.rgb, rgb)
        print(f"wrote {args.rgb} ({rgb.shape[1]}x{rgb.shape[0]} PPM)")
    if args.ckpt:
        from agrifly_tpu_torch.utils import checkpoint

        if mesh is not None:  # the whole fleet, saved by rank 0
            from agrifly_tpu_torch.parallel import sharding

            whole = sharding.gather_rows(state, mesh)
        if rank0:
            kind = checkpoint.save(args.ckpt, state if mesh is None else whole, gen)
            print(f"checkpoint saved ({kind}): {args.ckpt}")
    return Flight(0, params, state, gen)


def main(argv=None) -> int:
    return run(parse_args(argv)).rc


if __name__ == "__main__":
    sys.exit(main())
