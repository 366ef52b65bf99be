"""One-command multi-component bringup — `agrifly.launch` parity, on the port.

The reference's front door for the ROS workflow is a single launch file
(AIFS_ROS/hiperlab_rostools/launch/agrifly.launch:9-14) wiring the image
bridge, the lockstep simulator, the RAPPIDS planner/controller node and
the keyboard teleop with shared params (use_sim_time, traj_file).

    python -m agrifly_tpu_torch.launch [--frames N] [--traj-file PATH]
        [--record PATH] [--teleop MODE] [--image WxH] [--cpu] ...

wires the equivalent components in one process:
  - OrchardBridge        — sim + planner + controller + image topics
                           (depthImage/rgbImage/imageReceivedFlag, truth,
                           planner/controller diagnostics)
  - MessageRecorder      — rosbag_record_airsim.sh equivalent (JSONL bag,
                           image topics excluded like the script)
  - VehicleMonitor       — live per-second health line (sim-time rates)
  - teleop               — keyboard / joystick / scripted operator: the
                           START button arms the mission (the launch file
                           starts keyboard teleop for exactly this), the
                           RED button emergency-kills through the real
                           radio codec + 30 ms delay line

The mission does NOT fly until armed (keyboardmain.cpp operator flow);
pass --auto-start for unattended bringup. Everything shares one TopicBus
(deterministic step-indexed time, the sync_simulator default).

The port of `agrifly_tpu/launch.py`. It runs on the card and raises where
there is none; `--cpu` runs every tensor on the CPU. Each frame is one
`OrchardBridge.frame()`, a one-frame `orchard_env.fly_diag` block with the
params' default `fused_ticks=True`: on the card the tick kernel (K3) runs
the frame's ticks beside the raycast (K1) and inflation (K2c) kernels,
where the JAX launcher keeps the jnp tick scan; on the CPU the wrapper
runs the plain ticks.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=600,
                    help="max 32 ms frames to fly (default ~19 s sim)")
    ap.add_argument("--goal", type=float, nargs=3, default=(120.0, 0.0, 3.5))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image", type=str, default="640x480")
    ap.add_argument("--candidates", type=int, default=256)
    ap.add_argument("--traj-file", type=str, default=None,
                    help="waypoint file ('x,y,z' lines — the launch "
                         "file's traj_file param); lands after the last")
    ap.add_argument("--record", type=str, default="agrifly_bag.jsonl",
                    help="JSONL bag path (rosbag record -a equivalent); "
                         "'' disables")
    ap.add_argument("--record-images", action="store_true",
                    help="include depth/rgb image topics in the bag")
    ap.add_argument("--image-throttle", type=int, default=1,
                    help="publish image topics every Nth frame")
    ap.add_argument("--teleop", type=str, default="keyboard",
                    help="'keyboard' (s arms, b kills), 'joystick', or "
                         "'scripted:T:BUTTON,...'")
    ap.add_argument("--auto-start", action="store_true",
                    help="arm the mission immediately (no operator)")
    ap.add_argument("--vehicle-id", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from agrifly_tpu_torch import card_or_raise
    from agrifly_tpu_torch.io import bridge as bridge_mod
    from agrifly_tpu_torch.io import teleop as teleop_mod
    from agrifly_tpu_torch.models import logic as onboard
    from agrifly_tpu_torch.sim import orchard_env
    from agrifly_tpu_torch.utils import monitor as monitor_mod

    dev = torch.device("cpu") if args.cpu else card_or_raise("cuda", "agrifly_tpu_torch.launch")
    w, h = (int(x) for x in args.image.split("x"))
    waypoints = None
    if args.traj_file:
        from agrifly_tpu_torch.sim import mission

        waypoints = mission.load_trajectory_file(args.traj_file)
        print(f"loaded {len(waypoints)} waypoints from {args.traj_file}")

    def int32(value):
        return torch.tensor(value, dtype=torch.int32, device=dev)

    params = orchard_env.make_params(
        goal_world=tuple(args.goal), width=w, height=h,
        n_candidates=args.candidates, seed=args.seed, waypoints=waypoints,
        land=args.traj_file is not None, device=dev)
    armed = bool(args.auto_start)
    if not armed:  # disarmed: the start step is never reached until the operator arms
        params = params._replace(start_flight_step=int32(2 ** 30))
    ob = bridge_mod.OrchardBridge(
        params, vehicle_id=args.vehicle_id, seed=args.seed,
        image_throttle=args.image_throttle)
    rec = None
    if args.record:
        rec = bridge_mod.MessageRecorder(
            ob.bus, args.record, record_images=args.record_images)
    mon = monitor_mod.VehicleMonitor(ob.bus, args.vehicle_id)
    js = None if args.auto_start else teleop_mod.make(args.teleop)

    vid = args.vehicle_id
    dt = float(params.base.dt_us) * 1e-6
    killed = False
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"agrifly_tpu_torch launch: {dev.type} backend ({name}), "
          f"{w}x{h}, bag={'off' if not rec else args.record}, "
          f"teleop={'auto-start' if js is None else args.teleop}")
    if js is not None:
        print("press start to arm the mission, red to kill")

    t_wall = time.perf_counter()
    rc = 0
    last_step = 0
    for b in range(args.frames):
        # status rides the frame's own host outputs (ob.last_outs), never
        # the live state
        t = float(last_step) * dt
        if js is not None:
            jsv = js.poll(t)
            if jsv.buttonStart and not armed:
                armed = True
                # arming moves the params' scalar; the next frame reads it
                ob.params = ob.params._replace(start_flight_step=int32(last_step + 1))
                print(f"t={t:6.2f}s ARMED — mission start (start button)")
            if jsv.buttonRed and not killed:
                killed = True
                from agrifly_tpu_torch.io import messages as msgs
                from agrifly_tpu_torch.io import radio as radio_codec

                raw = radio_codec.fields_to_bytes(
                    *radio_codec.make_kill_command())
                ob.bus.publish(f"radio_command{vid}",
                               msgs.RadioCommand(raw=raw))
                print(f"t={t:6.2f}s KILL — emergency-kill on the radio "
                      f"(red button)")
        ob.frame()
        row = {k: ob.last_outs[k][-1] for k in
               ("step", "flight_state", "pos", "plan_count", "panic", "mstage")}
        last_step = int(row["step"])
        fs = int(row["flight_state"])
        if (b + 1) % 31 == 0 or fs == onboard.FS_KILLED:
            pos = row["pos"]
            print(f"[{t:6.2f}s] {mon.render(now=t)}  "
                  f"pos=({pos[0]:6.2f},{pos[1]:5.2f},{pos[2]:4.2f}) "
                  f"plans={int(row['plan_count'])}")
        if fs == onboard.FS_KILLED:
            print("vehicle KILLED — motors off")
            break
        if int(row["panic"]) != 0:
            print(f"PANIC: {onboard.PANIC_REASON_NAMES.get(int(row['panic']))}")
            rc = 1
            break
        if int(row["mstage"]) == 2:
            print("landed — mission complete")
            break
    wall = time.perf_counter() - t_wall
    if js is not None and hasattr(js, "close"):
        js.close()
    if rec is not None:
        rec.close()
        print(f"bag: {rec.count} messages -> {args.record}")
    print(f"flew {last_step * dt:.1f}s sim in {wall:.1f}s wall")
    return rc


if __name__ == "__main__":
    sys.exit(main())
