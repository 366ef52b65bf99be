#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port, `agrifly_tpu_torch`.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the eight CUDA kernel libraries from `agrifly_tpu_torch/csrc`,
the section-timed variants of `frame.cu`, `rollout.cu`, `fleet_uwb.cu` and
`meshscene.cu` and the UWB, wind and wind + UWB builds of `rollout.cu` (one nvcc
each, all in parallel) and holds each kernel against its plain
PyTorch version at the shapes the orchard frame gives it: the raycaster
bit for bit (one image and 16 in one launch, on the default orchard, a
scene at `make_params`' limit and one whose second canopy spheres leave
their cells, with the cells its early exit evaluates equal to its plain
mirror's), the two imported-world (mesh) raycasters, strip-culled and
window, bit for bit and against each other (a baked orchard and a scene of
spheres, cylinders and OBJ triangles; 1 and 16 cameras in one launch; the
strip-culled kernel's per-strip row counts equal to `strip_windows`'; a
window of edge-case rows), the RGB instances of both raycasters bit for bit
(K1-rgb and K4-rgb, against `raycast.render_rgb` and both plain mesh scans:
1 and 16 cameras, a camera above the canopy whose trees all lie beyond the
far plane, cameras pitched up, the edge rows with a pair tied on t, K4-rgb
on a shuffled 300-row window whose rows win pixels in both staged chunks;
K1-rgb's cells per pixel equal to its plain mirror's and their mean by the
pixel's winner, sky, ground or tree, beside the exit before its clear exit;
then K4's and K4-rgb's clock64() section timers, blocks per SM, waves and
floor at K = 0), the
pyramid inflation bit for bit (one image, and 16 fleet images in one
launch), the fused 16-tick block within the tick tolerances in five
mission states, for one vehicle and for fleets of 5 and 37 in one launch
(the fleets against the plain ticks on CPU copies of their inputs; then
its device time with 0, 1 and 16 ticks, at B = 1, 16 and 64, and
clock64() timers around the tick chain's sections, in a variant of
`csrc/frame.cu` built beside the kernels). The grouped
inflation kernel (K2g, a cluster of S blocks per S seeds) is held bit for
bit against the one-seed kernel and the plain version on the endpoint seeds
of the RAPPIDS evaluation harnesses (128 candidates on four orchard views at
640x480, every S = 2 .. 8; 1024 candidates, S = 2, 4, 8), ragged, on a
blocker-free scene and batched, and timed against K2 at S = 2, 4, 8. It then runs the evaluation path on those views
(`measure_conservativeness`, `measure_plan_conservativeness`,
`measure_collision_checking_speed`, `find_fastest_trajectory`) and checks
that no candidate the pyramid check frees collides by the ray-sphere
oracle. It then flies:

- the single-vehicle orchard frame (640x480 depth, 256 candidates, 16
  ticks per frame) through `OrchardEnv.fly`: 80 frames in the default
  configuration, whose ticks are the fused kernel, and 3 frames with
  `fused_ticks=False`, whose ticks are plain torch; every frame's planner
  makes one launch of the gate kernel (K8) and two of the collision-check
  kernel (K7, `csrc/plan.cu`), which are then held bit for bit against
  their plain versions on the flight's frame, a fleet of 16 copies of it
  and the evaluation's 4 x 1024 candidates (first check and lazy
  re-check; the gates also on random and near-limit trajectories, strict
  and not, with and without the static_max_tf cut) and timed; each frame
  split notes the percept head and the plan's parts (`plan_split`); every
  frame also makes one launch of the percept head (K9, `csrc/frame.cu`),
  two of the round seeds (K10), three of the pyramid set (K11) and one of
  the lazy seeds (K12, `csrc/rounds.cu`), which `check_plan_rounds` then
  holds bit for bit against their plain versions on the flight's frame, a
  fleet of 16 copies of it and adversarial cases (tied, -0.0, NaN and +inf
  costs, no gated candidate, a full set, fail points on the image's
  edges), K11 also on the evaluation's 4 x 1024 seeds, and times;
- a fleet of 16 vehicles in lanes 3 m apart, 40 frames through
  `OrchardEnv.fly_fleet`, whose every frame launches the raycaster once,
  the inflation once per planner round and the tick kernel once, for all
  16 vehicles; then timed fleet frames of 64 vehicles;
- the same frame through an imported world (`make_params(mesh_scene=...)`,
  the procedural orchard baked into primitives): first in turns with the
  procedural orchard from the single flight's final state (2 frames each,
  procedural, imported, imported, procedural), then one vehicle for 50
  frames and 16 in lanes for 10, every frame launching the strip-culled
  mesh kernel once and the procedural raycaster never; then one batch
  render of the fleet's poses through the window mesh kernel;
- what a topic bridge computes each frame, in both worlds: 6 frames of
  `OrchardEnv.fly_diag`, each frame's pose rendered to depth and to RGB
  (K1 and K1-rgb, or K4 and K4-rgb), its telemetry encoded on the card and
  on the host (equal), its command encoded on the host and on the card
  (equal); then fly and fly_diag in turns from one state;
- SimBridge's block of ticks, one launch of the env rollout kernel's
  wire-row instance (`cuda_rollout.tick_block`): blocks of 1, 5, 7, 40 and
  250 ticks chained, the telemetry firing on a block's first tick, its
  last, both and every fifth, in every estimator mode from a cold and a
  mid-flight state and in the UWB build, bit for bit against
  `tick_block_plain` on the card (rows and every state leaf); its device
  time at 1 (also in the UWB build), 5, 40 and 250 ticks and the host's
  time a call;
- the port's topic bridge (`io/bridge`): SimBridge for 60 ticks with the
  mocap estimator and a kill on radio_command1, without and with a UWB
  network of four anchors, which ranges: `tick` (one launch of the wire-row
  instance a tick, env.step never called) held to `tick_plain` on the card
  bit for bit (bags and final states), its bag to the same flight's on the
  CPU (the tick criteria, telemetry within one code) and its `run_blocked`
  bag (one kernel launch a block) to its `run` bag (bit for bit but the
  euler angles, within 2e-6 rad), a dispatched block that makes no
  synchronizing call and a tick that makes one, the ticks per second of
  run, tick_plain and run_blocked, the host's µs a tick split into the
  wrapper, the row's copy and the publish, the paced loop with device
  blocks at the reference's 500 Hz, 5 ticks a quantum, for 2 s with a
  kill, held to `benchmarks/verify_realtime500.py`'s four criteria (the
  rate within 2.5%, under 5% of the quanta late, the mocap and telemetry
  bands), and the per-tick paced loop at the same rate (a reading);
  OrchardBridge at 640x480 with 256 candidates from the
  single flight's state in both worlds, 6 frames synced and 6 pipelined
  from the same draws (byte-equal bags, images included; every depth image
  its frame's own render; per frame the depth kernel twice, the inflation
  once per planner round, the tick kernel once and the RGB kernel once; a
  dispatched frame that makes no synchronizing call),
  ms a frame of both, fly_diag and the bridge frame in turns, and the paced
  loop at 2 frames a second with a kill;
- the port's front doors, in this process at 640x480 with 256 candidates:
  `demo` for 62 frames (ms a frame beside `fly`'s, and beside 10 frames
  flown through `orchard_env.fly` on the demo's params), `demo --fleet 16`,
  `demo --scene-file` on the mixed scene's primitives file with `--rgb`,
  `--csv` and `--ckpt` (the PPM equal to the RGB kernel's image of the
  restored final state, the CSV one row a frame, frames flown from the
  checkpoint equal to the same frames from the saved state bit for bit),
  `demo --teleop` (armed, killed, KILLED), `demo --record` (the bag's
  topics) and `launch` with an operator and a bag (the JAX test's topic
  checks, the kill once), each run's kernel launches counted; then
  `demo --realtime` at its defaults (500 Hz) for 2 s, held to the same four
  criteria, one kernel launch a quantum, and `--realtime-orchard` at its
  default rate, the reference's real time (31.25 frames/s), with rc 0 (the
  wire bands held) and the loop's unpaced frame beside the demo's;
- the multi-device path (`agrifly_tpu_torch/parallel`), a world of one over
  NCCL on this card: the sharded fleet step at 4096 envs x 50 substeps in
  both estimator modes (bit-equal to `env.rollout`, its metrics equal to
  the rows' reductions), the candidate-sharded planner at 640x480 with 1024
  candidates (bit-equal to the same call on the CPU over a gloo group), the
  orchard fleet step of 16 vehicles x 31 frames (bit-equal to `fly_fleet`;
  K1, K2/K2c and K3b counted); then `demo --mesh --fleet 16` against `demo
  --fleet 16` (lines and final state) and `python -m
  agrifly_tpu_torch.parallel.dryrun 1` (and on min(cards, 4) cards where
  the host has two or more);
- `sim/env`'s fleet physics rollout (K5, `csrc/rollout.cu`) at bench.py's
  shape: 4096 envs x 250 steps per `env.rollout_fast` call, hover, IMU
  noise drawn inside each call, with the true state and with the mocap
  estimator, 8 timed calls each (steps/s, and the host's time to return
  from a call, split by the wrapper's steps); K5 with 2, 4 and 8 lanes per
  env held bit for bit against 1 lane (all 4096 envs with the true state,
  64 with the estimator, 250 steps), the default held against the plain
  (vmapped) rollout on the card (25 steps by the tick criteria, 250 by
  JAX's rollout_fast terms; past its first 25 eager steps every long plain
  rollout on the card is replayed as one CUDA graph of its eager step,
  bit for bit the eager loop's) and on the CPU from mid-flight; the device time
  of every lane count at 1, 64 and 4096 envs in both modes, and with 0
  steps; clock64() timers around the tick's sections in a variant of
  `csrc/rollout.cu` built beside the kernels; and the plain rollout's rate;
  then the GPS-IMU estimator and the onboard-UWB build at the same shape;
- `sim/fleet_env`'s fleets (config #5): the wind fleet through K5's
  `-DTICK_WIND` build (every lane count bit-equal to one lane, calm wind
  bit-equal to K5, against the plain rollout on the card, the formation
  and drift flights of tests/test_fleet_and_bridge.py, and `fleet_rollout`
  at 4096 vehicles x 250 steps in both estimator modes, K5-wind's device
  time beside K5's in turns); the wind fleet whose vehicles each carry a
  UWB network of their own through K5's `-DTICK_UWB -DTICK_WIND` build (every
  lane count bit-equal to one lane, `fleet_rollout` at 4096 vehicles x 250
  steps in both estimator modes bit-equal to the plain rollout on the card
  and, from mid-flight, against the plain rollout on the CPU; its device
  time in turns with K5-UWB's and K5-wind's); and the shared-UWB fleet through K6
  (`csrc/fleet_uwb.cu`: against the plain version, that test's 7500-tick
  three-vehicle flight, its device time a tick at 3 and 28 vehicles, and
  clock64() timers around its tick's sections on a vehicle and on the
  network's warp, in a variant built beside the kernels); and
  `sim/mission` with the small modules on the card against the CPU.

With `--parent DIR` (a checkout of the parent commit) it also holds K1,
K4, K4w, K3, K5 in every mode, K6 (3 and 28 vehicles, every lane count,
idle, position and rates commands, and the 7500-tick flight), K1-rgb (the
three scenes, above the canopy and pitched up) and K4-rgb (both worlds,
windows of 192 and 300 rows and a shuffled one, above the canopy, the edge
rows) bit for bit against the parent's kernels, built from
DIR and called through this tree's wrappers where the parent declares the
same C interface, and times both in turns (K5 also at bench.py's shape,
4096 envs x 250 steps, the true state and mocap, three times in turns);
and flies 20 frames of the parent's checkout (in a process of its own) and
of this tree in turns, the flights bit for bit.

Each flight's kernel counts are set to 0 just before it and read just
after; it checks that the flight went through its kernels and that its
output is sane, and holds a 16-tick block of the kernel on the card against
the plain block on the CPU from the flight's final state. It prints the
card's name and power limit, build and kernel times (each kernel's device
time from CUDA events), frame times and their split, each phase's wall
seconds, then one JSON line with the kernels and, last, one JSON line with
the device. It exits non-zero, with no result, when anything fails or
there is no CUDA device.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time

FRAMES = 80  # the default (fused) single-vehicle flight
PLAIN_FRAMES = 3  # the fused_ticks=False flight
FLEET, FLEET_FRAMES, BIG_FLEET = 16, 40, 64  # the fleet flight; the timed big fleet
FLEET_START = 0.3  # [s] planning starts inside the fleet flight
MESH_FRAMES, MESH_FLEET_FRAMES = 50, 10  # the imported-world flights
TURN_FRAMES = 2  # frames per turn when the two worlds are flown in turns
MESH_X, MESH_Y = (-10.0, 130.0), (-30.0, 30.0)  # the baked rectangle of the orchard [m]
SEED = 0
KERNELS = ("raycast", "inflate", "frame", "meshscene", "rollout",
           "fleet_uwb", "plan", "rounds")  # one library per csrc/<name>.cu
DEVICE_KERNELS = ("raycast_kernel", "raycast_rgb_kernel", "inflate_kernel",
                  "inflate_cluster_kernel", "inflate_grouped_kernel", "frame_kernel",
                  "meshscene_strips_kernel", "meshscene_window_kernel", "meshscene_rgb_kernel",
                  "rollout_kernel", "fleet_uwb_kernel", "collision_check_kernel",
                  "plan_gates_kernel", "percept_head_kernel", "round_seeds_kernel",
                  "pyramid_set_kernel", "lazy_seeds_kernel")
GROUPS = (2, 4, 8)  # the K2g instances held on every case and timed (seeds per cluster)
# The RAPPIDS evaluation views (benchmarks/bench_quality.py): identity
# attitude at these positions; the harnesses' start state and goal.
EVAL_POSES = ((5.0, 0.0, 2.5), (12.0, 1.5, 2.0), (20.0, -1.0, 3.0), (30.0, 0.5, 1.5))
EVAL_VEL0, EVAL_GRAV, EVAL_GOAL = (0.0, 0.0, 1.5), (0.0, 9.81, 0.0), (0.0, 0.0, 50.0)

# The least time the card could take for a kernel's work (its bound): the
# larger of its bytes over the memory rate and its operations over the
# float32 rate outside the tensor cores (an NVIDIA H100 SXM at 700 W; the
# kernels' integer operations are counted at that rate too, which can only
# lower the bound). Operation counts per item are read off the sources.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
SPIN_CYCLES = 10_000_000  # GPU clock cycles device_us queues ahead of a timed launch (~5 ms)
RAY_OPS_PER_CELL = 150  # csrc/raycast.cu tree_hit: 5 hashes, cylinder, 2 spheres
RAY_OPS_PER_PIXEL = 40  # ray set-up, ground plane, DDA set-up, code
INFLATE_OPS_PER_PIXEL = 8  # csrc/inflate.cu pass C: one shrink divide, 4 band tests
TICK_OPS = 20000  # csrc/frame.cu sim_tick, float operations per vehicle and tick
# csrc/meshscene.cu, each term counted where the inputs need it: per pixel
# (its ray; a = ca + dz^2 and 4a, 2a, 4ca, 2ca; the ground plane; the code);
# per window row and vehicle, by kind (none, sphere, cylinder, triangle), its
# camera-relative form (the clamped kind; camera - p0; a sphere's or
# cylinder's cc; a triangle's qv = tv x e1 and qv . e2); per pixel and tested
# row, by kind, the float operations of a miss (a sphere's or cylinder's
# discriminant and its test; a triangle's edge products, det, the divide and
# u to its first reject); a hit's square root and divides are not counted
MESH_OPS_PER_PIXEL = 41
MESH_PREP_OPS = (3, 13, 10, 20)
MESH_ROW_OPS = (0, 10, 9, 24)
# K4's and K4-rgb's culling of one row (not of kind 0: the window's padding
# returns at once) for one strip: bounding sphere, camera, 7 tests
MESH_CULL_OPS = 70
# The RGB pass (K1-rgb, K4-rgb), counted as above: per visited cell the
# winner's compare and three selects; per pixel the winning tree's five
# hashes and geometry, its normal (~3 square roots and 3 divides) and the
# shading (procedural), or the winning row's normal and the shading
# (imported, where a tested row's tie test is not counted)
RGB_RAY_OPS_PER_CELL = 4
RGB_RAY_SHADE_OPS = 130
RGB_MESH_SHADE_OPS = 60
# csrc/plan.cu, float operations read off the source, each double-precision
# acos, cos or pow counted as 20 (its polynomial): K7 per popped section
# (two z and two x/y positions, the projection, the first pyramid's test,
# four face quartics: five dot products, the resolvent cubic with its acos
# and three cos, two quadratics, the window tests) and per candidate (zdot's
# quartic, the six-bound sort); K8 per evaluated bisection section (two
# thrusts, three axes' acceleration extrema and jerk bounds, the verdict) and
# per candidate (the stationary times, three velocity cubics, 15 velocities)
PLAN_POP_OPS = 950
PLAN_CANDIDATE_OPS = 250
GATE_SECTION_OPS = 275
GATE_CANDIDATE_OPS = 950
PLAN_LAZY_ROUNDS = 1  # rappids.plan's default lazy_rounds, the frame's: 1 + 1 checks a frame
ABOVE_CANOPY = (10.0, 3.0, 14.0)  # a level camera here meets trees only beyond the far plane
BRIDGE_FRAMES = 6  # the fly_diag flights' frames, in each world


def _check(cond, what):
    if not cond:
        raise RuntimeError(what)


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds per call of fn on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0])


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def result(err, ms, plain_ms, n_bytes, n_ops):
    """A kernel's line: its error and times, and its bound, the larger of
    the memory and the operation time."""
    t_bytes, t_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_ops / OPS_PER_S
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def lanes(B, dev, x=0.0, z=0.0):
    """B positions in lanes 3 m apart, centred on y = 0 (the JAX package's
    fleet benchmark spawns its fleet so)."""
    import torch

    y = (torch.arange(B, dtype=torch.float32) - (B - 1) / 2.0) * 3.0
    return torch.stack([torch.full((B,), float(x)), y, torch.full((B,), float(z))], 1).to(dev)


# The scenes K1 is held on, as make_params keywords (the same for the port
# and the JAX package; tests/test_torch_raycast_exit.py and
# tests/test_torch_kernels.py import them from here).
RAY_SCENES = {
    "default": {},
    # jitter + 1.2 canopy_radius = 2.0 = half the 4 m tree spacing
    "limit": {"jitter": 0.38},
    # accepted by make_params (1.88 + 1.2 * 0.1 = 2.0), but the second canopy
    # sphere reaches 1.88 + 0.3 + 0.84 * 0.1 = 2.264 m from the cell centre,
    # so the containment test fails and the early exit must stay off
    "loose": {"jitter": 1.88, "canopy_radius": 0.1, "trunk_radius": 0.1},
}


def check_raycast(dev):
    """The raycast kernel (K1) against raycast.render_depth at 640x480, B = 1
    and 16: bit-equal codes, and the cells its early exit evaluated equal to
    its plain mirror's (render_depth_exit), on the default orchard and on
    the limit and loose scenes; then its wrapper, launch and device times
    on the default orchard."""
    import torch

    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast

    cfg = raycast.make_config(640, 480)
    g = torch.Generator().manual_seed(SEED)
    results = {}
    for B in (1, 16):
        pos = torch.stack([torch.rand(B, generator=g) * 40, torch.rand(B, generator=g) * 16 - 8,
                           torch.rand(B, generator=g) * 3 + 0.5], dim=1).to(dev)
        ypr = ((torch.rand(B, 3, generator=g) - 0.5) * 0.6).to(dev)
        cam = raycast.camera_attitude(rot.from_euler_ypr(ypr[:, 0], ypr[:, 1], ypr[:, 2]))
        mean_cells = {}
        for name, kw in RAY_SCENES.items():
            scene = orchard.make_params(device=dev, **kw)
            got = cuda_raycast.render_depth_batch(cfg, scene, pos, cam)
            ref = raycast.render_depth(cfg, scene, pos, cam)
            err = int((got - ref).abs().max())
            _check(err == 0, f"raycast kernel differs from plain at B={B}, {name} scene "
                             f"(max {err} codes)")
            _check(got.unique().numel() > 20, f"raycast rendered an empty scene ({name})")
            cells = torch.empty_like(got)
            cuda_raycast._launch(cfg, scene, pos, cam, cells)
            _check(torch.equal(cells, raycast.render_depth_exit(cfg, scene, pos, cam)[1]),
                   f"raycast kernel: cells per pixel differ from the plain mirror ({name}, B={B})")
            _check(name != "loose" or int(cells.min()) == cfg.dda_steps,
                   "raycast kernel: early exit on a scene that fails the containment test")
            mean_cells[name] = float(cells.float().mean())
        scene = orchard.make_params(device=dev)
        got = cuda_raycast.render_depth_batch(cfg, scene, pos, cam)
        ms = cuda_ms(lambda: cuda_raycast.render_depth_batch(cfg, scene, pos, cam))
        launch_ms = cuda_ms(lambda: cuda_raycast._launch(cfg, scene, pos, cam), reps=50)
        dev_us = device_us(lambda: cuda_raycast._launch(cfg, scene, pos, cam))
        plain_ms = cuda_ms(lambda: raycast.render_depth(cfg, scene, pos, cam), reps=3)
        # bytes: camera position and attitude, the scene table, the codes;
        # operations: the reference's 8 cells a pixel (the early exit does less)
        res = result(0, ms, plain_ms, nbytes(pos, cam, got) + 40,
                     got.numel() * (RAY_OPS_PER_PIXEL + RAY_OPS_PER_CELL * cfg.dda_steps))
        print(f"raycast B={B} 640x480: bit-equal on the default, limit and loose scenes, cells "
              f"equal to the plain mirror; mean cells per pixel "
              f"{', '.join(f'{k} {v:.4f}' for k, v in mean_cells.items())} of {cfg.dda_steps}; "
              f"kernel {ms:.4f} ms (launch alone {launch_ms:.4f} ms, device {us_text(dev_us)}), "
              f"plain {plain_ms:.4f} ms, bound "
              f"{res['bound_ms']:.6f} ms ({res['bound_by']})")
        results[B] = res
    return results[1]


def _inflate_case(name, prm, img, sd, extra):
    """One inflation call through the kernel, held bit for bit against the
    plain version (ok everywhere, maxd and edges wherever ok), and timed.
    Returns (result, ok seeds)."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate, rappids

    count = lambda: sum(read_counts()[k] for k in ("inflate", "inflate_cluster"))  # noqa: E731
    before = count()
    got = cuda_inflate.inflate_pyramids(prm, img, *sd, extra)
    _check(count() == before + 1, f"inflate ({name}): not one launch")
    ref = rappids.inflate_pyramid(prm, img, *sd, extra)
    ok = ref[0]
    _check(torch.equal(got[0], ok), f"inflate kernel: ok differs ({name})")
    diffs = torch.cat([(got[1] - ref[1])[ok], (got[2] - ref[2])[ok].flatten(),
                       torch.zeros(1, dtype=torch.int32, device=img.device)])
    err = int(diffs.abs().max())
    _check(err == 0, f"inflate kernel: maxd/edges differ on ok seeds ({name})")
    n_ok = int(ok.sum())
    ms = cuda_ms(lambda: cuda_inflate.inflate_pyramids(prm, img, *sd, extra))
    rows = rappids.seed_rows(prm, *sd, extra)
    launch_ms = cuda_ms(lambda: cuda_inflate._launch(img, rows), reps=50)
    plain_ms = cuda_ms(lambda: rappids.inflate_pyramid(prm, img, *sd, extra), reps=3)
    # bytes: the images, the seed rows and the (.., 8) int32 output rows;
    # operations: every seed that ends ok swept its whole image in pass C
    H, W = img.shape[-2:]
    res = result(err, ms, plain_ms, nbytes(img, rows) + rows.numel() // 12 * 32,
                 n_ok * H * W * INFLATE_OPS_PER_PIXEL)
    dev_us = device_us(lambda: cuda_inflate._launch(img, rows))
    print(f"inflate {name}: bit-equal ({n_ok} ok seeds); kernel {ms:.4f} ms (launch alone "
          f"{launch_ms:.4f} ms, device {us_text(dev_us)}), plain {plain_ms:.4f} ms, bound "
          f"{res['bound_ms']:.6f} ms ({res['bound_by']}); "
          + inflate_clusters(img, rows, got))
    return res, n_ok


def inflate_clusters(img, rows, got):
    """K2 (one block a seed) and K2c at every cluster size whose slab fits,
    each held bit for bit against `got` (the kernel's result) and timed
    (device_us); the text names cluster_size's choice."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate

    H, W = img.shape[-2:]
    B, P = img.numel() // (H * W), rows.shape[-2]
    sizes = [1] + [C for C in cuda_inflate.CLUSTER_SIZES
                   if cuda_inflate.slab_bytes(H, W, C) <= cuda_inflate.MAX_SLAB_BYTES]
    times = {}
    for C in sizes:
        out = cuda_inflate._launch(img, rows, cluster=C)
        ok = out[..., 0] > 0
        _check(torch.equal(ok, got[0]) and torch.equal(out[..., 1][ok], got[1][ok])
               and torch.equal(out[..., 2:6][ok], got[2][ok]),
               f"inflate: K2c C={C} differs from the chosen kernel")
        times[C] = device_us(lambda C=C: cuda_inflate._launch(img, rows, cluster=C))
    chosen = cuda_inflate.cluster_size(B, P, H, W, cuda_inflate._sm_count(img.device.index))
    return ("device by blocks per seed (bit-equal): " + ", ".join(
        f"{'K2' if C == 1 else f'K2c C={C}'} {us_text(t)}" for C, t in times.items())
        + f"; chosen C={chosen}")


def check_inflate(dev):
    """The inflation kernel against rappids.inflate_pyramid on rendered
    orchard frames (pooled 240x320 with P = 10 and 20, full 480x640) and on
    a blocker-free gradient scene."""
    import torch

    from agrifly_tpu_torch.planner import rappids
    from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast

    cfg, scene = raycast.make_config(640, 480), orchard.make_params(device=dev)
    params = rappids.make_params(rappids.make_camera(640, 480, device=dev), 0.116, 0.174)
    pos = torch.tensor([[7.0, 1.5, 2.0], [15.0, -2.0, 3.0]], device=dev)
    att = raycast.camera_attitude(torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2, device=dev))
    frames = cuda_raycast.render_depth_batch(cfg, scene, pos, att)
    pooled, cam_small = rappids._pooled(params, frames[0], 2)
    small = params._replace(cam=cam_small)
    ys, xs = torch.meshgrid(torch.arange(240, device=dev), torch.arange(320, device=dev),
                            indexing="ij")
    gradient = (20000 + 3 * xs + 7 * ys).to(torch.int32)
    g = torch.Generator().manual_seed(SEED)

    def seeds(P, W, H):
        return [(torch.rand(P, generator=g) * 0.8 * W + 0.1 * W).to(dev),
                (torch.rand(P, generator=g) * 0.8 * H + 0.1 * H).to(dev),
                (torch.rand(P, generator=g) * 1.5 + 1.5).to(dev)]

    cases = [("pooled frame 0, P=10", small, pooled, seeds(10, 320, 240), 1),
             ("pooled frame 0, P=20", small, pooled, seeds(20, 320, 240), 1),
             ("pooled frame 1, P=20", small, rappids._pooled(params, frames[1], 2)[0],
              seeds(20, 320, 240), 1),
             ("full-res 480x640, P=20", params, frames[0], seeds(20, 640, 480), 0),
             ("gradient 240x320, P=20", small, gradient, seeds(20, 320, 240), 1)]
    results = [_inflate_case(*case) for case in cases]
    _check(sum(n for _, n in results) > 0,
           "inflate: no seed inflated in any case; the comparison says nothing")
    return results[0][0]


def check_inflate_batched(dev):
    """The inflation kernel on FLEET pooled 240x320 orchard frames rendered
    from fleet poses, 10 seeds each, in one launch, against the batched
    plain version."""
    import torch

    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.planner import rappids
    from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast

    cfg, scene = raycast.make_config(640, 480), orchard.make_params(device=dev)
    params = rappids.make_params(rappids.make_camera(640, 480, device=dev), 0.116, 0.174)
    att = raycast.camera_attitude(rot.identity(dev).expand(FLEET, 4))
    frames = cuda_raycast.render_depth_batch(cfg, scene, lanes(FLEET, dev, x=6.0, z=2.0), att)
    pooled, cam_small = rappids._pooled(params, frames, 2)
    g = torch.Generator().manual_seed(SEED + 3)
    P = 10
    sd = [(torch.rand(FLEET, P, generator=g) * 256 + 32).to(dev),
          (torch.rand(FLEET, P, generator=g) * 192 + 24).to(dev),
          (torch.rand(FLEET, P, generator=g) * 1.5 + 1.5).to(dev)]
    res, n_ok = _inflate_case(f"batched: {FLEET} pooled fleet frames x P={P}",
                              params._replace(cam=cam_small), pooled, sd, 1)
    _check(n_ok > 0, "batched inflate: no seed inflated; the comparison says nothing")
    return res


def eval_views(dev):
    """The planner parameters of the evaluation harnesses and their four
    orchard views at 640x480, rendered in one raycast launch."""
    import torch

    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.planner import rappids
    from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast

    params = rappids.make_params(rappids.make_camera(640, 480, focal=320.0, device=dev),
                                 true_radius=0.116, plan_radius=0.174, min_check_dist=0.5)
    att = raycast.camera_attitude(rot.identity(dev).expand(len(EVAL_POSES), 4))
    before = cuda_raycast.render_depth_batch.launches
    views = cuda_raycast.render_depth_batch(raycast.make_config(640, 480),
                                            orchard.make_params(seed=SEED, device=dev),
                                            torch.tensor(EVAL_POSES, device=dev), att)
    _check(cuda_raycast.render_depth_batch.launches == before + 1, "views: not one launch")
    return params, views


def eval_state(dev):
    """The harnesses' (4, 3) start velocity, acceleration and gravity."""
    import torch

    vec = lambda v: torch.tensor(v, device=dev).expand(len(EVAL_POSES), 3)  # noqa: E731
    return vec(EVAL_VEL0), vec((0.0, 0.0, 0.0)), vec(EVAL_GRAV)


def eval_draws(n, dev):
    """The (4 views, 4, n) uniform block of the harness with n candidates."""
    import torch

    g = torch.Generator().manual_seed(SEED + n)
    return torch.rand(len(EVAL_POSES), 4, n, generator=g).to(dev)


def endpoint_seeds(params, u, dev):
    """The candidates' endpoints (px, py, depth), each (4, n): the seeds
    `measure_conservativeness` and `measure_collision_checking_speed`
    inflate."""
    from agrifly_tpu_torch.planner import rappids

    return list(rappids.endpoint_seeds(
        params, rappids.sample_candidates(params, u, *eval_state(dev)[:2])))


def _same_inflation(got, ref, what):
    """ok everywhere, maxd and edges wherever ok; returns the number ok."""
    import torch

    ok = ref[0]
    _check(torch.equal(got[0], ok), f"grouped inflation: ok differs ({what})")
    _check(torch.equal(got[1][ok], ref[1][ok]) and torch.equal(got[2][ok], ref[2][ok]),
           f"grouped inflation: maxd/edges differ on ok seeds ({what})")
    return int(ok.sum())


def us_text(v):
    return "not measured" if v is None else f"{v:.1f} us"


def device_us(launch, reps=5):
    """Device microseconds of one call of `launch` (which launches one
    kernel), the mean of `reps`: CUDA events around the call, queued behind
    a few milliseconds of GPU spin so that the launch is on the stream before
    the start event runs and the host's launch cost stays out of the time."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    launch()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return 1e3 * total / reps


def time_grouped(label, prm, img, sd, extra, plain=False):
    """K2 (K2c where the wrapper picks it) and K2g at each S on one image's
    seeds: the wrapper, the bare launch, and the device time (device_us).
    Returns {S: (wrapper ms, launch ms, device us)}, plain ms (or None),
    the seeds that ended ok and the bytes and operations of K2's bound."""
    from agrifly_tpu_torch.planner import cuda_inflate, rappids

    rows = rappids.seed_rows(prm, *sd, extra)
    padded = {S: cuda_inflate.pad_seed_rows(rows, S) for S in GROUPS}
    launch = {1: lambda: cuda_inflate._launch(img, rows),
              **{S: (lambda S=S: cuda_inflate._launch_grouped(img, padded[S], S)) for S in GROUPS}}
    wrapper = {S: cuda_ms(lambda S=S: cuda_inflate.inflate_pyramids(prm, img, *sd, extra,
                                                                    seeds_per_program=S))
               for S in launch}
    bare = {S: cuda_ms(fn, reps=20) for S, fn in launch.items()}
    dev_us = {S: device_us(fn) for S, fn in launch.items()}
    n_ok = int(cuda_inflate.inflate_pyramids(prm, img, *sd, extra)[0].sum())
    plain_ms = (cuda_ms(lambda: rappids.inflate_pyramid(prm, img, *sd, extra), reps=3)
                if plain else None)
    H, W = img.shape[-2:]
    bound = (nbytes(img, rows) + rows.numel() // 12 * 32, n_ok * H * W * INFLATE_OPS_PER_PIXEL)
    C = cuda_inflate.cluster_size(img.numel() // (H * W), rows.shape[-2], H, W,
                                  cuda_inflate._sm_count(img.device.index))
    one = "K2" if C == 1 else f"K2c C={C}"  # the kernel inflate_pyramids picks for S = 1
    print(f"inflate timing {label} ({n_ok} ok): " + "; ".join(
        f"{one if S == 1 else f'K2g S={S}'} {wrapper[S]:.4f} ms (launch {bare[S]:.4f} ms, "
        f"device {us_text(dev_us[S])})" for S in launch)
        + (f"; plain {plain_ms:.4f} ms" if plain else ""))
    return {S: (wrapper[S], bare[S], dev_us[S]) for S in launch}, plain_ms, bound


def check_inflate_grouped(dev, params, views):
    """The grouped inflation kernel (K2g) on the evaluation harnesses' seed
    batches: the endpoints of 128 and 1024 candidates on each of the four
    views at full resolution, through inflate_pyramids(seeds_per_program=S)
    for every S = 2 .. 8 (P = 128; clusters of every size) and S in GROUPS
    (P = 1024), counted; each result held bit for bit against K2 and
    (P = 128) the plain version. Then ragged P = 13 (S = 4), the
    blocker-free gradient scene of check_inflate, one batched call over the
    four views, and the times of K2 and K2g. Returns the kernels-line
    fields of K2g (S = 4) and of K2 at P = 128 on view 0, and K2g's
    launches in the counted run."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate, rappids

    batches = {n: endpoint_seeds(params, eval_draws(n, dev), dev) for n in (128, 1024)}
    one = lambda n, v, k=None: [x[v, :k] for x in batches[n]]  # noqa: E731
    every_s = tuple(range(2, cuda_inflate.MAX_SEEDS_PER_PROGRAM + 1))
    reset_counts()
    got = {(n, S, v): cuda_inflate.inflate_pyramids(params, views[v], *one(n, v), 0,
                                                    seeds_per_program=S)
           for n in batches for S in (every_s if n == 128 else GROUPS)
           for v in range(len(EVAL_POSES))}
    torch.cuda.synchronize()
    launches = read_counts()
    _check(launches["inflate_grouped"] == len(got) and launches["inflate"] == 0
           and launches["inflate_cluster"] == 0,
           f"grouped inflation: {launches} for {len(got)} calls")
    refs = {}
    for (n, S, v), out in got.items():
        if (n, v) not in refs:
            refs[n, v] = [cuda_inflate.inflate_pyramids(params, views[v], *one(n, v), 0)]
            if n == 128:
                refs[n, v].append(rappids.inflate_pyramid(params, views[v], *one(n, v), 0))
        for ref in refs[n, v]:
            _same_inflation(out, ref, f"view {v}, P={n}, S={S}")
    ok_by_n = {n: sum(int(refs[n, v][0][0].sum()) for v in range(len(EVAL_POSES)))
               for n in batches}
    _check(min(ok_by_n.values()) > 0, "grouped inflation: no seed inflated")

    # ragged, blocker-free, batched
    sd = one(128, 0, 13)
    ragged = cuda_inflate.inflate_pyramids(params, views[0], *sd, 0, seeds_per_program=4)
    for ref in (cuda_inflate.inflate_pyramids(params, views[0], *sd, 0),
                rappids.inflate_pyramid(params, views[0], *sd, 0)):
        _same_inflation(ragged, ref, "ragged P=13, S=4")
    _, cam_small = rappids._pooled(params, views[0], 2)
    small = params._replace(cam=cam_small)
    Hs, Ws = cam_small.height, cam_small.width
    ys, xs = torch.meshgrid(torch.arange(Hs, device=dev), torch.arange(Ws, device=dev),
                            indexing="ij")
    gradient = (20000 + 3 * xs + 7 * ys).to(torch.int32)
    g = torch.Generator().manual_seed(SEED)
    gsd = [(torch.rand(20, generator=g) * 0.8 * Ws + 0.1 * Ws).to(dev),
           (torch.rand(20, generator=g) * 0.8 * Hs + 0.1 * Hs).to(dev),
           (torch.rand(20, generator=g) * 1.5 + 1.5).to(dev)]
    g_ref = (cuda_inflate.inflate_pyramids(small, gradient, *gsd, 1),
             rappids.inflate_pyramid(small, gradient, *gsd, 1))
    b_ref = (cuda_inflate.inflate_pyramids(params, views, *batches[128], 0),
             rappids.inflate_pyramid(params, views, *batches[128], 0))
    for S in GROUPS:
        for ref in g_ref:
            n_grad = _same_inflation(cuda_inflate.inflate_pyramids(
                small, gradient, *gsd, 1, seeds_per_program=S), ref, f"gradient, S={S}")
        for ref in b_ref:
            _same_inflation(cuda_inflate.inflate_pyramids(
                params, views, *batches[128], 0, seeds_per_program=S), ref,
                f"batched 4 views x P=128, S={S}")
    _check(n_grad > 0, "grouped inflation: no seed inflated on the gradient scene")
    print(f"inflate_grouped: K2g S={every_s} bit-equal to K2 and to the plain version on the "
          f"endpoint seeds of 4 views x P=128 ({ok_by_n[128]} ok), S={GROUPS} to K2 x P=1024 "
          f"({ok_by_n[1024]} ok); ragged P=13 (S=4), gradient {Ws}x{Hs} ({n_grad} ok), batched "
          f"4 x 128 in one launch (S={GROUPS}): bit-equal; {launches['inflate_grouped']} launches "
          f"in the counted run")
    H, W = views.shape[-2:]

    # times: full resolution at P = 128 and 1024, the frame's pooled image
    # at P = 10 and 20 (the endpoints halved, as build_pyramid_set halves them)
    times = {}
    for n in (128, 1024):
        times[n] = time_grouped(f"{W}x{H} P={n}", params, views[0], one(n, 0), 0, plain=n == 128)
    pooled = rappids._pooled(params, views[0], 2)[0]
    for n in (10, 20):
        psd = [x / 2 for x in one(128, 0, n)[:2]] + [one(128, 0, n)[2]]
        time_grouped(f"pooled {Ws}x{Hs} P={n}", small, pooled, psd, 1)
    (per_s, plain_ms, (n_bytes, n_ops)) = times[128]
    return (result(0, per_s[4][0], plain_ms, n_bytes, n_ops),
            result(0, per_s[1][0], plain_ms, n_bytes, n_ops), launches["inflate_grouped"])


def evaluate(dev, params, views):
    """The RAPPIDS evaluation path on the four views, one call of each
    harness for all four (a leading view axis), counted: then 0
    false-frees against the ray-sphere oracle on the same pyramid sets,
    and some candidates free and some colliding. Returns the launches."""
    import torch

    from agrifly_tpu_torch.planner import oracle, rappids

    vel0, acc0, grav = eval_state(dev)
    goal = torch.tensor(EVAL_GOAL, device=dev).expand(len(EVAL_POSES), 3)
    u = {n: eval_draws(n, dev) for n in (128, 256, 512, 1024)}
    direction = torch.tensor([0.0, 0.0, 1.0], device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inc, cor = rappids.measure_conservativeness(params, views, u[128], vel0, acc0, grav)
    p_inc, p_cor, p_free = rappids.measure_plan_conservativeness(
        params, views, u[256], vel0, acc0, grav, goal, pyramid_capacity=32, rounds=2,
        lazy_rounds=1)
    seconds, per_traj, used = rappids.measure_collision_checking_speed(
        params, views, u[1024], vel0, acc0, grav)
    fast = rappids.find_fastest_trajectory(params, views, u[512], vel0, acc0, grav, direction)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    # K2 once per endpoint set (2), K2 or K2c three rounds per plan (2 plans)
    _check(launches["inflate"] + launches["inflate_cluster"] == 8
           and launches["inflate"] >= 2 and launches["inflate_grouped"] == 0
           and launches["raycast"] == 0, f"evaluation launches {launches}")

    # 0 false-frees on the same pyramid sets
    tr = rappids.sample_candidates(params, u[128], vel0, acc0)
    pyrs = rappids.build_pyramid_set(params, views, *rappids.endpoint_seeds(params, tr),
                                     torch.ones_like(tr.tf, dtype=torch.bool), 32)
    free = rappids.is_collision_free(params, pyrs, tr)
    free_oracle = oracle.is_collision_free_ground_truth(params, views, tr)
    _check(not bool((free & ~free_oracle).any()), "a pyramid-free candidate collides (N=128)")
    _check(torch.equal(inc, (~free & free_oracle).sum(-1, dtype=torch.int32))
           and torch.equal(cor, (~free & ~free_oracle).sum(-1, dtype=torch.int32)),
           "measure_conservativeness disagrees with its parts")
    tr2, _, _, _, gate, cfree, _ = rappids.plan_debug(
        params, views, rappids.samples_from_uniform(params, u[256]), vel0, acc0, grav, goal)
    free2 = oracle.is_collision_free_ground_truth(params, views, tr2)
    _check(not bool((gate & cfree & ~free2).any()), "a planner-free candidate collides (plan)")
    _check(torch.equal(p_free, (gate & cfree).sum(-1, dtype=torch.int32)),
           "measure_plan_conservativeness disagrees with plan_debug")
    best = rappids.traj_mod.Traj(*(x[:, None] for x in fast.traj))
    best_free = oracle.is_collision_free_ground_truth(params, views, best)[:, 0]
    _check(not bool((fast.found & ~best_free).any()), "find_fastest_trajectory picked a collision")
    _check(bool(free_oracle.any()) and bool((~free_oracle).any()) and bool(free.any())
           and bool(fast.found.any()), "the evaluation is vacuous")
    tr0 = rappids.traj_mod.Traj(*(x[0] for x in tr))
    oracle_ms = cuda_ms(lambda: oracle.is_collision_free_ground_truth(params, views[0], tr0),
                        reps=3, warmup=1)
    print(f"evaluate (4 views, {views.shape[-1]}x{views.shape[-2]}, {wall:.3f} s for the four "
          f"harnesses; {launches}): "
          f"conservativeness N=128 incorrect {inc.tolist()} correct {cor.tolist()}, pyramid-free "
          f"{free.sum(-1).tolist()} oracle-free {free_oracle.sum(-1).tolist()}, 0 false-frees; "
          f"plan N=256 (32 pyramids, 2+1 rounds) incorrect {p_inc.tolist()} correct "
          f"{p_cor.tolist()} free {p_free.tolist()}, 0 false-frees; collision checking N=1024: "
          f"{seconds * 1e3:.3f} ms for 4 x 1024, {per_traj * 1e6:.4f} us per trajectory, "
          f"{used} pyramids; fastest N=512 found {fast.found.tolist()} cost "
          f"{[round(c, 4) for c in fast.best_cost.tolist()]}, oracle-free; oracle "
          f"{oracle_ms:.3f} ms per 128 candidates (one view)")
    return launches


# The planner's candidate pass (K7, K8: csrc/plan.cu)


def random_trajs(seed, n, device="cpu"):
    """n trajectories (traj.Traj, p0 = 0, tf in [2, 3]) with coefficients
    over four decades, some exactly 0 and some |alpha| at 7e-6, just above
    the velocity cubic's 6e-6 degenerate threshold: the gates' branches."""
    import numpy as np
    import torch

    from agrifly_tpu_torch.planner import traj

    rng = np.random.default_rng(seed)

    def vec(scale):
        x = rng.standard_normal((n, 3)) * scale * np.exp(rng.uniform(-3, 1, (n, 1)))
        x[rng.uniform(size=(n, 3)) < 0.1] = 0.0
        return x

    al = vec(40.0)
    al[rng.uniform(size=(n, 3)) < 0.05] = 7e-6
    cols = [al, vec(20.0), vec(10.0), vec(5.0), vec(2.0), np.zeros((n, 3)),
            rng.uniform(2.0, 3.0, n), np.zeros(n)]
    return traj.Traj(*(torch.from_numpy(np.asarray(c, np.float32)).to(device) for c in cols))


def near_limit_trajs(seed, n, device="cpu", grav=(0.0, 9.81, 0.0)):
    """n trajectories whose thrust peaks 0.005-0.2 m/s^2 under the planner's
    fmax = 30 (their acceleration scaled so on a 1001-point grid), tf in
    [2.56, 3]: the input bisection narrows toward the peak over many
    levels, and some reach the static_max_tf cut at level 8."""
    import numpy as np
    import torch

    from agrifly_tpu_torch.planner import traj

    rng = np.random.default_rng(seed)
    coef = [rng.standard_normal((n, 3)) * s for s in (1.0, 2.0, 3.0, 2.0)]  # alpha .. a0
    tf = rng.uniform(2.56, 3.0, n)
    ts = (np.linspace(0.0, 1.0, 1001)[None, :] * tf[:, None])[..., None]
    acc = (coef[3][:, None] + coef[2][:, None] * ts + coef[1][:, None] * ts ** 2 / 2.0
           + coef[0][:, None] * ts ** 3 / 6.0)
    target = 30.0 - rng.uniform(0.005, 0.2, n)
    lo, hi = np.zeros(n), np.full(n, 20.0)
    for _ in range(30):
        mid = (lo + hi) / 2.0
        over = np.linalg.norm(mid[:, None, None] * acc - np.asarray(grav), axis=-1).max(-1) > target
        lo, hi = np.where(over, lo, mid), np.where(over, mid, hi)
    cols = [c * lo[:, None] for c in coef] + [rng.standard_normal((n, 3)), np.zeros((n, 3)), tf,
                                              np.zeros(n)]
    return traj.Traj(*(torch.from_numpy(np.asarray(c, np.float32)).to(device) for c in cols))


def strip_pyramids(cam, capacity=80, depth=10.0):
    """Narrow full-height pyramids every W / 80 px, each 7 W / 160 px wide,
    their base at `depth` m, padded to `capacity` slots with unused ones
    (77 strips at any width): a section that sweeps across the image is
    covered a few pixels a pop, and the search needs three 32-pyramid
    ballots."""
    import torch

    from agrifly_tpu_torch.planner import rappids

    W, H, dev = cam.width, cam.height, cam.focal.device
    u = W / 160.0
    left = torch.arange(0.0, W - 7.0 * u, 2.0 * u, device=dev)[:77]
    K = left.numel()
    d = torch.full((K,), depth, device=dev)
    bounds, normals = rappids._pyramid_from_edges(
        cam, left + 7.0 * u, torch.full((K,), 2.0 * u, device=dev), left,
        torch.full((K,), H - 2.0 * u, device=dev), d)
    pad = rappids.empty_pyramid_set(capacity - K, dev)
    return rappids.PyramidSet(*(torch.cat([a, b]) for a, b in zip(
        (d, bounds, normals, torch.ones(K, dtype=torch.bool, device=dev)), pad)))


def wavy_trajs(seed, n, device="cpu"):
    """n trajectories (p0 = 0, tf in [2, 3]) whose zdot has four simple roots
    in (0.2 tf, tf): five monotone sections each, and a lateral drift of up to
    2 m/s. Against `strip_pyramids` a section takes from one pop to more
    than the budget: some candidates spend most of the 24 pops in early
    sections and run out in a later one, and some are covered in several
    pops and then uncovered in a later section."""
    import numpy as np
    import torch

    from agrifly_tpu_torch.planner import traj

    rng = np.random.default_rng(seed)
    tf = rng.uniform(2.0, 3.0, n)
    # zdot's roots, one in each fifth of (0.2 tf, tf), at least 0.04 tf apart
    r = (0.2 + 0.2 * np.arange(4) + rng.uniform(0.02, 0.18, (n, 4))) * tf[:, None]
    sc = rng.uniform(0.5, 2.0, n)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    e2 = sum(r[:, i] * r[:, j] for i, j in pairs)
    e3 = sum(r[:, i] * r[:, j] * r[:, k] for i, j in pairs for k in range(j + 1, 4))
    # zdot = sc (t - r1)(t - r2)(t - r3)(t - r4): alpha, beta, gamma, a0, v0 along z
    z = np.stack([24 * sc, -6 * sc * r.sum(-1), 2 * sc * e2, -sc * e3, sc * r.prod(-1)], -1)
    lat = rng.standard_normal((n, 5, 2)) * np.array([0.5, 1.0, 1.0, 1.0, 1.0])[None, :, None]
    lat[:, 4, 0] = rng.uniform(-2.0, 2.0, n)
    cols = [np.concatenate([lat[:, i], z[:, i:i + 1]], -1) for i in range(5)]
    cols += [np.zeros((n, 3)), tf, np.zeros(n)]
    return traj.Traj(*(torch.from_numpy(np.asarray(c, np.float32)).to(device) for c in cols))


def section_chains(prm, pyrs, tr, enabled, cut=False):
    """K7's decomposition in plain torch (one vehicle: tr (N,), pyrs
    unbatched): each monotone section's chain run alone, all of them side by
    side, up to MAX_CHECK_ITERS pops each, with `collision_check_plain`'s
    operations. cut: a chain stops where its pops and those of the sections
    before it reach the budget, as the kernel's do. Returns (pops,
    uncovered, still live, live at the start), each (N, 5), and the fail
    points (3, N, 5)."""
    import torch

    from agrifly_tpu_torch.planner import rappids, traj

    budget = rappids.MAX_CHECK_ITERS
    t1, t2, valid = rappids.monotonic_sections(tr)
    t1, t2, live0 = t1[..., :5], t2[..., :5], (valid & enabled[..., None])[..., :5]
    trb = traj.Traj(*(x[..., None, :] if x.dim() == 2 else x[..., None] for x in tr))
    live, unc = live0.clone(), torch.zeros_like(live0)
    pops = torch.zeros(live0.shape, dtype=torch.int32, device=live0.device)
    fail = torch.zeros((3,) + live0.shape, device=live0.device)
    for _ in range(budget):
        active = live & ~unc
        if cut:
            active = active & (torch.cumsum(pops, -1) < budget)
        z1, z2 = rappids._poly_at(trb, 2, t1), rappids._poly_at(trb, 2, t2)
        inc = z1 < z2
        skip = (z1 < prm.min_check_dist) & (z2 < prm.min_check_dist)
        deep_t, deep_z = torch.where(inc, t2, t1), torch.maximum(z1, z2)
        px, py = rappids.project(prm.cam, torch.stack(
            [rappids._poly_at(trb, 0, deep_t), rappids._poly_at(trb, 1, deep_t), deep_z], -1))
        found, pidx = rappids.find_containing_pyramid(pyrs, px, py, deep_z)
        hit, t_col = rappids._deepest_collision_time(trb, pyrs.normals[pidx], t1, t2, inc)
        new_t1, new_t2 = torch.where(inc, t1, t_col), torch.where(inc, t_col, t2)
        keep = ~skip & found & hit & ((new_t2 - new_t1) > 1e-6)
        newly = active & ~skip & ~found
        fail = torch.where(newly, torch.stack([px, py, deep_z]), fail)
        unc = unc | newly
        live = torch.where(active & ~newly, keep, live)
        t1, t2 = torch.where(active & keep, new_t1, t1), torch.where(active & keep, new_t2, t2)
        pops = pops + active.to(torch.int32)
    return pops, unc, live & ~unc, live0, fail


def replay(chains):
    """The sequential loop's (free, fail_px, fail_py, fail_depth, pops) from
    `section_chains`: the sections in order with a running sum of pops; the
    budget spent inside a section gives free False, no fail point and
    MAX_CHECK_ITERS pops, a section uncovered within it its fail point, and
    the sections after either are thrown away."""
    import torch

    from agrifly_tpu_torch.planner import rappids

    budget = rappids.MAX_CHECK_ITERS
    pops, unc, still, live0, fail = chains
    it = torch.zeros_like(pops[..., 0])
    free = torch.ones_like(unc[..., 0])
    done = torch.zeros_like(free)
    out = torch.zeros_like(fail[..., 0])
    for j in range(pops.shape[-1]):
        n = pops[..., j]
        over = ~done & ((it + n > budget) | ((it + n == budget) & still[..., j]))
        it, free, done = torch.where(over, budget, it), free & ~over, done | over
        it = torch.where(done, it, it + n)
        u = ~done & unc[..., j]
        free, out, done = free & ~u, torch.where(u, fail[..., j], out), done | u
        end = ~done & (it == budget)
        free = torch.where(end, ~live0[..., j + 1:].any(-1), free)
        done = done | end
    return free, out[0], out[1], out[2], it


def chain_patterns(chains):
    """How many candidates show each adversarial pattern of `section_chains`
    (uncut): five live sections; the budget spent inside a section after
    earlier ones took at least 12 pops; a section uncovered within the
    budget after earlier ones were covered in at least 2 pops."""
    import torch

    from agrifly_tpu_torch.planner import rappids

    budget = rappids.MAX_CHECK_ITERS
    pops, unc, _, live0, _ = chains
    before = torch.cumsum(pops, -1) - pops
    clean = torch.cumsum(unc.to(torch.int32), -1) - unc.to(torch.int32) == 0  # none before
    spent = clean & (before >= 12) & (before < budget) & (before + pops > budget)
    late = clean & unc & (before >= 2) & (before + pops <= budget)
    late[..., 0] = False
    return {"five live sections": int((live0.sum(-1) == 5).sum()),
            "budget spent early": int(spent[..., 1:].any(-1).sum()),
            "uncovered late": int(late.any(-1).sum())}


def adversarial_checks(prm, dev):
    """K7's adversarial sets at prm's camera, each against `strip_pyramids`
    (P = 80, three ballot chunks): "iteration cap" (sampled candidates that
    sweep across the strips), and `wavy_trajs` seeds 0 and 3, whose
    candidates spend the budget early and are uncovered late. Returns
    {name: (tr, pyrs)}."""
    import torch

    from agrifly_tpu_torch.planner import rappids

    cam, n = prm.cam, 256
    g = torch.Generator().manual_seed(SEED + 31)
    W, H = cam.width, cam.height
    samples = (torch.rand(n, generator=g) * 0.8 * W + 0.1 * W,
               torch.rand(n, generator=g) * 0.8 * H + 0.1 * H,
               torch.rand(n, generator=g) * 1.5 + 1.5, torch.rand(n, generator=g) + 2.0)
    sweep = rappids.candidates_from_samples(
        prm, *(x.to(dev) for x in samples), torch.tensor([-1.5, 0.0, 1.5], device=dev),
        torch.zeros(3, device=dev))
    pyrs = strip_pyramids(cam)
    return {"iteration cap": (sweep, pyrs), "budget spent early": (wavy_trajs(0, n, dev), pyrs),
            "uncovered late": (wavy_trajs(3, n, dev), pyrs)}


def plan_args(p, state, u):
    """The (args, kwargs) of the rappids.plan call that
    orchard_env._frame_percept makes from `state` with the draws u."""
    from agrifly_tpu_torch.planner import rappids
    from agrifly_tpu_torch.sim import orchard_env

    seen, plan = [], rappids.plan

    def record(*args, **kw):
        seen.append((args, kw))
        return plan(*args, **kw)

    rappids.plan = record
    try:
        orchard_env._frame_percept(p, state, u)
    finally:
        rappids.plan = plan
    return seen[0]


def frame_plan_case(dev, state, p, gen):
    """A frame's candidates, gravity and final pyramid set (plan_debug's)
    from `state` (one vehicle or a fleet), and the lazy round's mask: the
    gated candidates the first check fails for want of a pyramid."""
    from agrifly_tpu_torch.planner import cuda_plan, rappids
    from agrifly_tpu_torch.sim import orchard_env

    lead = state.base.step.shape
    u = (orchard_env.draw_fleet(p, gen, lead[0], dev)[0] if lead
         else orchard_env.draw(p, gen, dev)[0])
    (prm, depth, u, vel, acc, grav, goal), kw = plan_args(p, state, u)
    kw.pop("candidates")  # the percept head's, the same as plan_debug's own
    tr, _, _, _, gate, _, pyrs = rappids.plan_debug(
        prm, depth, rappids.samples_from_uniform(prm, u), vel, acc, grav, goal, **kw)
    free, _, _, fail_z = cuda_plan.collision_check(prm, pyrs, tr)
    return prm, tr, grav[..., None, :], pyrs, gate & ~free & (fail_z > 0)


def _equal(got, ref):
    import torch

    return all(torch.equal(a, b) for a, b in zip(got, ref))


def _check_case(prm, pyrs, tr, enabled, label):
    """K7 against collision_check_plain on the card, bit for bit, pops
    against the plain count, one launch; returns the outputs and the pops
    tensor of the kernel's run."""
    import torch

    from agrifly_tpu_torch.planner import cuda_plan, rappids

    pops, ref_pops = (torch.zeros(tr.tf.shape, dtype=torch.int32, device=tr.tf.device)
                      for _ in range(2))
    before = cuda_plan.collision_check.launches
    got = cuda_plan.collision_check(prm, pyrs, tr, enabled, pops=pops)
    _check(cuda_plan.collision_check.launches == before + 1, f"K7 ({label}): not one launch")
    en = torch.ones(tr.tf.shape, dtype=torch.bool, device=tr.tf.device) if enabled is None \
        else enabled
    _check(_equal(got, rappids.collision_check_plain(prm, pyrs, tr, en, ref_pops))
           and torch.equal(pops, ref_pops),
           f"K7 differs from collision_check_plain on the card ({label})")
    return got, pops


def _gates_case(prm, tr, grav, label, static_max_tf=3.0, strict=True):
    """K8 against the plain gates on the card, bit for bit, the evaluated
    sections against the plain count, one launch; returns the masks and the
    evaluated sections of the kernel's run."""
    import torch

    from agrifly_tpu_torch.planner import cuda_plan, traj

    sections, ref_sections = (torch.zeros(tr.tf.shape, dtype=torch.int32, device=tr.tf.device)
                              for _ in range(2))
    before = cuda_plan.plan_gates.launches
    got = cuda_plan.plan_gates(tr, grav, prm.fmin, prm.fmax, prm.wmax, prm.min_section_time,
                               prm.vmax, static_max_tf=static_max_tf, strict_degenerate=strict,
                               sections=sections)
    _check(cuda_plan.plan_gates.launches == before + 1, f"K8 ({label}): not one launch")
    ref = (traj.check_input_feasibility(tr, grav, prm.fmin, prm.fmax, prm.wmax,
                                        prm.min_section_time, static_max_tf=static_max_tf,
                                        sections=ref_sections),
           traj.check_velocity_feasibility(tr, prm.vmax, strict))
    _check(_equal(got, ref) and torch.equal(sections, ref_sections),
           f"K8 differs from the plain gates on the card ({label})")
    return got, sections


def _traj_bytes(tr, fields):
    return sum(getattr(tr, f).numel() * 4 for f in fields)


def check_plan_kernels(dev, state):
    """K7 and K8 against their plain versions on the card, bit for bit, at
    the main path's shapes: the frame's candidates (256) and pyramid set
    from `state` (the single flight's) and from a fleet of FLEET copies of
    it (each with its own draws), the first check and the lazy re-check; the evaluation's 4 x 1024
    endpoint check; the gates on those candidates and on random,
    near-limit and wavy trajectories (strict and not, with and without the
    static_max_tf cut); K7 on `adversarial_checks` (P = 80: the iteration
    cap, five live sections, the budget spent early, uncovered late; the
    patterns counted by `section_chains` must occur). Pops and sections
    against the plain counts. Each kernel's wrapper, bare launch and device
    time (device_us), the plain version's time and the bound. Returns the
    two kernels' result dicts (at the single frame's shape) and the cases
    {label: (params, candidates, gravity, pyramids, lazy mask)}."""
    import torch

    from agrifly_tpu_torch.planner import cuda_plan, rappids, traj
    from agrifly_tpu_torch.sim import orchard_env

    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    p = orchard_env.make_params(start_flight_time=1.0, device=dev)
    fleet = orchard_env.stack_states([state] * FLEET)  # each vehicle draws its own candidates
    frames = {"B=1": frame_plan_case(dev, state, p, gen),
              f"B={FLEET}": frame_plan_case(dev, fleet, p, gen)}
    params, views = eval_views(dev)
    vel0, acc0, grav0 = eval_state(dev)
    tr = rappids.sample_candidates(params, eval_draws(1024, dev), vel0, acc0)
    pyrs = rappids._endpoint_pyramids(params, views, tr, 32)
    cases = dict(frames, **{"4x1024": (params, tr, grav0[:, None, :], pyrs, None)})

    lines, out = [], {}
    for label, (prm, tr, grav, pyrs, failed) in cases.items():
        (free, *_), pops = _check_case(prm, pyrs, tr, None, f"{label}, first check")
        lazy = ""
        if failed is not None:
            _, lazy_pops = _check_case(prm, pyrs, tr, failed, f"{label}, lazy re-check")
            lazy = (f", lazy re-check of {int(failed.sum())} bit-equal "
                    f"({int(lazy_pops.sum())} pops)")
        n = tr.tf.numel()
        k7_ms = cuda_ms(lambda: cuda_plan.collision_check(prm, pyrs, tr))
        launch_ms = cuda_ms(lambda: cuda_plan._launch_check(prm, pyrs, tr), reps=50)
        en = torch.ones(tr.tf.shape, dtype=torch.bool, device=dev)
        plain_ms = cuda_ms(lambda: rappids.collision_check_plain(prm, pyrs, tr, en), reps=2,
                           warmup=1)
        k7_us = device_us(lambda: cuda_plan._launch_check(prm, pyrs, tr))
        # bytes: the candidates' six vectors and tf, the pyramid set, the
        # outputs (free and three fail floats); operations: the pops this
        # run made and every candidate's sections
        k7 = result(0, k7_ms, plain_ms,
                    _traj_bytes(tr, ("alpha", "beta", "gamma", "a0", "v0", "p0", "tf"))
                    + nbytes(*pyrs) + 13 * n,
                    int(pops.sum()) * PLAN_POP_OPS + n * PLAN_CANDIDATE_OPS)
        (feas, vel_ok), sections = _gates_case(prm, tr, grav, f"{label}")
        _gates_case(prm, tr, grav, f"{label}, not strict", strict=False)
        k8_ms = cuda_ms(lambda: cuda_plan.plan_gates(
            tr, grav, prm.fmin, prm.fmax, prm.wmax, prm.min_section_time, prm.vmax,
            static_max_tf=3.0))
        k8_plain_ms = cuda_ms(lambda: traj.check_input_feasibility(
            tr, grav, prm.fmin, prm.fmax, prm.wmax, prm.min_section_time, static_max_tf=3.0)
            & traj.check_velocity_feasibility(tr, prm.vmax), reps=2, warmup=1)
        def gates():
            return cuda_plan._launch_gates(tr, grav, prm.fmin, prm.fmax, prm.wmax,
                                           prm.min_section_time, prm.vmax, 3.0)

        k8_launch_ms = cuda_ms(gates, reps=50)
        k8_us = device_us(gates)
        k8 = result(0, k8_ms, k8_plain_ms,
                    _traj_bytes(tr, ("alpha", "beta", "gamma", "a0", "v0", "tf"))
                    + nbytes(grav[..., 0, :]) + 2 * n,
                    int(sections.sum()) * GATE_SECTION_OPS + n * GATE_CANDIDATE_OPS)
        out[label] = (k7, k8)
        lines.append(
            f"{label} ({n} candidates, {int(pyrs.valid.sum())} pyramids): K7 bit-equal, free "
            f"{int(free.sum())}, pops {int(pops.sum())} (max {int(pops.max())}){lazy}; wrapper "
            f"{k7_ms:.4f} ms, launch {launch_ms:.4f} ms, device {us_text(k7_us)}, plain "
            f"{plain_ms:.3f} ms, bound {k7['bound_ms']:.6f} ms ({k7['bound_by']}); K8 bit-equal "
            f"(strict and not), feasible {int(feas.sum())}, velocity {int(vel_ok.sum())}, "
            f"sections {int(sections.sum())} (max {int(sections.max())}); wrapper {k8_ms:.4f} ms, "
            f"launch {k8_launch_ms:.4f} ms, device {us_text(k8_us)}, plain {k8_plain_ms:.3f} ms, "
            f"bound {k8['bound_ms']:.6f} ms ({k8['bound_by']})")
    # the gates' branches: degenerate axes, near-limit thrust, the cut or not
    prm = frames["B=1"][0]
    grav = torch.tensor([0.0, 9.81, 0.0], device=dev)
    for name, trs in (("random", random_trajs(SEED, 4096, dev)),
                      ("near-limit", near_limit_trajs(SEED, 4096, dev))):
        for static_max_tf in (3.0, None):
            for strict in (True, False):
                (feas, vel_ok), sections = _gates_case(
                    prm, trs, grav, f"{name}, static_max_tf={static_max_tf}, strict={strict}",
                    static_max_tf, strict)
        lines.append(f"K8 on 4096 {name} trajectories bit-equal (static_max_tf 3.0 / None, "
                     f"strict and not): feasible {int(feas.sum())}, velocity "
                     f"{int(vel_ok.sum())}, sections {int(sections.sum())} (max "
                     f"{int(sections.max())})")
    # K7's adversarial sets at the frame's camera, and the gates on them
    for name, (tr, pyrs) in adversarial_checks(prm, dev).items():
        everyone = torch.ones(tr.tf.shape, dtype=torch.bool, device=dev)
        lazy = everyone.clone()
        lazy[::3] = False
        (free, *_), pops = _check_case(prm, pyrs, tr, None, name)
        _, lazy_pops = _check_case(prm, pyrs, tr, lazy, f"{name}, partial enabled")
        counts = chain_patterns(section_chains(prm, pyrs, tr, everyone))
        if name == "iteration cap":
            _check(int(pops.max()) == rappids.MAX_CHECK_ITERS, "K7 iteration cap: no candidate "
                   "reached the budget")
        else:
            _check(min(counts.values()) > 0, f"K7 {name}: a pattern missing, {counts}")
        (feas, vel_ok), sections = _gates_case(prm, tr, grav, name, None)
        k7_us = device_us(lambda: cuda_plan._launch_check(prm, pyrs, tr))
        lines.append(
            f"{name} (256 candidates, P = {pyrs.depth.shape[-1]}, {int(pyrs.valid.sum())} "
            f"pyramids): K7 bit-equal, free {int(free.sum())}, pops {int(pops.sum())} (max "
            f"{int(pops.max())}), a third disabled {int(lazy_pops.sum())} pops; {counts}; device "
            f"{us_text(k7_us)}; K8 bit-equal, feasible {int(feas.sum())}, sections "
            f"{int(sections.sum())}")
    print("plan kernels (K7 collision check, K8 gates) against their plain versions on the "
          "card:\n  " + "\n  ".join(lines))
    return (*out["B=1"], cases)


# The rounds' kernels' operations, read off csrc/rounds.cu and
# csrc/frame.cu, counted as the work needs them: K9 the mocap prediction's
# replay (~10 segments of a rotation and a decay, 9 slots) with the camera
# frame and switch, and per candidate its samples, primitive, jerk cost,
# endpoint and cost; a stable sort of n keys n ceil(log2 n) comparisons
# of (key, index), a merge of two sorted lists one comparison an element;
# K11 a seed's base depth, bounds and four unit normals; K12 a considered
# point's set-up and containment, a pair of the dedupe's three distances,
# a pixel's range test, a blocking pixel's shrink and a (blocking pixel,
# valid point) pair's rectangle and box tests
HEAD_OPS = 3000
HEAD_CANDIDATE_OPS = 160
COMPARE_OPS = 3
PYRAMID_SEED_OPS = 90
CONTAIN_OPS = 10
DEDUPE_PAIR_OPS = 6
PREFILTER_PIXEL_OPS = 2
PREFILTER_SHRINK_OPS = 3
PREFILTER_PAIR_OPS = 9
PLAN_ROUND_KERNELS = ("percept_head", "round_seeds", "pyramid_set", "lazy_seeds")


def sort_ops(n):
    """The operations of a stable comparison sort of n keys."""
    return n * math.ceil(math.log2(n)) * COMPARE_OPS if n > 1 else 0


def _leaves_equal(got, ref):
    """Two trees of tensors (NamedTuples) equal leaf for leaf, bit for bit
    (NaN where NaN)."""
    import torch

    from agrifly_tpu_torch import convert

    a, b = convert.flatten_tensors(got)[0], convert.flatten_tensors(ref)[0]
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                        y.view(torch.int32) if y.dtype == torch.float32 else y)
        for x, y in zip(a, b))


def round_chain(prm, depth, cand, grav, capacity, rounds, k, check=None):
    """_plan_core's rounds on the card from the candidates `cand`, through
    the plain versions; check(name, plain output, kernel call): holds each
    kernel against its plain version on the plain chain's inputs. Returns
    {kernel: (plain fn, kernel fn)} of the last call of each, for timing."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate, cuda_plan, cuda_rounds, rappids

    tr, cost, epx, epy, endz = cand
    feas, vel_ok = cuda_plan.plan_gates(tr, grav[..., None, :], prm.fmin, prm.fmax, prm.wmax,
                                        prm.min_section_time, prm.vmax, static_max_tf=3.0)
    gate = feas & vel_ok
    work = rappids.work_image(prm, depth, k)
    pr = capacity // (rounds + PLAN_LAZY_ROUNDS)
    calls, pyrs = {}, None
    for rnd in range(rounds):
        args = (work, gate, cost, epx, epy, endz, pyrs, rnd, pr)
        calls["round_seeds"] = (lambda a=args: rappids.round_seeds_plain(*a),
                                lambda a=args: cuda_rounds._launch_round(*a))
        rows, sv = calls["round_seeds"][0]()
        check and check(f"K10 round {rnd}", (rows, sv), calls["round_seeds"][1])
        out = cuda_inflate.inflate_rows(work.params, work.img, rows)
        args = (prm, work, out, sv, pr, capacity - pr if pyrs is None else pyrs)
        calls["pyramid_set"] = (lambda a=args: rappids.pyramid_set_plain(*a),
                                lambda a=args: cuda_rounds._launch_set(*a))
        pyrs = calls["pyramid_set"][0]()
        check and check(f"K11 round {rnd}", pyrs, calls["pyramid_set"][1])
    free, fpx, fpy, fz = cuda_plan.collision_check(prm, pyrs, tr)
    args = (prm, work, depth.to(torch.int32), gate, free, fpx, fpy, fz, cost, pyrs, pr)
    calls["lazy_seeds"] = (lambda a=args: rappids.lazy_seeds_plain(*a),
                           lambda a=args: cuda_rounds._launch_lazy(*a))
    rows, sv, failed = calls["lazy_seeds"][0]()
    check and check("K12", (rows, sv, failed), calls["lazy_seeds"][1])
    out = cuda_inflate.inflate_rows(work.params, work.img, rows)
    args = (prm, work, out, sv, pr, pyrs)
    final = rappids.pyramid_set_plain(*args)
    check and check("K11 lazy", final, lambda: cuda_rounds._launch_set(*args))
    return calls, dict(gate=gate, work=work, pyrs=final, pr=pr, fz=fz, failed=failed)


def _adversarial_rounds(prm, depth, cand, grav, capacity, rounds, k, check, dev):
    """The rounds on inputs chosen to make the ranks, the containment and
    the prefilter decide: costs quantized to 0.25 (ties), with -0.0, +inf and
    NaN among them; no gated candidate at all (an all-invalid round); a
    full set of shallow pyramids as the base of the merge; fail points on
    the image's edges and beyond them."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate, cuda_rounds, rappids

    tr, cost, epx, epy, endz = cand
    q = torch.round(cost * 4.0) / 4.0
    q = torch.where(torch.arange(cost.shape[-1], device=dev) % 17 == 3, -0.0, q)
    q = torch.where(torch.arange(cost.shape[-1], device=dev) % 29 == 5, float("nan"), q)
    q = torch.where(torch.arange(cost.shape[-1], device=dev) % 31 == 7, float("inf"), q)
    tied = rappids.Candidates(tr, q, epx, epy, endz)
    round_chain(prm, depth, tied, grav, capacity, rounds, k, lambda n, r, f: check(
        f"ties, -0, NaN, inf: {n}", r, f))
    work = rappids.work_image(prm, depth, k)
    pr = capacity // (rounds + PLAN_LAZY_ROUNDS)
    none = torch.zeros(cost.shape, dtype=torch.bool, device=dev)
    args = (work, none, cost, epx, epy, endz, None, 0, pr)
    check("all-invalid round: K10", rappids.round_seeds_plain(*args),
          lambda: cuda_rounds._launch_round(*args))
    # a full set of valid pyramids, shallower than any new one, as the base
    full = rappids.PyramidSet(
        depth=torch.linspace(0.1, 0.5, capacity - pr, device=dev).expand(
            cost.shape[:-1] + (capacity - pr,)).contiguous(),
        bounds=torch.tensor([600.0, 10.0, 40.0, 470.0], device=dev).expand(
            cost.shape[:-1] + (capacity - pr, 4)).contiguous(),
        normals=torch.full(cost.shape[:-1] + (capacity - pr, 4, 3), 0.5, device=dev),
        valid=torch.ones(cost.shape[:-1] + (capacity - pr,), dtype=torch.bool, device=dev))
    rows, sv = rappids.round_seeds_plain(work, none | True, cost, epx, epy, endz, None, 0, pr)
    out = cuda_inflate.inflate_rows(work.params, work.img, rows)
    for label, base in (("full base", full), ("no merge", None), ("empty base", capacity)):
        args = (prm, work, out, sv, pr, base)
        check(f"{label}: K11", rappids.pyramid_set_plain(*args),
              lambda a=args: cuda_rounds._launch_set(*a))
    args = (work, none | True, cost, epx, epy, endz, full, 1, pr)
    check("full set: K10 containment", rappids.round_seeds_plain(*args),
          lambda: cuda_rounds._launch_round(*args))
    # fail points on and beyond the image's edges, every candidate failed
    W, H = prm.cam.width, prm.cam.height
    n = torch.arange(cost.shape[-1], device=dev, dtype=torch.float32).expand(cost.shape)
    fpx = torch.where(n % 4 == 0, 0.0, torch.where(n % 4 == 1, W - 1.0, n % W + 0.5))
    fpy = torch.where(n % 3 == 0, -3.0, torch.where(n % 3 == 1, H + 2.0, n % H + 0.25))
    fz = 0.5 + (n % 7) * 0.4
    empty = rappids.empty_pyramid_set(capacity - pr, dev, cost.shape[:-1])
    for label, pyrs in (("edges, empty set", empty), ("edges, full set", full)):
        args = (prm, work, depth.to(torch.int32), none | True, none, fpx, fpy, fz, cost, pyrs, pr)
        check(f"{label}: K12", rappids.lazy_seeds_plain(*args),
              lambda a=args: cuda_rounds._launch_lazy(*a))


def check_plan_rounds(dev, state):
    """K9 (the percept head), K10 (a round's seeds), K11 (a pyramid set)
    and K12 (a lazy round's seeds) against their plain versions on the card,
    bit for bit, on the frame from `state` (the single flight's) and a
    fleet of FLEET copies of it (each its own draws) at the orchard default
    (640x480, 256 candidates, capacity 32, 2 + 1 rounds, 2x2 pooling): the
    head, then every kernel on the plain chain's inputs; on the adversarial
    cases (`_adversarial_rounds`); K11 also on the evaluation's 4 x 1024
    endpoint seeds (no merge, the 32 shallowest). Each kernel's wrapper,
    device time (device_us), plain time and bound at B = 1. Returns
    {kernel: result dict}."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate, cuda_rounds, rappids
    from agrifly_tpu_torch.render import cuda_raycast
    from agrifly_tpu_torch.sim import cuda_percept, orchard_env

    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    p = orchard_env.make_params(start_flight_time=1.0, device=dev)
    fleet = orchard_env.stack_states([state] * FLEET)
    lines, held, out = [], [], {}

    def check(name, ref, kernel):
        got = kernel()
        _check(_leaves_equal(tuple(got) if isinstance(got, tuple) else got,
                             tuple(ref) if isinstance(ref, tuple) else ref),
               f"{name} differs from its plain version on the card ({label})")
        held.append(name)

    for label, s in (("B=1", state), (f"B={FLEET}", fleet)):
        lead = s.base.step.shape
        u = (orchard_env.draw_fleet(p, gen, lead[0], dev)[0] if lead
             else orchard_env.draw(p, gen, dev)[0])
        head = orchard_env.percept_head_plain(p, s, u)
        check("K9", head, lambda: cuda_percept._launch(p, s, u))
        depth = cuda_raycast.render_depth_batch(
            p.render_cfg, p.scene, s.base.plant.pos.reshape(-1, 3),
            head.cam_att.reshape(-1, 4)).reshape(lead + (p.render_cfg.height, p.render_cfg.width))
        args = (p.planner, depth, head.candidates, head.grav_cam, p.pyramid_capacity,
                p.planner_rounds, p.inflation_downsample)
        calls, info = round_chain(*args, check=check)
        _adversarial_rounds(*args, check, dev)
        n_valid = int(info["pyrs"].valid.sum())
        lines.append(f"{label}: K9, K10 x {p.planner_rounds}, K11 x {p.planner_rounds + 1}, "
                     f"K12 bit-equal; {int(info['failed'].sum())} failed candidates, {n_valid} "
                     f"pyramids in the final set; adversarial cases bit-equal")
        if label != "B=1":
            continue
        # times and bounds at B = 1
        N, pr = u.shape[-1], info["pr"]
        wk = info["work"]
        Hw, Ww = wk.img.shape[-2:]
        C = p.pyramid_capacity - pr
        head_fn = lambda: cuda_percept._launch(p, s, u)  # noqa: E731
        # K9's bytes: the uniform block, the candidates' 24 floats, the
        # head's 40 outputs and the ~120 state and parameter values it reads
        k9 = result(0, cuda_ms(lambda: cuda_percept.percept_head(p, s, u)),
                    cuda_ms(lambda: orchard_env.percept_head_plain(p, s, u), reps=3, warmup=1),
                    4 * 4 * N + 24 * 4 * N + 4 * 40 + 4 * 120,
                    HEAD_OPS + N * HEAD_CANDIDATE_OPS)
        set_bytes = 4 * (1 + 4 + 12) + 1
        k10 = result(0, cuda_ms(calls["round_seeds"][1]),
                     cuda_ms(calls["round_seeds"][0], reps=3, warmup=1),
                     N * (1 + 16) + C * set_bytes + pr * (12 * 4 + 1),
                     sort_ops(N) + pr * (C * CONTAIN_OPS + 40))
        P2 = 2 * pr
        k11 = result(0, cuda_ms(calls["pyramid_set"][1]),
                     cuda_ms(calls["pyramid_set"][0], reps=3, warmup=1),
                     P2 * (8 * 4 + 1) + 2 * C * set_bytes,
                     sort_ops(P2) + P2 * PYRAMID_SEED_OPS + (C + pr) * COMPARE_OPS)
        # K12's prefilter, for this run's valid considered points: every
        # pixel's range test, the shrink of each pixel that blocks one of
        # them and the two tests of each (pixel, point) pair it blocks
        blocking = []
        prefilter = rappids._prefilter

        def counting(work, px, py, seed_depth, valid):
            k = work.k
            sp = rappids.seed_setup(work.params, px / k if k > 1 else px,
                                    py / k if k > 1 else py, seed_depth, work.shrink_extra)
            img = work.img[..., None, :, :]
            pairs = (img > sp.ignore) & (img < sp.min_pyr_depth[..., None, None]) \
                & valid[..., None, None]
            blocking.append((int(pairs.any(dim=-3).sum()), int(pairs.sum())))
            return prefilter(work, px, py, seed_depth, valid)

        rappids._prefilter = counting
        try:
            calls["lazy_seeds"][0]()
        finally:
            rappids._prefilter = prefilter
        (n_pixels, n_pairs), = blocking
        M = min(N, 4 * pr)
        k12 = result(0, cuda_ms(calls["lazy_seeds"][1]),
                     cuda_ms(calls["lazy_seeds"][0], reps=3, warmup=1),
                     N * (2 + 16 + 1) + C * set_bytes + (Hw * Ww + N) * 4 + 2 * pr * 49,
                     sort_ops(N) + M * (C * CONTAIN_OPS + 40) + M * (M - 1) // 2 * DEDUPE_PAIR_OPS
                     + Hw * Ww * PREFILTER_PIXEL_OPS + n_pixels * PREFILTER_SHRINK_OPS
                     + n_pairs * PREFILTER_PAIR_OPS)
        lines.append(f"B=1: K12's prefilter: {n_pixels} of {Hw * Ww} pixels block a valid "
                     f"considered point, {n_pairs} (pixel, point) pairs")
        out = {"percept_head": k9, "round_seeds": k10, "pyramid_set": k11, "lazy_seeds": k12}
        rows = calls["round_seeds"][1]()[0]
        inflate_ms = cuda_ms(lambda: cuda_inflate.inflate_rows(wk.params, wk.img, rows))
        lines.append(f"B=1: the inflation's wrapper on K10's rows (inflate_rows, K2c) "
                     f"{inflate_ms:.4f} ms")
        dev_us = {"percept_head": device_us(head_fn)}
        dev_us.update({name: device_us(calls[name][1]) for name in PLAN_ROUND_KERNELS[1:]})
        lines.append("B=1 times: " + "; ".join(
            f"{name} wrapper {r['ms']:.4f} ms, device {us_text(dev_us[name])}, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
            for name, r in out.items()))
    # K11 on the evaluation path: 4 views x 1024 endpoint seeds, no merge
    params, views = eval_views(dev)
    vel0, acc0, _ = eval_state(dev)
    tr = rappids.sample_candidates(params, eval_draws(1024, dev), vel0, acc0)
    work = rappids.work_image(params, views, 1)
    ones = torch.ones(tr.tf.shape, dtype=torch.bool, device=dev)
    rows = rappids.work_rows(work, *rappids.endpoint_seeds(params, tr))
    out_rows = cuda_inflate.inflate_rows(work.params, work.img, rows)
    label = "4x1024"
    args = (params, work, out_rows, ones, 32)
    check("K11 evaluation", rappids.pyramid_set_plain(*args),
          lambda: cuda_rounds._launch_set(*args))
    eval_us = device_us(lambda: cuda_rounds._launch_set(*args))
    lines.append(f"4x1024 evaluation: K11 bit-equal (the 32 shallowest of 1024), device "
                 f"{us_text(eval_us)}")
    print(f"plan rounds (K9 percept head, K10 round seeds, K11 pyramid set, K12 lazy seeds) "
          f"against their plain versions on the card, {len(held)} cases bit-equal:\n  "
          + "\n  ".join(lines))
    return out


def baked_orchard(dev):
    """The procedural orchard baked into primitives over MESH_X x MESH_Y."""
    from agrifly_tpu_torch.render import meshscene, orchard

    return meshscene.from_orchard(orchard.make_params(seed=SEED, device=dev), MESH_X, MESH_Y,
                                 device=dev)


def mixed_scene(dev, directory):
    """Spheres, z-cylinders and trees from a primitives file and 60 boxes
    plus 400 loose triangles from an OBJ file, both written to `directory`
    and loaded, over the flight's rectangle."""
    import numpy as np
    import torch

    from agrifly_tpu_torch.render import meshscene

    rng = np.random.default_rng(SEED)
    lo, hi = (MESH_X[0], MESH_Y[0]), (MESH_X[1], MESH_Y[1])
    lines = [f"sphere {x:.4f} {y:.4f} {rng.uniform(0.5, 4):.4f} {rng.uniform(0.2, 1.5):.4f}"
             for x, y in rng.uniform(lo, hi, (40, 2))]
    lines += [f"cylinder {x:.4f} {y:.4f} 0 {rng.uniform(0.5, 3):.4f} {rng.uniform(0.1, 0.4):.4f}"
              for x, y in rng.uniform(lo, hi, (40, 2))]
    lines += [f"tree {x:.4f} {y:.4f} 0.2 1.5 {x:.4f} {y:.4f} 2.5 1.1"
              for x, y in rng.uniform(lo, hi, (40, 2))]
    verts, faces = [], []
    for x, y in rng.uniform(lo, hi, (60, 2)):  # boxes: 6 quads each
        sx, sy, sz = rng.uniform(0.3, 2.0, 3)
        n = len(verts)
        verts += [(x + dx * sx, y + dy * sy, dz * sz) for dz in (0, 1) for dx, dy in
                  ((0, 0), (1, 0), (1, 1), (0, 1))]
        faces += [[n + i for i in q] for q in ((1, 2, 3, 4), (5, 6, 7, 8), (1, 2, 6, 5),
                                                (2, 3, 7, 6), (3, 4, 8, 7), (4, 1, 5, 8))]
    for c in rng.uniform((*lo, 0.0), (*hi, 4.0), (400, 3)):  # loose leaves
        n = len(verts)
        verts += [tuple(c + rng.normal(0, 0.5, 3)) for _ in range(3)]
        faces.append([n + 1, n + 2, n + 3])
    prims, obj = f"{directory}/scene.txt", f"{directory}/scene.obj"
    with open(prims, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(obj, "w") as f:
        f.writelines(f"v {x:.5f} {y:.5f} {z:.5f}\n" for x, y, z in verts)
        f.writelines("f " + " ".join(map(str, q)) + "\n" for q in faces)
    a, b = meshscene.load_primitives(prims, device=dev), meshscene.load_obj(obj, device=dev)
    return meshscene.MeshScene(*(torch.cat([x, y]) for x, y in zip(a[:3], b[:3])),
                               count=a.count + b.count, material=torch.cat([a.material,
                                                                            b.material]))


def edge_rows(dev):
    """A window of rows at the mesh kernels' edge cases, the same 22 rows
    for five cameras: (windows (5, 22, 10), cam_pos (5, 3), cam_att (5, 4)).
    Camera 0 looks straight down from z = 3, so the pixel at (W / 2, H / 2)
    of an image with even W and H has the ray (0, 0, -1): vertical against
    the cylinder below it (ca = 0), tangent to a sphere (disc = 0), and
    parallel to a zero-area and a tiny triangle (|det| < 1e-12). Camera 1
    is inside a sphere, camera 2 at z = 0 (no ground hit), camera 3 at a
    generic pose. Kind 0 rows, zero and not, lie between the others.
    Camera 4 looks level along +x from the height of a sphere's centre,
    whose z-cylinder of the same axis and radius comes earlier in the
    window: the image's middle row (dz = 0) meets both at the same t, bit
    for bit, and the RGB pass must keep the earlier row (the cylinder),
    though the kernels stage spheres before cylinders."""
    import torch

    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.render import raycast

    rows = [
        [2, 0.0, 0.0, 0.0, 1.0, 0.3],  # cylinder right below camera 0
        [1, 0.5, 0.0, 1.0, 0.5],  # tangent to camera 0's centre ray at t = 2
        [3, -1.0, -1.0, 0.5, 1.0, 0.0, 0.0, 2.0, 0.0, 0.0],  # zero area
        [3, 0.2, 0.2, 1.5, 1e-7, 0.0, 0.0, 0.0, 1e-7, 0.0],  # |det| ~ 1e-14
        [0],
        [3, -2.1, 1.0, 0.2, 3.0, 0.0, 0.0, 0.0, 2.0, 0.1],
        [0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0],  # kind 0 with parameters
        [1, 10.2, 0.1, 2.1, 1.0],  # holds camera 1
        [2, 14.0, -1.0, 0.0, 3.0, 0.25],
        [0],
        [2, 25.0, 0.0, 0.0, 2.0, 0.4],  # in front of camera 2
        [1, 24.0, 1.0, 0.5, 0.6],
        [3, 23.0, -2.0, 0.0, 0.0, 3.0, 0.0, 0.0, 0.0, 2.0],  # a wall facing camera 2
        [1, 36.0, 4.0, 1.5, 1.2],
        [2, 34.0, 3.0, 0.0, 2.5, 0.3],
        [3, 35.0, 0.0, 0.0, 0.0, 2.0, 0.0, 1.0, 0.0, 3.0],
        [3, 33.0, 5.0, 1.0, -1.0, 0.5, 0.8, 0.3, -0.7, 0.4],
        [1, 40.0, 2.0, 0.0, 2.0],  # reaches below the ground
        [0],
        [2, 31.0, 3.5, 1.0, 1.0, 0.2],  # flat: z0 = z1
        [2, 55.0, 0.0, 0.0, 3.0, 0.5],  # tied with the next row in camera 4's middle row
        [1, 55.0, 0.0, 1.5, 0.5],
    ]
    window = torch.tensor([r + [0.0] * (10 - len(r)) for r in rows], dtype=torch.float32)
    pos = torch.tensor([[0.0, 0.0, 3.0], [10.0, 0.0, 2.0], [20.0, 0.0, 0.0], [30.0, 2.0, 1.5],
                        [50.0, 0.0, 1.5]])
    yaw, pitch, roll = torch.tensor([[0.0, 0.0, 0.0, 0.4, 0.0], [0.0, 0.0, 0.0, 0.1, 0.0],
                                     [0.0, 0.0, 0.0, -0.05, 0.0]])
    body = rot.from_euler_ypr(yaw, pitch, roll)
    att = raycast.camera_attitude(body)
    att[0] = torch.tensor([0.0, 1.0, 0.0, 0.0])  # world-from-camera R = diag(1, -1, -1)
    # camera z along world x, camera x along world -y, camera y along world
    # -z, every entry of R exactly 0 or +-1
    att[4] = torch.tensor([0.5, -0.5, 0.5, -0.5])
    return window.expand(5, -1, -1).contiguous().to(dev), pos.to(dev), att.to(dev)


def shuffled_window(windows, mats, seed=SEED):
    """A window's rows (and their materials) in a seeded order:
    select_window puts a window's visible rows first, so in a 300-row window
    rows 256.. (the kernels' second staged chunk) are all kind 0; shuffled,
    both chunks hold rows that win pixels."""
    import torch

    perm = torch.randperm(windows.shape[1], generator=torch.Generator().manual_seed(seed))
    perm = perm.to(windows.device)
    return windows[:, perm].contiguous(), mats[:, perm].contiguous()


def mesh_poses(g, B, dev):
    """B cameras over the mesh rectangle at 0.5-3.5 m, random yaw, small
    pitch and roll (world-from-camera attitudes)."""
    import torch

    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.render import raycast

    u = torch.rand(B, 6, generator=g)
    pos = torch.stack([MESH_X[0] + 10 + u[:, 0] * (MESH_X[1] - MESH_X[0] - 20),
                       MESH_Y[0] + 5 + u[:, 1] * (MESH_Y[1] - MESH_Y[0] - 10),
                       0.5 + u[:, 2] * 3.0], dim=1)
    body = rot.from_euler_ypr((u[:, 3] - 0.5) * 6.283, (u[:, 4] - 0.5) * 0.6,
                              (u[:, 5] - 0.5) * 0.6)
    return pos.to(dev), raycast.camera_attitude(body).to(dev)


def mesh_bound(cfg, window_kinds, kinds, rows_per_pixel_block, pixels_per_block, n_bytes,
               cull_rows=0):
    """The mesh kernels' bound: `window_kinds` (B, K) the window's row
    kinds, each row prepared once per vehicle; `kinds` (..., K) the kinds
    of the rows tested, of which the first `rows_per_pixel_block` (...,)
    of each block of `pixels_per_block` pixels are; `cull_rows` (strip,
    row) pairs culled at MESH_CULL_OPS each. Returns (bytes, operations)."""
    import torch

    def by_kind(table, k):
        return torch.tensor(table, dtype=torch.float64, device=k.device)[k.long().clamp(0, 3)]

    tested = torch.arange(kinds.shape[-1], device=kinds.device) < rows_per_pixel_block[..., None]
    row_ops = float((by_kind(MESH_ROW_OPS, kinds) * tested).sum())
    prep_ops = float(by_kind(MESH_PREP_OPS, window_kinds).sum())
    B = window_kinds.shape[0]
    return n_bytes, (B * cfg.height * cfg.width * MESH_OPS_PER_PIXEL + prep_ops
                     + row_ops * pixels_per_block + cull_rows * MESH_CULL_OPS)


def kernels_per_call(fn, calls=20):
    """Device kernels one call of fn launches: torch.profiler over `calls`
    calls, or None where the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    except RuntimeError:
        return None
    return n / calls if n else None


def check_meshscene(dev):
    """The strip-culled (K4) and window (K4w) mesh kernels against their
    plain versions (strip_windows then render_strips, render_depth_window)
    and each other at 640x480, with 1 and 16 random-yaw cameras in one
    launch, on the baked orchard and on the mixed scene: K4's per-strip row
    counts equal strip_windows' n_vis, and the codes are bit-equal; the
    wrapper, launch and device times of both, and the kernels one
    render_depth_batch call launches. Then the edge rows (check_edge_rows).
    Returns the B = 1 baked-orchard results (K4, K4w)."""
    import tempfile

    import torch

    from agrifly_tpu_torch.render import cuda_meshscene, meshscene, raycast

    cfg = raycast.make_config(640, 480)
    reach = cfg.far * meshscene.slant_factor(cfg)
    g = torch.Generator().manual_seed(SEED + 5)
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {"baked orchard": baked_orchard(dev), "mixed scene": mixed_scene(dev, tmp)}
    out = {}
    for label, mesh in scenes.items():
        kinds = [int((mesh.prims[:, 0] == k).sum()) for k in (1, 2, 3)]
        for B in (1, 16):
            pos, cam = mesh_poses(g, B, dev)
            windows = meshscene.select_window(mesh, pos, reach, 192)
            strips, nvis_r = meshscene.strip_windows(cfg, windows, pos, cam, cuda_meshscene.TILE_H)
            before = (cuda_meshscene.render_depth_strips_batch.launches,
                      cuda_meshscene.render_depth_window_batch.launches)
            k4 = cuda_meshscene.render_depth_strips_batch(cfg, windows, pos, cam)
            k4w = cuda_meshscene.render_depth_window_batch(cfg, windows, pos, cam)
            _check((cuda_meshscene.render_depth_strips_batch.launches,
                    cuda_meshscene.render_depth_window_batch.launches)
                   == (before[0] + 1, before[1] + 1), f"mesh kernels ({label}): not one launch each")
            nvis = torch.full_like(nvis_r, -1)
            again = cuda_meshscene._launch("meshscene_strips_launch", cfg, pos, cam, windows, nvis)
            _check(torch.equal(nvis, nvis_r), f"K4's n_vis differs from strip_windows' ({label}, "
                                              f"B={B})")
            ref4 = meshscene.render_strips(cfg, strips, pos, cam)
            ref4w = meshscene.render_depth_window(cfg, windows, pos, cam)
            err4, err4w = int((k4 - ref4).abs().max()), int((k4w - ref4w).abs().max())
            _check(err4 == 0, f"K4 differs from plain ({label}, B={B}): max {err4} codes")
            _check(err4w == 0, f"K4w differs from plain ({label}, B={B}): max {err4w} codes")
            _check(torch.equal(k4, k4w) and torch.equal(again, k4),
                   f"K4 differs from K4w ({label}, B={B})")
            _check(k4.unique().numel() > 20, f"mesh render of an empty scene ({label})")
            nv = nvis.float()
            line = (f"mesh {label} ({mesh.count} primitives: {kinds[0]} spheres, {kinds[1]} "
                    f"cylinders, {kinds[2]} triangles), B={B} {cfg.width}x{cfg.height}, "
                    f"window {windows.shape[1]} rows: K4 and K4w bit-equal to plain and to "
                    f"each other, K4's n_vis equal to strip_windows'; n_vis per strip mean "
                    f"{float(nv.mean()):.3f}, max {int(nv.max())}")
            res4, res4w = mesh_timings(cfg, mesh, windows, pos, cam, strips, nvis, k4)
            line += (f"; K4 {res4['ms']:.4f} ms (render_depth_batch with select_window "
                     f"{res4['batch_ms']:.4f}, launch alone {res4['launch_ms']:.4f}, device "
                     f"{us_text(res4['device_us'])}), plain {res4['plain_ms']:.4f}, bound "
                     f"{res4['bound_ms']:.6f} ({res4['bound_by']}); K4w {res4w['ms']:.4f} ms "
                     f"(launch alone {res4w['launch_ms']:.4f}, device "
                     f"{us_text(res4w['device_us'])}), plain {res4w['plain_ms']:.4f}, bound "
                     f"{res4w['bound_ms']:.6f} ({res4w['bound_by']}); kernels per "
                     f"render_depth_batch call {res4['kernels_per_call']}")
            if label == "baked orchard":
                out[B] = (res4, res4w)
            print(line)
    check_edge_rows(cfg, dev)
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return tuple({k: r[k] for k in keep} for r in out[1])


def check_edge_rows(cfg, dev):
    """K4 and K4w on edge_rows' window (a vertical ray against a cylinder,
    a tangent sphere, triangles with |det| < 1e-12, a camera inside a
    sphere and one at z = 0, kind 0 rows): bit-equal to their plain
    versions, to render_depth_window_prepared and to each other; K4's n_vis
    equal to strip_windows'."""
    import torch

    from agrifly_tpu_torch.render import cuda_meshscene, meshscene

    windows, pos, cam = edge_rows(dev)
    k4w = cuda_meshscene.render_depth_window_batch(cfg, windows, pos, cam)
    nvis = torch.full((pos.shape[0], cfg.height // cuda_meshscene.TILE_H), -1,
                      dtype=torch.int32, device=dev)
    k4 = cuda_meshscene._launch("meshscene_strips_launch", cfg, pos, cam, windows, nvis)
    strips, nvis_r = meshscene.strip_windows(cfg, windows, pos, cam, cuda_meshscene.TILE_H)
    ref = meshscene.render_depth_window(cfg, windows, pos, cam)
    _check(torch.equal(k4w, ref), "K4w differs from plain on the edge rows")
    _check(torch.equal(meshscene.render_depth_window_prepared(cfg, windows, pos, cam), ref),
           "render_depth_window_prepared differs from render_depth_window on the edge rows")
    _check(torch.equal(k4, meshscene.render_strips(cfg, strips, pos, cam))
           and torch.equal(k4, k4w) and torch.equal(nvis, nvis_r),
           "K4 differs from plain or from K4w on the edge rows")
    print(f"mesh edge rows ({windows.shape[1]} rows, 4 cameras): K4 and K4w bit-equal to plain, "
          f"to the prepared mirror and to each other, K4's n_vis equal to strip_windows'")


def mesh_timings(cfg, mesh, windows, pos, cam, strips, nvis, codes):
    """Wrapper, bare launch, device and plain times of K4 and K4w on one
    input, their bounds, and the kernels one render_depth_batch call launches."""
    from agrifly_tpu_torch.render import cuda_meshscene, meshscene

    B, K = windows.shape[:2]
    ms4 = cuda_ms(lambda: cuda_meshscene.render_depth_strips_batch(cfg, windows, pos, cam))
    ms4w = cuda_ms(lambda: cuda_meshscene.render_depth_window_batch(cfg, windows, pos, cam))
    batch_ms = cuda_ms(lambda: cuda_meshscene.render_depth_batch(cfg, mesh, pos, cam))
    per_call = kernels_per_call(lambda: cuda_meshscene.render_depth_batch(cfg, mesh, pos, cam))
    launch = {name: (lambda name=name: cuda_meshscene._launch(name, cfg, pos, cam, windows))
              for name in ("meshscene_strips_launch", "meshscene_window_launch")}
    launch4, launch4w = (cuda_ms(launch[n], reps=50) for n in launch)
    dev4, dev4w = (device_us(launch[n]) for n in launch)
    plain4 = cuda_ms(lambda: meshscene.render_strips(cfg, strips, pos, cam), reps=1, warmup=1)
    plain4w = cuda_ms(lambda: meshscene.render_depth_window(cfg, windows, pos, cam), reps=1,
                      warmup=1)
    # bytes: camera positions and attitudes, the windows, the codes;
    # operations: MESH_ROW_OPS per tested row and pixel, and for K4 the
    # culling of every (strip, window row)
    n_bytes = nbytes(pos, cam, windows, codes)
    b4, o4 = mesh_bound(cfg, windows[..., 0], strips[..., 0], nvis,
                        cuda_meshscene.TILE_H * cfg.width, n_bytes,
                        cull_rows=nvis.shape[-1] * int((windows[..., 0] != 0).sum()))
    b4w, o4w = mesh_bound(cfg, windows[..., 0], windows[..., 0], windows.new_full((B,), K),
                          cfg.height * cfg.width, n_bytes)
    return ({**result(0, ms4, plain4, b4, o4), "launch_ms": launch4, "device_us": dev4,
             "batch_ms": batch_ms, "kernels_per_call": per_call},
            {**result(0, ms4w, plain4w, b4w, o4w), "launch_ms": launch4w, "device_us": dev4w})


def ray_poses(g, B, dev):
    """B random orchard poses from generator g, as check_raycast draws them:
    (cam_pos (B, 3), cam_att (B, 4) world-from-camera)."""
    import torch

    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.render import raycast

    pos = torch.stack([torch.rand(B, generator=g) * 40, torch.rand(B, generator=g) * 16 - 8,
                       torch.rand(B, generator=g) * 3 + 0.5], dim=1).to(dev)
    ypr = ((torch.rand(B, 3, generator=g) - 0.5) * 0.6).to(dev)
    return pos, raycast.camera_attitude(rot.from_euler_ypr(ypr[:, 0], ypr[:, 1], ypr[:, 2]))


def above_canopy(dev):
    """One camera at ABOVE_CANOPY looking level along +x (the mount on an
    identity body): every tree it meets lies beyond the far plane, so its
    depth image is all 255 and its RGB image shows the trees hazed."""
    import torch

    from agrifly_tpu_torch.render import raycast

    pos = torch.tensor([ABOVE_CANOPY], dtype=torch.float32, device=dev)
    return pos, raycast.camera_attitude(torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev))


def up_poses(g, B, dev):
    """B orchard poses as ray_poses draws them, but each body pitched up by
    10-40 degrees: most of each image is sky beyond the canopy."""

    import torch

    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.render import raycast

    pos = torch.stack([torch.rand(B, generator=g) * 40, torch.rand(B, generator=g) * 16 - 8,
                       torch.rand(B, generator=g) * 3 + 0.5], dim=1).to(dev)
    ypr = ((torch.rand(B, 3, generator=g) - 0.5) * 0.6).to(dev)
    pitch = -math.radians(10) - torch.rand(B, generator=g).to(dev) * math.radians(30)
    return pos, raycast.camera_attitude(rot.from_euler_ypr(ypr[:, 0], pitch, ypr[:, 2]))


def rgb_cells(cfg, scene, pos, cam, label):
    """K1-rgb's cells per pixel on the cameras (its cells output), equal to
    its plain mirror's (raycast.render_rgb_exit) with the image equal to
    render_rgb's, and their mean by the pixel's winner (sky, ground, tree)
    beside the mirror's traversal before the clear exit (the exit on best
    alone). Prints a line; returns {kind: (mean before, mean now)}."""
    import torch

    from agrifly_tpu_torch.render import cuda_raycast, raycast

    B = pos.shape[0]
    cells = torch.empty((B, cfg.height, cfg.width), dtype=torch.int32, device=pos.device)
    got = cuda_raycast._launch_rgb(cfg, scene, pos, cam, cells)
    ref, ref_cells, mat = raycast._rgb(cfg, scene, pos, cam, "clear")
    _check(torch.equal(got, ref) and torch.equal(got, raycast.render_rgb(cfg, scene, pos, cam)),
           f"K1-rgb differs from render_rgb ({label})")
    _check(torch.equal(cells, ref_cells), f"K1-rgb: cells differ from the plain mirror ({label})")
    before = raycast._rgb(cfg, scene, pos, cam, "best")[1]
    kinds = {"sky": mat == raycast.MAT_SKY, "ground": mat == raycast.MAT_GROUND,
             "tree": mat >= raycast.MAT_TRUNK, "all": torch.ones_like(mat, dtype=torch.bool)}
    out = {}
    for kind, m in kinds.items():
        n = int(m.sum())
        out[kind] = ((float(before[m].float().mean()), float(cells[m].float().mean())) if n
                     else (float("nan"), float("nan")))
    print(f"K1-rgb cells per pixel, {label} (B={B}, {cfg.width}x{cfg.height}; the exit on best "
          f"alone -> with the clear exit, kernel = mirror): " + "; ".join(
              f"{k} {int(kinds[k].sum())} px {a:.4f} -> {b:.4f}" for k, (a, b) in out.items()))
    return out


def sky_bytes(cfg, dev):
    """The RGB bytes of a pixel that meets nothing (raycast.shade of the sky)."""
    import torch

    from agrifly_tpu_torch.render import raycast

    one = torch.ones((1, 1), device=dev)
    return raycast.shade(cfg, torch.zeros((1, 1), dtype=torch.int32, device=dev),
                         (0 * one, 0 * one, one), one * raycast.BIG)[0, 0]


def rgb_timings(wrapper, launch, plain, n_bytes, n_ops):
    """Wrapper, bare launch, device and plain times of an RGB kernel, and
    its bound."""
    res = result(0, cuda_ms(wrapper), cuda_ms(plain, reps=1, warmup=1), n_bytes, n_ops)
    return {**res, "launch_ms": cuda_ms(launch, reps=50), "device_us": device_us(launch)}


def rgb_line(name, res):
    return (f"{name} {res['ms']:.4f} ms (launch alone {res['launch_ms']:.4f}, device "
            f"{us_text(res['device_us'])}), plain {res['plain_ms']:.4f}, bound "
            f"{res['bound_ms']:.6f} ({res['bound_by']})")


def window_cases(cfg, pos, cam, windows, mats, label):
    """K4-rgb on a window of more rows than a staged chunk
    (shuffled_window's), bit-equal to both plain scans; rows of both chunks
    win pixels (the image changes where either chunk's rows are dropped)."""
    import torch

    from agrifly_tpu_torch.render import cuda_meshscene, meshscene

    ref = meshscene.render_rgb_strips(cfg, windows, mats, pos, cam)
    _check(torch.equal(ref, meshscene.render_rgb_window(cfg, windows, mats, pos, cam)),
           f"the plain scans differ on a shuffled window ({label})")
    _check(torch.equal(cuda_meshscene._launch_rgb(cfg, pos, cam, windows, mats), ref),
           f"K4-rgb differs from the plain scans on a shuffled {windows.shape[1]}-row window "
           f"({label})")
    won = []
    for rows in (slice(None, 256), slice(256, None)):
        dropped = windows.clone()
        dropped[:, rows, 0] = 0
        got = cuda_meshscene._launch_rgb(cfg, pos, cam, dropped, mats)
        won.append(int((got != ref).any(-1).sum()))
    _check(min(won) > 0, f"K4-rgb's shuffled window: pixels won by each chunk's rows {won}")
    print(f"K4-rgb on a shuffled {windows.shape[1]}-row window ({label}): bit-equal to both "
          f"plain scans; pixels won by rows of the first / second staged chunk {won[0]} / "
          f"{won[1]}")


def check_rgb(dev):
    """The RGB kernels against their plain versions at 640x480, bit for bit.
    K1-rgb against raycast.render_rgb on check_raycast's poses (B = 1 and
    16) on the default, limit and loose scenes, and from above the canopy
    (trees only beyond the far plane, where K1's depth exit would stop: the
    depth image is all 255, the RGB image is not the sky); every pixel of
    the sky's colour has K1's depth code 255. K4-rgb (render_rgb_batch,
    one launch) against both plain scans (render_rgb_strips,
    render_rgb_window) on the baked orchard and the mixed scene at B = 1 and
    16, from above the canopy (a window with rows beyond the far plane,
    which K4's depth culling drops) and on edge_rows' window (its camera 4
    meets two rows at the same t). Then both kernels' wrapper, launch,
    device and plain times, and bounds. Returns the B = 1 results (K1-rgb
    on the default orchard, K4-rgb on the baked orchard)."""
    import tempfile

    import torch

    from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast, meshscene, orchard, raycast

    t_phase = time.perf_counter()
    cfg = raycast.make_config(640, 480)
    sky = sky_bytes(cfg, dev)
    g = torch.Generator().manual_seed(SEED)
    out = {}
    for B in (1, 16):
        pos, cam = ray_poses(g, B, dev)
        for name, kw in RAY_SCENES.items():
            scene = orchard.make_params(device=dev, **kw)
            for label, (p, c) in (("random poses", (pos, cam)),
                                  ("above the canopy", above_canopy(dev)),
                                  ("pitched up", up_poses(g, B, dev))):
                before = cuda_raycast.render_rgb_batch.launches
                got = cuda_raycast.render_rgb_batch(cfg, scene, p, c)
                _check(cuda_raycast.render_rgb_batch.launches == before + 1,
                       "K1-rgb: not one launch")
                _check(torch.equal(got, raycast.render_rgb(cfg, scene, p, c)),
                       f"K1-rgb differs from render_rgb ({name} scene, {label}, B={B})")
                depth = cuda_raycast.render_depth_batch(cfg, scene, p, c)
                is_sky = (got == sky).all(-1)
                _check(bool((depth[is_sky] == 255).all()),
                       f"K1-rgb: a sky pixel with a depth code below 255 ({name}, {label})")
                trees = int((~is_sky).sum())
                if label == "above the canopy":
                    _check(int(depth.min()) == 255 and trees > 1000,
                           f"K1-rgb above the canopy: depth min {int(depth.min())}, {trees} "
                           f"pixels not sky")
                else:
                    _check(torch.unique(got.reshape(-1, 3), dim=0).shape[0] > 20,
                           f"K1-rgb rendered an empty scene ({name})")
        scene = orchard.make_params(device=dev)
        if B > 1:
            rgb_cells(cfg, scene, pos, cam, "random poses")
            rgb_cells(cfg, scene, *above_canopy(dev), "above the canopy")
            rgb_cells(cfg, scene, *up_poses(g, B, dev), "pitched up 10-40 degrees")
        got = cuda_raycast.render_rgb_batch(cfg, scene, pos, cam)
        ops = B * cfg.height * cfg.width * (
            RAY_OPS_PER_PIXEL + (RAY_OPS_PER_CELL + RGB_RAY_OPS_PER_CELL) * cfg.dda_steps
            + RGB_RAY_SHADE_OPS)
        res = rgb_timings(lambda: cuda_raycast.render_rgb_batch(cfg, scene, pos, cam),
                          lambda: cuda_raycast._launch_rgb(cfg, scene, pos, cam),
                          lambda: raycast.render_rgb(cfg, scene, pos, cam),
                          nbytes(pos, cam, got) + 40, ops)
        print(f"K1-rgb B={B} 640x480: bit-equal to render_rgb on the default, limit and loose "
              f"scenes, from above the canopy (depth all 255, hazed trees) and pitched up, sky "
              f"pixels all at depth 255; " + rgb_line("K1-rgb", res))
        out[("K1-rgb", B)] = res

    reach = cfg.far * meshscene.slant_factor(cfg)
    g = torch.Generator().manual_seed(SEED + 5)
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {"baked orchard": baked_orchard(dev), "mixed scene": mixed_scene(dev, tmp)}
    for label, mesh in scenes.items():
        for B in (1, 16):
            pos, cam = mesh_poses(g, B, dev)
            cases = [("random poses", pos, cam)]
            if label == "baked orchard" and B == 1:
                cases.append(("above the canopy", *above_canopy(dev)))
            for case, p, c in cases:
                windows, order, ok = meshscene.select_window(mesh, p, reach, 192,
                                                             return_order=True)
                mats = meshscene.window_materials(mesh, windows, order, ok)
                if case == "random poses":
                    rows = meshscene.select_window(mesh, p, reach, 300, return_order=True)
                    window_cases(cfg, p, c, *shuffled_window(
                        rows[0], meshscene.window_materials(mesh, *rows)), f"{label}, B={B}")
                before = cuda_meshscene.render_rgb_strips_batch.launches
                got = cuda_meshscene.render_rgb_batch(cfg, mesh, p, c)
                plain_order = cuda_meshscene.render_rgb_batch(cfg, mesh, p, c, strip_cull=False)
                _check(cuda_meshscene.render_rgb_strips_batch.launches == before + 2,
                       "K4-rgb: not one launch a call")
                strips = meshscene.render_rgb_strips(cfg, windows, mats, p, c)
                _check(torch.equal(got, strips) and torch.equal(plain_order, got),
                       f"K4-rgb differs from render_rgb_strips ({label}, {case}, B={B})")
                _check(torch.equal(got, meshscene.render_rgb_window(cfg, windows, mats, p, c)),
                       f"K4-rgb differs from render_rgb_window ({label}, {case}, B={B})")
                _check(torch.unique(got.reshape(-1, 3), dim=0).shape[0] > 20,
                       f"K4-rgb rendered an empty scene ({label}, {case})")
                if case == "above the canopy":
                    _, kept = meshscene.strip_windows(cfg, windows, p, c, cuda_meshscene.TILE_H,
                                                      far_clip=False)
                    _, clipped = meshscene.strip_windows(cfg, windows, p, c,
                                                         cuda_meshscene.TILE_H)
                    beyond = int((kept - clipped).sum())
                    _check(beyond > 0, "above the canopy: no row beyond the far plane")
                    print(f"K4-rgb above the canopy ({label}): bit-equal to both plain scans; "
                          f"{beyond} (strip, row) pairs beyond the far plane kept")
            windows, order, ok = meshscene.select_window(mesh, pos, reach, 192, return_order=True)
            mats = meshscene.window_materials(mesh, windows, order, ok)
            strips, nvis, _ = meshscene.strip_windows(cfg, windows, pos, cam,
                                                      cuda_meshscene.TILE_H, return_order=True,
                                                      far_clip=False)
            got = cuda_meshscene.render_rgb_strips_batch(cfg, windows, mats, pos, cam)
            b, o = mesh_bound(cfg, windows[..., 0], strips[..., 0], nvis,
                              cuda_meshscene.TILE_H * cfg.width,
                              nbytes(pos, cam, windows, mats, got),
                              cull_rows=nvis.shape[-1] * int((windows[..., 0] != 0).sum()))
            res = rgb_timings(
                lambda: cuda_meshscene.render_rgb_strips_batch(cfg, windows, mats, pos, cam),
                lambda: cuda_meshscene._launch_rgb(cfg, pos, cam, windows, mats),
                lambda: meshscene.render_rgb_strips(cfg, windows, mats, pos, cam),
                b, o + B * cfg.height * cfg.width * RGB_MESH_SHADE_OPS)
            print(f"K4-rgb {label}, B={B} 640x480, window {windows.shape[1]} rows: bit-equal to "
                  f"both plain scans; n_vis without the far clip mean "
                  f"{float(nvis.float().mean()):.3f}; " + rgb_line("K4-rgb", res))
            if label == "baked orchard":
                out[("K4-rgb", B)] = res

    windows, pos, cam = edge_rows(dev)
    mats = torch.where(windows[..., 0] == meshscene.PRIM_CYLINDER, meshscene.MAT_TRUNK,
                       meshscene.MAT_CANOPY).to(torch.int32)
    got = cuda_meshscene.render_rgb_strips_batch(cfg, windows, mats, pos, cam)
    _check(torch.equal(got, meshscene.render_rgb_strips(cfg, windows, mats, pos, cam))
           and torch.equal(got, meshscene.render_rgb_window(cfg, windows, mats, pos, cam)),
           "K4-rgb differs from the plain scans on the edge rows")
    print(f"K4-rgb on the edge rows ({windows.shape[1]} rows, {pos.shape[0]} cameras, a tied "
          f"pair among them): bit-equal to both plain scans; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return tuple({k: out[(name, 1)][k] for k in keep} for name in ("K1-rgb", "K4-rgb"))


MESH_TILE_W = 32  # meshscene.cu's kTileW: a mesh kernel block's image columns
# meshscene.cu's Section enum, in order (-DMESH_SECTIONS)
MESH_SECTIONS = ("block", "setup", "cull", "stage", "rows", "shade", "store")
TIMED_MESH = ("meshscene", ("MESH_SECTIONS",))  # cuda_build.load's arguments
MESH_SECTION_LAUNCHES = 5  # timed launches, after one warm-up


def mesh_sections(dev):
    """K4's and K4-rgb's blocks split by section: mean cycles per block of
    each Section of meshscene.cu's MESH_SECTIONS build (clock64 on each
    block's thread 0, a barrier before each mark) over MESH_SECTION_LAUNCHES
    launches at 640x480, B = 1 and 16, on the baked orchard from
    check_meshscene's poses (window 192); ptxas's registers and spills of
    both builds; each mesh kernel's blocks per SM and the waves of those
    grids; and the K = 0 floor, the device time of a launch on an empty
    window (the set-up, the ground or sky and the stores)."""
    import ctypes

    import torch

    from agrifly_tpu_torch import cuda_build
    from agrifly_tpu_torch.render import cuda_meshscene, meshscene, raycast

    print(ptxas_report("meshscene", cuda_build.build_logs.get("meshscene", "")))
    print(ptxas_report("meshscene", cuda_build.build_logs.get("meshscene-MESH_SECTIONS", ""),
                       "meshscene.cu -DMESH_SECTIONS"))
    per_sm = (ctypes.c_int * 3)()
    cuda_build.check(cuda_build.load("meshscene").meshscene_occupancy(per_sm),
                     "meshscene_occupancy")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = raycast.make_config(640, 480)
    strips = cfg.height // cuda_meshscene.TILE_H
    blocks_at = {B: strips * (cfg.width // MESH_TILE_W) * B for B in (1, 16)}
    print(f"mesh kernels, blocks per SM (occupancy API, {sms} SMs) and the waves of a "
          f"{cfg.width}x{cfg.height} grid: " + ", ".join(
              f"{name} {n} (" + ", ".join(
                  f"B={B}: {nb / (n * sms):.3f}" for B, nb in blocks_at.items()) + ")"
              for name, n in zip(("K4", "K4w", "K4-rgb"), per_sm)))

    lib = cuda_build.load(*TIMED_MESH)
    fns = {}
    for name in ("meshscene_strips_launch", "meshscene_rgb_launch"):
        fns[name] = getattr(lib, name)
        fns[name].argtypes, fns[name].restype = cuda_meshscene._ARGTYPES[name], ctypes.c_int
    mhz = max_sm_mhz()
    n = len(MESH_SECTIONS)
    sec, blocks = (ctypes.c_ulonglong * n)(), (ctypes.c_ulonglong * 1)()
    mesh = baked_orchard(dev)
    reach = cfg.far * meshscene.slant_factor(cfg)
    g = torch.Generator().manual_seed(SEED + 5)
    for B in (1, 16):
        pos, cam = mesh_poses(g, B, dev)
        windows, order, ok = meshscene.select_window(mesh, pos, reach, 192, return_order=True)
        mats = meshscene.window_materials(mesh, windows, order, ok)

        def k4(w, fn=None):
            return cuda_meshscene._launch("meshscene_strips_launch", cfg, pos, cam, w,
                                          launcher=fn)

        def k4rgb(w, fn=None):
            return cuda_meshscene._launch_rgb(cfg, pos, cam, w, mats[:, :w.shape[1]],
                                              launcher=fn)

        cases = {"K4": (k4, fns["meshscene_strips_launch"]),
                 "K4-rgb": (k4rgb, fns["meshscene_rgb_launch"])}
        for name, (launch, timed) in cases.items():
            _check(torch.equal(launch(windows, timed), launch(windows)),
                   f"{name}: the MESH_SECTIONS build differs")
            torch.cuda.synchronize()
            cuda_build.check(lib.meshscene_sections_read(sec, blocks), "meshscene_sections_read")
            for _ in range(MESH_SECTION_LAUNCHES):
                launch(windows, timed)
            torch.cuda.synchronize()
            cuda_build.check(lib.meshscene_sections_read(sec, blocks), "meshscene_sections_read")
            nb = blocks[0]
            _check(nb == MESH_SECTION_LAUNCHES * blocks_at[B],
                   f"{name}: {nb} blocks timed")
            whole = device_us(lambda launch=launch: launch(windows))
            floor = device_us(lambda launch=launch: launch(windows[:, :0]))
            print(f"{name} section timers, baked orchard, B={B} 640x480, window "
                  f"{windows.shape[1]} rows (mean cycles per block over {nb} blocks; thread 0, "
                  f"a barrier before each mark): " + ", ".join(
                      f"{s} {sec[k] / nb:.0f}" + (f" ({100 * sec[k] / sec[0]:.1f}%)" if k else "")
                      for k, s in enumerate(MESH_SECTIONS))
                  + f"; a block {sec[0] / nb / mhz:.3f} us at the {mhz:.0f} MHz maximum SM "
                    f"clock; the normal build's device time {whole:.1f} us, at K = 0 (the "
                    f"floor) {floor:.1f} us")


def tick_states(params):
    """Five CPU states for the tick block, built with the port alone: cold,
    takeoff (25 plain tick blocks), tracking (a trajectory adopted at the
    estimate), landing (the descent reaching touchdown mid-block, so the
    block goes landing -> complete) and complete (motors idled)."""
    import torch

    from agrifly_tpu_torch.planner import traj
    from agrifly_tpu_torch.render import raycast
    from agrifly_tpu_torch.sim import orchard_env

    g = torch.Generator().manual_seed(SEED)
    cold = orchard_env.init_state(params)
    warm = cold
    for _ in range(25):
        warm = orchard_env.frame_ticks_plain(params, warm, torch.randn((16, 2, 3), generator=g))
    step = int(warm.base.step)

    z3 = torch.zeros(3)
    tr = traj.generate(z3, torch.tensor([0.05, -0.4, 0.3]), z3, torch.tensor(2.5),
                       torch.tensor([0.3, -0.2, 2.5]), z3, z3)
    mocap = warm.base.mocap
    planned = warm.planned._replace(
        planned=torch.tensor(True), alpha=tr.alpha, beta=tr.beta, gamma=tr.gamma, a0=tr.a0,
        v0=tr.v0, p0=tr.p0, tf=tr.tf, att=raycast.camera_attitude(mocap.att),
        offset=mocap.pos.clone(), start_step=torch.tensor(step - 40, dtype=torch.int32),
        grav_cam=torch.tensor([0.0, 9.81, 0.0]))

    # landing: the 0.5 m/s descent (2 s blend-in) from the current height
    # reaches z = 0 eight ticks into the block
    z0, t = float(warm.base.plant.pos[2]), 0.0
    while z0 - 0.5 * min(t / 2.0, 1.0) * t >= 0.0:
        t += 0.002
    since = round(t / 0.002) - 8
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    land = lambda stage, start: warm._replace(  # noqa: E731
        mstage=i32(stage), land_pos=warm.base.plant.pos.clone(), land_start_step=i32(start))
    return {"cold": cold, "takeoff": warm, "tracking": warm._replace(planned=planned),
            "landing": land(orchard_env.MSTAGE_LANDING, step - since),
            "complete": land(orchard_env.MSTAGE_COMPLETE, step)}


@functools.lru_cache(maxsize=1)
def tick_case():
    """The tick phases' CPU params (start_flight_time 0.3) and their five
    tick_states, built once: each build runs 400 plain ticks on the CPU."""
    from agrifly_tpu_torch.sim import orchard_env

    p_cpu = orchard_env.make_params(start_flight_time=0.3, device="cpu")
    return p_cpu, tick_states(p_cpu)


def compare_ticks(got, ref, where, env=("base",)):
    """The tick criteria: discrete leaves equal, float leaves within
    1e-3 (|ref| + 1e-3), the commanded body rates within the controller's
    1e-2 rad/s command floor (+ 1e-3 |ref|) and their wire codes within 10
    codes. env: the path of the env state in the trees (() for an
    `env.EnvState`). Returns the worst float leaf's ratio to its bound."""
    import torch

    from agrifly_tpu_torch import convert

    commands = {env + ("last_cmd_angvel",), env + ("mocap", "pipe", "angvel")}
    worst = 0.0
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref)):
        a, b = a.cpu(), b.cpu()
        if path == env + ("ring", "fields"):
            _check(int((a - b).abs().max()) <= 10, f"wire codes differ ({where}): {path}")
        elif not a.is_floating_point():
            _check(torch.equal(a, b), f"discrete leaf differs ({where}): {path}")
        else:
            d = (a.double() - b.double()).abs()
            if path in commands:
                bound = 1e-2 + 1e-3 * b.double().abs()
            else:
                bound = 1e-3 * (b.double().abs() + 1e-3)
            ratio = float((d / bound).max())
            _check(ratio <= 1.0, f"float leaf off ({where}): {path} ({ratio:.3g} x bound)")
            worst = max(worst, ratio)
    return worst


def tick_reading(got, ref, env=("base",)):
    """The tick criteria as a reading, not a gate: (the worst float leaf's
    ratio to compare_ticks' bound, the discrete leaves that differ, the
    wire codes' largest difference)."""
    from agrifly_tpu_torch import convert

    commands = {env + ("last_cmd_angvel",), env + ("mocap", "pipe", "angvel")}
    worst, differ, codes = 0.0, 0, 0
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref)):
        a, b = a.cpu(), b.cpu()
        if path == env + ("ring", "fields"):
            codes = max(codes, int((a - b).abs().max()))
        elif not a.is_floating_point():
            differ += int(not bool((a == b).all()))
        else:
            d = (a.double() - b.double()).abs()
            scale = 1e-2 if path in commands else 1e-3 * 1e-3
            worst = max(worst, float((d / (scale + 1e-3 * b.double().abs())).max()))
    return worst, differ, codes


def to_device(tree, dev):
    from agrifly_tpu_torch import convert

    leaves, rebuild = convert.flatten_tensors(tree)
    return rebuild([t.to(dev) for t in leaves])


def tick_result(worst, p, state, noise, plain_reps=3, plain_warmup=1):
    """Time the tick kernel (wrapper and bare launch) and the plain ticks
    on `state` (one vehicle, or a fleet when noise has a leading B), and
    bound it: every state, parameter and noise byte read and every written
    leaf written once; TICK_OPS per vehicle and tick."""
    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    fleet = noise.dim() == 4
    plain = orchard_env.frame_ticks_plain_fleet if fleet else orchard_env.frame_ticks_plain
    ms = cuda_ms(lambda: cuda_frame.frame_ticks(p, state, noise), reps=20)
    leaves, _ = convert.flatten_tensors(state)
    pleaves = cuda_frame.param_leaves(p)
    batched = noise if fleet else noise[None]
    launch_ms = cuda_ms(lambda: cuda_frame._launch(leaves, pleaves, batched), reps=50)
    plain_ms = cuda_ms(lambda: plain(p, state, noise), reps=plain_reps, warmup=plain_warmup)
    specs, _ = cuda_frame.leaf_table()
    written = [t for s, t in zip(specs, leaves) if s.written]
    B, ticks = batched.shape[:2]
    res = result(worst, ms, plain_ms, nbytes(*leaves, *pleaves, noise, *written),
                 B * ticks * TICK_OPS)
    print(f"frame_ticks {ticks} ticks, B={B}: kernel {ms:.4f} ms (launch alone "
          f"{launch_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {res['bound_ms']:.6f} ms "
          f"({res['bound_by']})")
    return res


def check_frame_ticks(dev):
    """The fused tick kernel against frame_ticks_plain on the card, same
    states and noise, in five mission states."""
    import torch

    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    p_cpu, states = tick_case()
    p = orchard_env.OrchardEnv(p_cpu).to(dev).params
    noise = torch.randn((16, 2, 3), generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    worst = 0.0
    for name, s_cpu in states.items():
        s = to_device(s_cpu, dev)
        got = cuda_frame.frame_ticks(p, s, noise)
        ref = orchard_env.frame_ticks_plain(p, s, noise)
        torch.cuda.synchronize()
        _check(int(got.base.step) == int(s.base.step) + 16, f"{name}: step did not advance 16")
        ratio = compare_ticks(got, ref, f"kernel vs plain, {name}")
        print(f"frame_ticks {name}: discrete leaves equal, worst float leaf {ratio:.4g} x bound "
              f"(mstage {int(s.mstage)} -> {int(got.mstage)})")
        worst = max(worst, ratio)
    return tick_result(worst, p, s, noise, plain_reps=1)


def check_frame_ticks_batched(dev):
    """The tick kernel for a fleet (K3b): the five mission states repeated
    to B = 5 and 37 rows (37 crosses the 32-thread block), one launch each,
    against the plain ticks of every vehicle on CPU copies of the same
    inputs, by the tick criteria (the plain fleet loops its vehicles, and a
    vehicle's 16 plain ticks cost the CPU about a third of the card's
    launch-bound time). Returns the worst float leaf's ratio to its
    bound."""
    import torch

    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    p_cpu, states = tick_case()
    p = orchard_env.OrchardEnv(p_cpu).to(dev).params
    states = list(states.values())
    worst = 0.0
    for B in (5, 37):
        fleet_cpu = orchard_env.stack_states([states[b % 5] for b in range(B)])
        noise_cpu = torch.randn((B, 16, 2, 3), generator=torch.Generator().manual_seed(B))
        fleet, noise = to_device(fleet_cpu, dev), noise_cpu.to(dev)
        before = cuda_frame.frame_ticks.launches
        got = cuda_frame.frame_ticks(p, fleet, noise)
        _check(cuda_frame.frame_ticks.launches == before + 1, f"K3b B={B}: not one launch")
        ref = orchard_env.frame_ticks_plain_fleet(p_cpu, fleet_cpu, noise_cpu)
        torch.cuda.synchronize()
        _check(torch.equal(got.base.step, fleet.base.step + 16), f"K3b B={B}: steps")
        ratio = compare_ticks(got, ref, f"K3b vs plain, B={B}")
        print(f"frame_ticks batched B={B} (one launch) vs the plain ticks on the CPU: discrete "
              f"leaves equal, worst float leaf "
              f"{ratio:.4g} x bound; mstage {fleet.mstage[:5].tolist()} -> "
              f"{got.mstage[:5].tolist()}")
        worst = max(worst, ratio)
    return worst


def tick_split(dev):
    """K3's device time per bare launch (device_us) at n_ticks = 0, 1 and
    16: one vehicle in the tracking state, and fleets of
    16 and 64 of the five mission states. The n_ticks = 0 launch is the
    kernel's leaf prologue and epilogue alone; the difference to 16 ticks
    is the tick chain."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    p_cpu, states = tick_case()
    p = orchard_env.OrchardEnv(p_cpu).to(dev).params
    pleaves = cuda_frame.param_leaves(p)
    out = {}
    for B, names in ((1, ("tracking",)), (16, tuple(states)), (64, tuple(states))):
        fleet = to_device(orchard_env.stack_states([states[names[b % len(names)]]
                                                    for b in range(B)]), dev)
        leaves, _ = convert.flatten_tensors(fleet)
        for n in ((0, 1, 16) if B < 64 else (16,)):
            noise = torch.randn((B, n, 2, 3), generator=torch.Generator().manual_seed(n)).to(dev)
            out[B, n] = device_us(lambda: cuda_frame._launch(leaves, pleaves, noise))
    print("frame_ticks device time per launch (bare launch): " + "; ".join(
        f"B={B} ({'tracking' if B == 1 else 'five states'}) n_ticks={n}: {us_text(v)}"
        for (B, n), v in out.items()))


# csrc/frame.cu's Section enum, in order: the statements its clock64() timers
# enclose in the FRAME_SECTIONS build
SECTIONS = ("ticks", "plant", "logic", "ekf_predict", "cov_predict", "mocap_update",
            "replay (update)", "prediction", "offboard", "radio", "imu")
SECTION_LAUNCHES = 20  # timed 16-tick launches, after one warm-up
TIMED_FRAME = ("frame", ("FRAME_SECTIONS",))  # cuda_build.load's arguments for the timed build


def frame_sections(dev):
    """Cycles per tick of each section of the tick chain (vehicle 0, the
    tracking state, SECTION_LAUNCHES launches of 16 ticks) from frame.cu's
    FRAME_SECTIONS build, and the leader's measured chain time: the ticks'
    cycles per launch over the card's maximum SM clock."""
    import ctypes

    import torch

    from agrifly_tpu_torch import convert, cuda_build
    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    lib = cuda_build.load(*TIMED_FRAME)
    lib.frame_ticks_launch.argtypes = cuda_frame._ARGTYPES
    lib.frame_ticks_launch.restype = ctypes.c_int
    p_cpu, states = tick_case()
    p = orchard_env.OrchardEnv(p_cpu).to(dev).params
    leaves, _ = convert.flatten_tensors(to_device(states["tracking"], dev))
    pleaves = cuda_frame.param_leaves(p)
    noise = torch.randn((1, 16, 2, 3), generator=torch.Generator().manual_seed(SEED)).to(dev)
    specs, _ = cuda_frame.leaf_table()
    bufs = {ty: torch.empty(sum(max(s.numel, 1) for s in specs if s.written and s.dtype == ty),
                            dtype=ty, device=dev) for ty in cuda_frame._DTYPES.values()}
    ptrs = [(ctypes.c_void_p * len(x))(*[t.data_ptr() for t in x]) for x in (leaves, pleaves)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        cuda_build.check(lib.frame_ticks_launch(
            *ptrs, noise.data_ptr(), bufs[torch.float32].data_ptr(),
            bufs[torch.int32].data_ptr(), bufs[torch.bool].data_ptr(), 1, 16, stream),
            "frame_sections")

    sec, cnt = (ctypes.c_ulonglong * len(SECTIONS))(), (ctypes.c_ulonglong * len(SECTIONS))()
    launch()
    torch.cuda.synchronize()
    lib.frame_sections_read(sec, cnt)
    for _ in range(SECTION_LAUNCHES):
        launch()
    torch.cuda.synchronize()
    cuda_build.check(lib.frame_sections_read(sec, cnt), "frame_sections_read")
    ticks = SECTION_LAUNCHES * 16
    mhz = max_sm_mhz()
    chain_ms = sec[0] / SECTION_LAUNCHES / (mhz * 1e3)
    print(f"frame_ticks section timers (tracking state, cycles per tick over {ticks} ticks): "
          + ", ".join(f"{name} {sec[k] / ticks:.0f} (runs {cnt[k]})"
                      for k, name in enumerate(SECTIONS))
          + f"; measured chain time {sec[0] / SECTION_LAUNCHES:.0f} cycles per 16 ticks = "
            f"{chain_ms:.6f} ms at the {mhz:.0f} MHz maximum SM clock")


RENDER_KERNELS = ("raycast", "meshscene_strips", "meshscene_window", "raycast_rgb",
                  "meshscene_rgb")


def reset_counts():
    from agrifly_tpu_torch.planner import cuda_inflate, cuda_plan, cuda_rounds, rappids, traj
    from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast
    from agrifly_tpu_torch.sim import cuda_frame, cuda_percept, orchard_env

    cuda_raycast.render_depth_batch.launches = 0
    cuda_raycast.render_rgb_batch.launches = 0
    cuda_meshscene.render_depth_strips_batch.launches = 0
    cuda_meshscene.render_depth_window_batch.launches = 0
    cuda_meshscene.render_rgb_strips_batch.launches = 0
    cuda_inflate.inflate_pyramids.launches = 0
    cuda_inflate.inflate_pyramids.cluster_launches = 0
    cuda_inflate.inflate_pyramids.grouped_launches = 0
    cuda_frame.frame_ticks.launches = 0
    orchard_env.frame_ticks_plain.calls = 0
    cuda_plan.collision_check.launches = 0
    cuda_plan.plan_gates.launches = 0
    rappids.collision_check_plain.calls = 0
    traj.check_input_feasibility.calls = 0
    traj.check_velocity_feasibility.calls = 0
    cuda_percept.percept_head.launches = 0
    cuda_rounds.round_seeds.launches = 0
    cuda_rounds.pyramid_set.launches = 0
    cuda_rounds.lazy_seeds.launches = 0
    for fn in (orchard_env.percept_head_plain, rappids.round_seeds_plain,
               rappids.pyramid_set_plain, rappids.lazy_seeds_plain):
        fn.calls = 0


def read_counts():
    from agrifly_tpu_torch.planner import cuda_inflate, cuda_plan, cuda_rounds, rappids, traj
    from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast
    from agrifly_tpu_torch.sim import cuda_frame, cuda_percept, orchard_env

    return {"raycast": cuda_raycast.render_depth_batch.launches,
            "meshscene_strips": cuda_meshscene.render_depth_strips_batch.launches,
            "meshscene_window": cuda_meshscene.render_depth_window_batch.launches,
            "raycast_rgb": cuda_raycast.render_rgb_batch.launches,
            "meshscene_rgb": cuda_meshscene.render_rgb_strips_batch.launches,
            "inflate": cuda_inflate.inflate_pyramids.launches,
            "inflate_cluster": cuda_inflate.inflate_pyramids.cluster_launches,
            "inflate_grouped": cuda_inflate.inflate_pyramids.grouped_launches,
            "frame_ticks": cuda_frame.frame_ticks.launches,
            "frame_ticks_plain calls": orchard_env.frame_ticks_plain.calls,
            "collision_check": cuda_plan.collision_check.launches,
            "plan_gates": cuda_plan.plan_gates.launches,
            "plain check and gates calls": (rappids.collision_check_plain.calls
                                            + traj.check_input_feasibility.calls
                                            + traj.check_velocity_feasibility.calls),
            "percept_head": cuda_percept.percept_head.launches,
            "round_seeds": cuda_rounds.round_seeds.launches,
            "pyramid_set": cuda_rounds.pyramid_set.launches,
            "lazy_seeds": cuda_rounds.lazy_seeds.launches,
            "plain head and rounds calls": sum(fn.calls for fn in (
                orchard_env.percept_head_plain, rappids.round_seeds_plain,
                rappids.pyramid_set_plain, rappids.lazy_seeds_plain))}


def check_counts(launches, frames, fused, rounds, render="raycast", renders=1, rgb=None):
    """Per frame, whatever the number of vehicles: `renders` launches of the
    render kernel (the raycaster, or K4 in an imported world), one of the
    RGB kernel `rgb` (where one is named) and none of the other render
    kernels, one percept head (K9), one inflation launch (K2 or K2c) and
    one pyramid set (K11) per planner round, one round-seeds launch (K10)
    per pre-planned round and one lazy-seeds launch (K12) per lazy round,
    one gate launch (K8) and 1 + PLAN_LAZY_ROUNDS collision-check launches
    (K7), with no call of their plain versions, and one tick launch (fused)
    or one plain tick block (plain, one vehicle)."""
    for name in RENDER_KERNELS:
        want = frames * renders if name == render else frames if name == rgb else 0
        _check(launches[name] == want,
               f"{name} launched {launches[name]} times in {frames} frames (want {want})")
    inflations = launches["inflate"] + launches["inflate_cluster"]
    _check(inflations == rounds * frames,
           f"inflation launched {inflations} times in {frames} frames of {rounds} rounds")
    _check(launches["inflate_grouped"] == 0, "the frame launched the grouped inflation")
    _check(launches["plan_gates"] == frames,
           f"plan_gates launched {launches['plan_gates']} times in {frames} frames")
    checks = (1 + PLAN_LAZY_ROUNDS) * frames
    _check(launches["collision_check"] == checks,
           f"collision_check launched {launches['collision_check']} times in {frames} frames "
           f"(want {checks})")
    _check(launches["plain check and gates calls"] == 0,
           f"the plain collision check or gates ran {launches['plain check and gates calls']} "
           f"times in {frames} frames on the card")
    want = {"percept_head": frames, "round_seeds": (rounds - PLAN_LAZY_ROUNDS) * frames,
            "pyramid_set": rounds * frames, "lazy_seeds": PLAN_LAZY_ROUNDS * frames}
    for name, n in want.items():
        _check(launches[name] == n, f"{name} launched {launches[name]} times in {frames} frames "
                                    f"(want {n})")
    _check(launches["plain head and rounds calls"] == 0,
           f"the plain percept head or rounds ran {launches['plain head and rounds calls']} "
           f"times in {frames} frames on the card")
    ticks_k, ticks_p = (frames, 0) if fused else (0, frames)
    _check(launches["frame_ticks"] == ticks_k,
           f"frame_ticks launched {launches['frame_ticks']} times in {frames} frames")
    _check(launches["frame_ticks_plain calls"] == ticks_p,
           f"frame_ticks_plain ran {launches['frame_ticks_plain calls']} times in {frames} frames")


PLAN_PARTS = ("gates", "round seeds", "inflation", "pyramid sets", "collision check",
              "lazy seeds", "lazy re-check", "glue")


def plan_split(p, state, u, reps=3):
    """The frame's rappids.plan call from `state` with the draws u (its
    candidates the percept head's), split at its kernels' wrappers: the
    gates (K8), the rounds' seeds (K10), the inflations (K2/K2c), the
    pyramid sets (K11), the first collision check (K7), the lazy round's
    seeds (K12), its re-check (K7), and the glue between them (the pooled
    image, the lazy round's four selects, the selection). The card is
    synchronized at every boundary and each part timed on the host's clock,
    the mean of `reps` plans (one warm-up first); returns {part: ms} and the
    synchronized plan's ms."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate, cuda_plan, cuda_rounds, rappids

    args, kw = plan_args(p, state, u)
    marks = []

    def mark(label):
        torch.cuda.synchronize()
        marks.append((label, time.perf_counter()))

    def around(fn, part):
        def call(*a, **k):
            mark("start")
            out = fn(*a, **k)
            mark(part() if callable(part) else part)
            return out
        call.launches = getattr(fn, "launches", 0)  # the wrapper counts while it stands in
        return call

    checks = iter(("collision check", "lazy re-check") * (reps + 1))
    patched = [(cuda_plan, "plan_gates", "gates"), (cuda_rounds, "round_seeds", "round seeds"),
               (cuda_inflate, "inflate_rows", "inflation"),
               (cuda_rounds, "pyramid_set", "pyramid sets"),
               (cuda_rounds, "lazy_seeds", "lazy seeds"),
               (rappids, "collision_check", lambda: next(checks))]
    originals = [getattr(mod, name) for mod, name, _ in patched]
    spent = dict.fromkeys(PLAN_PARTS, 0.0)
    total = 0.0
    for mod, name, part in patched:
        setattr(mod, name, around(getattr(mod, name), part))
    try:
        for rep in range(reps + 1):
            marks.clear()
            mark("start")
            rappids.plan(*args, **kw)
            mark("start")
            for (_, t0), (label, t1) in zip(marks, marks[1:]):
                if rep:
                    spent["glue" if label == "start" else label] += 1e3 * (t1 - t0) / reps
            if rep:
                total += 1e3 * (marks[-1][1] - marks[0][1]) / reps
    finally:
        for (mod, name, _), fn in zip(patched, originals):
            if hasattr(fn, "launches"):
                fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)
    return spent, total


def frame_split(p, state, gen, dev, label, reps=5):
    """Where a frame's time goes, from `state` (each part timed apart over
    `reps` calls, so the parts need not sum to the frame), and the
    planner's split (plan_split)."""
    from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast, raycast
    from agrifly_tpu_torch.sim import cuda_percept, orchard_env

    lead = state.base.step.shape
    u, noise = (orchard_env.draw_fleet(p, gen, lead[0], dev) if lead
                else orchard_env.draw(p, gen, dev))
    cam_att = raycast.camera_attitude(state.base.plant.att).reshape(-1, 4)
    pos = state.base.plant.pos.reshape(-1, 3)
    if p.mesh is not None:
        render = cuda_ms(lambda: cuda_meshscene.render_depth_batch(
            p.render_cfg, p.mesh, pos, cam_att), reps=5)
    else:
        render = cuda_ms(lambda: cuda_raycast.render_depth_batch(
            p.render_cfg, p.scene, pos, cam_att), reps=5)
    warmup = min(reps, 2)
    percept = cuda_ms(lambda: orchard_env._frame_percept(p, state, u), reps=reps, warmup=warmup)
    head = cuda_ms(lambda: cuda_percept.percept_head(p, state, u), reps=reps, warmup=warmup)
    ticks = cuda_ms(lambda: orchard_env.frame_ticks(p, state, noise), reps=reps, warmup=warmup)
    parts, total = plan_split(p, state, u, reps=min(reps, 3))
    print(f"frame split ({label}): percept head (K9) {head:.3f} ms, render {render:.3f} ms, "
          f"plan and adoption {percept - render - head:.3f} ms, 16 ticks {ticks:.3f} ms; the plan "
          f"synchronized at its parts {total:.3f} ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))


def fly(dev, fused, frames, state=None, mesh=None):
    """The single-vehicle slice: OrchardEnv at full width flies `frames`
    frames on the card, from `state` or from the start; fused: the default
    configuration (the tick kernel), else fused_ticks=False (plain ticks);
    mesh: an imported world in place of the procedural orchard."""
    import torch

    from agrifly_tpu_torch.sim import orchard_env

    env = orchard_env.OrchardEnv(orchard_env.make_params(
        start_flight_time=1.0, fused_ticks=fused, mesh_scene=mesh, device=dev))
    state = env.init_state() if state is None else state
    plans0 = int(state.plan_count)
    gen = torch.Generator(device=dev).manual_seed(SEED + fused)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = env.fly(state, frames, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_counts(launches, frames, fused, env.params.planner_rounds + 1,
                 "raycast" if mesh is None else "meshscene_strips")
    pos = outs["pos"]
    _check(tuple(pos.shape) == (frames, 3) and bool(torch.isfinite(pos).all()),
           "non-finite or misshaped positions")
    _check(not bool((outs["panic"] != 0).any()), "the vehicle panicked")
    plans = int(state.plan_count) - plans0
    _check(plans > 0, "no plan was adopted")
    x = float(pos[-1, 0])
    if mesh is None:
        _check(x > 1.0, f"no forward progress (x = {x:.3f} m)")
    frame_ms = 1e3 * seconds / frames
    fly.last_ms = frame_ms
    label = f"{'fused' if fused else 'plain'} ticks" + ("" if mesh is None else
                                                         ", imported world")
    print(f"flight ({label}): {frames} frames at 640x480, 256 candidates: "
          f"{frame_ms:.3f} ms/frame; {plans} plans adopted, x = {x:.3f} m, "
          f"z = {float(pos[-1, 2]):.3f} m; {launches}")
    frame_split(env.params, state, gen, dev, label, reps=5 if fused else 1)
    if fused:
        profile_frame(lambda: env.frame_step(state, gen), frame_ms, f"frame ({label})")
    return state, launches


def fly_fleet(dev, frames=FLEET_FRAMES, mesh=None):
    """The fleet slice: FLEET vehicles in lanes 3 m apart fly `frames`
    frames of the default configuration through OrchardEnv.fly_fleet, in
    the procedural orchard or the imported world `mesh`."""
    import torch

    from agrifly_tpu_torch.sim import orchard_env

    env = orchard_env.OrchardEnv(
        orchard_env.make_params(start_flight_time=FLEET_START, mesh_scene=mesh, device=dev))
    state = env.init_state_fleet(lanes(FLEET, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = env.fly_fleet(state, frames, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_counts(launches, frames, True, env.params.planner_rounds + 1,
                 "raycast" if mesh is None else "meshscene_strips")
    pos = outs["pos"]
    _check(tuple(pos.shape) == (frames, FLEET, 3) and bool(torch.isfinite(pos).all()),
           "fleet: non-finite or misshaped positions")
    _check(not bool((outs["panic"] != 0).any()), "fleet: a vehicle panicked")
    frame_ms = 1e3 * seconds / frames
    if mesh is not None:
        label = f"fleet of {FLEET}, imported world"
        print(f"fleet flight ({label}): {FLEET} vehicles x {frames} frames at 640x480, 256 "
              f"candidates: {frame_ms:.3f} ms per fleet frame ({FLEET * 32.0 / frame_ms:.3f}x "
              f"real time in aggregate); plans adopted per vehicle "
              f"{state.plan_count.tolist()}, mean z {float(pos[-1, :, 2].mean()):.3f} m; "
              f"{launches}")
        frame_split(env.params, state, gen, dev, label)
        profile_frame(lambda: env.frame_step_fleet(state, gen), frame_ms, f"fleet frame ({label})")
        return state, launches
    # The mission is the JAX package's, shared by the fleet: before a vehicle
    # has a plan it hovers toward the world origin's lane. The two lanes
    # next to it plan; the others are pulled toward it too fast for the
    # planner's velocity gate within the flight.
    y0, y1 = lanes(FLEET, dev)[:, 1], pos[-1, :, 1]
    centre = y0.abs() < 3.0
    planned = state.plan_count > 0
    _check(bool(planned[centre].all()), f"fleet: a centre-lane vehicle adopted no plan "
                                        f"({state.plan_count.tolist()})")
    x0, x1 = float(pos[0, centre, 0].mean()), float(pos[-1, centre, 0].mean())
    _check(x1 > x0 + 0.02, f"fleet: no forward progress in the centre lanes "
                           f"(mean x {x0:.3f} -> {x1:.3f} m)")
    _check(bool((y1[~centre].abs() < y0[~centre].abs()).all()),
           f"fleet: an outer vehicle did not move toward the hover lane ({y1.tolist()})")
    print(f"fleet flight: {FLEET} vehicles x {FLEET_FRAMES} frames at 640x480, 256 candidates: "
          f"{frame_ms:.3f} ms per fleet frame ({FLEET * 32.0 / frame_ms:.3f}x real time in "
          f"aggregate); plans adopted per vehicle {state.plan_count.tolist()}, centre-lane mean "
          f"x {x0:.3f} -> {x1:.3f} m, final |y| {[round(v, 2) for v in y1.abs().tolist()]} m, "
          f"final speed {[round(v, 2) for v in outs['vel'][-1].norm(dim=-1).tolist()]} m/s, "
          f"mean z {float(pos[-1, :, 2].mean()):.3f} m; {launches}")
    frame_split(env.params, state, gen, dev, f"fleet of {FLEET}")
    profile_frame(lambda: env.frame_step_fleet(state, gen), frame_ms, f"fleet frame, B={FLEET}")
    return state, launches


def fly_worlds_in_turns(dev, state, mesh):
    """The procedural orchard and the imported world `mesh` (the same trees,
    baked), each flown TURN_FRAMES frames from one mid-flight `state` with
    the same draws, in turns: procedural, imported, imported, procedural.
    Within one call and one state, the two worlds' frame times differ only
    by their render and the host's drift."""
    import torch

    from agrifly_tpu_torch.sim import orchard_env

    envs = {world: orchard_env.OrchardEnv(orchard_env.make_params(
        start_flight_time=1.0, mesh_scene=m, device=dev))
        for world, m in (("procedural", None), ("imported", mesh))}
    times = {world: [] for world in envs}
    for world in ("procedural", "imported", "imported", "procedural"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = envs[world].fly(state, TURN_FRAMES, gen)
        torch.cuda.synchronize()
        times[world].append(1e3 * (time.perf_counter() - t0) / TURN_FRAMES)
        check_counts(read_counts(), TURN_FRAMES, True, envs[world].params.planner_rounds + 1,
                     "raycast" if world == "procedural" else "meshscene_strips")
        _check(bool(torch.isfinite(outs["pos"]).all()) and not bool((outs["panic"] != 0).any()),
               f"worlds in turns: {world} flight not sane")
    print(f"worlds in turns from one state ({TURN_FRAMES} frames each, same draws): "
          + "; ".join(f"{w} {', '.join(f'{t:.3f}' for t in ts)} ms/frame"
                      for w, ts in times.items()))


def fly_mesh(dev, state):
    """The imported-world slice: the procedural orchard baked into
    primitives, flown in turns with the procedural orchard from `state`
    (a procedural flight's), by one vehicle for MESH_FRAMES frames and by
    FLEET vehicles in lanes for MESH_FLEET_FRAMES, every frame through K4;
    then the fleet's final poses rendered in one call of
    render_depth_batch(strip_culling=False), the window kernel (K4w), held
    equal to K4 on the same poses. Returns the launches of the single
    flight, of the fleet flight and of the window render."""
    import torch

    from agrifly_tpu_torch.render import cuda_meshscene, raycast

    mesh = baked_orchard(dev)
    fly_worlds_in_turns(dev, state, mesh)
    _, launches = fly(dev, True, MESH_FRAMES, mesh=mesh)
    state, fleet_launches = fly_fleet(dev, MESH_FLEET_FRAMES, mesh)
    cfg = raycast.make_config(640, 480)
    pos = state.base.plant.pos
    cam = raycast.camera_attitude(state.base.plant.att)
    culled = cuda_meshscene.render_depth_batch(cfg, mesh, pos, cam)
    reset_counts()
    window = cuda_meshscene.render_depth_batch(cfg, mesh, pos, cam, strip_culling=False)
    torch.cuda.synchronize()
    window_launches = read_counts()
    _check(window_launches["meshscene_window"] == 1 and window_launches["meshscene_strips"] == 0
           and window_launches["raycast"] == 0, f"window render: {window_launches}")
    _check(torch.equal(window, culled), "K4w differs from K4 on the fleet's poses")
    ms = cuda_ms(lambda: cuda_meshscene.render_depth_batch(cfg, mesh, pos, cam,
                                                           strip_culling=False), reps=5)
    print(f"window render of the fleet's {FLEET} poses (K4w, one launch): equal to K4; "
          f"{ms:.4f} ms; {window_launches}")
    profile_frame(lambda: [cuda_meshscene.render_depth_batch(cfg, mesh, pos, cam,
                                                             strip_culling=False)
                           for _ in range(5)], 5 * ms, f"5 window renders, B={FLEET}")
    return launches, fleet_launches, window_launches


def bridge_frame(env, state, gen, mesh):
    """One frame as a topic bridge runs it: OrchardEnv.fly_diag for the
    frame's row; the row's pose rendered to depth and to RGB through the
    batch wrappers; the telemetry encoded on the card (encode_from_logic of
    the frame's logic state) and on the host (wire_quantize_np of the
    row's sources, which must equal the card's decode); the command encoded
    on the host (make_rates_command_np, which must equal make_rates_command's
    codes on the card). Returns (state, row, rgb image)."""
    import numpy as np
    import torch

    from agrifly_tpu_torch.io import radio, telemetry
    from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast

    p = env.params
    state, row = env.fly_diag(state, 1, gen)
    pos, att = row["pos"], row["att"]
    if mesh is None:
        depth = cuda_raycast.render_depth_body_batch(p.render_cfg, p.scene, pos, att)
        rgb = cuda_raycast.render_rgb_body_batch(p.render_cfg, p.scene, pos, att)
    else:
        depth = cuda_meshscene.render_depth_body_batch(p.render_cfg, mesh, pos, att)
        rgb = cuda_meshscene.render_rgb_body_batch(p.render_cfg, mesh, pos, att)
    pkts, _ = telemetry.encode_from_logic(state.base.logic)
    cmd = radio.make_rates_command(row["last_cmd_thrust"][0], row["last_cmd_angvel"][0])
    host = {k: v[0].cpu().numpy() for k, v in row.items() if isinstance(v, torch.Tensor)}
    dec = telemetry.decode(pkts)
    att_q = host["tel_kf_att"]
    wire = {"accel": (host["tel_acc"], telemetry.RANGE_ACC),
            "gyro": (host["tel_gyro"], telemetry.RANGE_GYRO),
            "motor_forces": (host["tel_motor_forces"], telemetry.RANGE_FORCE),
            "position": (host["tel_kf_pos"], telemetry.RANGE_POS),
            "batt_voltage": (host["tel_batt"], telemetry.RANGE_BATT),
            "velocity": (host["tel_kf_vel"], telemetry.RANGE_VEL),
            "attitude": (att_q[1:] * (1.0 if att_q[0] > 0 else -1.0), telemetry.RANGE_ATT),
            "debug": (host["tel_debug"], telemetry.RANGE_GENERIC)}
    for name, (x, rng) in wire.items():
        _check(np.array_equal(telemetry.wire_quantize_np(x, rng),
                              getattr(dec, name).cpu().numpy().astype(np.float64), equal_nan=True),
               f"bridge frame: host telemetry {name} differs from the card's decode")
    _check(int(dec.warnings) == int(host["tel_warnings"]) and
           int(dec.panic_reason) == int(row["panic"][0]), "bridge frame: telemetry flags differ")
    mtype, flags, fields = radio.make_rates_command_np(host["last_cmd_thrust"],
                                                       host["last_cmd_angvel"])
    _check(mtype == int(cmd[0]) and flags == int(cmd[1])
           and np.array_equal(fields, cmd[2].cpu().numpy()),
           "bridge frame: host command codes differ from the card's")
    _check(len(radio.fields_to_bytes(mtype, flags, fields)) == radio.RAW_PACKET_SIZE
           and depth.shape == rgb.shape[:-1], "bridge frame: misshaped packet or images")
    return state, row, rgb


def fly_bridge(dev, state, mesh=None):
    """What a topic bridge computes each frame (bridge_frame), for
    BRIDGE_FRAMES frames in the procedural orchard or the imported world
    `mesh`, one vehicle from `state` (mid-flight: the planner adopts plans
    within the flight). Per frame the render kernel runs
    twice (the frame's depth image and the bridge's), the RGB kernel once,
    the inflation once per planner round and the tick kernel once. In the
    procedural orchard, then TURN_FRAMES frames of fly and of fly_diag from
    the flight's final state with the same draws, in turns (fly, fly_diag,
    fly_diag, fly). Returns the launches of the flight."""
    import torch

    from agrifly_tpu_torch.sim import orchard_env

    env = orchard_env.OrchardEnv(orchard_env.make_params(start_flight_time=1.0, mesh_scene=mesh,
                                                         device=dev))
    plans0 = int(state.plan_count)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    world = "procedural" if mesh is None else "imported"
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    colours, poses = [], []
    for _ in range(BRIDGE_FRAMES):
        state, row, rgb = bridge_frame(env, state, gen, mesh)
        colours.append(torch.unique(rgb.reshape(-1, 3), dim=0).shape[0])
        poses.append((row["pos"], row["att"]))
    torch.cuda.synchronize()
    frame_ms = 1e3 * (time.perf_counter() - t0) / BRIDGE_FRAMES
    launches = read_counts()
    depth = "raycast" if mesh is None else "meshscene_strips"
    check_counts(launches, BRIDGE_FRAMES, True, env.params.planner_rounds + 1, depth, renders=2,
                 rgb="raycast_rgb" if mesh is None else "meshscene_rgb")
    plans = int(state.plan_count) - plans0
    _check(bool(torch.isfinite(row["pos"]).all()) and int(row["panic"][0]) == 0 and plans > 0
           and min(colours) > 20, f"bridge flight ({world}): not sane ({plans} plans adopted, "
                                  f"colours {colours})")
    print(f"bridge flight ({world}): {BRIDGE_FRAMES} frames of fly_diag with the depth and RGB "
          f"images, the telemetry (card and host, equal) and the command (host and card, equal) "
          f"each frame: {frame_ms:.3f} ms per frame; {plans} plans adopted, x = "
          f"{float(row['pos'][0, 0]):.3f} m; colours per image {min(colours)}-{max(colours)}; "
          f"{launches}")
    if mesh is None:
        from agrifly_tpu_torch.render import raycast

        pos, att = (torch.cat(x) for x in zip(*poses))
        rgb_cells(env.params.render_cfg, env.params.scene, pos, raycast.camera_attitude(att),
                  f"the bridge flight's {BRIDGE_FRAMES} poses")
        times = {"fly": [], "fly_diag": []}
        for name in ("fly", "fly_diag", "fly_diag", "fly"):
            g = torch.Generator(device=dev).manual_seed(SEED + 10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, outs = getattr(env, name)(state, TURN_FRAMES, g)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0) / TURN_FRAMES)
            _check(bool(torch.isfinite(outs["pos"]).all()), f"{name} in turns: not finite")
        print("fly and fly_diag in turns from one state (same draws, ms per frame): "
              + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}" for k, v in times.items())
              + f"; ratio {sum(times['fly_diag']) / sum(times['fly']):.4f}")
    return launches


BRIDGE_TICKS = 60  # SimBridge ticks a flight, the mocap estimator on, with and without UWB
BRIDGE_KILL_TICK = 35  # the kill on radio_command1 is published after this tick
TICK_SPLIT_TICKS = 200  # card ticks timed on the host's clock, split by step
BRIDGE_TICK_BLOCK = 7  # run_blocked's ticks a block (a divisor of neither leg)
YPR_BOUND = 2e-6  # rad: the tick's float32 euler angles against the block path's
# (float64 on the host), from the same float32 quaternion
PHASE_FRAMES = 6  # OrchardBridge frames a flight, synced and pipelined, in each world
PIPE_BLOCK = 3  # fly_frames_pipelined's frames a block
TURN_BRIDGE_FRAMES = 3  # frames per turn of fly_diag against the bridge frame
# the paced SimBridge at the reference's rate (a kill in quantum 1), and demo --realtime
# at its defaults, for REALTIME_S seconds of wall time each
SIM_PACED_HZ, SIM_PACED_BLOCK, REALTIME_S = 500.0, 5, 2.0
# benchmarks/verify_realtime500.py's criteria: the achieved tick rate within this share of
# the target, fewer late quanta than this share (and the mocap and telemetry bands)
REALTIME_RATE_BAND, REALTIME_LATE_SHARE = 0.025, 0.05
ORCHARD_PACED_S, ORCHARD_PACED_HZ = 3.0, 2.0
TEL_RANGES = {"accelerometer": (-30.0, 30.0), "rateGyro": (-35.0, 35.0),
              "position": (-30.0, 30.0), "attitude": (-1.0, 1.0), "velocity": (-30.0, 30.0),
              "motorForces": (0.0, 10.0), "debugVals": (-100.0, 100.0),
              "batteryVoltage": (0.0, 15.0)}  # io/telemetry's ranges, by message field
YPR_FIELDS = ("attyaw", "attpitch", "attroll", "attitudeYPR")


def read_bag(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def bag_diff(mine, theirs, bound_of, what):
    """Two recorder bags line by line: the same topics in the same order,
    equal strings, integers and stamps, each other float within
    bound_of(topic, field, ref) (NaN only against NaN). Returns the worst
    float's ratio to its bound (0 where every bound is 0 and met)."""
    import math

    _check(len(mine) == len(theirs), f"{what}: {len(mine)} messages against {len(theirs)}")
    worst = 0.0

    def walk(a, b, path, topic):
        nonlocal worst
        if isinstance(b, dict):
            _check(isinstance(a, dict) and a.keys() == b.keys(), f"{what}: fields at {path}")
            for k in b:
                walk(a[k], b[k], path + (k,), topic)
        elif isinstance(b, list):
            _check(isinstance(a, list) and len(a) == len(b), f"{what}: length at {path}")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,), topic)
        elif not isinstance(b, float) or path[-1] == "stamp":
            _check(type(a) is type(b) and a == b, f"{what}: {path} {a!r} against {b!r}")
        elif math.isnan(b) or math.isnan(a):
            _check(math.isnan(a) and math.isnan(b), f"{what}: {path} {a!r} against {b!r}")
        else:
            name = next(p for p in reversed(path) if isinstance(p, str))
            bound = bound_of(topic, name, b)
            _check(abs(a - b) <= bound, f"{what}: {path} {a!r} against {b!r} (bound {bound:.3g})")
            if bound:
                worst = max(worst, abs(a - b) / bound)

    for i, (a, b) in enumerate(zip(mine, theirs)):
        _check(a["topic"] == b["topic"], f"{what}: message {i} on {a['topic']}, not {b['topic']}")
        walk(a["msg"], b["msg"], (i, a["topic"]), a["topic"])
    return worst


def tick_bound(topic, name, ref):
    """The tick criteria for a SimBridge float against another run's (the
    commanded rates do not appear on its topics); telemetry within one code
    of its field's range."""
    if topic.startswith("telemetry") and name in TEL_RANGES:
        lo, hi = TEL_RANGES[name]
        return (hi - lo) / 65536.0 * (1 + 1e-6)
    return 1e-3 * (abs(ref) + 1e-3)


def _kill_raw():
    import numpy as np

    from agrifly_tpu_torch.io import radio

    return radio.fields_to_bytes(radio.TYPE_EMERGENCY_KILL, 0, np.zeros(radio.NUM_FIELDS,
                                                                         np.int64))


def _hook(rows):
    """A SimBridge draws hook serving the rows of `rows` in order."""
    at = [0]

    def take(n):
        at[0] += n
        return rows[at[0] - n:at[0]]
    return take


def _sim_flight(params, directory, name, how, noise, uwb_draws=None):
    """A SimBridge flight of BRIDGE_TICKS ticks with the mocap estimator on
    the IMU noise `noise` (BRIDGE_TICKS, 2, 3) (and, over a UWB network,
    its draws (BRIDGE_TICKS, 4)), a kill on radio_command1 after
    BRIDGE_KILL_TICK ticks, flown
    by `how`: "tick" (run, then tick), "plain" (tick_plain) or "blocked"
    (run_blocked): its bag, wall seconds, the flight state after each tick
    of the second leg (the final one for the blocked run) and the bridge."""
    import torch

    from agrifly_tpu_torch.io import bridge, messages
    from agrifly_tpu_torch.sim import env

    br = bridge.SimBridge(params, vehicle_id=1, draws=_hook(noise),
                          uwb_draws=None if uwb_draws is None else _hook(uwb_draws))
    cmd = env.hover_command((0.0, 0.0, 1.0), device=params.dt_us.device)
    path = f"{directory}/{name}.jsonl"
    rec = bridge.MessageRecorder(br.bus, path)
    fs = []
    sync = torch.cuda.synchronize if params.dt_us.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for leg, n in enumerate((BRIDGE_KILL_TICK, BRIDGE_TICKS - BRIDGE_KILL_TICK)):
        if leg:
            br.bus.publish("radio_command1", messages.RadioCommand(raw=_kill_raw()))
        if how == "blocked":
            br.run_blocked(n, cmd, block=BRIDGE_TICK_BLOCK)
        elif leg:
            for _ in range(n):
                br.tick(cmd) if how == "tick" else br.tick_plain(cmd)
                fs.append(int(br.state.logic.fs))
        elif how == "tick":
            br.run(n, cmd)
        else:
            for _ in range(n):
                br.tick_plain(cmd)
    sync()
    wall = time.perf_counter() - t0
    rec.close()
    if how == "blocked":
        fs.append(int(br.state.logic.fs))
    _check(br.t_us == BRIDGE_TICKS * int(params.dt_us), f"SimBridge {name}: sim time {br.t_us}")
    return read_bag(path), wall, fs, br


def _dispatch_syncs(fn):
    """The synchronizing CUDA operations fn makes (torch's sync debug
    mode): their count, the python lines that made them, and fn's result."""
    import collections
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                if "called a synchronizing" in str(w.message))
    return sum(sites.values()), dict(sites), out


def _sim_bridge_case(p, directory, label, noise, draws):
    """One SimBridge flight (`_sim_flight`) four ways from the same draws:
    `tick` on the card (one launch of K5's wire-row instance a tick, and
    never env.step), `tick_plain` on the card, `run_blocked` on the card
    (one launch a block) and `tick` on the CPU (its plain version). The
    card's tick against tick_plain bit for bit (the bags, euler angles
    included, and the final states), against the CPU by the tick criteria
    (telemetry within one code), run_blocked against the card's run bit for
    bit but the euler angles (within YPR_BOUND); the kill reaching
    FS_KILLED on the same tick in each. Returns the card's bag, the walls of
    the card's flights, the tick of FS_KILLED, the card-vs-CPU worst float
    and the card tick's final state."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.models import logic
    from agrifly_tpu_torch.sim import cuda_rollout, env

    dev = p.dt_us.device
    on_card = (noise.to(dev), None if draws is None else draws.to(dev))
    steps, step = [0], env.step

    def counted(*args, **kw):
        steps[0] += 1
        return step(*args, **kw)

    env.step = counted
    cuda_rollout.tick_block.launches = 0
    try:
        card, card_s, card_fs, card_br = _sim_flight(p, directory, f"{label}card", "tick",
                                                     *on_card)
    finally:
        env.step = step
    _check(cuda_rollout.tick_block.launches == BRIDGE_TICKS and steps[0] == 0,
           f"SimBridge.tick{label}: {cuda_rollout.tick_block.launches} wire-row launches and "
           f"{steps[0]} env.step calls in {BRIDGE_TICKS} ticks")
    plain, plain_s, plain_fs, plain_br = _sim_flight(p, directory, f"{label}plain", "plain",
                                                     *on_card)
    cuda_rollout.tick_block.launches = 0
    blocked, blocked_s, blocked_fs, _ = _sim_flight(p, directory, f"{label}blocked", "blocked",
                                                    *on_card)
    blocks = sum(-(-n // BRIDGE_TICK_BLOCK) for n in (BRIDGE_KILL_TICK,
                                                      BRIDGE_TICKS - BRIDGE_KILL_TICK))
    _check(cuda_rollout.tick_block.launches == blocks,
           f"run_blocked{label}: {cuda_rollout.tick_block.launches} launches in {blocks} blocks")
    cpu, _, cpu_fs, _ = _sim_flight(to_device(p, "cpu"), directory, f"{label}cpu", "tick", noise,
                                    draws)
    bag_diff(card, plain, lambda topic, name, ref: 0.0,
             f"SimBridge{label} tick against tick_plain on the card")
    for (path, a), (_, b) in zip(convert.leaves(card_br.state), convert.leaves(plain_br.state)):
        _check(torch.equal(a, b), f"SimBridge{label} tick against tick_plain: {'.'.join(path)}")
    worst = bag_diff(card, cpu, tick_bound, f"SimBridge{label} on the card against the CPU")
    bag_diff(blocked, card, lambda topic, name, ref: YPR_BOUND if name in YPR_FIELDS else 0.0,
             f"SimBridge{label} run_blocked against run on the card")
    _check(card_fs == plain_fs == cpu_fs and card_fs[-1] == blocked_fs[-1] == logic.FS_KILLED,
           f"SimBridge{label} kill: card {card_fs[-5:]}, plain {plain_fs[-5:]}, CPU "
           f"{cpu_fs[-5:]}, blocked {blocked_fs}")
    walls = {"run": card_s, "tick_plain": plain_s, "run_blocked": blocked_s}
    return card, walls, BRIDGE_KILL_TICK + 1 + card_fs.index(logic.FS_KILLED), worst, card_br.state


def sim_tick_split(p, hover):
    """SimBridge.tick on the card, TICK_SPLIT_TICKS ticks through `run` from
    a warm bridge: its ticks/s and wire-row launches a tick, and the host's
    µs a tick split into the wrapper (`cuda_rollout.tick_block`), the row's
    copy (its wait on the launch included), the publish, and the rest (the
    radio queue, the cadences, the draws); the synchronizing calls of a
    tick (one, gated) and of a tick that injects a radio command. Returns a
    dict of them."""
    import torch

    from agrifly_tpu_torch.io import bridge, messages
    from agrifly_tpu_torch.sim import cuda_rollout

    br = bridge.SimBridge(p, vehicle_id=2, seed=SEED + 15)
    br.run(10, hover)
    torch.cuda.synchronize()
    cuda_rollout.tick_block.launches = 0
    split = dict.fromkeys(("wrapper", "copy", "publish"), 0.0)
    ended = [0.0]
    tick_block, publish = cuda_rollout.tick_block, br._publish_tick_block

    def timed_block(*args, **kw):
        t = time.perf_counter()
        try:
            return tick_block(*args, **kw)
        finally:
            ended[0] = time.perf_counter()
            split["wrapper"] += ended[0] - t

    def timed_publish(*args, **kw):
        t = time.perf_counter()
        split["copy"] += t - ended[0]
        publish(*args, **kw)
        split["publish"] += time.perf_counter() - t

    timed_block.launches = tick_block.launches  # _launch_rows counts on the module's name
    cuda_rollout.tick_block, br._publish_tick_block = timed_block, timed_publish
    try:
        t0 = time.perf_counter()
        br.run(TICK_SPLIT_TICKS, hover)  # a tick ends on its row's copy: nothing stays queued
        total = time.perf_counter() - t0
    finally:
        tick_block.launches = timed_block.launches
        cuda_rollout.tick_block = tick_block
        del br._publish_tick_block
    out = {"run_hz": TICK_SPLIT_TICKS / total,
           "launches_a_tick": cuda_rollout.tick_block.launches / TICK_SPLIT_TICKS,
           "us": {k: 1e6 * v / TICK_SPLIT_TICKS for k, v in split.items()}}
    out["us"]["rest"] = 1e6 * total / TICK_SPLIT_TICKS - sum(out["us"].values())
    out["syncs"], sites, _ = _dispatch_syncs(lambda: br.tick(hover))
    _check(out["syncs"] == 1, f"SimBridge.tick made {out['syncs']} synchronizing calls: {sites}")
    br.bus.publish(f"radio_command{br.vehicle_id}", messages.RadioCommand(raw=_kill_raw()))
    _check(len(br._pending_radio) == 1, "SimBridge: the radio command was not received")
    out["radio_syncs"], _, _ = _dispatch_syncs(lambda: br.tick(hover))
    _check(not br._pending_radio and out["launches_a_tick"] == 1.0,
           f"SimBridge.tick: {out}")
    return out


def check_sim_bridge(dev, directory):
    """SimBridge (500 Hz topics) on the card: `tick` one launch of K5's
    wire-row instance a tick, held to tick_plain (env.step) on the card bit
    for bit, to the same flight on the CPU (the tick criteria, telemetry
    within one code), run_blocked to run (bit for bit but the euler angles,
    within YPR_BOUND), the kill reaching FS_KILLED on the same tick on each
    (`_sim_bridge_case`), for the mocap env and over a UWB network, which
    ranges; a dispatched block that reads nothing back; the tick's rate,
    its host split and its one synchronizing call (`sim_tick_split`); the
    paced loop with device blocks (gated) and per tick (a reading)."""
    import torch

    from agrifly_tpu_torch.io import bridge, messages
    from agrifly_tpu_torch.models import logic
    from agrifly_tpu_torch.sim import cuda_rollout, env, uwb

    p = env.make_params(noise_scale=1.0, device=dev)
    hover = env.hover_command(device=dev)
    warm = bridge.SimBridge(p, vehicle_id=9)
    warm.run(10, hover)
    warm.run_blocked(10, hover, block=5)
    syncs, sites, pending = _dispatch_syncs(lambda: warm._dispatch_tick_block(
        BRIDGE_TICK_BLOCK, hover))
    warm._publish_tick_block(pending)
    _check(syncs == 0, f"SimBridge._dispatch_tick_block made {syncs} synchronizing CUDA calls: "
                       f"{sites}")
    g = torch.Generator().manual_seed(SEED + 12)
    noise = torch.randn((BRIDGE_TICKS, 2, 3), generator=g)
    card, walls, kill_tick, worst, _ = _sim_bridge_case(p, directory, "", noise, None)
    pu = env.with_uwb_anchors(p, UWB_ANCHOR_IDS, UWB_ANCHOR_POS, noise_std=0.05,
                              comm_period=0.01)
    noise = torch.randn((BRIDGE_TICKS, 2, 3), generator=g)
    u_card, _, u_kill_tick, u_worst, u_state = _sim_bridge_case(
        pu, directory, " over UWB", noise, uwb.draw((BRIDGE_TICKS,), g))
    ranges = int(u_state.logic.uwb_meas_count)
    _check(ranges > 0, "SimBridge over UWB: the network took no range")
    split = sim_tick_split(p, hover)
    card_line_ = card_line()
    print(f"bridge: SimBridge on {card_line_}: {BRIDGE_TICKS} ticks with the mocap estimator, "
          f"{len(card)} messages, a kill after tick {BRIDGE_KILL_TICK} (FS_KILLED at tick "
          f"{kill_tick} on the card, in tick_plain and on the CPU); tick (one K5-rows launch a "
          f"tick, no env.step) publishes what tick_plain publishes on the card, bit for bit, "
          f"euler angles included, and ends in its state; card against CPU worst float "
          f"{worst:.4g} x its bound; run_blocked(block={BRIDGE_TICK_BLOCK}) publishes what run "
          f"publishes (euler angles within {YPR_BOUND} rad), one K5 launch a block; a "
          f"dispatched block made {syncs} synchronizing calls")
    print(f"bridge: SimBridge over UWB ({len(UWB_ANCHOR_IDS)} anchors) on {card_line_}: the "
          f"same flight, {len(u_card)} messages, {ranges} ranges taken (FS_KILLED at tick "
          f"{u_kill_tick}); the same four comparisons held (tick = tick_plain bit for bit; card "
          f"against CPU worst float {u_worst:.4g} x its bound; run_blocked = run but euler)")
    print(f"bridge: SimBridge on {card_line_}: run {split['run_hz']:.1f} ticks/s over "
          f"{TICK_SPLIT_TICKS} ticks ({BRIDGE_TICKS / walls['run']:.1f} in the flight, reading "
          f"the flight state after each tick of its second leg), tick_plain "
          f"{BRIDGE_TICKS / walls['tick_plain']:.1f}, run_blocked "
          f"{BRIDGE_TICKS / walls['run_blocked']:.1f}; K5-rows launches a tick "
          f"{split['launches_a_tick']:.3f}; synchronizing calls a tick {split['syncs']} "
          f"({split['radio_syncs']} on a tick that injects a radio command); host us a tick: "
          + ", ".join(f"{k} {v:.1f}" for k, v in split["us"].items()))

    # the reference's 500 Hz, 5-tick quanta: the kill published in quantum
    # 1 enters the delay line with block 2 and crosses its 30 ms (16 ticks)
    # some four quanta later
    paced = bridge.SimBridge(p, vehicle_id=1, seed=SEED + 13)

    def kill(b, k):
        if k == 1:
            b.bus.publish("radio_command1", messages.RadioCommand(raw=_kill_raw()))

    t0_us = paced.t_us
    cuda_rollout.tick_block.launches = 0
    rep = paced.run_realtime(REALTIME_S, hover, rate_hz=SIM_PACED_HZ, block=SIM_PACED_BLOCK,
                             on_quantum=kill, device_blocks=True)
    quanta = round(REALTIME_S * SIM_PACED_HZ / SIM_PACED_BLOCK)
    ticks = rep["ticks"] + SIM_PACED_BLOCK  # and the warm-up block's
    _check(rep["n_quanta"] == quanta and rep["ticks"] == SIM_PACED_BLOCK * quanta
           and paced.bus.counts["simulator_truth1"] == ticks
           and paced.t_us - t0_us == ticks * int(p.dt_us)
           and cuda_rollout.tick_block.launches == quanta + 1
           and int(paced.state.logic.fs) == logic.FS_KILLED,
           f"SimBridge.run_realtime(device_blocks=True): {rep}, "
           f"{cuda_rollout.tick_block.launches} launches")
    realtime_verdict(rep["achieved_tick_hz"], rep["target_tick_hz"], rep["late_quanta"],
                     rep["n_quanta"], rep["bands_ok"], "SimBridge.run_realtime")
    print(f"bridge: SimBridge.run_realtime(device_blocks=True) on {card_line_}: target "
          f"{SIM_PACED_HZ:.1f} ticks/s, {SIM_PACED_BLOCK} a quantum, {REALTIME_S} s: achieved "
          f"{rep['achieved_tick_hz']:.2f}, {rep['late_quanta']} of {rep['n_quanta']} quanta late "
          f"(max {1e3 * rep['max_late_s']:.2f} ms), topics (Hz) "
          + ", ".join(f"{k} {v:.2f}" for k, v in rep["topic_hz"].items())
          + f", bands {rep['bands_ok']}; verify_realtime500's criteria met; one K5 launch a "
          f"quantum; the kill landed")
    cuda_rollout.tick_block.launches = 0
    rep = bridge.SimBridge(p, vehicle_id=1, seed=SEED + 16).run_realtime(
        REALTIME_S, hover, rate_hz=SIM_PACED_HZ, block=SIM_PACED_BLOCK, device_blocks=False)
    _check(cuda_rollout.tick_block.launches == rep["ticks"] + 10,
           f"SimBridge.run_realtime per tick: {cuda_rollout.tick_block.launches} launches for "
           f"{rep['ticks']} ticks and 10 warm ones")
    print(f"bridge: SimBridge.run_realtime(device_blocks=False) on {card_line_} (a reading, "
          f"ungated): target {SIM_PACED_HZ:.1f} ticks/s, {SIM_PACED_BLOCK} a quantum, "
          f"{REALTIME_S} s: achieved {rep['achieved_tick_hz']:.2f}, {rep['late_quanta']} of "
          f"{rep['n_quanta']} quanta late (max {1e3 * rep['max_late_s']:.2f} ms), bands "
          f"{rep['bands_ok']}; one K5 launch a tick")
    return syncs


def realtime_verdict(achieved, target, late, quanta, bands, what):
    """benchmarks/verify_realtime500.py's four criteria for a paced loop:
    the achieved tick rate within REALTIME_RATE_BAND of the target, fewer
    than REALTIME_LATE_SHARE of its quanta late, the mocap and telemetry
    topics' wall rates in their bands."""
    _check(abs(achieved - target) / target < REALTIME_RATE_BAND,
           f"{what}: {achieved:.2f} ticks/s against {target:.1f}")
    _check(late < REALTIME_LATE_SHARE * quanta, f"{what}: {late} of {quanta} quanta late")
    _check(bands.get("mocap", False) and bands.get("telemetry", False),
           f"{what}: topic bands {bands}")


# The tick block's cases: blocks of n ticks chained in this order, the
# telemetry firing after the listed ticks (the first tick, the last, both,
# and the bridge's every-fifth schedule, which ends on the last), in each
# estimator mode, from a cold state and from one TICK_BLOCK_MID_TICKS into a
# hover; and the onboard-UWB build from cold.
TICK_BLOCKS = ((1, (0,)), (5, (4,)), (7, (0, 6)), (40, tuple(range(4, 40, 5))),
               (250, tuple(range(4, 250, 5))))
TICK_BLOCK_MODES = (("true", False), ("mocap", True), ("gpsimu", "gpsimu"))
TICK_BLOCK_MID_TICKS = 613
TICK_BLOCK_EAGER = 3  # blocks of each cold chain also held against the eager plain version
TICK_BLOCK_TIMED = (1, 5, 40, 250)  # block sizes K5's wire-row instance is timed at (mocap)
TICK_BLOCK_HOST_CALLS = 200  # tick_block calls timed on the host's clock, each way
# float operations a wire row adds to its tick (the body-frame velocity, the
# row's conversions) and a fire tick's encode (28 codes of ~6 each)
WIRE_ROW_OPS, TEL_ENCODE_OPS = 20, 170


def tick_chain_masks(dev):
    """The concatenated TICK_BLOCKS' telemetry masks (int8 on dev) and each
    block's first tick."""
    import torch

    total = sum(n for n, _ in TICK_BLOCKS)
    fire = torch.zeros(total, dtype=torch.int8)
    starts, k0 = [], 0
    for n, fires in TICK_BLOCKS:
        fire[[k0 + f for f in fires]] = 1
        starts.append(k0)
        k0 += n
    return fire.to(dev), starts


def tick_chain_equal(p, start, cmd, noise, fire, starts, mode, ctrl, draws, what):
    """TICK_BLOCKS from `start` (one env, or a fleet whose noise and draws
    carry its leading B) through tick_block (one launch each) against
    tick_block_plain's ticks as one chain, its eager step
    (cuda_rollout.wire_tick) replayed as a CUDA graph (graphed_steps): every block's rows and the final state bit for
    bit. Returns the kernel's final state and its launches."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_rollout

    s, rows = start, []
    before = cuda_rollout.tick_block.launches
    for (n, _), k0 in zip(TICK_BLOCKS, starts):
        s, r = cuda_rollout.tick_block(
            p, s, cmd, noise[..., k0:k0 + n, :, :], fire[k0:k0 + n], mode, ctrl,
            uwb_draws=None if draws is None else draws[..., k0:k0 + n, :])
        rows.append(r)
    launches = cuda_rollout.tick_block.launches - before
    ref, ref_rows = graphed_steps(
        lambda st, nz, f, d: cuda_rollout.wire_tick(p, st, cmd, nz, f, mode, ctrl, d), start,
        lambda k: (noise[..., k, :, :], fire[k], None if draws is None else draws[..., k, :]),
        fire.shape[0])
    ref_rows = torch.stack(ref_rows, dim=-2)
    torch.cuda.synchronize()
    for (n, _), k0, r in zip(TICK_BLOCKS, starts, rows):
        _check(r.shape == ref_rows.shape[:-2] + (n, cuda_rollout.ROW_WORDS)
               and torch.equal(r, ref_rows[..., k0:k0 + n, :]),
               f"tick_block {what}: the {n}-tick block's rows differ from the plain version's")
    for (path, a), (_, b) in zip(convert.leaves(s), convert.leaves(ref)):
        _check(torch.equal(a, b), f"tick_block {what}: {'.'.join(path)} differs after the blocks")
    return s, launches


def tick_block_host_us(p, s, cmd, noise, fire, mode):
    """The host's µs a tick_block call (no sync inside the loop): chained
    (each call takes the tree the last returned, which the wrapper accepts
    again without the full leaf check), and the same with the full check
    forced (the accepted trees dropped before each call)."""
    import torch

    from agrifly_tpu_torch.sim import cuda_rollout

    def chain(forced):
        state = s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TICK_BLOCK_HOST_CALLS):
            if forced:
                cuda_rollout._accepted.pop("own", None)
                cuda_rollout._accepted.pop("state", None)
            state = cuda_rollout.tick_block(p, state, cmd, noise, fire, mode)[0]
        us = 1e6 * (time.perf_counter() - t0) / TICK_BLOCK_HOST_CALLS
        torch.cuda.synchronize()
        return us

    chain(False)  # warm-up
    return {"chained": chain(False), "full check": chain(True)}


def check_tick_block(dev):
    """K5's wire-row instance (cuda_rollout.tick_block, the topic bridge's
    block of ticks) on the card: TICK_BLOCKS chained through it against
    tick_block_plain, bit for bit (every block's rows and the final state),
    in every estimator mode from a cold and a mid-flight state and in the
    TICK_UWB build; the first TICK_BLOCK_EAGER blocks of each cold chain
    also against the eager plain version. Then its device µs at
    TICK_BLOCK_TIMED ticks (mocap, the bridge's mode; at 1 tick, SimBridge.tick's
    launch, also in the TICK_UWB build with anchors), the wrapper's ms, the
    eager plain version's ms and the bound at 5 ticks (a 10 ms quantum of
    the 500 Hz loop), and the host's µs a call (tick_block_host_us).
    Returns the kernel's line at 5 ticks."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_rollout, env, uwb

    t_phase = time.perf_counter()
    p = env.make_params(noise_scale=1.0, device=dev)
    cmd = env.hover_command(device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    fire, starts = tick_chain_masks(dev)
    total = fire.shape[0]
    cold = env.init_state(p)
    launches = 0
    mids = {}
    for name, mode in TICK_BLOCK_MODES:
        mids[name] = cuda_rollout.rollout(p, cold, cmd, torch.randn(
            (TICK_BLOCK_MID_TICKS, 2, 3), generator=gen, device=dev), mode)[0]
        for label, start in (("cold", cold), ("mid-flight", mids[name])):
            noise = torch.randn((total, 2, 3), generator=gen, device=dev)
            if label == "cold":  # the first blocks against the eager plain version too
                s_k = s_p = start
                for (n, _), k0 in list(zip(TICK_BLOCKS, starts))[:TICK_BLOCK_EAGER]:
                    s_k, r_k = cuda_rollout.tick_block(p, s_k, cmd, noise[k0:k0 + n],
                                                       fire[k0:k0 + n], mode)
                    s_p, r_p = cuda_rollout.tick_block_plain(p, s_p, cmd, noise[k0:k0 + n],
                                                             fire[k0:k0 + n], mode)
                    _check(torch.equal(r_k, r_p) and all(
                        torch.equal(a, b) for (_, a), (_, b) in zip(convert.leaves(s_k),
                                                                    convert.leaves(s_p))),
                           f"tick_block {name}: the {n}-tick block differs from the eager "
                           f"plain version")
                launches += TICK_BLOCK_EAGER
            end, n_launch = tick_chain_equal(p, start, cmd, noise, fire, starts, mode, "rates",
                                             None, f"{name}, {label}")
            launches += n_launch
            _check(bool(torch.isfinite(end.plant.pos).all()) and int(end.logic.panic_reason) == 0,
                   f"tick_block {name}, {label}: non-finite, or a panic")
    # the UWB build as a fleet of one: the plain tick's anchor lookup indexes
    # by a 0-d tensor (a read-back) where it is not vmapped, which a graph
    # cannot capture
    pu = env.with_uwb_anchors(p, UWB_ANCHOR_IDS, UWB_ANCHOR_POS, noise_std=0.05, comm_period=0.01)
    noise = torch.randn((1, total, 2, 3), generator=gen, device=dev)
    end, n_launch = tick_chain_equal(pu, env.init_state_fleet(pu, torch.zeros((1, 3), device=dev)),
                                     env.hover_command(ENV_MODES["uwb"]["hover"], device=dev),
                                     noise, fire, starts, False, "position",
                                     uwb.draw((1, total), gen, dev), "UWB build, position")
    launches += n_launch
    _check(int(end.logic.uwb_meas_count.sum()) > 0, "tick_block UWB: no range was taken")
    _check(launches == (2 * len(TICK_BLOCKS) + TICK_BLOCK_EAGER) * len(TICK_BLOCK_MODES)
           + len(TICK_BLOCKS), f"tick_block: {launches} launches")
    print(f"tick_block on {card_line()}: K5's wire-row instance bit-equal to tick_block_plain "
          f"(rows and every state leaf) in blocks of {', '.join(str(n) for n, _ in TICK_BLOCKS)} "
          f"ticks chained, the telemetry firing on a block's first tick, its last, both and every "
          f"fifth; {', '.join(n for n, _ in TICK_BLOCK_MODES)}, from cold and from "
          f"{TICK_BLOCK_MID_TICKS} ticks into a hover (the first {TICK_BLOCK_EAGER} blocks from "
          f"cold also against the eager plain version); the TICK_UWB build with anchors (a fleet "
          f"of one); one launch a block ({launches})")

    mid = mids["mocap"]
    s_entry, p_entry = cuda_rollout._accept_env(p, mid, dev, None, False)
    cmd_rows = cuda_rollout._command(cmd, None, dev)
    dev_us = {}
    for n in TICK_BLOCK_TIMED:
        nz = torch.randn((1, n, 2, 3), generator=gen, device=dev)
        f = fire[starts[-1]:starts[-1] + n]
        dev_us[n] = device_us(lambda: cuda_rollout._launch_rows(s_entry, p_entry, cmd_rows, nz,
                                                                True, "rates", f), reps=5)
    su, spu = cuda_rollout._accept_env(pu, env.init_state(pu), dev, None, True)
    nz = torch.randn((1, 1, 2, 3), generator=gen, device=dev)
    d1 = uwb.draw((1, 1), gen, dev)
    uwb_us = device_us(lambda: cuda_rollout._launch_rows(su, spu, cmd_rows, nz, True, "rates",
                                                         fire[starts[-1]:starts[-1] + 1],
                                                         draws=d1, uwb=True), reps=5)
    n = SIM_PACED_BLOCK
    nz = torch.randn((n, 2, 3), generator=gen, device=dev)
    f = fire[starts[1]:starts[1] + n]
    w_ms = cuda_ms(lambda: cuda_rollout.tick_block(p, mid, cmd, nz, f, True), reps=10, warmup=2)
    cuda_rollout.tick_block_plain(p, mid, cmd, nz, f, True)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        cuda_rollout.tick_block_plain(p, mid, cmd, nz, f, True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / 2
    host = tick_block_host_us(p, mid, cmd, nz, f, True)
    new, rows = cuda_rollout._launch_rows(s_entry, p_entry, cmd_rows, nz[None], True, "rates",
                                          f)
    n_bytes = (env_bytes(convert.flatten_tensors(mid)[0], cuda_rollout.param_leaves(p),
                         cmd_rows[0], nz, new, []) + nbytes(f, rows))
    n_ops = n * (ENV_TICK_OPS[True] + WIRE_ROW_OPS) + int(f.sum()) * TEL_ENCODE_OPS
    r = result(0.0, 1e-3 * dev_us[n], plain_ms, n_bytes, n_ops)
    print(f"tick_block on {card_line()}: device (bare launch, mocap, G="
          f"{cuda_rollout.TICK_BLOCK_GROUP}) " + ", ".join(f"{k} ticks {us_text(v)}"
                                                            for k, v in dev_us.items())
          + f", the TICK_UWB build 1 tick {us_text(uwb_us)}; at {n} ticks: wrapper {w_ms:.4f} ms (CUDA events), plain (eager, on the card) "
          f"{plain_ms:.3f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}); host us a call: "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return r


class _PlannerInputs:
    """Records the depth codes each frame's _frame_percept renders (the
    planner's input) by wrapping the world's render_depth_batch; the
    wrapper keeps the render counter of cuda_raycast's."""

    def __init__(self, mesh):
        from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast
        from agrifly_tpu_torch.sim import orchard_env

        self.mod = cuda_raycast if mesh is None else cuda_meshscene
        self.oe = orchard_env
        self.codes, self.inside = [], False

    def __enter__(self):
        render, percept = self.mod.render_depth_batch, self.oe._frame_percept

        def recording(*args, **kw):
            out = render(*args, **kw)
            if self.inside:
                self.codes.append(out[0].clone())
            return out

        def marked(*args, **kw):
            self.inside = True
            try:
                return percept(*args, **kw)
            finally:
                self.inside = False

        if hasattr(render, "launches"):
            recording.launches = render.launches
        self.saved = (render, percept)
        self.mod.render_depth_batch, self.oe._frame_percept = recording, marked
        return self

    def __exit__(self, *exc):
        render, percept = self.saved
        if hasattr(render, "launches"):
            render.launches = self.mod.render_depth_batch.launches
        self.mod.render_depth_batch, self.oe._frame_percept = render, percept


def _orchard_flight(p, state, directory, name, pipelined, mesh):
    """One OrchardBridge flight of PHASE_FRAMES frames from `state` in blocks
    of PIPE_BLOCK (synced: fly_frames_block per block; or pipelined), images
    and wire recorded: (bag bytes, ms a frame, launches, depth messages, the
    planner's inputs, the bridge). A block publishes its images before its
    rows, so the two flights' bags compare at the same block size."""
    import torch

    from agrifly_tpu_torch.io import bridge

    ob = bridge.OrchardBridge(p, vehicle_id=1, seed=SEED + 14)
    ob.state = state
    depth = []
    ob.bus.subscribe("depthImage1", depth.append)
    path = f"{directory}/{name}.jsonl"
    rec = bridge.MessageRecorder(ob.bus, path, record_images=True)
    with _PlannerInputs(mesh) as inputs:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if pipelined:
            _check(ob.fly_frames_pipelined(PHASE_FRAMES, PIPE_BLOCK) == PHASE_FRAMES,
                   f"{name}: frames")
        else:
            ob.fly_frames(PHASE_FRAMES, block=PIPE_BLOCK)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / PHASE_FRAMES
        launches = read_counts()
    rec.close()
    with open(path, "rb") as f:
        bag = f.read()
    return bag, ms, launches, depth, inputs.codes, ob


def check_orchard_bridge(dev, state, directory, mesh=None):
    """OrchardBridge at 640x480 with 256 candidates, one vehicle, from the
    single flight's state, in the procedural orchard or the imported world
    `mesh`: PHASE_FRAMES frames synced and pipelined, from the same draws,
    give byte-equal bags (images included); every depth image is the
    millimetre image of its frame's own render, bit for bit; per frame the
    depth kernel runs twice, the inflation once per planner round, the tick
    kernel once and the RGB kernel once; a dispatched frame makes no
    synchronizing call. Returns the synced flight's launches and the two
    times a frame."""
    import numpy as np

    from agrifly_tpu_torch.io import bridge
    from agrifly_tpu_torch.sim import orchard_env

    world = "procedural" if mesh is None else "imported"
    p = orchard_env.make_params(start_flight_time=1.0, mesh_scene=mesh, device=dev)
    runs = {name: _orchard_flight(p, state, directory, f"{world}_{name}", name == "pipelined",
                                  mesh) for name in ("synced", "pipelined")}
    _check(runs["synced"][0] == runs["pipelined"][0],
           f"OrchardBridge ({world}): the pipelined bag differs from the synced one")
    depth_kernel = "raycast" if mesh is None else "meshscene_strips"
    rgb_kernel = "raycast_rgb" if mesh is None else "meshscene_rgb"
    scale = float(p.planner.cam.depth_scale)
    for name, (_, _, launches, depth, codes, ob) in runs.items():
        check_counts(launches, PHASE_FRAMES, True, p.planner_rounds + 1, depth_kernel, renders=2,
                     rgb=rgb_kernel)
        _check(len(depth) == len(codes) == PHASE_FRAMES, f"OrchardBridge {name}: images")
        for m in depth:
            want = bridge.depth_to_mm16(codes[m.header.seq].cpu().numpy(), scale)
            _check(np.array_equal(np.frombuffer(m.data, "<u2").reshape(want.shape), want),
                   f"OrchardBridge ({world}, {name}): depth image {m.header.seq} is not its "
                   f"frame's render")
        outs = ob.last_outs
        _check(bool(np.isfinite(outs["pos"]).all()) and int(outs["panic"][-1]) == 0,
               f"OrchardBridge ({world}, {name}): not sane")
    synced, pipelined = runs["synced"], runs["pipelined"]
    probe = bridge.OrchardBridge(p, vehicle_id=2, seed=SEED + 17)
    probe.state = state
    probe.fly_frames_block(1)
    syncs, sites, pending = _dispatch_syncs(lambda: probe._dispatch_block(1))
    probe._publish_block(pending)
    _check(syncs == 0, f"OrchardBridge._dispatch_block ({world}) made {syncs} synchronizing "
                       f"CUDA calls: {sites}")
    print(f"bridge: OrchardBridge ({world}, {p.render_cfg.width}x{p.render_cfg.height}, "
          f"{p.n_candidates} candidates) on "
          f"{card_line()}: fly_frames_block({PIPE_BLOCK}) {synced[1]:.3f} ms a frame, "
          f"fly_frames_pipelined({PHASE_FRAMES}, {PIPE_BLOCK}) {pipelined[1]:.3f} ms a frame; "
          f"bags byte-equal ({len(synced[0])} bytes, images included); every depth image its "
          f"frame's render; launches a frame {depth_kernel} 2, inflation "
          f"{p.planner_rounds + 1}, frame_ticks 1, {rgb_kernel} 1; plans adopted "
          f"{int(synced[5].last_outs['plan_count'][-1]) - int(state.plan_count)}; a dispatched "
          f"frame made {syncs} synchronizing calls")
    return synced[2], synced[1], pipelined[1]


def orchard_turns(dev, state):
    """fly_diag against the bridge frame (fly_diag with the depth and RGB
    images, the wire and the diagnostics published), from one state with
    the same draws, in turns."""
    import torch

    from agrifly_tpu_torch.io import bridge
    from agrifly_tpu_torch.sim import orchard_env

    p = orchard_env.make_params(start_flight_time=1.0, device=dev)
    times = {"fly_diag": [], "bridge": []}
    for name in ("fly_diag", "bridge", "bridge", "fly_diag"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "fly_diag":
            orchard_env.fly_diag(p, state, TURN_BRIDGE_FRAMES,
                                 torch.Generator(device=dev).manual_seed(SEED + 15))
        else:
            ob = bridge.OrchardBridge(p, vehicle_id=1, seed=SEED + 15)
            ob.state = state
            ob.fly_frames_block(TURN_BRIDGE_FRAMES)
        torch.cuda.synchronize()
        times[name].append(1e3 * (time.perf_counter() - t0) / TURN_BRIDGE_FRAMES)
    print(f"bridge: fly_diag and the bridge frame in turns on {card_line()} (ms a frame): "
          + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}" for k, v in times.items())
          + f"; fly_diag / bridge frame {sum(times['fly_diag']) / sum(times['bridge']):.4f}")


def orchard_paced(dev, state):
    """OrchardBridge.run_realtime at ORCHARD_PACED_HZ frames a second of wall
    time (images off), a kill published in quantum 2: one frame a quantum,
    sim time one frame a quantum, the kill lands; rates and lateness are a
    reading."""
    from agrifly_tpu_torch.io import bridge, messages
    from agrifly_tpu_torch.models import logic
    from agrifly_tpu_torch.sim import orchard_env

    p = orchard_env.make_params(start_flight_time=1.0, device=dev)
    ob = bridge.OrchardBridge(p, vehicle_id=1, seed=SEED + 16, publish_images=False)
    ob.state = state
    steps = []

    def on_quantum(b, k):
        steps.append(int(b.last_outs["step"][-1]))
        if k == 2:
            b.bus.publish("radio_command1", messages.RadioCommand(raw=_kill_raw()))

    rep = ob.run_realtime(ORCHARD_PACED_S, rate_hz=ORCHARD_PACED_HZ, on_quantum=on_quantum)
    spf = p.steps_per_frame
    _check(rep["frames"] == rep["n_quanta"]
           and [s - steps[0] for s in steps] == [spf * i for i in range(len(steps))]
           and int(ob.last_outs["flight_state"][-1]) == logic.FS_KILLED,
           f"OrchardBridge.run_realtime: {rep}, steps {steps}")
    print(f"bridge: OrchardBridge.run_realtime on {card_line()}: target {ORCHARD_PACED_HZ} "
          f"frames/s, achieved {rep['achieved_frame_hz']:.3f}, {rep['late_quanta']} of "
          f"{rep['n_quanta']} quanta late (max {1e3 * rep['max_late_s']:.1f} ms), bands "
          f"{rep['bands_ok']} (a reading); one frame a quantum, the kill landed")


def check_bridge(dev, state):
    """The port's topic bridge on the card (io/bridge): SimBridge
    (check_sim_bridge), OrchardBridge in both worlds
    (check_orchard_bridge), fly_diag against the bridge frame in turns,
    and the paced orchard loop. Returns the procedural and the imported
    synced flights' launches."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        check_sim_bridge(dev, directory)
        procedural = check_orchard_bridge(dev, state, directory)[0]
        imported = check_orchard_bridge(dev, state, directory, baked_orchard(dev))[0]
    orchard_turns(dev, state)
    orchard_paced(dev, state)
    print(f"bridge phase: {time.perf_counter() - t0:.1f} s")
    return procedural, imported


ENTRY_FRAMES = 62  # the demo's default path: two 31-frame blocks
ENTRY_FLEET, ENTRY_FLEET_FRAMES = 16, 31
ENTRY_RESUME_FRAMES = 3  # frames flown from the checkpoint and from the saved state
ENTRY_SAME_FRAMES = 10  # frames flown through fly on the demo's params, after the demo
ENTRY_TELEOP = "scripted:0.1:buttonStart,0.5:buttonRed"
ENTRY_TELEOP_FRAMES = 40  # the kill lands near frame 16; the loop stops once it reads it
ENTRY_RECORD_FRAMES = 8
ENTRY_LAUNCH_FRAMES = 40
ENTRY_ORCHARD_QUANTA = 20  # frames of the paced orchard loop (the same band)
ENTRY_TOPICS = ("simulator_truth1", "planner_diagnostics1", "controller_diagnostics1",
                "mocap_output1", "telemetry1", "radio_command1")


def _entry(label, fn, argv, prefix="entry"):
    """One entry point in this process: fn(argv) with its standard output
    captured; prints its lines with the `entry:` prefix (or `prefix`) and
    returns (its result, its output)."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        print(f"{prefix}:   {line}")
    rc = res if isinstance(res, int) else res.rc
    _check(rc == 0, f"{label}: rc {rc}")
    print(f"{prefix}: {label}: rc 0 in {seconds:.1f} s")
    return res, text


def _ms_per_frame(text, label):
    import re

    found = re.search(r"\(([0-9.]+) ms/frame\)", text)
    _check(found is not None, f"{label}: no steady-state ms/frame line")
    return float(found.group(1))


def _same_tree(a, b):
    """The leaves of two state trees equal bit for bit."""
    import torch

    from agrifly_tpu_torch import convert

    la, lb = convert.flatten_tensors(a)[0], convert.flatten_tensors(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _entry_scene(dev, directory):
    """demo --scene-file (mixed_scene's primitives file) with --rgb, --csv
    and --ckpt: K4 on every frame, K4-rgb for the PPM; the PPM is the RGB
    kernel's image from the final state, the CSV one row a frame of the
    block re-flown for it, and the checkpoint resumes bit for bit."""
    import numpy as np
    import torch

    from agrifly_tpu_torch import demo
    from agrifly_tpu_torch.sim import orchard_env
    from agrifly_tpu_torch.utils import checkpoint, simlog

    mixed_scene(dev, directory)
    ppm, csv, ckpt = (f"{directory}/final.ppm", f"{directory}/flight.csv",
                      f"{directory}/final.pt")
    reset_counts()
    flight, _ = _entry("demo --scene-file --rgb --csv --ckpt", lambda a: demo.run(
        demo.parse_args(a)), ["--frames", str(demo.FRAMES_PER_BLOCK), "--scene-file",
                              f"{directory}/scene.txt", "--rgb", ppm, "--csv", csv,
                              "--ckpt", ckpt])
    launches = read_counts()
    frames = 2 * demo.FRAMES_PER_BLOCK  # the flight and the block re-flown for the CSV
    _check(launches["meshscene_rgb"] == 1, f"K4-rgb launched {launches['meshscene_rgb']} times "
                                           f"for one PPM")
    check_counts(dict(launches, meshscene_rgb=0), frames, True,
                 flight.params.planner_rounds + 1, "meshscene_strips")
    with open(ppm, "rb") as f:
        data = f.read()
    gen = torch.Generator(device=dev)
    restored = checkpoint.restore(ckpt, flight.state, gen)
    image = demo.final_rgb(flight.params, restored).cpu().numpy()
    header = f"P6\n{image.shape[1]} {image.shape[0]}\n255\n".encode()
    _check(data[:len(header)] == header and data[len(header):] == image.tobytes(),
           "the PPM is not the RGB kernel's image from the final state")
    with open(csv) as f:
        lines = f.read().splitlines()
    _check(lines[0] == simlog.HEADER and len(lines) == 1 + demo.FRAMES_PER_BLOCK
           and all(len(r.split(",")) == len(simlog.HEADER.split(",")) for r in lines[1:]),
           f"the CSV has {len(lines) - 1} rows under {lines[0][:40]}...")
    rows = np.array([[float(x) for x in r.split(",")] for r in lines[1:]])
    _check(bool(np.isfinite(rows).all()), "non-finite CSV values")
    _check(_same_tree(restored, flight.state), "the restored state differs from the saved one")
    saved_gen = torch.Generator(device=dev)
    saved_gen.set_state(flight.gen.get_state())
    a, outs_a = orchard_env.fly(flight.params, flight.state, ENTRY_RESUME_FRAMES, saved_gen)
    b, outs_b = orchard_env.fly(flight.params, restored, ENTRY_RESUME_FRAMES, gen)
    _check(_same_tree(a, b) and all(torch.equal(outs_a[k], outs_b[k]) for k in outs_a),
           "the flight from the checkpoint differs from the flight from the saved state")
    pos = outs_b["pos"].cpu().numpy()
    _check(np.allclose(rows[:len(pos), 1:4], pos, rtol=0, atol=1e-6),
           "the CSV's first rows are not the frames flown from the checkpoint")
    print(f"entry: demo --scene-file: {launches}; the PPM is K4-rgb's image of the final "
          f"state, the CSV {demo.FRAMES_PER_BLOCK} rows, {ENTRY_RESUME_FRAMES} frames from the "
          f"checkpoint equal to the same frames from the saved state, bit for bit")


def demo_realtime():
    """`demo --realtime` at its defaults (500 Hz, 5-tick quanta, each one
    launch of K5's wire-row instance) for REALTIME_S, held to
    verify_realtime500.py's four criteria. Returns the wire-row instance's
    launches in the run (counted from 0)."""
    import re

    from agrifly_tpu_torch import demo
    from agrifly_tpu_torch.sim import cuda_rollout

    cuda_rollout.tick_block.launches = 0
    _, text = _entry("demo --realtime", demo.main, ["--realtime", "--duration", f"{REALTIME_S}"])
    launches = cuda_rollout.tick_block.launches
    found = re.search(r"achieved ([0-9.]+) Hz \(target ([0-9.]+)\), late (\d+)/(\d+) quanta",
                      text)
    _check(found is not None and "bands OK" in text, "demo --realtime: no verdict line")
    achieved, target = float(found.group(1)), float(found.group(2))
    late, quanta = int(found.group(3)), int(found.group(4))
    realtime_verdict(achieved, target, late, quanta, {"mocap": True, "telemetry": True},
                     "demo --realtime")
    _check(target == SIM_PACED_HZ and launches == quanta + 1,
           f"demo --realtime: target {target}, {launches} launches in {quanta} quanta")
    print(f"entry: demo --realtime on {card_line()} at its defaults for {REALTIME_S} s: "
          + " ".join(line for line in text.splitlines() if line.startswith("achieved"))
          + f"; verify_realtime500's criteria met; K5's wire-row instance {launches} launches "
          f"({quanta} quanta and the warm-up block)")
    return launches


def _bridge_quantum_ms(dev, quanta=5):
    """Host ms a frame of --realtime-orchard's loop unpaced: quanta of
    demo.ORCHARD_QUANTUM frames through an OrchardBridge that publishes
    no images, as the loop's are, after one warm-up quantum."""
    import torch

    from agrifly_tpu_torch import demo
    from agrifly_tpu_torch.io import bridge
    from agrifly_tpu_torch.sim import orchard_env

    ob = bridge.OrchardBridge(orchard_env.make_params(device=dev), vehicle_id=1, seed=SEED,
                              publish_images=False)
    ob.fly_frames_block(demo.ORCHARD_QUANTUM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(quanta):
        ob.fly_frames_block(demo.ORCHARD_QUANTUM)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (quanta * demo.ORCHARD_QUANTUM)


def _entry_paced(dev, directory, frame_ms):
    """demo --realtime at its defaults (demo_realtime), and
    --realtime-orchard at its default rate, the reference's real time
    (500 ticks/s: 31.25 frames/s) (rc 0: the wire bands held), with the
    loop's unpaced frame (`_bridge_quantum_ms`) beside the demo's as a
    reading. Returns the wire-row instance's launches in the demo
    --realtime run."""
    from agrifly_tpu_torch import demo
    from agrifly_tpu_torch.sim import orchard_env

    launches = demo_realtime()
    loop_ms = _bridge_quantum_ms(dev)
    frame_hz = SIM_PACED_HZ / orchard_env.make_params(device=dev).steps_per_frame
    _, text = _entry("demo --realtime-orchard", demo.main, [
        "--realtime-orchard", "--duration", f"{ENTRY_ORCHARD_QUANTA / frame_hz:.4f}"])
    print(f"entry: demo --realtime-orchard on {card_line()} at its default {frame_hz:.3f} "
          f"frames/s: the demo's {frame_ms:.3f} ms a frame, the loop's unpaced "
          f"{loop_ms:.3f} ms: "
          + " ".join(line for line in text.splitlines() if line.startswith("achieved")))
    return launches


def check_entry_points(dev, fly_ms):
    """The port's front doors at 640x480 / 256 candidates, in this process
    (`demo.main` / `demo.run`, `launch.main`): the default path, a fleet,
    an imported world with --rgb / --csv / --ckpt, the teleop arm and kill,
    the recorder, the launcher with an operator and a bag, and the paced
    loops. Each run's kernel counts are set to 0 just before it and read
    just after. fly_ms: `fly`'s ms a frame in this call, for the ratio.
    Returns the `--fleet` run's (output, Flight), which `check_mesh`
    holds `demo --mesh` against, and the launches of K5's wire-row
    instance in the `--realtime` run."""
    import base64
    import tempfile

    import torch

    from agrifly_tpu_torch import demo, launch
    from agrifly_tpu_torch.sim import orchard_env

    t0 = time.perf_counter()
    card = card_line()
    with tempfile.TemporaryDirectory() as directory:
        reset_counts()
        flight, text = _entry("demo", lambda a: demo.run(demo.parse_args(a)),
                              ["--frames", str(ENTRY_FRAMES)])
        launches = read_counts()
        check_counts(launches, ENTRY_FRAMES, True, 3)
        _check(sum(line.startswith("t=") for line in text.splitlines()) >= 1
               and "flew " in text, "demo: no status lines")
        frame_ms = _ms_per_frame(text, "demo")
        # ENTRY_SAME_FRAMES frames through orchard_env.fly alone, on the
        # demo's params and from its final state: the demo loop's own cost,
        # apart from the configuration's (the demo plans from 5 s, `fly`
        # above from 1 s)
        torch.cuda.synchronize()
        t_fly = time.perf_counter()
        orchard_env.fly(flight.params, flight.state, ENTRY_SAME_FRAMES, flight.gen)
        torch.cuda.synchronize()
        same_ms = 1e3 * (time.perf_counter() - t_fly) / ENTRY_SAME_FRAMES
        print(f"entry: demo on {card}: {frame_ms:.3f} ms a frame in steady state "
              f"({frame_ms / fly_ms:.4f} x fly's {fly_ms:.3f}; {ENTRY_SAME_FRAMES} frames through "
              f"fly on the demo's params after it: {same_ms:.3f} ms, {frame_ms / same_ms:.4f} x); "
              f"{launches}")

        reset_counts()
        fleet_flight, fleet_text = _entry("demo --fleet", lambda a: demo.run(demo.parse_args(a)), [
            "--fleet", str(ENTRY_FLEET), "--frames", str(ENTRY_FLEET_FRAMES)])
        launches = read_counts()
        check_counts(launches, ENTRY_FLEET_FRAMES, True, 3)
        _check(launches["inflate"] > 0, f"the fleet's inflation never took K2: {launches}")
        print(f"entry: demo --fleet {ENTRY_FLEET} on {card}: {launches}")

        _entry_scene(dev, directory)

        reset_counts()
        _, text = _entry("demo --teleop", demo.main, [
            "--frames", str(ENTRY_TELEOP_FRAMES), "--teleop", ENTRY_TELEOP])
        marks = [text.find(m) for m in ("ARMED", "KILL —", "KILLED_EXTERNALLY", "vehicle KILLED")]
        _check(-1 not in marks and marks == sorted(marks),
               f"demo --teleop: armed, killed, KILLED in that order: {marks}")
        frames = read_counts()["frame_ticks"]
        print(f"entry: demo --teleop: ARMED, KILL, then vehicle KILLED after {frames} frames "
              f"({demo.TELEOP_BLOCK['cuda']} a block)")

        bag = f"{directory}/demo_bag.jsonl"
        reset_counts()
        _entry("demo --record", demo.main, ["--frames", str(ENTRY_RECORD_FRAMES), "--record", bag])
        launches = read_counts()
        check_counts(launches, ENTRY_RECORD_FRAMES, True, 3)
        lines = read_bag(bag)
        topics = sorted({line["topic"] for line in lines})
        _check(topics == sorted(ENTRY_TOPICS)
               and sum(line["topic"] == "simulator_truth1" for line in lines) == ENTRY_RECORD_FRAMES,
               f"demo --record: topics {topics}")
        print(f"entry: demo --record: {len(lines)} messages on {topics}")

        bag = f"{directory}/launch_bag.jsonl"
        reset_counts()
        t_launch = time.perf_counter()
        _entry("launch", launch.main, ["--frames", str(ENTRY_LAUNCH_FRAMES), "--record", bag,
                                       "--teleop", ENTRY_TELEOP])
        launch_s = time.perf_counter() - t_launch
        launches = read_counts()
        lines = read_bag(bag)
        topics = {line["topic"] for line in lines}
        kill = base64.b64encode(_kill_raw()).decode("ascii")
        kills = sum(line["topic"] == "radio_command1" and line["msg"]["raw"] == kill
                    for line in lines)
        flown = sum(line["topic"] == "simulator_truth1" for line in lines)
        for t in ("simulator_truth1", "planner_diagnostics1", "controller_diagnostics1",
                  "imageReceivedFlag1", "radio_command1"):
            _check(t in topics, f"launch: {t} not in the bag: {sorted(topics)}")
        _check("depthImage1" not in topics and kills == 1,
               f"launch: depthImage1 in the bag or {kills} kills")
        check_counts(launches, flown, True, 3, renders=2, rgb="raycast_rgb")
        print(f"entry: launch on {card}: {flown} frames, {1e3 * launch_s / flown:.3f} ms a frame "
              f"(set-up included), the kill once in {len(lines)} messages; {launches}")

        realtime_launches = _entry_paced(dev, directory, frame_ms)
    print(f"entry points phase: {time.perf_counter() - t0:.1f} s")
    return (fleet_text, fleet_flight), realtime_launches


# The multi-device path (agrifly_tpu_torch/parallel): a world of one over
# NCCL on this card; the JAX dry run's sizes for parallel.dryrun.
PAR_ENVS, PAR_SUBSTEPS = 4096, 50  # the fleet step, both estimator modes
PAR_CANDIDATES, PAR_CAPACITY = 1024, 32  # the candidate-sharded planner at 640x480
PAR_FRAMES = 31  # the orchard fleet step: ENTRY_FLEET vehicles, one demo block
PAR_DRYRUN_TIMEOUT = 300  # [s] python -m agrifly_tpu_torch.parallel.dryrun, set-up included
PAR_MAX_WORLD = 4


def _masked(text):
    """A demo's lines with the wall-clock figures masked."""
    import re

    return [re.sub(r"in [0-9.]+s wall.*", "in <wall>", line) for line in text.splitlines()]


def _mesh_fleet_step(dev, mesh, card):
    """sharding.make_fleet_step at PAR_ENVS x PAR_SUBSTEPS in both modes:
    every leaf bit-equal to env.rollout on the same draws, one K5 launch a
    call, the metrics equal to the same reductions of the rows made without
    a collective; timed in turns against env.rollout."""
    import torch

    from agrifly_tpu_torch.models import logic
    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.ops.fmath import norm3
    from agrifly_tpu_torch.parallel import sharding
    from agrifly_tpu_torch.sim import cuda_rollout, env

    p = env.make_params(noise_scale=1.0, device=dev)
    s0 = sharding.init_fleet(p, mesh, PAR_ENVS)
    cmd = env.hover_command(ENV_HOVER, device=dev)
    noise = torch.randn((PAR_ENVS, PAR_SUBSTEPS, 2, 3),
                        generator=torch.Generator(device=dev).manual_seed(SEED + 20), device=dev)
    for mode in (False, "mocap"):
        step = sharding.make_fleet_step(p, mesh, PAR_ENVS, PAR_SUBSTEPS, mode)
        cuda_rollout.rollout.launches = 0
        got, m = step(s0, cmd, noise=noise)
        torch.cuda.synchronize()
        launches = cuda_rollout.rollout.launches
        ref, _ = env.rollout(p, s0, cmd, PAR_SUBSTEPS, use_estimator=mode, noise=noise)
        _check(launches == 1, f"mesh: the fleet step launched K5 {launches} times")
        _check(_same_tree(got, ref), f"mesh: the fleet step ({mode}) differs from env.rollout")
        inv_n = 1.0 / PAR_ENVS
        up = torch.zeros_like(ref.plant.pos)
        up[:, 2] = 1.0
        host = (ref.plant.pos.sum(0) * inv_n, norm3(ref.plant.vel).sum() * inv_n,
                (ref.logic.fs == logic.FS_PANIC).sum(dtype=torch.int32),
                rot.rotate(ref.plant.att, up)[:, 2].min())  # as the JAX package reduces
        _check(all(torch.equal(a, b) for a, b in zip(m, host)),
               f"mesh: the fleet metrics ({mode}) differ from the rows' reductions: {m} {host}")
        _check(int(m.num_panicked) == 0, f"mesh: {int(m.num_panicked)} envs panicked")
        f64 = ref.plant.pos.double().mean(0).float()
        t_roll = lambda: env.rollout(p, s0, cmd, PAR_SUBSTEPS, use_estimator=mode,  # noqa: E731
                                     noise=noise)
        t_step = lambda: step(s0, cmd, noise=noise)  # noqa: E731
        times = [cuda_ms(fn, reps=5) for fn in (t_roll, t_step, t_step, t_roll)]
        metrics_ms = cuda_ms(lambda: sharding.fleet_metrics(got, mesh, PAR_ENVS), reps=5)
        print(f"mesh: fleet step, {PAR_ENVS} envs x {PAR_SUBSTEPS} substeps, "
              f"use_estimator={mode}: every leaf bit-equal to env.rollout on the same draws, "
              f"K5 launched {launches} time(s); the metrics equal to the rows' reductions bit for "
              f"bit (mean_pos {m.mean_pos.tolist()}, a float64 mean {f64.tolist()}, max |d| "
              f"{float((m.mean_pos - f64).abs().max()):.3g}; mean_speed "
              f"{float(m.mean_speed):.6f}, max_tilt_cos {float(m.max_tilt_cos):.6f}); on {card} "
              f"in turns, env.rollout / step / step / env.rollout: "
              f"{' / '.join(f'{t:.4f}' for t in times)} ms a call, the metrics alone "
              f"{metrics_ms:.4f} ms")


def _mesh_planner(dev, mesh, state, card):
    """sharding.make_sharded_planner at 640x480 with PAR_CANDIDATES
    candidates and capacity PAR_CAPACITY on the depth image of `state`'s
    pose (K1), over NCCL, bit-equal to the same call on CPU tensors over a
    gloo subgroup; one inflation launch (K2 or K2c) a plan."""
    import torch
    import torch.distributed as dist

    from agrifly_tpu_torch.ops import lin3
    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.parallel import sharding
    from agrifly_tpu_torch.render import cuda_raycast, raycast
    from agrifly_tpu_torch.sim import orchard_env

    p = orchard_env.make_params(device=dev)
    pos, att = state.base.plant.pos.reshape(1, 3), state.base.plant.att.reshape(1, 4)
    cam = raycast.camera_attitude(att)
    depth = cuda_raycast.render_depth_batch(p.render_cfg, p.scene, pos, cam)[0]
    R = rot.to_matrix(cam[0])
    grav = lin3.mv3t(R, torch.tensor(orchard_env.GRAV_W, device=dev))
    vel = lin3.mv3t(R, state.base.plant.vel.reshape(3))
    goal = lin3.mv3t(R, p.waypoints[0] - pos[0])
    u = torch.rand((4, PAR_CANDIDATES),
                   generator=torch.Generator(device=dev).manual_seed(SEED + 21), device=dev)
    args = (depth, u, vel, torch.zeros_like(vel), grav, goal)
    plan = sharding.make_sharded_planner(p.planner, mesh, PAR_CANDIDATES, PAR_CAPACITY)
    reset_counts()
    got = plan(*args)
    torch.cuda.synchronize()
    launches = read_counts()
    inflations = launches["inflate"] + launches["inflate_cluster"]
    _check(inflations == 1, f"mesh: the sharded planner launched the inflation {inflations} times")
    _check(launches["collision_check"] == 1 and launches["plan_gates"] == 1
           and launches["plain check and gates calls"] == 0,
           f"mesh: the sharded planner's candidate pass: {launches}")
    gloo = dist.new_group(backend="gloo")
    cpu_mesh = sharding.Mesh(gloo, 1, 0, torch.device("cpu"))
    p_cpu = orchard_env.make_params(device="cpu")
    t0 = time.perf_counter()
    ref = sharding.make_sharded_planner(p_cpu.planner, cpu_mesh, PAR_CANDIDATES,
                                        PAR_CAPACITY)(*(a.cpu() for a in args))
    cpu_s = time.perf_counter() - t0
    dist.destroy_process_group(gloo)
    _check(_same_tree(to_device(got, "cpu"), ref),
           "mesh: the sharded planner on the card differs from the same call on the CPU")
    _check(bool(got.found), "mesh: the sharded planner found no trajectory")
    ms = cuda_ms(lambda: plan(*args), reps=3, warmup=1)
    cfg = p.render_cfg
    print(f"mesh: sharded planner at {cfg.width}x{cfg.height}, {PAR_CANDIDATES} candidates, "
          f"capacity {PAR_CAPACITY}, on the depth image of the single flight's final pose: "
          f"bit-equal to the same call on CPU tensors over a gloo group (found "
          f"{bool(got.found)}, best_cost "
          f"{float(got.best_cost):.6f}, feasible {int(got.num_feasible)}, admissible "
          f"{int(got.num_velocity_admissible)}, free {int(got.num_collision_free)}, pyramids "
          f"{int(got.num_pyramids)}); {launches['inflate']} K2 + {launches['inflate_cluster']} "
          f"K2c launch a plan; {ms:.3f} ms a plan on {card} (the CPU's {1e3 * cpu_s:.1f} ms)")


def _mesh_orchard(dev, mesh, card):
    """sharding.make_orchard_fleet_step: ENTRY_FLEET vehicles x PAR_FRAMES
    frames bit-equal to orchard_env.fly_fleet on the same generator, K1, the
    inflation and K3b launched once (the inflation once a round) a fleet
    frame, the metrics equal to the rows' reductions; both timed."""
    import torch

    from agrifly_tpu_torch.parallel import sharding
    from agrifly_tpu_torch.sim import orchard_env

    p = orchard_env.make_params(start_flight_time=FLEET_START, device=dev)
    s0 = sharding.init_orchard_fleet(p, mesh, ENTRY_FLEET)
    step = sharding.make_orchard_fleet_step(p, mesh, ENTRY_FLEET, PAR_FRAMES)
    runs = {}
    for name, fly_block in (("fly_fleet", lambda g: orchard_env.fly_fleet(p, s0, PAR_FRAMES, g)),
                            ("mesh step", lambda g: step(s0, gen=g))):
        gen = torch.Generator(device=dev).manual_seed(SEED + 22)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fly_block(gen)
        torch.cuda.synchronize()
        runs[name] = (out, 1e3 * (time.perf_counter() - t0) / PAR_FRAMES, read_counts())
    (ref, _), ref_ms, _ = runs["fly_fleet"]
    (got, m), ms, launches = runs["mesh step"]
    check_counts(launches, PAR_FRAMES, True, p.planner_rounds + 1)
    _check(_same_tree(got, ref), "mesh: the orchard fleet step differs from fly_fleet")
    host = (ref.base.plant.pos.sum(0) * (1.0 / ENTRY_FLEET),
            (ref.base.logic.panic_reason != 0).sum(dtype=torch.int32),
            ref.plan_count.sum(dtype=torch.int32),
            (ref.mstage == orchard_env.MSTAGE_COMPLETE).sum(dtype=torch.int32))
    _check(all(torch.equal(a, b) for a, b in zip(m, host)),
           f"mesh: the orchard metrics differ from the rows' reductions: {m} {host}")
    _check(int(m.num_panicked) == 0 and int(m.num_plans) > 0,
           f"mesh: orchard fleet panicked or never planned: {m}")
    cfg = p.render_cfg
    print(f"mesh: orchard fleet step, {ENTRY_FLEET} vehicles x {PAR_FRAMES} frames at "
          f"{cfg.width}x{cfg.height}, {p.n_candidates} candidates: every leaf bit-equal to "
          f"fly_fleet on the same generator; metrics "
          f"{[round(v, 4) for v in m.mean_pos.tolist()]} m, {int(m.num_plans)} plans, "
          f"{int(m.num_panicked)} panics; {launches}; on {card}, fly_fleet then the mesh step: "
          f"{ref_ms:.3f} / {ms:.3f} ms per fleet frame")


def _mesh_demo(fleet_entry):
    """demo --mesh --fleet ENTRY_FLEET (a world of one the demo makes and
    closes): its lines are the --fleet run's with the mesh: line, its final
    state that run's bit for bit, its launches one fleet frame's each."""
    from agrifly_tpu_torch import demo

    fleet_text, fleet_flight = fleet_entry
    reset_counts()
    flight, text = _entry("demo --mesh --fleet", lambda a: demo.run(demo.parse_args(a)), [
        "--mesh", "--fleet", str(ENTRY_FLEET), "--frames", str(ENTRY_FLEET_FRAMES)], "mesh")
    launches = read_counts()
    check_counts(launches, ENTRY_FLEET_FRAMES, True, 3)
    lines = _masked(text)
    _check(lines[0] == f"mesh: 1 devices, {ENTRY_FLEET} vehicles/device",
           f"demo --mesh: first line {lines[0]!r}")
    _check(lines[1:] == _masked(fleet_text), "demo --mesh: its lines are not --fleet's")
    _check(_same_tree(flight.state, fleet_flight.state),
           "demo --mesh: its final state differs from --fleet's")
    print(f"mesh: demo --mesh --fleet {ENTRY_FLEET}: the --fleet run's {len(lines) - 1} lines "
          f"(wall times aside) and its final state bit for bit; {launches}")


def _mesh_dryrun(card):
    """python -m agrifly_tpu_torch.parallel.dryrun on one card, and on
    min(cards, PAR_MAX_WORLD) where the host has more than one."""
    import torch

    worlds = [1] + ([min(torch.cuda.device_count(), PAR_MAX_WORLD)]
                    if torch.cuda.device_count() >= 2 else [])
    for world in worlds:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "agrifly_tpu_torch.parallel.dryrun",
                              str(world)], capture_output=True, text=True,
                             timeout=PAR_DRYRUN_TIMEOUT)
        _check(res.returncode == 0 and "DRYRUN OK" in res.stdout,
               f"mesh: dryrun {world}: rc {res.returncode}\n{res.stdout[-2000:]}"
               f"\n{res.stderr[-3000:]}")
        ok = next(line for line in res.stdout.splitlines() if line.startswith("DRYRUN OK"))
        print(f"mesh: python -m agrifly_tpu_torch.parallel.dryrun {world} on {card}: "
              f"{ok} ({time.perf_counter() - t0:.1f} s, set-up included)")
    if len(worlds) == 1:
        print("mesh: W >= 2 did not run: this host has one card, and NCCL takes one rank a "
              "card; W = 2 and 4 are held on the CPU over gloo (tests/test_torch_sharding.py, "
              "tests/test_torch_multihost.py)")


def check_mesh(dev, state, fleet_entry):
    """The multi-device path (agrifly_tpu_torch/parallel) on the card: a
    world of one over NCCL (make_mesh) for the fleet step, the
    candidate-sharded planner and the orchard fleet step, its group
    destroyed after them; then `demo --mesh --fleet` against the entry
    points' `--fleet` run (`fleet_entry`) and the dry run in a process of
    its own. `state`: the single flight's final state (the planner's
    pose)."""
    import torch.distributed as dist

    from agrifly_tpu_torch.parallel import sharding

    t0 = time.perf_counter()
    card = card_line()
    mesh = sharding.make_mesh(dev)
    try:
        _check(dist.get_backend() == "nccl" and mesh.world == 1 and mesh.device == dev,
               f"mesh: {dist.get_backend()} world of {mesh.world} on {mesh.device}")
        print(f"mesh: a world of one over NCCL on {mesh.device} ({card})")
        _mesh_fleet_step(dev, mesh, card)
        _mesh_planner(dev, mesh, state, card)
        _mesh_orchard(dev, mesh, card)
    finally:
        sharding.close_mesh(mesh)
    _check(not dist.is_initialized(), "mesh: the phase left its process group")
    _mesh_demo(fleet_entry)
    _mesh_dryrun(card)
    print(f"mesh: phase {time.perf_counter() - t0:.1f} s")


def time_big_fleet(dev):
    """Frames of a BIG_FLEET-vehicle fleet, timed after one warm-up frame."""
    import torch

    from agrifly_tpu_torch.sim import orchard_env

    env = orchard_env.OrchardEnv(
        orchard_env.make_params(start_flight_time=FLEET_START, device=dev))
    state = env.init_state_fleet(lanes(BIG_FLEET, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    state, _ = env.frame_step_fleet(state, gen)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = env.frame_step_fleet(state, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    _check(tuple(out["pos"].shape) == (BIG_FLEET, 3) and bool(torch.isfinite(out["pos"]).all()),
           "big fleet: non-finite or misshaped positions")
    ms = sum(times) / len(times)
    print(f"fleet of {BIG_FLEET}: {ms:.3f} ms per fleet frame (frames "
          f"{', '.join(f'{t:.3f}' for t in times)} ms; {BIG_FLEET * 32.0 / ms:.3f}x real time "
          f"in aggregate)")
    profile_frame(lambda: env.frame_step_fleet(state, gen), ms, f"fleet frame, B={BIG_FLEET}")


def profile_frame(step, frame_ms, label):
    """Device time over one profiled frame (`step()`): the sum of its
    kernels' device times, their number, the port kernels' own times, and
    the busy share of the unprofiled frame time `frame_ms` (the profiler
    slows the host, so its own wall time would read the idle share high).
    Informational: a profiler that cannot trace the card prints "not
    measured" and fails nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        rows = prof.key_averages()
    except RuntimeError as exc:
        print(f"profiled {label}: not measured ({exc})")
        return
    # device-side rows only: an operator's row repeats its kernels' time
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) * 1e-3
    if busy_ms <= 0:
        print(f"profiled {label}: not measured (the profiler saw no device time)")
        return
    ours = ", ".join(f"{name} {e.self_device_time_total / e.count:.1f} us x{e.count}"
                     for e in kernels for name in DEVICE_KERNELS if name in e.key)
    print(f"profiled {label}: {sum(e.count for e in kernels)} kernels, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / frame_ms:.2f}% of the unprofiled {frame_ms:.3f} "
          f"ms); {ours}")


def check_ticks_against_cpu(state, dev, start_flight_time):
    """One 16-tick block from a flight's final state (one vehicle or a
    fleet): the kernel on the card against the plain ticks on the CPU, same
    noise, tick criteria. Returns (card params, card noise, worst ratio)."""
    import torch

    from agrifly_tpu_torch.sim import orchard_env

    lead = tuple(state.base.step.shape)
    noise = torch.randn(lead + (16, 2, 3), generator=torch.Generator().manual_seed(SEED))
    p_cpu = orchard_env.make_params(start_flight_time=start_flight_time, fused_ticks=False,
                                    device="cpu")
    p_dev = orchard_env.OrchardEnv(p_cpu._replace(fused_ticks=True)).to(dev).params
    got = orchard_env.frame_ticks(p_dev, state, noise.to(dev))
    ref = orchard_env.frame_ticks(p_cpu, to_device(state, "cpu"), noise)
    worst = compare_ticks(got, ref, "card kernel vs CPU plain")
    print(f"16 ticks from the final state (B={lead[0] if lead else 1}), kernel on the card vs "
          f"plain on the CPU: discrete leaves equal, worst float leaf {worst:.4g} x bound")
    return p_dev, noise.to(dev), worst


# The env rollout (K5, csrc/rollout.cu) at bench.py's shape: envs, steps per
# call, timed calls; hover at (0, 0, 1.5) with the reference IMU noise.
ENVS, ENV_STEPS, ENV_CALLS = 4096, 250, 8
ENV_HOVER = (0.0, 0.0, 1.5)
ENV_CHECK_ENVS, ENV_CHECK_STEPS = 64, 25  # the mocap subset held against the plain rollout
ENV_CPU_ENVS = 8  # envs held against the plain rollout on the CPU from mid-flight
ENV_PLAIN_STEPS = 4  # steps of the plain vmapped rollout timed at ENVS envs with the estimator
ENV_TIMED_ENVS = (1, ENV_CHECK_ENVS, ENVS)  # K5's device time at each G for these B
# csrc/tick.cuh and rollout.cu, float operations per env and tick, counted
# where bench.py's ticks run them: the plant (~300), IMU (~60), the onboard
# logic with its complementary attitude and rates branch (~1100), the
# offboard controller on one tick in five (~500 / 5); with the mocap
# estimator also its update (replay of 9 segments and the 2x2 filters,
# ~1700) on two ticks in five and its prediction replay (~1100) on one.
ENV_TICK_OPS = {False: 1600, True: 2500}
# rollout.cu's Section enum, in order: the statements its clock64() timers
# enclose in the ROLLOUT_SECTIONS build
ROLLOUT_SECTIONS = ("ticks", "radio", "plant", "imu", "logic", "ekf_predict", "cov_predict",
                    "mocap_update", "replay (update)", "prediction", "offboard", "store", "noise")
TIMED_ROLLOUT = ("rollout", ("ROLLOUT_SECTIONS",))  # cuda_build.load's arguments
ROLLOUT_SECTION_LAUNCHES = 3  # timed launches of ENV_STEPS steps, after one warm-up
UWB_ROLLOUT = ("rollout", ("TICK_UWB",))  # K5's UWB variant
# The estimator and UWB modes of K5, each at ENVS envs x ENV_STEPS steps:
# "gpsimu" is benchmarks/bench_estimators.py's third call (hover at
# (0, 0, 1.2), the GPS-IMU estimator, rates commands); "uwb" is
# tests/test_uwb.py's onboard-UWB configuration (four anchors, 0.05 m range
# noise, a 10 ms network period, position commands to hover at
# (0.5, -0.5, 1.5), the true state offboard).
ENV_MODES = {"gpsimu": dict(hover=(0.0, 0.0, 1.2), use_estimator="gpsimu", ctrl="rates"),
             "uwb": dict(hover=(0.5, -0.5, 1.5), use_estimator=False, ctrl="position")}
UWB_ANCHOR_IDS = (101, 102, 103, 104)
UWB_ANCHOR_POS = ((-3.0, -3.0, 0.1), (3.0, -3.0, 0.2), (3.0, 3.0, 2.0), (-3.0, 3.0, 1.5))
UWB_FLIGHT_ENVS, UWB_FLIGHT_STEPS, UWB_SILENCE_STEPS = 64, 5000, 1000  # tests/test_uwb.py's
# float operations per env and tick, estimated as ENV_TICK_OPS is (rounded
# counts read off the source, not a tally of executed operations): the true
# state's 1600, and with the GPS-IMU estimator its full EKF prediction every
# tick (the covariance's 3x3 block products ~500, the mean ~100) and the GPS
# fix on one tick in five (~700 / 5); with UWB the network (~100), the
# onboard EKF's full prediction (~600) and the range update on one tick in
# six (~400 / 6), and the onboard position loop (~400) in place of the rates
# branch
ENV_MODE_TICK_OPS = {"gpsimu": 2350, "uwb": 2750}


def env_bytes(leaves, pleaves, cmd, noise, new_leaves, traj):
    """Bytes a rollout call must move: every state, parameter, command and
    noise byte read once, the written state leaves and the trajectory
    written once."""
    written = [t for t, old in zip(new_leaves, leaves) if t is not old]
    return nbytes(*leaves, *pleaves, *cmd, noise, *written, *traj)


def compare_traj(got, ref, where):
    """StepOutputs trajectories: discrete leaves equal, float leaves within
    1e-3 (|ref| + 1e-3). Returns (worst ratio, max abs difference)."""
    import torch

    worst = err = 0.0
    for name, a, b in zip(got._fields, got, ref):
        a, b = a.cpu(), b.cpu()
        if not a.is_floating_point():
            _check(torch.equal(a, b), f"trajectory {name} differs ({where})")
            continue
        d = (a.double() - b.double()).abs()
        ratio = float((d / (1e-3 * (b.double().abs() + 1e-3))).max())
        _check(ratio <= 1.0, f"trajectory {name} off ({where}): {ratio:.3g} x bound")
        worst, err = max(worst, ratio), max(err, float(d.max()))
    return worst, err


def max_abs_err(got, ref):
    from agrifly_tpu_torch import convert

    return max(float((a.cpu().double() - b.cpu().double()).abs().max())
               for (_, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref))
               if a.is_floating_point())


def env_subset(tree, rows):
    from agrifly_tpu_torch.sim import env

    return env._tree_map(lambda t: t[rows].contiguous(), tree)


def env_launcher(p, s, cmd, noise, mode, group, launcher=None, ctrl="rates", draws=None):
    """A bare launch of K5 (the wrapper's checks done once, up front) on
    state s with `group` lanes per env (with draws: the UWB variant):
    returns fn() -> (new leaves, traj)."""
    from agrifly_tpu_torch import cuda_build
    from agrifly_tpu_torch.sim import cuda_rollout, env

    specs, pspecs = cuda_rollout.leaf_table(draws is not None)
    B, dev = env._fleet_size(s), noise.device
    s_entry = cuda_rollout._accept("state", s, dev, lambda leaves: cuda_build.check_leaves(
        specs, leaves, dev, "state", B, "tick.cuh"))
    p_entry = cuda_rollout._accept("params", p, dev, lambda leaves: cuda_build.check_leaves(
        pspecs, leaves, dev, "params", None, "tick.cuh"))
    rows = cuda_rollout._command(cmd, B, dev)
    return lambda: cuda_rollout._launch(s_entry, p_entry, rows, noise, mode, ctrl, group,
                                        launcher, draws, uwb=draws is not None)


def k5_groups_equal(launch, names, what):
    """K5 at every built G against G = 1 on the same inputs, bit for bit:
    launch(group) -> (state leaves, trajectory leaves), named `names`."""
    import torch

    from agrifly_tpu_torch.sim import cuda_rollout

    ref_state, ref_traj = launch(1)
    for group in cuda_rollout.GROUPS[1:]:
        state, traj = launch(group)
        for name, a, b in zip(names, state + traj, ref_state + ref_traj):
            _check(torch.equal(a, b), f"K5 G={group} vs G=1, {what}: {name} differs")
    torch.cuda.synchronize()
    print(f"env_rollout {what}: K5 at G = {', '.join(map(str, cuda_rollout.GROUPS[1:]))} "
          "bit-equal to G = 1 (every state and trajectory leaf)")


def bench_calls(call, what, dev_us, drawn="the noise"):
    """A bench.py call timed: one warm-up, then ENV_CALLS calls of call()
    (ENVS envs x ENV_STEPS steps each) on the host's clock around a
    synchronised loop; checks the result's shape, finiteness, steps and that
    nothing panicked. Returns steps/s."""
    import torch

    final, traj = call()
    torch.cuda.synchronize()
    t0, host = time.perf_counter(), 0.0
    for _ in range(ENV_CALLS):
        t1 = time.perf_counter()
        final, traj = call()
        host += time.perf_counter() - t1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    _check(tuple(traj.pos.shape) == (ENVS, ENV_STEPS, 3)
           and bool(torch.isfinite(traj.pos).all()) and bool(torch.isfinite(final.plant.pos).all()),
           f"env_rollout {what}: misshaped or non-finite trajectory")
    _check(bool((final.logic.panic_reason == 0).all()) and bool((final.step == ENV_STEPS).all()),
           f"env_rollout {what}: a panic, or the step did not advance")
    rate = ENVS * ENV_STEPS * ENV_CALLS / elapsed
    print(f"env_rollout {what}: {rate:.1f} physics+logic steps/s at {ENVS} envs x {ENV_STEPS} "
          f"steps ({ENV_CALLS} timed calls of {1e3 * elapsed / ENV_CALLS:.3f} ms, {drawn} drawn "
          f"inside; the host returns from a call in {1e3 * host / ENV_CALLS:.3f} ms, K5's device "
          f"time {us_text(dev_us)}), final z mean {float(final.plant.pos[:, 2].mean()):.4f} m")
    return rate


def k5_row(p, s, cmd, nz, mode, ctrl, draws, err, plain_ms, ops, dev_us, what):
    """K5's row for state s: the wrapper's ms (CUDA events around
    cuda_rollout.rollout), the bound from the call's inputs (every state,
    parameter, command, noise and draw byte read and the state and
    trajectory written once; `ops` operations)."""
    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_rollout

    B = s.step.shape[0]
    leaves, pleaves = convert.flatten_tensors(s)[0], cuda_rollout.param_leaves(p)
    cmd_leaves = cuda_rollout._command(cmd, B, nz.device)[0]
    new, traj = env_launcher(p, s, cmd, nz, mode, cuda_rollout.GROUP, ctrl=ctrl, draws=draws)()
    w_ms = cuda_ms(lambda: cuda_rollout.rollout(p, s, cmd, nz, mode, ctrl, uwb_draws=draws),
                   reps=5, warmup=1)
    n_bytes = env_bytes(leaves, pleaves, cmd_leaves, nz, new, traj)
    r = result(err, w_ms, plain_ms, n_bytes + (0 if draws is None else nbytes(draws)), ops)
    print(f"env_rollout {B} envs x {ENV_STEPS} steps, {what} (G={cuda_rollout.GROUP}): wrapper "
          f"{w_ms:.4f} ms, device {us_text(dev_us)}, bound {r['bound_ms']:.6f} ms "
          f"({r['bound_by']})")
    return r


def check_env_groups(p, s0, cmd, noise):
    """K5 at every built G against G = 1 on the same inputs, bit for bit,
    in both estimator modes over ENV_STEPS steps: all ENVS envs with the
    true state, ENV_CHECK_ENVS with the estimator; state and trajectory."""
    from agrifly_tpu_torch.sim import cuda_rollout, env

    specs, _ = cuda_rollout.leaf_table()
    names = [".".join(spec.path) for spec in specs] + list(env.StepOutputs._fields)
    for mode, n_envs in ((False, ENVS), (True, ENV_CHECK_ENVS)):
        s, nz = env_subset(s0, slice(0, n_envs)), noise[:n_envs].contiguous()
        k5_groups_equal(lambda g: env_launcher(p, s, cmd, nz, mode, g)(), names,
                        f"use_estimator={mode}, {n_envs} envs x {ENV_STEPS} steps")


def env_group_times(p, s0, cmd, noise):
    """K5's device time per call (device_us, bare launch) at every G, for B
    = ENV_TIMED_ENVS envs x ENV_STEPS steps, both estimator modes; and at
    ENVS envs with 0 steps (the state's copies in and out alone). Returns
    {(B, mode, G): us}."""
    from agrifly_tpu_torch.sim import cuda_rollout

    out = {}
    empty = noise[:, :0].contiguous()
    copies = {g: device_us(env_launcher(p, s0, cmd, empty, False, g), reps=3)
              for g in cuda_rollout.GROUPS}
    print(f"env_rollout device time per call, {ENVS} envs x 0 steps (the state copied in and "
          "out; bare launch): " + "; ".join(f"G={g} {us_text(v)}" for g, v in copies.items()))
    for B in ENV_TIMED_ENVS:
        s, nz = env_subset(s0, slice(0, B)), noise[:B].contiguous()
        for mode in (False, True):
            for group in cuda_rollout.GROUPS:
                out[B, mode, group] = device_us(env_launcher(p, s, cmd, nz, mode, group), reps=3)
            print(f"env_rollout device time per call, {B} envs x {ENV_STEPS} steps, use_estimator="
                  f"{mode} (bare launch): " + "; ".join(
                      f"G={g} {us_text(out[B, mode, g])}" for g in cuda_rollout.GROUPS))
    return out


def rollout_sections(p, s0, cmd, noise, groups):
    """Cycles per tick of each section of K5's tick chain (env 0's lane 0,
    ROLLOUT_SECTION_LAUNCHES launches of ENV_STEPS steps) from rollout.cu's
    ROLLOUT_SECTIONS build, at each G in `groups`, both estimator modes, at
    1 and ENVS envs; and the measured chain time (the ticks' cycles per
    launch over the card's maximum SM clock)."""
    import ctypes

    import torch

    from agrifly_tpu_torch import cuda_build
    from agrifly_tpu_torch.sim import cuda_rollout

    lib = cuda_build.load(*TIMED_ROLLOUT)
    fn = lib.env_rollout_launch
    fn.argtypes, fn.restype = cuda_rollout._ARGTYPES, ctypes.c_int
    mhz = max_sm_mhz()
    n = len(ROLLOUT_SECTIONS)
    sec, cnt = (ctypes.c_ulonglong * n)(), (ctypes.c_ulonglong * n)()
    ticks = ROLLOUT_SECTION_LAUNCHES * ENV_STEPS
    for B in (1, ENVS):
        s, nz = env_subset(s0, slice(0, B)), noise[:B].contiguous()
        for mode in (False, True):
            for group in groups:
                launch = env_launcher(p, s, cmd, nz, mode, group, fn)
                launch()
                torch.cuda.synchronize()
                lib.env_rollout_sections_read(sec, cnt)
                for _ in range(ROLLOUT_SECTION_LAUNCHES):
                    launch()
                torch.cuda.synchronize()
                cuda_build.check(lib.env_rollout_sections_read(sec, cnt),
                                 "env_rollout_sections_read")
                print(f"env_rollout section timers, {B} envs, use_estimator={mode}, G={group} "
                      f"(env 0, cycles per tick over {ticks} ticks): " + ", ".join(
                          f"{name} {sec[k] / ticks:.0f} (runs {cnt[k]})"
                          for k, name in enumerate(ROLLOUT_SECTIONS))
                      + f"; measured chain time {sec[0] / ROLLOUT_SECTION_LAUNCHES:.0f} cycles "
                        f"per call = {sec[0] / ROLLOUT_SECTION_LAUNCHES / (mhz * 1e3):.6f} ms at "
                        f"the {mhz:.0f} MHz maximum SM clock")


def wrapper_split(p, s0, cmd, gen, reps=ENV_CALLS):
    """The host's time for each step of a bench.py call (env.rollout_fast,
    true state), each step timed alone over `reps` runs (as many as
    bench.py's timed calls, each run's result kept, as its loop keeps them):
    the noise draw, the two cached leaf checks, the command, the launch
    (buffers and the ctypes call) with the output views, and the tree's
    rebuild. Returns {step: ms}."""
    import torch

    from agrifly_tpu_torch import cuda_build
    from agrifly_tpu_torch.sim import cuda_rollout

    specs, pspecs = cuda_rollout.leaf_table()
    dev = s0.step.device
    steps = {
        "noise": lambda: torch.randn((ENVS, ENV_STEPS, 2, 3), generator=gen, device=dev),
        "state check": lambda: cuda_rollout._accept("state", s0, dev, lambda leaves: (
            cuda_build.check_leaves(specs, leaves, dev, "state", ENVS, "tick.cuh"))),
        "params check": lambda: cuda_rollout._accept("params", p, dev, lambda leaves: (
            cuda_build.check_leaves(pspecs, leaves, dev, "params", None, "tick.cuh"))),
        "command": lambda: cuda_rollout._command(cmd, ENVS, dev),
    }
    noise = steps["noise"]()
    s_entry, p_entry, rows = steps["state check"](), steps["params check"](), steps["command"]()
    steps["launch and views"] = lambda: cuda_rollout._launch(s_entry, p_entry, rows, noise, False,
                                                             "rates")
    new = steps["launch and views"]()[0]
    steps["rebuild"] = lambda: s_entry.rebuild(new)
    out = {}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept = [fn() for _ in range(reps)]
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        del kept
    print("env_rollout wrapper's host time per step of a call (ms, each alone over "
          f"{reps} runs): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
          + f"; sum {sum(out.values()):.4f}")
    return out


def graphed_steps(step, state, inputs, n, outputs=True):
    """`state, out = step(state, *inputs(k))` for k < n, as replays of one
    CUDA graph captured from the eager step (warmed up once on its capture
    stream): the same kernels on the same inputs, so the eager loop's
    results bit for bit at a fraction of its host time (an eager tick is
    some 3000 launches). The state and input buffers take the strides the
    eager loop hands the step. inputs(k): the step's tensors for tick k
    (None where it takes none). Returns (the final state, [out_k] where
    `outputs`)."""
    import torch

    from agrifly_tpu_torch import convert

    leaves, rebuild = convert.flatten_tensors(state)
    stream, graph = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    with torch.inference_mode():
        xs = [None if v is None else torch.empty_strided(v.size(), v.stride(), dtype=v.dtype,
                                                         device=v.device) for v in inputs(0)]
        for x, v in zip(xs, inputs(0)):
            if x is not None:
                x.copy_(v)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            warm = convert.flatten_tensors(step(state, *xs)[0])[0]
        torch.cuda.current_stream().wait_stream(stream)
        static = [torch.empty_like(w).copy_(t) for w, t in zip(warm, leaves)]
        with torch.cuda.graph(graph, stream=stream):
            new, out = step(rebuild(static), *xs)
        new_leaves = convert.flatten_tensors(new)[0]
        out_leaves, out_rebuild = convert.flatten_tensors(out)
        outs = []
        for k in range(n):
            for x, v in zip(xs, inputs(k)):
                if x is not None:
                    x.copy_(v)
            graph.replay()
            if outputs:
                outs.append(out_rebuild([t.clone() for t in out_leaves]))
            for a, b in zip(static, new_leaves):
                a.copy_(b)
    return rebuild(static), outs


def plain_rollout_graphed(p, s, cmd, noise, mode, ctrl="rates", draws=None):
    """env.rollout_plain's (state, traj), its eager step replayed as a CUDA
    graph (graphed_steps)."""
    import torch

    from agrifly_tpu_torch.sim import env

    B = env._fleet_size(s)
    stepper, c = env._stepper(p, mode, ctrl, B), env._fleet_command(cmd, B)
    state, outs = graphed_steps(
        lambda st, nz, d: stepper(st, c, nz, d), s,
        lambda k: (noise[..., k, :, :], None if draws is None else draws[..., k, :]),
        noise.shape[-3])
    return env._tree_map(torch.Tensor.contiguous, state), env._stack_outputs(outs, B)


def plain_fleet_graphed(p, s, des, noise, gusts, mode, draws=None):
    """fleet_env.fleet_rollout_plain's final state, its eager fleet_step
    replayed as a CUDA graph (graphed_steps)."""
    import torch

    from agrifly_tpu_torch.sim import env, fleet_env

    state, _ = graphed_steps(
        lambda st, nz, g, d: fleet_env.fleet_step(p, st, des, mode, nz, g, d), s,
        lambda k: (noise[:, k], gusts[k], None if draws is None else draws[:, k]),
        noise.shape[1], outputs=False)
    return env._tree_map(torch.Tensor.contiguous, state)


def check_env_against_plain(p, s0, cmd, noise, mode, ctrl="rates", draws=None):
    """K5 (the default G) against the plain rollout (vmapped) on the card,
    from the start: the first ENV_CHECK_STEPS steps by the tick criteria,
    then all ENV_STEPS steps by JAX's own rollout_fast terms (flight state
    and panic reason equal at every step, final position within 0.05 m).
    The plain rollout runs its first ENV_CHECK_STEPS steps eagerly (timed)
    and the rest as replays of a CUDA graph of its eager step
    (plain_rollout_graphed). draws: the UWB draws, with anchors. Returns
    (worst ratio, max abs error of the float leaves after ENV_CHECK_STEPS
    steps, the kernel's state then, the eager plain rollout's seconds a
    step)."""
    import torch

    from agrifly_tpu_torch.sim import cuda_rollout, env

    n = ENV_CHECK_STEPS
    head = (lambda t: None) if draws is None else (lambda t: t[:, :n].contiguous())
    tail = (lambda t: None) if draws is None else (lambda t: t[:, n:].contiguous())
    got, got_traj = cuda_rollout.rollout(p, s0, cmd, noise[:, :n].contiguous(), mode, ctrl,
                                         uwb_draws=head(draws))
    env.rollout_plain(p, s0, cmd, noise[:, :1], mode, ctrl,
                      uwb_draws=None if draws is None else draws[:, :1])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_traj = env.rollout_plain(p, s0, cmd, noise[:, :n], mode, ctrl, uwb_draws=head(draws))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    ref_end, ref_traj_end = plain_rollout_graphed(p, ref, cmd, noise[:, n:], mode, ctrl,
                                                  tail(draws))
    torch.cuda.synchronize()
    graph_s = (time.perf_counter() - t0) / (ENV_STEPS - n)
    where = f"K5 vs plain, use_estimator={mode}, {ctrl}, {n} steps"
    worst = compare_ticks(got, ref, where, env=())
    worst_traj, err_traj = compare_traj(got_traj, ref_traj, where)
    err = max(max_abs_err(got, ref), err_traj)
    full, full_traj = cuda_rollout.rollout(p, s0, cmd, noise, mode, ctrl, uwb_draws=draws)
    torch.cuda.synchronize()
    for name in ("flight_state", "panic_reason"):
        want = torch.cat([getattr(ref_traj, name), getattr(ref_traj_end, name)], dim=1)
        _check(torch.equal(getattr(full_traj, name), want),
               f"K5 vs plain, use_estimator={mode}: {name} differs over {ENV_STEPS} steps")
    dpos = float((full.plant.pos - ref_end.plant.pos).abs().max())
    _check(dpos <= 0.05, f"K5 vs plain, use_estimator={mode}: final position {dpos:.3g} m apart")
    r250 = tick_reading(full, ref_end, env=())
    print(f"env_rollout use_estimator={mode}, {ctrl}: after {ENV_STEPS} steps (a reading, not a "
          f"gate) worst float leaf {r250[0]:.4g} x the tick bound, {r250[1]} discrete leaves "
          f"differ, wire codes {r250[2]} apart")
    B = s0.step.shape[0]
    print(f"env_rollout use_estimator={mode}{'' if draws is None else ', UWB'}, {ctrl}, {B} envs, "
          f"kernel (G={cuda_rollout.GROUP}) vs plain on "
          f"the card: {n} steps discrete leaves equal, worst float leaf {max(worst, worst_traj):.4g}"
          f" x bound, max abs err {err:.3g}; {ENV_STEPS} steps flight state and panic equal, final "
          f"position {dpos:.3g} m apart; fs {sorted(set(full.logic.fs.tolist()))}; the plain "
          f"(vmapped torch) rollout {B / step_s:.1f} steps/s ({1e3 * step_s:.3f} ms per step over "
          f"its first {n}, eager; the other {ENV_STEPS - n} replayed as a CUDA graph of the eager "
          f"step, {1e3 * graph_s:.3f} ms per step)")
    return max(worst, worst_traj), err, got, step_s


def check_env_against_cpu(p, state, cmd, mode, dev, ctrl="rates"):
    """From a mid-flight state (nonzero step, warm cadence accumulators):
    K5 on the card against the plain rollout on the CPU, same noise (and,
    with anchors, UWB draws), tick criteria (compare_ticks)."""
    import torch

    from agrifly_tpu_torch.sim import cuda_rollout, uwb

    gen = torch.Generator().manual_seed(SEED + 6)
    noise = torch.randn((ENV_CPU_ENVS, ENV_CHECK_STEPS, 2, 3), generator=gen)
    draws = None if p.uwb is None else uwb.draw((ENV_CPU_ENVS, ENV_CHECK_STEPS), gen)
    s = env_subset(state, slice(0, ENV_CPU_ENVS))
    got, got_traj = cuda_rollout.rollout(p, s, cmd, noise.to(dev), mode, ctrl,
                                         uwb_draws=None if draws is None else draws.to(dev))
    p_cpu, s_cpu = to_device(p, "cpu"), to_device(s, "cpu")
    ref, ref_traj = cuda_rollout.rollout(p_cpu, s_cpu, to_device(cmd, "cpu"), noise, mode, ctrl,
                                         uwb_draws=draws)
    where = f"K5 on the card vs plain on the CPU, use_estimator={mode}, {ctrl}"
    worst = max(compare_ticks(got, ref, where, env=()), compare_traj(got_traj, ref_traj, where)[0])
    print(f"env_rollout use_estimator={mode}{'' if draws is None else ', UWB'}, {ctrl} from step "
          f"{int(s.step[0])} (mocap_acc "
          f"{int(s.mocap_acc_us[0])}, offboard_acc {int(s.offboard_acc_us[0])} us), "
          f"{ENV_CPU_ENVS} envs x {ENV_CHECK_STEPS} steps, kernel on the card vs plain on the CPU:"
          f" discrete leaves equal, worst float leaf {worst:.4g} x bound")
    return worst


def check_env_rollout(dev):
    """K5, the env rollout kernel: every built G bit-equal to G = 1, the
    default G held against the plain rollout on the card and on the CPU in
    both estimator modes, the device time of every G at B = 1, 64 and 4096,
    the section timers, then bench.py's workload through env.rollout_fast
    (4096 envs x 250 steps, noise drawn inside each timed call, the host's
    time to return from a call), whose launches it counts, and the plain
    vmapped rollout's rate at 4096 envs. Returns the kernel's line (at
    bench.py's shape, use_estimator=False) and its launches."""
    import torch

    from agrifly_tpu_torch.sim import cuda_rollout, env

    t_phase = time.perf_counter()
    p = env.make_params(noise_scale=1.0, device=dev)
    s0 = env.init_state_fleet(p, torch.zeros((ENVS, 3), device=dev))
    cmd = env.hover_command(ENV_HOVER, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    # the true state on all ENVS envs (bench.py's call: its plain time is
    # the kernel line's), the mocap estimator on ENV_CHECK_ENVS of them
    noise = torch.randn((ENVS, ENV_STEPS, 2, 3), generator=gen, device=dev)
    check_env_groups(p, s0, cmd, noise)
    worst = err = 0.0
    for mode, s, nz in ((False, s0, noise),
                        (True, env_subset(s0, slice(0, ENV_CHECK_ENVS)),
                         noise[:ENV_CHECK_ENVS].contiguous())):
        w, e, mid, step_s = check_env_against_plain(p, s, cmd, nz, mode)
        worst, err = max(worst, w), max(err, e)
        worst = max(worst, check_env_against_cpu(p, mid, cmd, mode, dev))
        if not mode:
            plain_ms = 1e3 * step_s * ENV_STEPS

    dev_us = env_group_times(p, s0, cmd, noise)
    fastest = min(cuda_rollout.GROUPS, key=lambda g: dev_us[ENVS, False, g])
    print(f"env_rollout fastest G at {ENVS} envs with the true state: G={fastest} "
          f"({us_text(dev_us[ENVS, False, fastest])}); the default: G={cuda_rollout.GROUP} "
          f"({us_text(dev_us[ENVS, False, cuda_rollout.GROUP])})")
    rollout_sections(p, s0, cmd, noise, cuda_rollout.GROUPS)

    wrapper_split(p, s0, cmd, gen)
    # bench.py's workload: its launches are counted from here
    cuda_rollout.rollout.launches = 0
    for mode in (False, True):
        bench_calls(lambda: env.rollout_fast(p, s0, cmd, ENV_STEPS, use_estimator=mode, gen=gen),
                    f"bench.py workload, use_estimator={mode}",
                    dev_us[ENVS, mode, cuda_rollout.GROUP])
    launches = cuda_rollout.rollout.launches
    _check(launches == 2 * (ENV_CALLS + 1), f"env_rollout launched {launches} times")

    # the plain vmapped rollout with the mocap estimator at bench.py's width
    t0 = time.perf_counter()
    env.rollout_plain(p, s0, cmd, noise[:, :ENV_PLAIN_STEPS], True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    print(f"env_rollout plain (vmapped torch) use_estimator=True: "
          f"{ENVS * ENV_PLAIN_STEPS / plain_s:.1f} steps/s at {ENVS} envs "
          f"({1e3 * plain_s / ENV_PLAIN_STEPS:.3f} ms per step over {ENV_PLAIN_STEPS})")

    # K5's rows at 1 and ENVS envs in both modes; the kernel's line is
    # bench.py's call (use_estimator=False) with the plain version's time on
    # the same inputs (check_env_against_plain)
    rows = {(B, mode): k5_row(p, env_subset(s0, slice(0, B)), cmd, noise[:B].contiguous(), mode,
                              "rates", None, err, None, B * ENV_STEPS * ENV_TICK_OPS[mode],
                              dev_us[B, mode, cuda_rollout.GROUP], f"use_estimator={mode}")
            for B in (1, ENVS) for mode in (False, True)}
    res = dict(rows[ENVS, False], plain_ms=plain_ms)
    print(f"env_rollout: worst float leaf {worst:.4g} x bound; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return res, launches


def env_mode_case(dev, name, B):
    """(params, state, command) of ENV_MODES[name] for B envs at rest at the
    origin (the network's anchors with "uwb")."""
    import torch

    from agrifly_tpu_torch.sim import env

    p = env.make_params(noise_scale=1.0, device=dev)
    if name == "uwb":
        p = env.with_uwb_anchors(p, UWB_ANCHOR_IDS, UWB_ANCHOR_POS, noise_std=0.05,
                                 comm_period=0.01)
    return (p, env.init_state_fleet(p, torch.zeros((B, 3), device=dev)),
            env.hover_command(ENV_MODES[name]["hover"], device=dev))


def check_uwb_flight(dev, gen):
    """tests/test_uwb.py's onboard-UWB flight through K5: UWB_FLIGHT_STEPS
    ticks at UWB_FLIGHT_ENVS envs in one env.rollout call, each env held to
    the test's assertions (fully autonomous, no panic, the EKF past its
    complementary phase, over 100 ranges taken, the estimate within 0.5 m of
    the truth and the truth within 0.5 m of the setpoint); then the anchors
    fall silent (max_range 0.01 m) and UWB_SILENCE_STEPS ticks later every
    env has panicked with PANIC_UWB_TIMEOUT."""
    import torch

    from agrifly_tpu_torch.models import logic
    from agrifly_tpu_torch.sim import cuda_rollout, env

    p, s0, cmd = env_mode_case(dev, "uwb", UWB_FLIGHT_ENVS)
    before = cuda_rollout.rollout.launches
    final, traj = env.rollout(p, s0, cmd, UWB_FLIGHT_STEPS, False, "position", gen=gen)
    sp = torch.tensor(ENV_MODES["uwb"]["hover"], device=dev)
    est_err = (final.logic.kf.pos - final.plant.pos).norm(dim=1)
    sp_err = (final.plant.pos - sp).norm(dim=1)
    _check(bool((final.logic.fs == logic.FS_FULLY_AUTONOMOUS).all())
           and bool((final.logic.panic_reason == logic.PANIC_NO_PANIC).all()),
           f"UWB flight: flight states {sorted(set(final.logic.fs.tolist()))}, panic reasons "
           f"{sorted(set(final.logic.panic_reason.tolist()))}")
    _check(bool(final.logic.kf.uwb_init.all()) and bool((final.logic.uwb_meas_count > 100).all()),
           f"UWB flight: uwb_init {final.logic.kf.uwb_init.float().mean():.3f}, fewest ranges "
           f"{int(final.logic.uwb_meas_count.min())}")
    _check(float(est_err.max()) < 0.5 and float(sp_err.max()) < 0.5,
           f"UWB flight: estimate {float(est_err.max()):.3f} m from the truth, truth "
           f"{float(sp_err.max()):.3f} m from the setpoint")
    dead = env.with_uwb_anchors(p, UWB_ANCHOR_IDS, UWB_ANCHOR_POS, noise_std=0.05,
                                comm_period=0.01, max_range=0.01)
    silent, _ = env.rollout(dead, final, cmd, UWB_SILENCE_STEPS, False, "position", gen=gen)
    _check(bool((silent.logic.fs == logic.FS_PANIC).all())
           and bool((silent.logic.panic_reason == logic.PANIC_UWB_TIMEOUT).all()),
           f"UWB silence: flight states {sorted(set(silent.logic.fs.tolist()))}, panic reasons "
           f"{sorted(set(silent.logic.panic_reason.tolist()))}")
    launches = cuda_rollout.rollout.launches - before
    print(f"env_rollout UWB flight (tests/test_uwb.py's), {UWB_FLIGHT_ENVS} envs x "
          f"{UWB_FLIGHT_STEPS} steps through K5: every env fully autonomous, no panic, uwb_init, "
          f"ranges {int(final.logic.uwb_meas_count.min())}..{int(final.logic.uwb_meas_count.max())}"
          f", estimate within {float(est_err.max()):.4f} m of the truth, truth within "
          f"{float(sp_err.max()):.4f} m of the setpoint; then {UWB_SILENCE_STEPS} steps with the "
          f"anchors silent: every env PANIC_UWB_TIMEOUT ({launches} launches)")


def check_env_modes(dev):
    """K5 in its estimator and UWB modes (ENV_MODES), each at bench.py's shape
    (ENVS envs x ENV_STEPS steps): every G bit-equal to G = 1; the default G
    against the plain rollout on the card (ENV_CHECK_ENVS envs) and on the
    CPU from mid-flight; the device time of every G at B = 1, 64 and ENVS;
    the bench call through env.rollout_fast (ENV_CALLS timed calls, the
    noise and UWB draws drawn inside; steps/s and the host's return time),
    its launches counted from 0; K5's rows at 1 and ENVS envs (wrapper ms,
    device time, bound) and the plain vmapped rollout's ms a step at ENVS
    envs. Then the onboard-UWB flight and its silence (check_uwb_flight).
    The new modes are held to the tick criteria against the plain rollout
    on the card and on the CPU."""
    import torch

    from agrifly_tpu_torch.sim import cuda_rollout, env, uwb

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for name, mode in ENV_MODES.items():
        est, ctrl = mode["use_estimator"], mode["ctrl"]
        p, s0, cmd = env_mode_case(dev, name, ENVS)
        noise = torch.randn((ENVS, ENV_STEPS, 2, 3), generator=gen, device=dev)
        draws = uwb.draw((ENVS, ENV_STEPS), gen, dev) if name == "uwb" else None

        def launcher(B, group, n=ENV_STEPS):
            sub = lambda t: None if t is None else t[:B, :n].contiguous()  # noqa: E731
            return env_launcher(p, env_subset(s0, slice(0, B)), cmd, sub(noise), est, group,
                                ctrl=ctrl, draws=sub(draws))

        specs, _ = cuda_rollout.leaf_table(draws is not None)
        k5_groups_equal(lambda g: launcher(ENVS, g)(),
                        [".".join(spec.path) for spec in specs] + list(env.StepOutputs._fields),
                        f"{name}, {ENVS} envs x {ENV_STEPS} steps")

        sub = env_subset(s0, slice(0, ENV_CHECK_ENVS))
        worst, err, mid, _ = check_env_against_plain(
            p, sub, cmd, noise[:ENV_CHECK_ENVS].contiguous(), est, ctrl,
            None if draws is None else draws[:ENV_CHECK_ENVS].contiguous())
        worst_cpu = check_env_against_cpu(p, mid, cmd, est, dev, ctrl)

        dev_us = {(B, g): device_us(launcher(B, g), reps=3)
                  for B in ENV_TIMED_ENVS for g in cuda_rollout.GROUPS}
        for B in ENV_TIMED_ENVS:
            print(f"env_rollout device time per call, {B} envs x {ENV_STEPS} steps, {name} "
                  "(bare launch): " + "; ".join(f"G={g} {us_text(dev_us[B, g])}"
                                                for g in cuda_rollout.GROUPS))

        # the bench call, its launches counted from 0
        cuda_rollout.rollout.launches = 0
        bench_calls(lambda: env.rollout_fast(p, s0, cmd, ENV_STEPS, use_estimator=est,
                                             ctrl_mode=ctrl, gen=gen),
                    f"{name} bench call", dev_us[ENVS, cuda_rollout.GROUP],
                    "the noise" if draws is None else "the noise and UWB draws")
        launches = cuda_rollout.rollout.launches
        _check(launches == ENV_CALLS + 1, f"env_rollout {name}: {launches} launches")
        print(f"env_rollout {name} bench call: {launches} launches of K5 in "
              f"{ENV_CALLS + 1} calls")

        # the plain vmapped rollout at ENVS envs (after a warm-up pass), and
        # K5's rows
        for _ in range(2):
            t0 = time.perf_counter()
            env.rollout_plain(p, s0, cmd, noise[:, :ENV_PLAIN_STEPS], est, ctrl,
                              uwb_draws=None if draws is None else draws[:, :ENV_PLAIN_STEPS])
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0) / ENV_PLAIN_STEPS
        print(f"env_rollout plain (vmapped torch) {name}: {plain_ms:.3f} ms per step at {ENVS} "
              f"envs (over {ENV_PLAIN_STEPS}); worst float leaf {max(worst, worst_cpu):.4g} x "
              f"bound, max abs err {err:.3g}")
        for B in (1, ENVS):
            k5_row(
                p, env_subset(s0, slice(0, B)), cmd, noise[:B].contiguous(), est, ctrl,
                None if draws is None else draws[:B].contiguous(), err,
                plain_ms * ENV_STEPS if B == ENVS else None,
                B * ENV_STEPS * ENV_MODE_TICK_OPS[name], dev_us[B, cuda_rollout.GROUP], name)
    check_uwb_flight(dev, gen)
    print(f"env_rollout modes (gpsimu, uwb): phase {time.perf_counter() - t_phase:.1f} s")


# sim/fleet_env (config #5). The wind fleet (K5's -DTICK_WIND build):
# tests/test_fleet_and_bridge.py's formation (4 vehicles 2 m apart, mean wind
# (2, 0, 0), gusts 1.0 m/s, gain 0.02, 3000 steps, the mocap estimator) and
# its windy drift (no IMU noise; calm against mean 8 m/s, gain 0.05; one
# vehicle, 2500 steps); the kernel held at FLEET_CHECK_ENVS x ENV_STEPS
# against the plain rollout on the card, and bench.py's shape (ENVS x
# ENV_STEPS) timed in both estimator modes. FLEET_TICK_OPS: ENV_TICK_OPS
# and the gust process and its force (~20 operations a tick).
FLEET_N, FLEET_STEPS, DRIFT_STEPS = 4, 3000, 2500
FLEET_CHECK_ENVS = 64
FLEET_WIND = dict(mean=(2.0, 0.0, 0.0), gust_std=1.0, gust_tau=2.0, force_gain=0.02)
FLEET_TICK_OPS = {False: ENV_TICK_OPS[False] + 20, True: ENV_TICK_OPS[True] + 20}
WIND_ROLLOUT = ("rollout", ("TICK_WIND",))  # K5's wind build
# The wind fleet whose vehicles each carry a UWB network of their own (K5's
# -DTICK_UWB -DTICK_WIND build): FLEET_WIND's gusts, and on every vehicle
# tests/test_fleet_and_bridge.py's five anchors (UWB_FLEET_IDS), 0.05 m range
# noise and a 5 ms network period; at bench.py's shape in both estimator
# modes. The vehicles (each alone with its anchors) start on a line
# WIND_UWB_SPACING apart inside the anchors' field, each holding 1.5 m above
# its start (on FLEET_WIND's 2 m line most would range anchors kilometres
# away, all in one direction). A few onboard EKFs, cold on the ground when
# the ranges begin, dip below the logic's sane height and panic
# (ONBOARD_ESTIMATE_CRAZY), as the JAX package's do on the same
# configuration (6 and 1 of 4096 on the card, 0 and 3 in the JAX package):
# the phase allows at most WIND_UWB_MAX_PANICS of them, for that reason only.
# WIND_UWB_TICK_OPS: the fleet sends rates commands, so a tick is
# ENV_TICK_OPS (the rates branch, not the UWB configuration's onboard
# position loop) with the onboard network (~100), the onboard EKF's full
# prediction (~600), the range update on one tick in six (~400 / 6) and the
# gusts (~20).
WIND_UWB_ROLLOUT = ("rollout", ("TICK_UWB", "TICK_WIND"))
WIND_UWB_PERIOD, WIND_UWB_NOISE, WIND_UWB_SPACING = 0.005, 0.05, 1.0 / 1024
WIND_UWB_MAX_PANICS = ENVS // 100
# The shared-UWB fleet (K6, csrc/fleet_uwb.cu): tests/test_fleet_and_bridge.py's
# three vehicles 1.5 m apart, five anchors, a 5 ms network period, 0.05 m
# range noise; 1500 idle ticks, then 6000 with position commands. Held
# against the plain version over UWB_CHECK_TICKS with a gusty wind (mean
# (1, 0, 0), 0.5 m/s, gain 0.01) so the wind code runs too; timed at N = 3
# and at the radio cap (28 vehicles and 5 anchors, 33 radios).
UWB_FLEET_IDS = (101, 102, 103, 104, 105)
UWB_FLEET_POS = ((-5.0, -4.0, 0.1), (6.0, -4.0, 3.0), (6.0, 6.0, 0.2), (-5.0, 6.0, 3.0),
                 (0.5, 1.0, 4.0))
UWB_FLEET_DES = ((0.0, 0.0, 1.5), (0.5, 1.5, 1.5), (1.0, 3.0, 1.5))
UWB_IDLE, UWB_FLY, UWB_CHECK_TICKS, UWB_TIMED_TICKS, UWB_CAP = 1500, 6000, 100, 1000, 28
# K6's float operations per vehicle and tick: the UWB configuration's
# ENV_MODE_TICK_OPS without the per-env network, the gusts (~20); and the
# network's scan of 33 radios (~150) once a tick
K6_VEHICLE_OPS, K6_NETWORK_OPS = ENV_MODE_TICK_OPS["uwb"] - 100 + 20, 150
WIND_UWB_TICK_OPS = {m: ENV_TICK_OPS[m] + 100 + 600 + 400 // 6 + 20 for m in (False, True)}


def fleet_case(dev, n, wind=FLEET_WIND, noise_scale=1.0, spacing=2.0):
    """(params, state) of a wind fleet of n vehicles on a line."""
    from agrifly_tpu_torch.sim import env, fleet_env

    p = fleet_env.FleetParams(env.make_params(noise_scale=noise_scale, device=dev),
                              fleet_env.make_wind(**wind, device=dev))
    return p, fleet_env.init_fleet(p, n, spacing=spacing)


def fleet_des(n, dev):
    import torch

    return torch.tensor([[0.0, 2.0 * i, 1.5] for i in range(n)], device=dev)


def wind_launcher(p, s, des, noise, gusts, mode, group, launcher=None, draws=None):
    """A bare launch of K5's wind build on fleet s (gusts (n, B, 3)); with
    draws (each vehicle's UWB draws (B, n, 4)), of its TICK_UWB + TICK_WIND
    build: returns fn() -> (new leaves, traj)."""
    import torch

    from agrifly_tpu_torch import cuda_build
    from agrifly_tpu_torch.sim import cuda_rollout, env

    uwb = draws is not None
    specs, pspecs = cuda_rollout.leaf_table(uwb, wind=True)
    B, dev = s.wind_vel.shape[0], noise.device
    s_entry = cuda_rollout._accept("state", s, dev, lambda leaves: cuda_build.check_leaves(
        specs, leaves, dev, "state", B, "tick.cuh"))
    p_entry = cuda_rollout._accept("params", p, dev, lambda leaves: cuda_build.check_leaves(
        pspecs, leaves, dev, "params", None, "tick.cuh"))
    z3 = torch.zeros(3, device=dev)
    rows = cuda_rollout._command(env.Command(des, z3, z3, z3[0], z3, z3), B, dev)
    words = cuda_rollout.fleet_draw_words(gusts, draws)
    return lambda: cuda_rollout._launch(s_entry, p_entry, rows, noise, mode, "rates", group,
                                        launcher, words, uwb=uwb, wind=True)


def fleet_draws(B, n, gen, dev):
    import torch

    return (torch.randn((B, n, 2, 3), generator=gen, device=dev),
            torch.randn((n, B, 3), generator=gen, device=dev))


def check_wind_kernel(dev, gen):
    """K5's wind build: every G bit-equal to G = 1 (ENVS x ENV_STEPS, both
    estimator modes); calm wind (sigma 0, gain 0) bit-equal to K5 without
    TICK_WIND on the same inputs; the default G against the plain rollout on
    the card (FLEET_CHECK_ENVS x ENV_STEPS, tick criteria, both modes).
    Returns (worst ratio, max abs err, plain ms of the mocap check)."""
    import torch

    from agrifly_tpu_torch.sim import cuda_rollout, env, fleet_env

    p, s0 = fleet_case(dev, ENVS)
    des = fleet_des(ENVS, dev)
    noise, gusts = fleet_draws(ENVS, ENV_STEPS, gen, dev)
    specs, _ = cuda_rollout.leaf_table(wind=True)
    names = [".".join(spec.path) for spec in specs] + list(env.StepOutputs._fields)
    for mode in (False, True):
        k5_groups_equal(lambda g: wind_launcher(p, s0, des, noise, gusts, mode, g)(), names,
                        f"wind fleet, use_estimator={mode}, {ENVS} envs x {ENV_STEPS} steps")

    # calm wind against K5 without TICK_WIND: the env leaves and the
    # trajectory equal, the gusts still at rest
    calm, c0 = fleet_case(dev, ENVS, wind=dict(mean=(0.0, 0.0, 0.0), gust_std=0.0, gust_tau=2.0,
                                               force_gain=0.0))
    z3 = torch.zeros(3, device=dev)
    for mode in (False, True):
        w_state, w_traj = wind_launcher(calm, c0, des, noise, gusts, mode, cuda_rollout.GROUP)()
        e_state, e_traj = env_launcher(calm.base, c0.envs, env.Command(des, z3, z3, z3[0], z3, z3),
                                       noise, mode, cuda_rollout.GROUP)()
        for a, b in zip(w_state[:-1] + w_traj, e_state + e_traj):
            _check(torch.equal(a, b), f"calm wind vs K5, use_estimator={mode}: a leaf differs")
        _check(not bool(w_state[-1].any()), "calm wind: the gusts moved")
    torch.cuda.synchronize()
    print(f"env_rollout wind build: calm wind (sigma 0, gain 0) bit-equal to K5 without TICK_WIND "
          f"at {ENVS} envs x {ENV_STEPS} steps, both estimator modes")

    # against the plain rollout, as K5's check_env_against_plain holds K5:
    # the first ENV_CHECK_STEPS steps by the tick criteria, all ENV_STEPS by
    # JAX's rollout_fast terms (flight state and panic equal, final
    # position within 0.05 m), with the tick criteria's reading there
    worst = err = 0.0
    plain_ms = None
    sub, n = slice(0, FLEET_CHECK_ENVS), ENV_CHECK_STEPS
    s = fleet_env.FleetState(env_subset(s0.envs, sub), s0.wind_vel[sub].contiguous())
    nz, gs = noise[sub].contiguous(), gusts[:, sub].contiguous()
    for mode in (True, False):
        where = f"K5 wind vs plain, use_estimator={mode}"
        head = (nz[:, :n].contiguous(), gs[:n].contiguous())
        got = fleet_env.fleet_rollout(p, s, des[sub], n, mode, *head)[0]
        full = fleet_env.fleet_rollout(p, s, des[sub], ENV_STEPS, mode, noise=nz, wind_noise=gs)[0]
        fleet_env.fleet_rollout_plain(p, s, des[sub], nz[:, :1], gs[:1], mode)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = fleet_env.fleet_rollout_plain(p, s, des[sub], *head, mode)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n * ENV_STEPS
        t0 = time.perf_counter()
        ref_end = plain_fleet_graphed(p, ref, des[sub], nz[:, n:].contiguous(),
                                      gs[n:].contiguous(), mode)
        torch.cuda.synchronize()
        graph_ms = 1e3 * (time.perf_counter() - t0) / (ENV_STEPS - n)
        w = compare_ticks(got, ref, f"{where}, {n} steps", env=("envs",))
        e = max_abs_err(got, ref)
        worst, err = max(worst, w), max(err, e)
        plain_ms = ms if mode else plain_ms
        for name in ("fs", "panic_reason"):
            _check(torch.equal(getattr(full.envs.logic, name), getattr(ref_end.envs.logic, name)),
                   f"{where}: {name} differs after {ENV_STEPS} steps")
        dpos = float((full.envs.plant.pos - ref_end.envs.plant.pos).abs().max())
        _check(dpos <= 0.05, f"{where}: final position {dpos:.3g} m apart")
        r250 = tick_reading(full, ref_end, env=("envs",))
        print(f"env_rollout wind build vs plain on the card, use_estimator={mode}, "
              f"{FLEET_CHECK_ENVS} envs: {n} steps discrete leaves equal, worst float leaf "
              f"{w:.4g} x bound, max abs err {e:.3g}; {ENV_STEPS} steps flight state and panic "
              f"equal, final position {dpos:.3g} m apart, the tick criteria's reading "
              f"{r250[0]:.4g} x bound ({r250[1]} discrete leaves differ, wire codes {r250[2]} "
              f"apart); the plain rollout {ms:.1f} ms ({ms / ENV_STEPS:.3f} ms a step over its "
              f"first {n}, eager; the other {ENV_STEPS - n} replayed as a CUDA graph of the eager "
              f"step, {graph_ms:.3f} ms a step)")
    return worst, err, plain_ms


def fleet_flights(dev, gen):
    """tests/test_fleet_and_bridge.py's formation under wind (FLEET_N x
    FLEET_STEPS through fleet_rollout: every vehicle within 0.4 m of its
    setpoint, no panic, the gusts moved) and its windy drift (x apart by
    more than 0.02 m after DRIFT_STEPS)."""
    import torch

    from agrifly_tpu_torch.sim import fleet_env

    p, s = fleet_case(dev, FLEET_N)
    des = fleet_des(FLEET_N, dev)
    t0 = time.perf_counter()
    final, _ = fleet_env.fleet_rollout(p, s, des, FLEET_STEPS, gen=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = (final.envs.plant.pos - des).norm(dim=1)
    moved = float((final.wind_vel - torch.tensor(FLEET_WIND["mean"], device=dev)).abs().max())
    _check(bool((err < 0.4).all()) and bool((final.envs.logic.panic_reason == 0).all())
           and moved > 1e-3, f"formation: errors {err.tolist()}, panic "
           f"{final.envs.logic.panic_reason.tolist()}, gusts moved {moved:.3g}")
    x = []
    for wind in (dict(mean=(0.0, 0.0, 0.0), gust_std=0.0, gust_tau=2.0, force_gain=0.0),
                 dict(mean=(8.0, 0.0, 0.0), gust_std=0.0, gust_tau=2.0, force_gain=0.05)):
        pw, sw = fleet_case(dev, 1, wind=wind, noise_scale=0.0)
        f, _ = fleet_env.fleet_rollout(pw, sw, torch.tensor([[0.0, 0.0, 1.5]], device=dev),
                                       DRIFT_STEPS, gen=gen)
        x.append(float(f.envs.plant.pos[0, 0]))
    _check(abs(x[1] - x[0]) > 0.02, f"windy drift: x {x}")
    print(f"fleet_env formation under wind, {FLEET_N} vehicles x {FLEET_STEPS} steps in one "
          f"call ({1e3 * wall:.1f} ms): every error < 0.4 m (max {float(err.max()):.4f}), no "
          f"panic, gusts moved {moved:.3f} m/s; windy drift over {DRIFT_STEPS} steps: x calm "
          f"{x[0]:.4f} m, windy {x[1]:.4f} m")


def check_fleet_wind(dev):
    """sim/fleet_env's wind fleet on the card (K5's -DTICK_WIND build):
    check_wind_kernel, fleet_flights, then bench.py's shape through
    fleet_rollout (ENVS vehicles x ENV_STEPS steps, ENV_CALLS timed calls
    per estimator mode, the draws drawn inside) with its launches counted
    from 0, and K5-wind's device time beside K5's in the same call on the
    same inputs. Returns the kernel's line and its launches."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_rollout, env, fleet_env

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    worst, err, plain_ms = check_wind_kernel(dev, gen)
    fleet_flights(dev, gen)

    p, s0 = fleet_case(dev, ENVS)
    des = fleet_des(ENVS, dev)
    noise, gusts = fleet_draws(ENVS, ENV_STEPS, gen, dev)
    z3 = torch.zeros(3, device=dev)
    cmd = env.Command(des, z3, z3, z3[0], z3, z3)
    dev_us = {}
    for mode in (False, True):  # in turns: K5, K5-wind, K5-wind, K5
        k5 = env_launcher(p.base, s0.envs, cmd, noise, mode, cuda_rollout.GROUP)
        k5w = wind_launcher(p, s0, des, noise, gusts, mode, cuda_rollout.GROUP)
        t = [device_us(fn, reps=3) for fn in (k5, k5w, k5w, k5)]
        dev_us[mode] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
        print(f"env_rollout device time per call, {ENVS} envs x {ENV_STEPS} steps, use_estimator="
              f"{mode}, in turns: K5 {us_text(t[0])}, K5-wind {us_text(t[1])}, K5-wind "
              f"{us_text(t[2])}, K5 {us_text(t[3])} (K5-wind / K5 "
              f"{dev_us[mode][1] / dev_us[mode][0]:.4f})")

    # the main path: fleet_rollout at bench.py's shape, launches from 0
    fleet_rollout_launches = 0
    for mode in (True, False):
        cuda_rollout.fleet_rollout.launches = 0
        final, _ = fleet_env.fleet_rollout(p, s0, des, ENV_STEPS, mode, gen=gen)
        torch.cuda.synchronize()
        t0, host = time.perf_counter(), 0.0
        for _ in range(ENV_CALLS):
            t1 = time.perf_counter()
            final, _ = fleet_env.fleet_rollout(p, s0, des, ENV_STEPS, mode, gen=gen)
            host += time.perf_counter() - t1
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = cuda_rollout.fleet_rollout.launches
        _check(launches == ENV_CALLS + 1, f"fleet_rollout: {launches} launches")
        fleet_rollout_launches += launches
        _check(bool(torch.isfinite(final.envs.plant.pos).all())
               and bool((final.envs.step == ENV_STEPS).all())
               and bool((final.envs.logic.panic_reason == 0).all()),
               f"fleet_rollout use_estimator={mode}: non-finite, a panic, or steps")
        print(f"fleet_rollout use_estimator={mode}: "
              f"{ENVS * ENV_STEPS * ENV_CALLS / elapsed:.1f} steps/s at {ENVS} vehicles x "
              f"{ENV_STEPS} steps ({ENV_CALLS} timed calls of {1e3 * elapsed / ENV_CALLS:.3f} ms, "
              f"the noise and gust normals drawn inside; the host returns from a call in "
              f"{1e3 * host / ENV_CALLS:.3f} ms; K5-wind's device time "
              f"{us_text(dev_us[mode][1])}); {launches} launches of K5-wind in {ENV_CALLS + 1} "
              f"calls; final z mean {float(final.envs.plant.pos[:, 2].mean()):.4f} m")

    # the bound at bench.py's shape
    for mode in (False, True):
        new, traj = wind_launcher(p, s0, des, noise, gusts, mode, cuda_rollout.GROUP)()
        n_bytes = env_bytes(convert.flatten_tensors(s0)[0], cuda_rollout.param_leaves(p), [des],
                            noise, new, traj) + nbytes(gusts)
        r = result(0.0, 0.0, None, n_bytes, ENVS * ENV_STEPS * FLEET_TICK_OPS[mode])
        print(f"env_rollout wind build, {ENVS} vehicles x {ENV_STEPS} steps, use_estimator={mode}:"
              f" bound {r['bound_ms']:.6f} ms ({r['bound_by']})")

    # the kernel's line: the default mode (mocap) at FLEET_CHECK_ENVS, where
    # the plain rollout was timed, and its bound
    sub = slice(0, FLEET_CHECK_ENVS)
    s = fleet_env.FleetState(env_subset(s0.envs, sub), s0.wind_vel[sub].contiguous())
    nz, gs = noise[sub].contiguous(), gusts[:, sub].contiguous()
    ms = cuda_ms(lambda: fleet_env.fleet_rollout(p, s, des[sub], ENV_STEPS, True, noise=nz,
                                                 wind_noise=gs), reps=5, warmup=1)
    leaves, pleaves = convert.flatten_tensors(s)[0], cuda_rollout.param_leaves(p)
    launch = wind_launcher(p, s, des[sub], nz, gs, True, cuda_rollout.GROUP)
    new, traj = launch()
    n_bytes = env_bytes(leaves, pleaves, [des[sub]], nz, new, traj) + nbytes(gs)
    res = result(err, ms, plain_ms, n_bytes, FLEET_CHECK_ENVS * ENV_STEPS * FLEET_TICK_OPS[True])
    print(f"env_rollout wind build, {FLEET_CHECK_ENVS} vehicles x {ENV_STEPS} steps, mocap: "
          f"wrapper {ms:.4f} ms, device {us_text(device_us(launch, reps=3))}, plain "
          f"{plain_ms:.1f} ms, bound {res['bound_ms']:.6f} ms "
          f"({res['bound_by']}); worst float leaf {worst:.4g} x bound; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return res, fleet_rollout_launches


def wind_uwb_case(dev, n):
    """(params, state, setpoints, the network-free fleet's (params, state))
    of FLEET_WIND's fleet of n vehicles on a line WIND_UWB_SPACING apart
    whose vehicles each range UWB_FLEET_IDS' anchors on a network of their
    own, each holding 1.5 m above its start."""
    import torch

    from agrifly_tpu_torch.sim import env, fleet_env

    free, s_free = fleet_case(dev, n, spacing=WIND_UWB_SPACING)
    base = env.with_uwb_anchors(free.base, UWB_FLEET_IDS, UWB_FLEET_POS,
                                comm_period=WIND_UWB_PERIOD, noise_std=WIND_UWB_NOISE)
    p = free._replace(base=base)
    s0 = fleet_env.init_fleet(p, n, spacing=WIND_UWB_SPACING)
    des = s0.envs.plant.pos + torch.tensor([0.0, 0.0, 1.5], device=dev)
    return p, s0, des, (free, s_free)


def check_fleet_wind_uwb(dev):
    """sim/fleet_env's wind fleet whose vehicles each carry a UWB network of
    their own, on the card (K5's -DTICK_UWB -DTICK_WIND build), at bench.py's
    shape (ENVS vehicles x ENV_STEPS steps) in both estimator modes: every G
    bit-equal to G = 1; fleet_rollout (the main path: ENV_CALLS + 1 calls a
    mode, the draws drawn inside, its launches counted from 0); fleet_rollout
    bit-equal to fleet_rollout_plain on the card; from the kernel's final
    state, ENV_CPU_ENVS vehicles x ENV_CHECK_STEPS steps against the plain
    rollout on the CPU by the tick criteria; the device time in turns with
    K5-UWB (the env rollout on the same base, state and draws) and K5-wind
    (the network-free fleet on the same draws). Returns the kernel's line
    (mocap, at ENVS) and its launches."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.models import logic as logic_mod
    from agrifly_tpu_torch.sim import cuda_rollout, env, fleet_env, uwb

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    p, s0, des, (free, s_free) = wind_uwb_case(dev, ENVS)
    noise, gusts = fleet_draws(ENVS, ENV_STEPS, gen, dev)
    draws = uwb.draw((ENVS, ENV_STEPS), gen, dev)
    specs, _ = cuda_rollout.leaf_table(uwb=True, wind=True)
    names = [".".join(spec.path) for spec in specs] + list(env.StepOutputs._fields)
    for mode in (False, True):
        k5_groups_equal(lambda g: wind_launcher(p, s0, des, noise, gusts, mode, g,
                                                draws=draws)(), names,
                        f"wind fleet with onboard UWB, use_estimator={mode}, {ENVS} vehicles x "
                        f"{ENV_STEPS} steps")

    # the main path: fleet_rollout at bench.py's shape, launches from 0
    launches = 0
    for mode in (True, False):
        cuda_rollout.fleet_rollout.launches = 0
        t0, host = time.perf_counter(), 0.0
        for _ in range(ENV_CALLS + 1):
            t1 = time.perf_counter()
            final, _ = fleet_env.fleet_rollout(p, s0, des, ENV_STEPS, mode, gen=gen)
            host += time.perf_counter() - t1
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        n = cuda_rollout.fleet_rollout.launches
        _check(n == ENV_CALLS + 1, f"fleet_rollout with onboard UWB: {n} launches")
        launches += n
        logic = final.envs.logic
        faults = {"non-finite": int((~torch.isfinite(final.envs.plant.pos)).any(1).sum()),
                  "steps": int((final.envs.step != ENV_STEPS).sum()),
                  "no range": int((logic.uwb_meas_count == 0).sum())}
        _check(not any(faults.values()), f"fleet_rollout with onboard UWB, use_estimator={mode}: "
               f"vehicles at fault {faults}")
        panics = int((logic.panic_reason != logic_mod.PANIC_NO_PANIC).sum())
        reasons = set(logic.panic_reason.tolist()) - {logic_mod.PANIC_NO_PANIC}
        _check(panics <= WIND_UWB_MAX_PANICS
               and reasons <= {logic_mod.PANIC_ONBOARD_ESTIMATE_CRAZY},
               f"fleet_rollout with onboard UWB, use_estimator={mode}: {panics} vehicles "
               f"panicked (reasons {sorted(reasons)}), at most {WIND_UWB_MAX_PANICS} allowed, "
               f"for ONBOARD_ESTIMATE_CRAZY only")
        print(f"fleet_rollout with onboard UWB, use_estimator={mode}: {n} launches of "
              f"K5-wind-UWB in {ENV_CALLS + 1} calls of {ENVS} vehicles x {ENV_STEPS} steps "
              f"({1e3 * elapsed / (ENV_CALLS + 1):.3f} ms a call, the draws drawn inside; the host "
              f"returns in {1e3 * host / (ENV_CALLS + 1):.3f} ms); ranges taken per vehicle "
              f"{float(logic.uwb_meas_count.float().mean()):.2f} on average; {panics} vehicles "
              f"panicked (reasons {sorted(set(logic.panic_reason.tolist()))})")

    # against the plain rollout on the card (bit for bit: its first
    # ENV_CHECK_STEPS steps eager and timed, the rest replayed as a CUDA
    # graph of its eager step) and, from the kernel's final state, on the
    # CPU (tick criteria)
    worst, err, plain_ms, mids = 0.0, 0.0, None, {}
    n = ENV_CHECK_STEPS
    for mode in (True, False):
        where = f"K5-wind-UWB vs plain on the card, use_estimator={mode}"
        got = fleet_env.fleet_rollout(p, s0, des, ENV_STEPS, mode, noise=noise, wind_noise=gusts,
                                      uwb_draws=draws)[0]
        fleet_env.fleet_rollout_plain(p, s0, des, noise[:, :1], gusts[:1], mode,
                                      draws[:, :1])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        head = fleet_env.fleet_rollout_plain(p, s0, des, noise[:, :n], gusts[:n], mode,
                                             draws[:, :n])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n * ENV_STEPS
        t0 = time.perf_counter()
        ref = plain_fleet_graphed(p, head, des, noise[:, n:], gusts[n:], mode, draws[:, n:])
        torch.cuda.synchronize()
        graph_ms = 1e3 * (time.perf_counter() - t0) / (ENV_STEPS - n)
        plain_ms = ms if mode else plain_ms
        differ = [".".join(path) for (path, a), (_, b) in zip(convert.leaves(got),
                                                               convert.leaves(ref))
                  if not torch.equal(a, b)]
        if differ:
            _check(False, f"{where}: {len(differ)} leaves differ ({differ[:4]}); the tick "
                          f"criteria's reading {tick_reading(got, ref, env=('envs',))}")
        err = max(err, max_abs_err(got, ref))
        mids[mode] = got
        print(f"{where}, {ENVS} vehicles x {ENV_STEPS} steps: every leaf bit-equal; the plain "
              f"rollout {ms:.1f} ms ({ms / ENV_STEPS:.3f} ms a step over its first {n}, eager; the "
              f"other {ENV_STEPS - n} replayed as a CUDA graph of the eager step, "
              f"{graph_ms:.3f} ms a step)")
    cpu_gen = torch.Generator().manual_seed(SEED + 12)
    c_noise = torch.randn((ENV_CPU_ENVS, ENV_CHECK_STEPS, 2, 3), generator=cpu_gen)
    c_gusts = torch.randn((ENV_CHECK_STEPS, ENV_CPU_ENVS, 3), generator=cpu_gen)
    c_draws = uwb.draw((ENV_CPU_ENVS, ENV_CHECK_STEPS), cpu_gen)
    sub = slice(0, ENV_CPU_ENVS)
    for mode, mid in mids.items():
        s = fleet_env.FleetState(env_subset(mid.envs, sub), mid.wind_vel[sub].contiguous())
        got = fleet_env.fleet_rollout(p, s, des[sub], ENV_CHECK_STEPS, mode,
                                      noise=c_noise.to(dev), wind_noise=c_gusts.to(dev),
                                      uwb_draws=c_draws.to(dev))[0]
        ref = fleet_env.fleet_rollout(to_device(p, "cpu"), to_device(s, "cpu"), des[sub].cpu(),
                                      ENV_CHECK_STEPS, mode, noise=c_noise, wind_noise=c_gusts,
                                      uwb_draws=c_draws)[0]
        w = compare_ticks(got, ref, f"K5-wind-UWB on the card vs plain on the CPU, "
                                    f"use_estimator={mode}", env=("envs",))
        worst = max(worst, w)
        print(f"fleet_rollout with onboard UWB, use_estimator={mode}, from step "
              f"{int(s.envs.step[0])}, {ENV_CPU_ENVS} vehicles x {ENV_CHECK_STEPS} steps, kernel "
              f"on the card vs plain on the CPU: discrete leaves equal, worst float leaf "
              f"{w:.4g} x bound")

    # device times in turns on the same inputs: K5-UWB, K5-wind, K5-wind-UWB
    # twice, K5-wind, K5-UWB
    z3 = torch.zeros(3, device=dev)
    cmd = env.Command(des, z3, z3, z3[0], z3, z3)
    dev_us = {}
    for mode in (False, True):
        fns = {"K5-UWB": env_launcher(p.base, s0.envs, cmd, noise, mode, cuda_rollout.GROUP,
                                      draws=draws),
               "K5-wind": wind_launcher(free, s_free, des, noise, gusts, mode, cuda_rollout.GROUP),
               "K5-wind-UWB": wind_launcher(p, s0, des, noise, gusts, mode, cuda_rollout.GROUP,
                                            draws=draws)}
        order = ["K5-UWB", "K5-wind", "K5-wind-UWB", "K5-wind-UWB", "K5-wind", "K5-UWB"]
        t = [device_us(fns[k], reps=3) for k in order]
        dev_us[mode] = {k: sum(v for o, v in zip(order, t) if o == k) / 2 for k in fns}
        print(f"env_rollout device time per call, {ENVS} envs x {ENV_STEPS} steps, use_estimator="
              f"{mode}, in turns: " + ", ".join(f"{k} {us_text(v)}" for k, v in zip(order, t))
              + f" (K5-wind-UWB / K5-UWB {dev_us[mode]['K5-wind-UWB'] / dev_us[mode]['K5-UWB']:.4f}"
              f", / K5-wind {dev_us[mode]['K5-wind-UWB'] / dev_us[mode]['K5-wind']:.4f})")

    # the bound, and the kernel's line at bench.py's shape (mocap)
    leaves, pleaves = convert.flatten_tensors(s0)[0], cuda_rollout.param_leaves(p)
    rows = {}
    for mode in (False, True):
        new, traj = wind_launcher(p, s0, des, noise, gusts, mode, cuda_rollout.GROUP,
                                  draws=draws)()
        n_bytes = env_bytes(leaves, pleaves, [des], noise, new, traj) + nbytes(gusts, draws)
        ms = cuda_ms(lambda: fleet_env.fleet_rollout(p, s0, des, ENV_STEPS, mode, noise=noise,
                                                     wind_noise=gusts, uwb_draws=draws),
                     reps=5, warmup=1)
        rows[mode] = result(err, ms, plain_ms if mode else None, n_bytes,
                            ENVS * ENV_STEPS * WIND_UWB_TICK_OPS[mode])
        print(f"env_rollout wind + UWB build, {ENVS} vehicles x {ENV_STEPS} steps, use_estimator="
              f"{mode}: wrapper {ms:.4f} ms, device {us_text(dev_us[mode]['K5-wind-UWB'])}, bound "
              f"{rows[mode]['bound_ms']:.6f} ms ({rows[mode]['bound_by']})")
    print(f"env_rollout wind + UWB build: worst float leaf {worst:.4g} x bound against the CPU; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return rows[True], launches


def uwb_fleet_case(dev, n, wind=None):
    """(params, state, setpoints) of the shared-UWB fleet of n vehicles with
    UWB_FLEET_IDS' anchors (setpoints UWB_FLEET_DES, or a line for n > 3)."""
    import torch

    from agrifly_tpu_torch.sim import fleet_env

    w = None if wind is None else fleet_env.make_wind(**wind, device=dev)
    p = fleet_env.make_uwb_fleet_params(n, UWB_FLEET_IDS, UWB_FLEET_POS, wind=w,
                                        comm_period=0.005, noise_std=0.05, noise_scale=1.0,
                                        device=dev)
    des = (torch.tensor(UWB_FLEET_DES, device=dev) if n == 3 else
           torch.tensor([[0.5 * (i % 4), 1.5 * (i // 4), 1.5] for i in range(n)], device=dev))
    return p, fleet_env.init_uwb_fleet(p, spacing=1.5), des


def uwb_draws(n, steps, gen, dev):
    import torch

    from agrifly_tpu_torch.sim import uwb

    return (torch.randn((n, steps, 2, 3), generator=gen, device=dev),
            torch.randn((steps, n, 3), generator=gen, device=dev), uwb.draw((steps,), gen, dev))


def check_fleet_uwb(dev):
    """K6, the shared-UWB fleet kernel: against the plain version on the
    card over UWB_CHECK_TICKS (idle, then position, a gusty wind; the
    network's state and latch_start equal, floats by the tick criteria);
    every G bit-equal to G = 1; tests/test_fleet_and_bridge.py's flight
    (UWB_IDLE idle + UWB_FLY position ticks, two uwb_fleet_rollout calls,
    its launches counted from 0) held to that test's assertions; K6's µs
    per tick at N = 3 and at the radio cap. Returns the kernel's line and
    its launches."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_fleet_uwb, cuda_rollout, fleet_env

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    p, s, des = uwb_fleet_case(dev, 3, wind=dict(mean=(1.0, 0.0, 0.0), gust_std=0.5,
                                                 gust_tau=2.0, force_gain=0.01))
    worst = err = 0.0
    for ctrl in ("idle", "position"):
        draws = uwb_draws(3, UWB_CHECK_TICKS, gen, dev)
        case = (p, s, des, draws)
        got = fleet_env.uwb_fleet_rollout(p, s, des, UWB_CHECK_TICKS, ctrl, *draws)[0]
        for g in cuda_rollout.GROUPS:
            other = cuda_fleet_uwb.rollout(p, s, des, *draws, ctrl, group=g)
            for (path, a), (_, b) in zip(convert.leaves(other), convert.leaves(got)):
                _check(torch.equal(a, b), f"K6 G={g} vs G={cuda_fleet_uwb.GROUP}: {path}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = fleet_env.uwb_fleet_rollout_plain(p, s, des, *draws, ctrl)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)  # the line's: the position check's
        w = compare_ticks(got, ref, f"K6 vs plain, {ctrl}", env=("envs",))
        e = max_abs_err(got, ref)
        worst, err = max(worst, w), max(err, e)
        print(f"fleet_uwb K6 vs plain on the card, 3 vehicles, {ctrl}, {UWB_CHECK_TICKS} ticks: "
              f"the network ({[int(t) for t in got.uwb]}) and latch_start "
              f"({int(got.latch_start)}) equal, discrete leaves equal, worst float leaf {w:.4g} x "
              f"bound, max abs err {e:.3g}; ranges {got.envs.logic.uwb_meas_count.tolist()}; "
              f"every G in {cuda_rollout.GROUPS} bit-equal")
        s = got

    # the flight, its launches counted from 0
    p, s, des = uwb_fleet_case(dev, 3)
    cuda_fleet_uwb.rollout.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, _ = fleet_env.uwb_fleet_rollout(p, s, des, UWB_IDLE, "idle", gen=gen)
    final, _ = fleet_env.uwb_fleet_rollout(p, s, des, UWB_FLY, gen=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_fleet_uwb.rollout.launches
    _check(launches == 2, f"uwb_fleet_rollout: {launches} launches")
    pos = final.envs.plant.pos
    e = (pos - des).norm(dim=1)
    counts = final.envs.logic.uwb_meas_count
    _check(bool((e < 1.0).all()) and bool((pos[:, 2] > 0.5).all())
           and bool((final.envs.logic.panic_reason == 0).all()) and bool((counts > 100).all())
           and bool(final.envs.logic.kf.uwb_init.all()),
           f"UWB fleet flight: errors {e.tolist()}, z {pos[:, 2].tolist()}, panic "
           f"{final.envs.logic.panic_reason.tolist()}, ranges {counts.tolist()}")
    print(f"fleet_uwb flight (tests/test_fleet_and_bridge.py's), 3 vehicles, {UWB_IDLE} idle + "
          f"{UWB_FLY} position ticks in {launches} launches of K6: {1e3 * wall:.1f} ms wall; "
          f"errors {[round(float(x), 4) for x in e]} m, ranges {counts.tolist()}, no panic, "
          f"uwb_init, latch_start {int(final.latch_start)}")

    # µs per tick at N = 3 and at the cap, and the bound of those launches
    us = {}
    for n in (3, UWB_CAP):
        pn, sn, dn = uwb_fleet_case(dev, n)
        draws = uwb_draws(n, UWB_TIMED_TICKS, gen, dev)
        us[n] = device_us(lambda: cuda_fleet_uwb.rollout(pn, sn, dn, *draws, "position"),
                          reps=3) / UWB_TIMED_TICKS
        r = result(0.0, 0.0, None, 2 * nbytes(*convert.flatten_tensors(sn)[0])
                   + nbytes(*convert.flatten_tensors(pn)[0], dn, *draws),
                   UWB_TIMED_TICKS * (n * K6_VEHICLE_OPS + K6_NETWORK_OPS))
        print(f"fleet_uwb K6, {n} vehicles and 5 anchors, {UWB_TIMED_TICKS} ticks: device "
              f"{us[n]:.3f} us a tick, bound {r['bound_ms']:.6f} ms a launch ({r['bound_by']})")
    print(f"fleet_uwb K6 device time per tick ({UWB_TIMED_TICKS}-tick launches, position): "
          f"N = 3 with 5 anchors {us[3]:.3f} us; N = {UWB_CAP} with 5 anchors (the cap, "
          f"{UWB_CAP + 5} radios) {us[UWB_CAP]:.3f} us")

    # the kernel's line: the position check's inputs (3 vehicles,
    # UWB_CHECK_TICKS ticks), where the plain version was timed
    p, s, des, draws = case
    ms = cuda_ms(lambda: fleet_env.uwb_fleet_rollout(p, s, des, UWB_CHECK_TICKS, "position",
                                                     *draws), reps=5, warmup=1)
    dev_us = device_us(lambda: cuda_fleet_uwb.rollout(p, s, des, *draws, "position"), reps=3)
    leaves = convert.flatten_tensors(s)[0]
    n_bytes = 2 * nbytes(*leaves) + nbytes(*convert.flatten_tensors(p)[0], des, *draws)
    res = result(err, ms, plain_ms, n_bytes,
                 UWB_CHECK_TICKS * (3 * K6_VEHICLE_OPS + K6_NETWORK_OPS))
    print(f"fleet_uwb K6, 3 vehicles x {UWB_CHECK_TICKS} ticks: wrapper {ms:.4f} ms, device "
          f"{us_text(dev_us)}, plain "
          f"{plain_ms:.1f} ms, bound {res['bound_ms']:.6f} ms ({res['bound_by']}); worst float "
          f"leaf {worst:.4g} x bound; phase {time.perf_counter() - t_phase:.1f} s")
    return res, launches


# fleet_uwb.cu's Section enum, in order (-DFLEET_SECTIONS)
FLEET_SECTIONS = ("tick", "phase_a", "radio", "plant", "imu", "net_wait", "net_step",
                  "net_stage", "wait_broadcast", "logic", "logic_pre", "ekf_predict",
                  "cov_predict", "range", "rest", "offboard", "mocap_update", "replay_update",
                  "prediction")
TIMED_FLEET = ("fleet_uwb", ("FLEET_SECTIONS",))  # cuda_build.load's arguments
FLEET_SECTION_LAUNCHES = 3  # timed launches of UWB_TIMED_TICKS ticks, after one warm-up


def fleet_sections(dev):
    """Cycles per tick of each Section of K6 (fleet_uwb.cu's FLEET_SECTIONS
    build, clock64 timers on vehicle 0's lane 0 and on the network's
    thread) over FLEET_SECTION_LAUNCHES launches of UWB_TIMED_TICKS position
    ticks, at N = 3 and UWB_CAP vehicles with 5 anchors, at every G; and the
    tick's measured time (its cycles over the card's maximum SM clock). The
    launches are not counted in cuda_fleet_uwb.rollout.launches."""
    import ctypes

    import torch

    from agrifly_tpu_torch import cuda_build
    from agrifly_tpu_torch.sim import cuda_fleet_uwb, cuda_rollout

    lib = cuda_build.load(*TIMED_FLEET)
    fn = lib.fleet_uwb_launch
    fn.argtypes, fn.restype = cuda_fleet_uwb._ARGTYPES, ctypes.c_int
    mhz = max_sm_mhz()
    n = len(FLEET_SECTIONS)
    sec, cnt = (ctypes.c_ulonglong * n)(), (ctypes.c_ulonglong * n)()
    ticks = FLEET_SECTION_LAUNCHES * UWB_TIMED_TICKS
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    counted = cuda_fleet_uwb.rollout.launches
    for N in (3, UWB_CAP):
        p, s, des = uwb_fleet_case(dev, N)
        draws = uwb_draws(N, UWB_TIMED_TICKS, gen, dev)
        for group in cuda_rollout.GROUPS:
            def launch():
                return cuda_fleet_uwb.rollout(p, s, des, *draws, "position", group=group,
                                              launcher=fn)
            launch()
            torch.cuda.synchronize()
            cuda_build.check(lib.fleet_uwb_sections_read(sec, cnt), "fleet_uwb_sections_read")
            for _ in range(FLEET_SECTION_LAUNCHES):
                launch()
            torch.cuda.synchronize()
            cuda_build.check(lib.fleet_uwb_sections_read(sec, cnt), "fleet_uwb_sections_read")
            print(f"fleet_uwb section timers, {N} vehicles + 5 anchors, G={group} (cycles per "
                  f"tick over {ticks} ticks; vehicle 0 and the network's thread): " + ", ".join(
                      f"{name} {sec[k] / ticks:.0f} (runs {cnt[k]})"
                      for k, name in enumerate(FLEET_SECTIONS) if cnt[k])
                  + f"; a tick {sec[0] / ticks:.0f} cycles = {sec[0] / ticks / mhz:.3f} us at "
                    f"the {mhz:.0f} MHz maximum SM clock")
    cuda_fleet_uwb.rollout.launches = counted


def check_mission(dev):
    """sim/mission on the card: tests/test_mission.py's progression and
    landing drives (50 Hz ticks on an ideal pose) on CUDA tensors, held to
    the same drive on the CPU (discrete leaves and messages equal, floats by
    the tick criteria); safetynet, aruco and test_trajectories once each."""
    import torch

    from agrifly_tpu_torch.models import constants as qconst
    from agrifly_tpu_torch.offboard import controller, safetynet
    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.sim import aruco, mission
    from agrifly_tpu_torch.sim import test_trajectories as tt

    t_phase = time.perf_counter()
    runs = []
    for d in (dev, torch.device("cpu")):
        p = mission.make_params(desired_position=(0.0, 0.0, 2.0),
                                waypoints=((5.0, 0.0, 2.0), (10.0, 0.0, 2.0)), device=d)
        c = controller.make_params(qconst.vehicle_params(qconst.QC_TYPE_CF_MINIQUAD), device=d)
        s = mission.init_state(p)
        z3 = torch.zeros(3, device=d)
        refs = (z3, z3, z3, torch.tensor(9.81, device=d), z3)
        yes, no = torch.tensor(True, device=d), torch.tensor(False, device=d)
        stages, msgs, now = [], [], 0
        for pos, seconds in (((0.0, 0.0, 0.5), 1.1), ((0.0, 0.0, 2.0), 6.0),
                             ((4.8, 0.0, 2.0), 0.1), ((9.8, 0.0, 2.0), 0.1),
                             ((9.8, 0.0, 1.0), 7.0)):
            for _ in range(int(seconds * 50)):
                now += 20000
                s, cmd = mission.step(p, c, s, now, torch.tensor(pos, device=d), z3,
                                      rot.identity(d), no, refs, yes, no)
                stages.append(s.stage)
                msgs.append(torch.cat([cmd.msg_type[None], cmd.msg_flags[None], cmd.msg_fields]))
        runs.append((s, torch.stack(stages).cpu(), torch.stack(msgs).cpu()))
    (s, stages, msgs), (s_cpu, stages_cpu, msgs_cpu) = runs
    _check(torch.equal(stages, stages_cpu) and torch.equal(msgs, msgs_cpu),
           "mission: the card's stages or messages differ from the CPU's")
    compare_ticks(s, s_cpu, "mission on the card vs the CPU", env=())
    _check(int(s.stage) == mission.STAGE_COMPLETE and bool(s.ready_to_exit),
           f"mission: ended in {mission.STAGE_NAMES[int(s.stage)]}")

    sp = safetynet.lab_params(device=dev)
    st = safetynet.update(sp, safetynet.init_state(dev), torch.tensor([10.0, 0.0, 1.0], device=dev),
                          rot.identity(dev), torch.tensor(1000, device=dev))
    _check(not bool(st.is_safe) and bool(st.unsafe_position), "safetynet: the geofence")
    ap = aruco.make_params(period=0.1, noise_std_pos=0.05, device=dev)
    a = aruco.init_state(dev)
    fires = 0
    for _ in range(250):
        a = aruco.step(ap, a, torch.ones(3, device=dev), rot.identity(dev), 2000,
                       torch.zeros(3, device=dev))
        fires += int(a.has_new)
    _check(fires == 4, f"aruco: {fires} measurements in 0.5 s")
    for traj_id in range(6):
        got = tt.evaluate(traj_id, torch.tensor(3.0, device=dev),
                          torch.tensor([0.3, -0.2, 1.7], device=dev))
        ref = tt.evaluate(traj_id, torch.tensor(3.0), torch.tensor([0.3, -0.2, 1.7]))
        for x, y in zip(got, ref):
            _check(float((x.cpu() - y).abs().max()) <= 1e-5, f"test trajectory {traj_id}")
    print(f"mission on the card: {len(stages)} ticks through "
          f"{' -> '.join(dict.fromkeys(mission.STAGE_NAMES[int(k)] for k in stages))}, stages "
          f"and messages equal to the CPU's, the state within the tick criteria; safetynet, "
          f"aruco ({fires} measurements in 0.5 s), test_trajectories 0-5 on the card; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def _c_declaration(src, name):
    """The text of `extern "C" int name(...)` in a source, whitespace folded."""
    import re

    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    _check(m is not None, f"{name} not found")
    return " ".join(m.group(1).split())


def check_parent(dev, root, plan_cases):
    """This tree's K1, K4, K4w, K3, K5 (true state, mocap, GPS-IMU, and the
    UWB build), K6, K1-rgb, K4-rgb, K7 and K8 against the parent's: its
    raycast.cu, meshscene.cu, frame.cu, rollout.cu (with and without
    TICK_UWB), fleet_uwb.cu and plan.cu built from
    root/agrifly_tpu_torch/csrc and called through
    this tree's wrappers, which the check allows only where the parent
    declares the same C interface. The results bit for bit (K3, K5 and K6
    where the parent's tick.cuh rounds sin, cos and exp as this tree's; else
    their differing elements are a reading), and both device times in turns
    (parent, this tree, this tree, parent); K6 also over
    tests/test_fleet_and_bridge.py's flight, its wall time in turns; K7 and
    K8 on check_plan_kernels' cases (`plan_cases`), pops and sections
    included."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch

    from agrifly_tpu_torch import cuda_build

    csrc = Path(root) / "agrifly_tpu_torch" / "csrc"
    out = Path(root) / "agrifly_tpu_torch" / "_build"
    out.mkdir(parents=True, exist_ok=True)
    # build key: (source, defines, the launch function held)
    builds = {"raycast": ("raycast", (), "raycast_launch"),
              "raycast_rgb": ("raycast", (), "raycast_rgb_launch"),
              "meshscene": ("meshscene", (), "meshscene_strips_launch"),
              "meshscene_window": ("meshscene", (), "meshscene_window_launch"),
              "meshscene_rgb": ("meshscene", (), "meshscene_rgb_launch"),
              "frame": ("frame", (), "frame_ticks_launch"),
              "rollout": ("rollout", (), "env_rollout_launch"),
              "rollout_uwb": ("rollout", ("TICK_UWB",), "env_rollout_launch"),
              "fleet_uwb": ("fleet_uwb", (), "fleet_uwb_launch"),
              "plan_check": ("plan", (), "collision_check_launch"),
              "plan_gates": ("plan", (), "plan_gates_launch")}
    for name, _, fn in builds.values():
        _check(_c_declaration((csrc / f"{name}.cu").read_text(), fn)
               == _c_declaration((cuda_build.CSRC / f"{name}.cu").read_text(), fn),
               f"the parent's {fn} has another C interface")

    def build(item):
        key, (name, defines, _) = item
        lib = out / f"libparent_{name}{''.join('-' + d for d in defines)}.so"
        if not lib.exists():
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                   "-o", str(lib), str(csrc / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            _check(proc.returncode == 0, f"the parent's {name}.cu: {proc.stderr[-2000:]}")
        return key, ctypes.CDLL(str(lib))

    sources = {}
    for key, (name, defines, _) in builds.items():  # one nvcc per library
        sources.setdefault((name, defines), key)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(pool.map(build, [(k, builds[k]) for k in sources.values()]))
    fns = {}
    for key, (name, defines, fn_name) in builds.items():
        fn = getattr(libs[sources[(name, defines)]], fn_name)
        fn.restype = ctypes.c_int
        fns[key] = fn
    times = {}
    # the tick kernels are bit-equal only to a parent whose tick.cuh rounds sin,
    # cos and exp as this tree's does (through double, sin_r); against an older
    # parent their differences are a reading
    exact = "sin_r(" in (csrc / "tick.cuh").read_text()
    _parent_renders(dev, fns["raycast"], fns["meshscene"], fns["meshscene_window"], times)
    _parent_frame(dev, fns["frame"], times, exact)
    _parent_rollout(dev, fns["rollout"], fns["rollout_uwb"], times, exact)
    _parent_fleet_uwb(dev, fns["fleet_uwb"], times, exact)
    _parent_rgb(dev, fns["raycast_rgb"], times)
    _parent_mesh_rgb(dev, fns["meshscene_rgb"], times)
    _parent_plan(dev, fns["plan_check"], fns["plan_gates"], times, plan_cases, root,
                 out / "libparent_plan.so")
    print("parent vs this tree, in turns (parent, this, this, parent): " + "; ".join(
        f"{k} {v[0]:.1f} / {v[1]:.1f} {'ms' if 'flight' in k else 'us'} ({v[1] / v[0]:.4f})"
        for k, v in times.items()))
    return times


def _parent_plan(dev, check_fn, gates_fn, times, cases, root, lib_path):
    """K7 and K8 of the parent's plan.cu against this tree's: the frame's
    candidate pass at B = 1 and 16 x 256 (first check and lazy re-check) and
    the evaluation's 4 x 1024, then K7 on the adversarial sets; every output
    bit for bit, pops and sections too; device times in turns; and at the
    three main shapes the bare launch's ms (CUDA events over 200 launches in
    a row: the host's time where it exceeds the device's) of the parent's
    wrapper module (root's cuda_plan.py, its own handle on the parent's
    library) against this tree's, in turns."""
    import ctypes
    import importlib.util
    import types
    from pathlib import Path

    import torch

    from agrifly_tpu_torch import cuda_build
    from agrifly_tpu_torch.planner import cuda_plan

    check_fn.argtypes = cuda_plan._SIGNATURES["collision_check_launch"]
    gates_fn.argtypes = cuda_plan._SIGNATURES["plan_gates_launch"]
    sets = dict(cases)
    grav = torch.tensor([0.0, 9.81, 0.0], device=dev)
    prm0 = cases["B=1"][0]
    for name, (tr, pyrs) in adversarial_checks(prm0, dev).items():
        sets[name] = (prm0, tr, grav, pyrs, None)
    for label, (prm, tr, g, pyrs, lazy) in sets.items():
        for enabled in (None, lazy) if lazy is not None else (None,):
            outs = []
            for launcher in (check_fn, None):
                pops = torch.zeros(tr.tf.shape, dtype=torch.int32, device=dev)
                outs.append(cuda_plan._launch_check(prm, pyrs, tr, enabled, pops, launcher)
                            + (pops,))
            _check(_equal(*outs), f"K7 differs from the parent's ({label})")
        gate_outs = []
        for launcher in (gates_fn, None):
            sections = torch.zeros(tr.tf.shape, dtype=torch.int32, device=dev)
            gate_outs.append(cuda_plan._launch_gates(
                tr, g, prm.fmin, prm.fmax, prm.wmax, prm.min_section_time, prm.vmax, 3.0, 9,
                True, sections, launcher) + (sections,))
        _check(_equal(*gate_outs), f"K8 differs from the parent's ({label})")
        times[f"K7 {label}"] = _in_turns(
            lambda: cuda_plan._launch_check(prm, pyrs, tr, launcher=check_fn),
            lambda: cuda_plan._launch_check(prm, pyrs, tr))
        times[f"K8 {label}"] = _in_turns(
            *(lambda fn=fn: cuda_plan._launch_gates(tr, g, prm.fmin, prm.fmax, prm.wmax,
                                                    prm.min_section_time, prm.vmax, 3.0,
                                                    launcher=fn) for fn in (gates_fn, None)))
    spec = importlib.util.spec_from_file_location(
        "parent_cuda_plan", Path(root) / "agrifly_tpu_torch" / "planner" / "cuda_plan.py")
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    own = ctypes.CDLL(str(lib_path))  # its functions' argument types are the parent's
    parent.cuda_build = types.SimpleNamespace(load=lambda name, defines=(): own,
                                              check=cuda_build.check)
    host = []
    for label in ("B=1", f"B={FLEET}", "4x1024"):
        prm, tr, g, pyrs, _ = cases[label]
        t = [(cuda_ms(lambda: mod._launch_check(prm, pyrs, tr), reps=200),
              cuda_ms(lambda: mod._launch_gates(tr, g, prm.fmin, prm.fmax, prm.wmax,
                                                prm.min_section_time, prm.vmax, 3.0), reps=200))
             for mod in (parent, cuda_plan, cuda_plan, parent)]
        host.append(f"{label} K7 {(t[0][0] + t[3][0]) / 2:.4f} / {(t[1][0] + t[2][0]) / 2:.4f}, "
                    f"K8 {(t[0][1] + t[3][1]) / 2:.4f} / {(t[1][1] + t[2][1]) / 2:.4f}")
    frames = _frames_in_turns(dev, root)
    print("parent's plan.cu: K7 and K8 bit-equal to this tree's (outputs, pops, sections) on " +
          ", ".join(sets) + "; bare launch ms, the parent's wrapper and kernel / this tree's, in "
          "turns: " + "; ".join(host) + f"; {PLAN_TURN_FRAMES}-frame flights (fused ticks, the "
          f"parent's checkout in a process of its own), ms a frame in turns: parent {frames[0]:.3f}, this {frames[1]:.3f}, this "
          f"{frames[2]:.3f}, parent {frames[3]:.3f}, the flights bit-equal")


PLAN_TURN_FRAMES = 20  # the flights _frames_in_turns times

# The parent's one-vehicle flight, run in a process of its own from the
# parent's checkout (its package is another version of this one): its four
# frame kernels built together, a 2-frame warm-up, then the timed flight.
PARENT_FLIGHT = """
import sys, time
from concurrent.futures import ThreadPoolExecutor
import torch
from agrifly_tpu_torch import convert, cuda_build
from agrifly_tpu_torch.sim import orchard_env
with ThreadPoolExecutor(4) as pool:
    list(pool.map(cuda_build.load, ("raycast", "inflate", "frame", "plan")))
dev = torch.device("cuda", 0)
env = orchard_env.OrchardEnv(orchard_env.make_params(start_flight_time=1.0, device=dev))
env.fly(env.init_state(), 2, torch.Generator(device=dev).manual_seed(99))
gen = torch.Generator(device=dev).manual_seed(int(sys.argv[1]))
torch.cuda.synchronize()
t0 = time.perf_counter()
state, outs = env.fly(env.init_state(), int(sys.argv[2]), gen)
torch.cuda.synchronize()
ms = 1e3 * (time.perf_counter() - t0) / int(sys.argv[2])
torch.save({"ms": ms, "state": [t.cpu() for t in convert.flatten_tensors(state)[0]],
            "outs": {k: v.cpu() for k, v in outs.items()}}, sys.argv[3])
"""


def _frames_in_turns(dev, root):
    """The one-vehicle flight (fused ticks, from the start, the same draws,
    PLAN_TURN_FRAMES frames) of the parent's checkout `root` (in a process
    of its own) and of this tree, in turns (parent, this, this, parent): ms
    a frame of each; every flight's outputs and final state bit for bit the
    parent's first."""
    import os
    import tempfile

    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import orchard_env

    env = orchard_env.OrchardEnv(orchard_env.make_params(start_flight_time=1.0, device=dev))
    env.fly(env.init_state(), 2, torch.Generator(device=dev).manual_seed(99))
    penv = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    ms, first = [], None
    with tempfile.TemporaryDirectory() as tmp:
        for turn, who in enumerate(("parent", "this", "this", "parent")):
            if who == "parent":
                path = os.path.join(tmp, f"parent{turn}.pt")
                proc = subprocess.run([sys.executable, "-c", PARENT_FLIGHT, str(SEED),
                                       str(PLAN_TURN_FRAMES), path], cwd=root, env=penv,
                                      capture_output=True, text=True, timeout=600)
                _check(proc.returncode == 0, f"the parent's flight: {proc.stderr[-2000:]}")
                run = torch.load(path)
            else:
                gen = torch.Generator(device=dev).manual_seed(SEED)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, outs = env.fly(env.init_state(), PLAN_TURN_FRAMES, gen)
                torch.cuda.synchronize()
                run = {"ms": 1e3 * (time.perf_counter() - t0) / PLAN_TURN_FRAMES,
                       "state": [t.cpu() for t in convert.flatten_tensors(state)[0]],
                       "outs": {k: v.cpu() for k, v in outs.items()}}
            ms.append(run["ms"])
            first = run if first is None else first
            _check(len(run["state"]) == len(first["state"])
                   and all(torch.equal(a, b) for a, b in zip(run["state"], first["state"]))
                   and run["outs"].keys() == first["outs"].keys()
                   and all(torch.equal(run["outs"][k], first["outs"][k]) for k in run["outs"]),
                   f"turn {turn} ({who}): the flight differs from the parent's")
    return ms


def _in_turns(parent, mine, reps=5):
    """(parent's, this tree's) device µs of two launches, in turns."""
    t = [device_us((parent, mine)[i], reps=reps) for i in (0, 1, 1, 0)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def _parent_renders(dev, raycast_fn, meshscene_fn, window_fn, times):
    """K1, K4 and K4w (depth) at 640x480 on check_raycast's and
    check_meshscene's first poses (B = 1 and 16), the default orchard and
    the baked one."""
    import torch

    from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast, meshscene, orchard, raycast

    raycast_fn.argtypes = cuda_raycast._ARGTYPES["raycast_launch"]
    meshscene_fn.argtypes = cuda_meshscene._ARGTYPES["meshscene_strips_launch"]
    window_fn.argtypes = cuda_meshscene._ARGTYPES["meshscene_window_launch"]
    cfg = raycast.make_config(640, 480)
    scene, mesh = orchard.make_params(device=dev), baked_orchard(dev)
    reach = cfg.far * meshscene.slant_factor(cfg)
    g_ray, g_mesh = torch.Generator().manual_seed(SEED), torch.Generator().manual_seed(SEED + 5)
    for B in (1, 16):
        pos, cam = ray_poses(g_ray, B, dev)
        launches = (lambda: cuda_raycast._launch(cfg, scene, pos, cam, launcher=raycast_fn),
                    lambda: cuda_raycast._launch(cfg, scene, pos, cam))
        _check(torch.equal(launches[0](), launches[1]()), f"K1 against the parent's (B={B})")
        times[f"K1 B={B}"] = _in_turns(*launches)
        mpos, mcam = mesh_poses(g_mesh, B, dev)
        windows = meshscene.select_window(mesh, mpos, reach, 192)
        launches = (lambda: cuda_meshscene._launch("meshscene_strips_launch", cfg, mpos, mcam,
                                                   windows, launcher=meshscene_fn),
                    lambda: cuda_meshscene._launch("meshscene_strips_launch", cfg, mpos, mcam,
                                                   windows))
        _check(torch.equal(launches[0](), launches[1]()), f"K4 against the parent's (B={B})")
        times[f"K4 B={B}"] = _in_turns(*launches)
        launches = (lambda: cuda_meshscene._launch("meshscene_window_launch", cfg, mpos, mcam,
                                                   windows, launcher=window_fn),
                    lambda: cuda_meshscene._launch("meshscene_window_launch", cfg, mpos, mcam,
                                                   windows))
        _check(torch.equal(launches[0](), launches[1]()), f"K4w against the parent's (B={B})")
        times[f"K4w B={B}"] = _in_turns(*launches)
    print("parent's K1, K4 and K4w at 640x480, B = 1 and 16: codes bit-equal")


def _tick_kernel_verdict(what, differ, total, largest, exact):
    """Gate (exact) or report the elements of a tick kernel's leaves that
    differ from the parent's."""
    _check(not exact or differ == 0, f"{what} against the parent's: {differ} of {total} "
                                     f"elements differ")
    return (f"{differ} of {total} leaf elements differ" + ("" if exact else
            f" (a reading: the parent rounds sin, cos and exp otherwise; largest "
            f"|d| {largest:.3g})"))


def _parent_frame(dev, parent, times, exact=True):
    """K3: the five mission states at B = 5 and the tracking state at B = 1,
    10 chained blocks of 16 ticks each."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    parent.argtypes = cuda_frame._ARGTYPES
    p_cpu, states = tick_case()
    p = orchard_env.OrchardEnv(p_cpu).to(dev).params
    pleaves = cuda_frame.param_leaves(p)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    differ = total = 0
    largest = 0.0
    for B, names in ((5, tuple(states)), (1, ("tracking",))):
        fleet = to_device(orchard_env.stack_states([states[names[b % len(names)]]
                                                    for b in range(B)]), dev)
        mine = theirs = convert.flatten_tensors(fleet)[0]
        for _ in range(10):
            noise = torch.randn((B, 16, 2, 3), generator=gen, device=dev)
            mine = cuda_frame._launch(mine, pleaves, noise)
            theirs = cuda_frame._launch(theirs, pleaves, noise, launcher=parent)
            for a, b in zip(mine, theirs):
                differ += int((a != b).sum())
                total += a.numel()
                largest = max(largest, float((a.double() - b.double()).abs().max()))
        times[f"K3 B={B}"] = _in_turns(
            lambda: cuda_frame._launch(mine, pleaves, noise, launcher=parent),
            lambda: cuda_frame._launch(mine, pleaves, noise))
    verdict = _tick_kernel_verdict("K3", differ, total, largest, exact)
    print(f"parent's K3: 10 blocks of 16 ticks at B = 5 (five states) and B = 1 (tracking): "
          f"{verdict}")


PARENT_K5_TURNS = 3  # _in_turns runs of K5 against the parent's at bench.py's shape


def _parent_rollout(dev, parent, parent_uwb, times, exact=True):
    """K5 in every mode at 1024 envs x ENV_STEPS; and at bench.py's shape
    (ENVS envs, the true state and mocap), PARENT_K5_TURNS times in turns."""
    import torch

    from agrifly_tpu_torch.sim import cuda_rollout, env, uwb

    parent.argtypes = parent_uwb.argtypes = cuda_rollout._ARGTYPES
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    B = 1024
    verdicts = []
    for name, mode, ctrl in (("true", False, "rates"), ("mocap", True, "rates"),
                             ("gpsimu", "gpsimu", "rates"), ("uwb", False, "position")):
        pp, s, cmd = env_mode_case(dev, "uwb" if name == "uwb" else "gpsimu", B)
        noise = torch.randn((B, ENV_STEPS, 2, 3), generator=gen, device=dev)
        draws = uwb.draw((B, ENV_STEPS), gen, dev) if name == "uwb" else None
        fn = parent_uwb if name == "uwb" else parent
        launches = (env_launcher(pp, s, cmd, noise, mode, cuda_rollout.GROUP, fn, ctrl=ctrl,
                                 draws=draws),
                    env_launcher(pp, s, cmd, noise, mode, cuda_rollout.GROUP, ctrl=ctrl,
                                 draws=draws))
        b_state, b_traj = launches[0]()
        a_state, a_traj = launches[1]()
        pairs = list(zip(a_state + a_traj, b_state + b_traj))
        verdicts.append(name + ": " + _tick_kernel_verdict(
            f"K5 {name}", sum(int((a != b).sum()) for a, b in pairs),
            sum(a.numel() for a, _ in pairs),
            max(float((a.double() - b.double()).abs().max()) for a, b in pairs), exact))
        times[f"K5 {name} {B} envs"] = _in_turns(*launches, reps=3)
    print(f"parent's K5 at {B} envs x {ENV_STEPS} steps (every state and trajectory leaf): "
          + "; ".join(verdicts))
    # bench.py's path: ENVS envs at rest, hover at ENV_HOVER, the true state and mocap
    p = env.make_params(noise_scale=1.0, device=dev)
    s = env.init_state_fleet(p, torch.zeros((ENVS, 3), device=dev))
    cmd = env.hover_command(ENV_HOVER, device=dev)
    noise = torch.randn((ENVS, ENV_STEPS, 2, 3), generator=gen, device=dev)
    for name, mode in (("true", False), ("mocap", True)):
        launches = (env_launcher(p, s, cmd, noise, mode, cuda_rollout.GROUP, parent),
                    env_launcher(p, s, cmd, noise, mode, cuda_rollout.GROUP))
        pairs = list(zip(*(a + b for a, b in (launches[1](), launches[0]()))))
        _check(all(torch.equal(a, b) for a, b in pairs),
               f"K5 {name} at {ENVS} envs differs from the parent's")
        for turn in range(PARENT_K5_TURNS):
            times[f"K5 {name} {ENVS} envs, turn {turn}"] = _in_turns(*launches, reps=5)
    print(f"parent's K5 at {ENVS} envs x {ENV_STEPS} steps (bench.py's path), true state and "
          f"mocap: every state and trajectory leaf bit-equal")


def _parent_fleet_uwb(dev, parent, times, exact=True):
    """K6 at 3 and UWB_CAP vehicles with 5 anchors, every G, in the idle,
    position and rates modes one after the other (300 ticks each, from the
    start state, a gusty wind), bit-equal to the parent's (every leaf); its
    device µs per tick (UWB_TIMED_TICKS position ticks) and the 1500 + 6000
    tick flight's wall time, in turns."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_fleet_uwb, cuda_rollout

    parent.argtypes = cuda_fleet_uwb._ARGTYPES
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    wind = dict(mean=(1.0, 0.0, 0.0), gust_std=0.5, gust_tau=2.0, force_gain=0.01)
    counted = cuda_fleet_uwb.rollout.launches
    differ = total = 0
    largest = 0.0
    for n in (3, UWB_CAP):
        p, s, des = uwb_fleet_case(dev, n, wind=wind)
        for ctrl in ("idle", "position", "rates"):
            draws = uwb_draws(n, 300, gen, dev)
            theirs = cuda_fleet_uwb.rollout(p, s, des, *draws, ctrl, launcher=parent)
            for g in cuda_rollout.GROUPS:
                mine = cuda_fleet_uwb.rollout(p, s, des, *draws, ctrl, group=g)
                for (path, a), (_, b) in zip(convert.leaves(mine), convert.leaves(theirs)):
                    differ += int((a != b).sum())
                    total += a.numel()
                    largest = max(largest, float((a.double() - b.double()).abs().max()))
            s = theirs
        _check(int(s.latch_start) > 0, f"K6 against the parent's: no range at {n} vehicles")
        pn, sn, dn = uwb_fleet_case(dev, n)
        draws = uwb_draws(n, UWB_TIMED_TICKS, gen, dev)
        t = _in_turns(lambda: cuda_fleet_uwb.rollout(pn, sn, dn, *draws, launcher=parent),
                      lambda: cuda_fleet_uwb.rollout(pn, sn, dn, *draws), reps=3)
        times[f"K6 {n}+5 a tick"] = (t[0] / UWB_TIMED_TICKS, t[1] / UWB_TIMED_TICKS)
    verdict = _tick_kernel_verdict("K6", differ, total, largest, exact)
    print(f"parent's K6 at 3 and {UWB_CAP} vehicles with 5 anchors: idle, position and rates "
          f"(300 ticks each) at every G in {cuda_rollout.GROUPS}: {verdict}")

    # the flight of tests/test_fleet_and_bridge.py: two calls, its draws made first
    p, s0, des = uwb_fleet_case(dev, 3)
    idle, fly = uwb_draws(3, UWB_IDLE, gen, dev), uwb_draws(3, UWB_FLY, gen, dev)

    def flight(launcher):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = cuda_fleet_uwb.rollout(p, s0, des, *idle, "idle", launcher=launcher)
        s = cuda_fleet_uwb.rollout(p, s, des, *fly, "position", launcher=launcher)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), s

    walls, finals = ([], []), [None, None]  # (the parent's, this tree's)
    for i in (0, 1, 1, 0):
        ms, finals[i] = flight(parent if i == 0 else None)
        walls[i].append(ms)
    pairs = [(a, b) for (_, a), (_, b) in zip(convert.leaves(finals[1]),
                                               convert.leaves(finals[0]))]
    verdict = _tick_kernel_verdict(
        "K6's flight", sum(int((a != b).sum()) for a, b in pairs),
        sum(a.numel() for a, _ in pairs),
        max(float((a.double() - b.double()).abs().max()) for a, b in pairs), exact)
    times["K6 flight wall"] = (sum(walls[0]) / 2, sum(walls[1]) / 2)
    cuda_fleet_uwb.rollout.launches = counted
    print(f"parent's K6 over the {UWB_IDLE} + {UWB_FLY} tick flight: {verdict}; wall "
          f"ms parent {', '.join(f'{t:.1f}' for t in walls[0])}, this tree "
          f"{', '.join(f'{t:.1f}' for t in walls[1])}")


def _parent_rgb(dev, parent, times):
    """K1-rgb at 640x480, B = 1 and 16, on the three scenes from
    check_rgb's poses, above the canopy and pitched up, bit-equal to the
    parent's; device µs in turns on the default orchard's poses."""
    import torch

    from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast

    parent.argtypes = cuda_raycast._ARGTYPES["raycast_rgb_launch"]
    cfg = raycast.make_config(640, 480)
    g = torch.Generator().manual_seed(SEED)
    counted = cuda_raycast.render_rgb_batch.launches
    for B in (1, 16):
        pos, cam = ray_poses(g, B, dev)
        cases = (("random poses", (pos, cam)), ("above the canopy", above_canopy(dev)),
                 ("pitched up", up_poses(g, B, dev)))
        for name, kw in RAY_SCENES.items():
            scene = orchard.make_params(device=dev, **kw)
            for label, (p, c) in cases:
                mine = cuda_raycast._launch_rgb(cfg, scene, p, c)
                _check(torch.equal(mine, cuda_raycast._launch_rgb(cfg, scene, p, c,
                                                                  launcher=parent)),
                       f"K1-rgb against the parent's ({name}, {label}, B={B})")
        scene = orchard.make_params(device=dev)
        times[f"K1-rgb B={B}"] = _in_turns(
            lambda: cuda_raycast._launch_rgb(cfg, scene, pos, cam, launcher=parent),
            lambda: cuda_raycast._launch_rgb(cfg, scene, pos, cam))
        up = up_poses(g, B, dev)
        times[f"K1-rgb pitched up B={B}"] = _in_turns(
            lambda: cuda_raycast._launch_rgb(cfg, scene, *up, launcher=parent),
            lambda: cuda_raycast._launch_rgb(cfg, scene, *up))
    cuda_raycast.render_rgb_batch.launches = counted
    print("parent's K1-rgb at 640x480, B = 1 and 16: bit-equal on the default, limit and loose "
          "scenes, from above the canopy and pitched up")


def _parent_mesh_rgb(dev, parent, times):
    """K4-rgb at 640x480 against the parent's, bit for bit: the baked
    orchard and the mixed scene at B = 1 and 16 (check_rgb's poses) with
    windows of 192 and 300 rows (two staged chunks), from above the canopy,
    and on edge_rows; device µs in turns on the baked orchard at B = 1 and
    16 (window 192)."""
    import tempfile

    import torch

    from agrifly_tpu_torch.render import cuda_meshscene, meshscene, raycast

    parent.argtypes = cuda_meshscene._ARGTYPES["meshscene_rgb_launch"]
    cfg = raycast.make_config(640, 480)
    reach = cfg.far * meshscene.slant_factor(cfg)
    g = torch.Generator().manual_seed(SEED + 5)
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {"baked orchard": baked_orchard(dev), "mixed scene": mixed_scene(dev, tmp)}
    for label, mesh in scenes.items():
        for B in (1, 16):
            pos, cam = mesh_poses(g, B, dev)
            cases = (("random poses", pos, cam), ("above the canopy", *above_canopy(dev)))
            for case, p, c in cases:
                for capacity in (192, 300, "300 shuffled"):
                    windows, order, ok = meshscene.select_window(mesh, p, reach,
                                                                 300 if capacity != 192 else 192,
                                                                 return_order=True)
                    mats = meshscene.window_materials(mesh, windows, order, ok)
                    if capacity == "300 shuffled":
                        windows, mats = shuffled_window(windows, mats)
                    launches = (lambda: cuda_meshscene._launch_rgb(cfg, p, c, windows, mats,
                                                                   launcher=parent),
                                lambda: cuda_meshscene._launch_rgb(cfg, p, c, windows, mats))
                    _check(torch.equal(launches[1](), launches[0]()),
                           f"K4-rgb against the parent's ({label}, {case}, B={B}, window "
                           f"{capacity})")
                    if label == "baked orchard" and case == "random poses" and capacity == 192:
                        times[f"K4-rgb B={B}"] = _in_turns(*launches)
    windows, pos, cam = edge_rows(dev)
    mats = torch.where(windows[..., 0] == meshscene.PRIM_CYLINDER, meshscene.MAT_TRUNK,
                       meshscene.MAT_CANOPY).to(torch.int32)
    _check(torch.equal(cuda_meshscene._launch_rgb(cfg, pos, cam, windows, mats),
                       cuda_meshscene._launch_rgb(cfg, pos, cam, windows, mats, launcher=parent)),
           "K4-rgb against the parent's (edge rows)")
    print("parent's K4-rgb at 640x480: bit-equal on the "
          "baked orchard and the mixed scene at B = 1 and 16, windows of 192 and 300 rows and a "
          "shuffled 300-row one, from above the canopy, and on the edge rows")


def build_kernels():
    """Build the kernel libraries, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from agrifly_tpu_torch import cuda_build

    t0 = time.perf_counter()
    variants = (TIMED_FRAME, TIMED_ROLLOUT, UWB_ROLLOUT, WIND_ROLLOUT, WIND_UWB_ROLLOUT,
                TIMED_FLEET, TIMED_MESH)
    with ThreadPoolExecutor(len(KERNELS) + len(variants)) as pool:
        timed = [pool.submit(cuda_build.load, *variant) for variant in variants]
        list(pool.map(cuda_build.load, KERNELS))
        for variant in timed:
            variant.result()
    built = ", ".join(f"{k} {v:.1f} s" for k, v in cuda_build.build_seconds.items())
    print(f"kernel build: {built or 'up to date'} ({time.perf_counter() - t0:.1f} s)")
    for name in KERNELS:
        print(ptxas_report(name, cuda_build.build_logs.get(name, "")))
    for defines in (("TICK_UWB",), ("TICK_WIND",), ("TICK_UWB", "TICK_WIND")):
        print(ptxas_report("rollout", cuda_build.build_logs.get("-".join(("rollout",) + defines), ""),
                           "rollout.cu " + " ".join(f"-D{d}" for d in defines)))


# kernel entry names in ptxas's report -> short names
PTXAS_NAMES = {"raycast": {"raycast_kernel": "K1", "raycast_rgb_kernel": "K1-rgb"},
               "meshscene": {"meshscene_strips_kernel": "K4", "meshscene_window_kernel": "K4w",
                             "meshscene_rgb_kernel": "K4-rgb"},
               "inflate": {"inflate_kernel": "K2", "inflate_cluster_kernel": "K2c",
                           "inflate_grouped_kernel": "K2g"},
               "frame": {"frame_kernel": "K3", "percept_head_kernel": "K9"},
               "rollout": {"rollout_kernel": "K5"},  # K5 G=g: its template instance for g lanes
               "fleet_uwb": {"fleet_uwb_kernel": "K6"},
               "plan": {"collision_check_kernel": "K7", "plan_gates_kernel": "K8"},
               "rounds": {"round_seeds_kernel": "K10", "pyramid_set_kernel": "K11",
                          "lazy_seeds_kernel": "K12"}}


def ptxas_report(lib, log, label=None):
    """One line from ptxas's -v report of a library's kernels: registers,
    shared memory and spill bytes of each."""
    import re

    names = PTXAS_NAMES[lib]
    kernels, name = [], None
    for line in log.splitlines():
        entry = re.search("(" + "|".join(names) + r")(ILi)?(\d+)?(ELb1)?", line)
        if "Compiling entry function" in line and entry:
            name = names[entry.group(1)] + (f" G={entry.group(3)}" if entry.group(2)
                                              else entry.group(3) or "")
            name += " rows" if entry.group(4) else ""
        elif name and "spill" in line:
            spill = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            kernels.append([name, ", ".join(f"{b} B spill {k}" for b, k in spill)])
        elif name and "Used" in line:
            kernels[-1].append(line.split(":", 1)[1].strip())
            name = None
    return f"ptxas ({label or lib + '.cu'}): " + ("; ".join(f"{k} {u} ({sp})" for k, sp, u in
                                               (r for r in kernels if len(r) == 3))
                                     or "not rebuilt in this process")


def _timed(seconds, fn):
    """fn, its calls' wall time added to seconds[fn's name]."""
    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            seconds[fn.__name__] = seconds.get(fn.__name__, 0.0) + time.perf_counter() - t0
    return call


def main(argv) -> int:
    import torch

    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = argv[1]
    elif argv:
        print("usage: python3 chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from agrifly_tpu_torch import cuda_build  # noqa: F401
        from agrifly_tpu_torch.planner import cuda_inflate, cuda_plan  # noqa: F401
        from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast  # noqa: F401
        from agrifly_tpu_torch.sim import cuda_fleet_uwb, cuda_frame, cuda_rollout  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not here: {exc}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    seconds = {}  # wall seconds of each phase, by name
    timed = functools.partial(_timed, seconds)
    t_start = time.perf_counter()
    try:
        print(card_line())
        timed(build_kernels)()
        k1 = timed(check_raycast)(dev)
        k4, k4w = timed(check_meshscene)(dev)
        k1rgb, k4rgb = timed(check_rgb)(dev)
        timed(mesh_sections)(dev)
        k2 = timed(check_inflate)(dev)
        k2b = timed(check_inflate_batched)(dev)
        k3 = timed(check_frame_ticks)(dev)
        k3b_worst = timed(check_frame_ticks_batched)(dev)
        timed(tick_split)(dev)
        timed(frame_sections)(dev)
        t_eval = time.perf_counter()
        eval_params, views = timed(eval_views)(dev)
        k2g, k2_eval, k2g_launches = timed(check_inflate_grouped)(dev, eval_params, views)
        eval_launches = timed(evaluate)(dev, eval_params, views)
        print(f"grouped inflation and evaluation phases: {time.perf_counter() - t_eval:.1f} s")
        state, launches = timed(fly)(dev, fused=True, frames=FRAMES)
        fly_ms = fly.last_ms
        k7, k8, plan_cases = timed(check_plan_kernels)(dev, state)
        rounds = timed(check_plan_rounds)(dev, state)
        timed(fly)(dev, fused=False, frames=PLAIN_FRAMES, state=state)
        timed(check_ticks_against_cpu)(state, dev, 1.0)
        fleet_state, fleet_launches = timed(fly_fleet)(dev)
        p_dev, noise, worst = timed(check_ticks_against_cpu)(fleet_state, dev, FLEET_START)
        k3b = timed(tick_result)(max(k3b_worst, worst), p_dev, fleet_state, noise,
                                 plain_reps=1, plain_warmup=0)
        timed(time_big_fleet)(dev)
        mesh_launches, _, window_launches = timed(fly_mesh)(dev, state)
        t_bridge = time.perf_counter()
        timed(fly_bridge)(dev, state)
        timed(fly_bridge)(dev, state, baked_orchard(dev))
        print(f"bridge flights: {time.perf_counter() - t_bridge:.1f} s")
        k5rows = timed(check_tick_block)(dev)
        bridge_launches, mesh_bridge_launches = timed(check_bridge)(dev, state)
        fleet_entry, k5rows_launches = timed(check_entry_points)(dev, fly_ms)
        timed(check_mesh)(dev, state, fleet_entry)
        k5, k5_launches = timed(check_env_rollout)(dev)
        timed(check_env_modes)(dev)
        k5w, k5w_launches = timed(check_fleet_wind)(dev)
        k5wu, k5wu_launches = timed(check_fleet_wind_uwb)(dev)
        k6, k6_launches = timed(check_fleet_uwb)(dev)
        timed(fleet_sections)(dev)
        timed(check_mission)(dev)
        if parent is not None:
            timed(check_parent)(dev, parent, plan_cases)
    except Exception as exc:  # report and fail: no result line
        print(f"chip_smoke: FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print("chip_smoke: seconds by phase: " + ", ".join(
        f"{name} {s:.1f}" for name, s in sorted(seconds.items(), key=lambda kv: -kv[1])))

    source = "agrifly_tpu_torch/csrc/{}.cu".format
    kernels = [
        {"name": "raycast", "route": "cuda", "source": source("raycast"),
         "replaces": "agrifly_tpu/render/pallas_raycast.py:167",
         "launches": launches["raycast"], **k1},
        {"name": "inflate", "route": "cuda", "source": source("inflate"),
         "replaces": "agrifly_tpu/planner/pallas_inflate.py:1174",
         "launches": eval_launches["inflate"], **k2_eval},
        {"name": "inflate_cluster", "route": "cuda", "source": source("inflate"),
         "replaces": "agrifly_tpu/planner/pallas_inflate.py:1174",
         "launches": launches["inflate_cluster"], **k2},
        {"name": "frame_ticks", "route": "cuda", "source": source("frame"),
         "replaces": "agrifly_tpu/sim/pallas_frame.py:144",
         "launches": launches["frame_ticks"], **k3},
        {"name": "frame_ticks_batched", "route": "cuda", "source": source("frame"),
         "replaces": "agrifly_tpu/sim/pallas_frame.py:315",
         "launches": fleet_launches["frame_ticks"], **k3b},
        {"name": "inflate_batched", "route": "cuda", "source": source("inflate"),
         "replaces": "agrifly_tpu/planner/pallas_inflate.py:1174",
         "launches": fleet_launches["inflate"], **k2b},
        {"name": "meshscene_strips", "route": "cuda", "source": source("meshscene"),
         "replaces": "agrifly_tpu/render/pallas_meshscene.py:224",
         "launches": mesh_launches["meshscene_strips"], **k4},
        {"name": "meshscene_window", "route": "cuda", "source": source("meshscene"),
         "replaces": "agrifly_tpu/render/pallas_meshscene.py:164",
         "launches": window_launches["meshscene_window"], **k4w},
        {"name": "raycast_rgb", "route": "cuda", "source": source("raycast"),
         "replaces": "agrifly_tpu/render/raycast.py:199 (render_rgb; jnp, no pallas_call)",
         "launches": bridge_launches["raycast_rgb"], **k1rgb},
        {"name": "meshscene_rgb", "route": "cuda", "source": source("meshscene"),
         "replaces": "agrifly_tpu/render/meshscene.py:508 (render_rgb; jnp, no pallas_call)",
         "launches": mesh_bridge_launches["meshscene_rgb"], **k4rgb},
        {"name": "inflate_grouped", "route": "cuda", "source": source("inflate"),
         "replaces": "agrifly_tpu/planner/pallas_inflate.py:1174 (_kernel_grouped:559)",
         "launches": k2g_launches, **k2g},
        {"name": "env_rollout", "route": "cuda", "source": source("rollout"),
         "replaces": "agrifly_tpu/sim/env.py:214 (rollout_fast; jnp, no pallas_call)",
         "launches": k5_launches, **k5},
        {"name": "env_rollout_wind", "route": "cuda", "source": source("rollout"),
         "replaces": "agrifly_tpu/sim/fleet_env.py:99 (fleet_rollout; jnp, no pallas_call)",
         "launches": k5w_launches, **k5w},
        {"name": "env_rollout_wind_uwb", "route": "cuda", "source": source("rollout"),
         "replaces": "agrifly_tpu/sim/fleet_env.py:99 (fleet_rollout with base.uwb; jnp, no "
                     "pallas_call)",
         "launches": k5wu_launches, **k5wu},
        {"name": "env_tick_block", "route": "cuda", "source": source("rollout"),
         "replaces": "agrifly_tpu/io/bridge.py:420 (SimBridge._dispatch_tick_block; lax.scan "
                     "under jit, no pallas_call)",
         "launches": k5rows_launches, **k5rows},
        {"name": "fleet_uwb", "route": "cuda", "source": source("fleet_uwb"),
         "replaces": "agrifly_tpu/sim/fleet_env.py:265 (uwb_fleet_rollout, uwb_fleet_step:184; "
                     "jnp, no pallas_call)",
         "launches": k6_launches, **k6},
        {"name": "collision_check", "route": "cuda", "source": source("plan"),
         "replaces": "agrifly_tpu/planner/rappids.py:738 (collision_check, a lax.while_loop "
                     "vmapped over candidates; jnp, no pallas_call)",
         "launches": launches["collision_check"], **k7},
        {"name": "plan_gates", "route": "cuda", "source": source("plan"),
         "replaces": "agrifly_tpu/planner/traj.py:264 (check_input_feasibility) and :317 "
                     "(check_velocity_feasibility); jnp, no pallas_call",
         "launches": launches["plan_gates"], **k8},
        {"name": "percept_head", "route": "cuda", "source": source("frame"),
         "replaces": "agrifly_tpu/sim/orchard_env.py:348 (_frame_percept's head: "
                     "offboard/estimators.py:354, render/raycast.py:52, planner/rappids.py:937, "
                     ":150; jnp under jit, no pallas_call)",
         "launches": launches["percept_head"], **rounds["percept_head"]},
        {"name": "round_seeds", "route": "cuda", "source": source("rounds"),
         "replaces": "agrifly_tpu/planner/rappids.py:994 (_plan_core's rounds: the order, "
                     "find_containing_pyramid:626, the seed set-up; jnp under jit, no "
                     "pallas_call)",
         "launches": launches["round_seeds"], **rounds["round_seeds"]},
        {"name": "pyramid_set", "route": "cuda", "source": source("rounds"),
         "replaces": "agrifly_tpu/planner/rappids.py:470 (build_pyramid_set's tail, "
                     "_pyramid_from_edges:182, merge_pyramid_sets:613; jnp under jit, no "
                     "pallas_call)",
         "launches": launches["pyramid_set"], **rounds["pyramid_set"]},
        {"name": "lazy_seeds", "route": "cuda", "source": source("rounds"),
         "replaces": "agrifly_tpu/planner/rappids.py:1022 (_plan_core's lazy round: "
                     "prefilter_seeds:538, _greedy_seed_dedupe:912; jnp under jit, no "
                     "pallas_call)",
         "launches": launches["lazy_seeds"], **rounds["lazy_seeds"]},
    ]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        print(f"chip_smoke: FAIL: not launched on their paths: {idle}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
