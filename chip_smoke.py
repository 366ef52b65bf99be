#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port, `agrifly_tpu_torch`.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the three CUDA kernels from `agrifly_tpu_torch/csrc` (one nvcc
each, in parallel) and holds each against its plain PyTorch version at the
shapes the orchard frame gives it: the raycaster and the pyramid inflation
bit for bit (one image, and 16 fleet images in one launch), the fused
16-tick block within the tick tolerances in five mission states, for one
vehicle and for fleets of 5 and 37 in one launch. It then flies:

- the single-vehicle orchard frame (640x480 depth, 256 candidates, 16
  ticks per frame) through `OrchardEnv.fly`: 100 frames in the default
  configuration, whose ticks are the fused kernel, and 5 frames with
  `fused_ticks=False`, whose ticks are plain torch;
- a fleet of 16 vehicles in lanes 3 m apart, 40 frames through
  `OrchardEnv.fly_fleet`, whose every frame launches the raycaster once,
  the inflation once per planner round and the tick kernel once, for all
  16 vehicles; then timed fleet frames of 64 vehicles.

Each flight's kernel counts are set to 0 just before it and read just
after; it checks that the flight went through its kernels and that its
output is sane, and holds a 16-tick block of the kernel on the card against
the plain block on the CPU from the flight's final state. It prints the
card's name and power limit, build and kernel times, frame times and their
split, then one JSON line with the kernels and, last, one JSON line with
the device. It exits non-zero, with no result, when anything fails or
there is no CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

FRAMES = 100  # the default (fused) single-vehicle flight
PLAIN_FRAMES = 5  # the fused_ticks=False flight
FLEET, FLEET_FRAMES, BIG_FLEET = 16, 40, 64  # the fleet flight; the timed big fleet
FLEET_START = 0.3  # [s] planning starts inside the fleet flight
SEED = 0
KERNELS = ("raycast", "inflate", "frame")

# The least time the card could take for a kernel's work (its bound): the
# larger of its bytes over the memory rate and its operations over the
# float32 rate outside the tensor cores (an NVIDIA H100 SXM at 700 W; the
# kernels' integer operations are counted at that rate too, which can only
# lower the bound). Operation counts per item are read off the sources.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
RAY_OPS_PER_CELL = 150  # csrc/raycast.cu tree_hit: 5 hashes, cylinder, 2 spheres
RAY_OPS_PER_PIXEL = 40  # ray set-up, ground plane, DDA set-up, code
INFLATE_OPS_PER_PIXEL = 8  # csrc/inflate.cu pass C: one shrink divide, 4 band tests
TICK_OPS = 20000  # csrc/frame.cu sim_tick, float operations per vehicle and tick


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


def check_raycast(dev):
    """The raycast kernel against raycast.render_depth at 640x480, B = 1 and 16."""
    import torch

    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast

    cfg, scene = raycast.make_config(640, 480), orchard.make_params(device=dev)
    g = torch.Generator().manual_seed(SEED)
    results = {}
    for B in (1, 16):
        pos = torch.stack([torch.rand(B, generator=g) * 40, torch.rand(B, generator=g) * 16 - 8,
                           torch.rand(B, generator=g) * 3 + 0.5], dim=1).to(dev)
        ypr = ((torch.rand(B, 3, generator=g) - 0.5) * 0.6).to(dev)
        cam = raycast.camera_attitude(rot.from_euler_ypr(ypr[:, 0], ypr[:, 1], ypr[:, 2]))
        got = cuda_raycast.render_depth_batch(cfg, scene, pos, cam)
        ref = raycast.render_depth(cfg, scene, pos, cam)
        err = int((got - ref).abs().max())
        _check(err == 0, f"raycast kernel differs from plain at B={B} (max {err} codes)")
        _check(got.unique().numel() > 20, "raycast rendered an empty scene")
        ms = cuda_ms(lambda: cuda_raycast.render_depth_batch(cfg, scene, pos, cam))
        rows = cuda_raycast.camera_rows(pos, cam)
        launch_ms = cuda_ms(lambda: cuda_raycast._launch(cfg, scene, rows), reps=50)
        plain_ms = cuda_ms(lambda: raycast.render_depth(cfg, scene, pos, cam), reps=3)
        res = result(err, ms, plain_ms, nbytes(rows, got) + 40,
                     got.numel() * (RAY_OPS_PER_PIXEL + RAY_OPS_PER_CELL * cfg.dda_steps))
        print(f"raycast B={B} 640x480: bit-equal; kernel {ms:.4f} ms (launch alone "
              f"{launch_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {res['bound_ms']:.6f} ms "
              f"({res['bound_by']})")
        results[B] = res
    return results[1]


def _inflate_case(name, prm, img, sd, extra):
    """One inflation call through the kernel, held bit for bit against the
    plain version (ok everywhere, maxd and edges wherever ok), and timed.
    Returns (result, ok seeds)."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate, rappids

    before = cuda_inflate.inflate_pyramids.launches
    got = cuda_inflate.inflate_pyramids(prm, img, *sd, extra)
    _check(cuda_inflate.inflate_pyramids.launches == before + 1,
           f"inflate ({name}): not one launch")
    ref = rappids.inflate_pyramid(prm, img, *sd, extra)
    ok = ref[0]
    _check(torch.equal(got[0], ok), f"inflate kernel: ok differs ({name})")
    diffs = torch.cat([(got[1] - ref[1])[ok], (got[2] - ref[2])[ok].flatten(),
                       torch.zeros(1, dtype=torch.int32, device=img.device)])
    err = int(diffs.abs().max())
    _check(err == 0, f"inflate kernel: maxd/edges differ on ok seeds ({name})")
    n_ok = int(ok.sum())
    ms = cuda_ms(lambda: cuda_inflate.inflate_pyramids(prm, img, *sd, extra))
    rows = cuda_inflate.seed_rows(prm, *sd, extra)
    launch_ms = cuda_ms(lambda: cuda_inflate._launch(img, rows), reps=50)
    plain_ms = cuda_ms(lambda: rappids.inflate_pyramid(prm, img, *sd, extra), reps=3)
    # bytes: the images, the seed rows and the (.., 8) int32 output rows;
    # operations: every seed that ends ok swept its whole image in pass C
    H, W = img.shape[-2:]
    res = result(err, ms, plain_ms, nbytes(img, rows) + rows.numel() // 12 * 32,
                 n_ok * H * W * INFLATE_OPS_PER_PIXEL)
    print(f"inflate {name}: bit-equal ({n_ok} ok seeds); kernel {ms:.4f} ms (launch alone "
          f"{launch_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {res['bound_ms']:.6f} ms "
          f"({res['bound_by']})")
    return res, n_ok


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


def compare_ticks(got, ref, where):
    """The tick criteria: discrete leaves equal, float leaves within
    1e-3 (|ref| + 1e-3), the commanded body rates within the controller's
    1e-2 rad/s command floor (+ 1e-3 |ref|) and their wire codes within 10
    codes. Returns the worst float leaf's ratio to its bound."""
    import torch

    from agrifly_tpu_torch import convert

    commands = {("base", "last_cmd_angvel"), ("base", "mocap", "pipe", "angvel")}
    worst = 0.0
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref)):
        a, b = a.cpu(), b.cpu()
        if path == ("base", "ring", "fields"):
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

    p_cpu = orchard_env.make_params(start_flight_time=0.3, device="cpu")
    p = orchard_env.OrchardEnv(p_cpu).to(dev).params
    noise = torch.randn((16, 2, 3), generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    worst = 0.0
    for name, s_cpu in tick_states(p_cpu).items():
        s = to_device(s_cpu, dev)
        got = cuda_frame.frame_ticks(p, s, noise)
        ref = orchard_env.frame_ticks_plain(p, s, noise)
        torch.cuda.synchronize()
        _check(int(got.base.step) == int(s.base.step) + 16, f"{name}: step did not advance 16")
        ratio = compare_ticks(got, ref, f"kernel vs plain, {name}")
        print(f"frame_ticks {name}: discrete leaves equal, worst float leaf {ratio:.4g} x bound "
              f"(mstage {int(s.mstage)} -> {int(got.mstage)})")
        worst = max(worst, ratio)
    return tick_result(worst, p, s, noise)


def check_frame_ticks_batched(dev):
    """The tick kernel for a fleet (K3b): the five mission states repeated
    to B = 5 and 37 rows (37 crosses the 32-thread block), one launch each,
    against the plain ticks of every vehicle on the card. Returns the worst
    float leaf's ratio to its bound."""
    import torch

    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    p_cpu = orchard_env.make_params(start_flight_time=0.3, device="cpu")
    p = orchard_env.OrchardEnv(p_cpu).to(dev).params
    states = list(tick_states(p_cpu).values())
    worst = 0.0
    for B in (5, 37):
        fleet = to_device(orchard_env.stack_states([states[b % 5] for b in range(B)]), dev)
        noise = torch.randn((B, 16, 2, 3), generator=torch.Generator().manual_seed(B)).to(dev)
        before = cuda_frame.frame_ticks.launches
        got = cuda_frame.frame_ticks(p, fleet, noise)
        _check(cuda_frame.frame_ticks.launches == before + 1, f"K3b B={B}: not one launch")
        ref = orchard_env.frame_ticks_plain_fleet(p, fleet, noise)
        torch.cuda.synchronize()
        _check(torch.equal(got.base.step, fleet.base.step + 16), f"K3b B={B}: steps")
        ratio = compare_ticks(got, ref, f"K3b vs plain, B={B}")
        print(f"frame_ticks batched B={B} (one launch): discrete leaves equal, worst float leaf "
              f"{ratio:.4g} x bound; mstage {fleet.mstage[:5].tolist()} -> "
              f"{got.mstage[:5].tolist()}")
        worst = max(worst, ratio)
    return worst


def reset_counts():
    from agrifly_tpu_torch.planner import cuda_inflate
    from agrifly_tpu_torch.render import cuda_raycast
    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    cuda_raycast.render_depth_batch.launches = 0
    cuda_inflate.inflate_pyramids.launches = 0
    cuda_frame.frame_ticks.launches = 0
    orchard_env.frame_ticks_plain.calls = 0


def read_counts():
    from agrifly_tpu_torch.planner import cuda_inflate
    from agrifly_tpu_torch.render import cuda_raycast
    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    return {"raycast": cuda_raycast.render_depth_batch.launches,
            "inflate": cuda_inflate.inflate_pyramids.launches,
            "frame_ticks": cuda_frame.frame_ticks.launches,
            "frame_ticks_plain calls": orchard_env.frame_ticks_plain.calls}


def check_counts(launches, frames, fused, rounds):
    """Per frame, whatever the number of vehicles: one raycast launch, one
    inflation launch per planner round, and one tick launch (fused) or one
    plain tick block (plain, one vehicle)."""
    _check(launches["raycast"] == frames,
           f"raycast launched {launches['raycast']} times in {frames} frames")
    _check(launches["inflate"] == rounds * frames,
           f"inflate launched {launches['inflate']} times in {frames} frames of {rounds} rounds")
    ticks_k, ticks_p = (frames, 0) if fused else (0, frames)
    _check(launches["frame_ticks"] == ticks_k,
           f"frame_ticks launched {launches['frame_ticks']} times in {frames} frames")
    _check(launches["frame_ticks_plain calls"] == ticks_p,
           f"frame_ticks_plain ran {launches['frame_ticks_plain calls']} times in {frames} frames")


def frame_split(p, state, gen, dev, label):
    """Where a frame's time goes, from `state` (each part timed apart, so
    the parts need not sum to the frame)."""
    from agrifly_tpu_torch.render import cuda_raycast, raycast
    from agrifly_tpu_torch.sim import orchard_env

    lead = state.base.step.shape
    u, noise = (orchard_env.draw_fleet(p, gen, lead[0], dev) if lead
                else orchard_env.draw(p, gen, dev))
    cam_att = raycast.camera_attitude(state.base.plant.att).reshape(-1, 4)
    render = cuda_ms(lambda: cuda_raycast.render_depth_batch(
        p.render_cfg, p.scene, state.base.plant.pos.reshape(-1, 3), cam_att), reps=5)
    percept = cuda_ms(lambda: orchard_env._frame_percept(p, state, u), reps=5)
    ticks = cuda_ms(lambda: orchard_env.frame_ticks(p, state, noise), reps=5)
    print(f"frame split ({label}): render {render:.3f} ms, plan {percept - render:.3f} ms, "
          f"16 ticks {ticks:.3f} ms")


def fly(dev, fused, frames, state=None):
    """The single-vehicle slice: OrchardEnv at full width flies `frames`
    frames on the card, from `state` or from the start; fused: the default
    configuration (the tick kernel), else fused_ticks=False (plain ticks)."""
    import torch

    from agrifly_tpu_torch.sim import orchard_env

    env = orchard_env.OrchardEnv(
        orchard_env.make_params(start_flight_time=1.0, fused_ticks=fused, device=dev))
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
    check_counts(launches, frames, fused, env.params.planner_rounds + 1)
    pos = outs["pos"]
    _check(tuple(pos.shape) == (frames, 3) and bool(torch.isfinite(pos).all()),
           "non-finite or misshaped positions")
    _check(not bool((outs["panic"] != 0).any()), "the vehicle panicked")
    plans = int(state.plan_count) - plans0
    _check(plans > 0, "no plan was adopted")
    x = float(pos[-1, 0])
    _check(x > 1.0, f"no forward progress (x = {x:.3f} m)")
    frame_ms = 1e3 * seconds / frames
    label = "fused" if fused else "plain"
    print(f"flight ({label} ticks): {frames} frames at 640x480, 256 candidates: "
          f"{frame_ms:.3f} ms/frame; {plans} plans adopted, x = {x:.3f} m, "
          f"z = {float(pos[-1, 2]):.3f} m; {launches}")
    frame_split(env.params, state, gen, dev, f"{label} ticks")
    if fused:
        profile_frame(lambda: env.frame_step(state, gen), frame_ms, "frame")
    return state, launches


def fly_fleet(dev):
    """The fleet slice: FLEET vehicles in lanes 3 m apart fly FLEET_FRAMES
    frames of the default configuration through OrchardEnv.fly_fleet."""
    import torch

    from agrifly_tpu_torch.sim import orchard_env

    env = orchard_env.OrchardEnv(
        orchard_env.make_params(start_flight_time=FLEET_START, device=dev))
    state = env.init_state_fleet(lanes(FLEET, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = env.fly_fleet(state, FLEET_FRAMES, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_counts(launches, FLEET_FRAMES, True, env.params.planner_rounds + 1)
    pos = outs["pos"]
    _check(tuple(pos.shape) == (FLEET_FRAMES, FLEET, 3) and bool(torch.isfinite(pos).all()),
           "fleet: non-finite or misshaped positions")
    _check(not bool((outs["panic"] != 0).any()), "fleet: a vehicle panicked")
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
    frame_ms = 1e3 * seconds / FLEET_FRAMES
    print(f"fleet flight: {FLEET} vehicles x {FLEET_FRAMES} frames at 640x480, 256 candidates: "
          f"{frame_ms:.3f} ms per fleet frame ({FLEET * 32.0 / frame_ms:.3f}x real time in "
          f"aggregate); plans adopted per vehicle {state.plan_count.tolist()}, centre-lane mean "
          f"x {x0:.3f} -> {x1:.3f} m, final |y| {[round(v, 2) for v in y1.abs().tolist()]} m, "
          f"final speed {[round(v, 2) for v in outs['vel'][-1].norm(dim=-1).tolist()]} m/s, "
          f"mean z {float(pos[-1, :, 2].mean()):.3f} m; {launches}")
    frame_split(env.params, state, gen, dev, f"fleet of {FLEET}")
    profile_frame(lambda: env.frame_step_fleet(state, gen), frame_ms, f"fleet frame, B={FLEET}")
    return state, launches


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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
                     for e in kernels for name in KERNELS if f"{name}_kernel" in e.key)
    print(f"profiled {label}: device busy {busy_ms:.3f} ms in {sum(e.count for e in kernels)} "
          f"kernels ({100 * busy_ms / frame_ms:.2f}% of the unprofiled {frame_ms:.3f} ms); "
          f"{ours}")


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


def build_kernels():
    """Build the three kernels, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from agrifly_tpu_torch import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(cuda_build.load, KERNELS))
    built = ", ".join(f"{k} {v:.1f} s" for k, v in cuda_build.build_seconds.items())
    print(f"kernel build: {built or 'up to date'} ({time.perf_counter() - t0:.1f} s)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from agrifly_tpu_torch import cuda_build  # noqa: F401
        from agrifly_tpu_torch.planner import cuda_inflate  # noqa: F401
        from agrifly_tpu_torch.render import cuda_raycast  # noqa: F401
        from agrifly_tpu_torch.sim import cuda_frame  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not here: {exc}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        print(card_line())
        build_kernels()
        k1 = check_raycast(dev)
        k2 = check_inflate(dev)
        k2b = check_inflate_batched(dev)
        k3 = check_frame_ticks(dev)
        k3b_worst = check_frame_ticks_batched(dev)
        state, launches = fly(dev, fused=True, frames=FRAMES)
        fly(dev, fused=False, frames=PLAIN_FRAMES, state=state)
        check_ticks_against_cpu(state, dev, 1.0)
        fleet_state, fleet_launches = fly_fleet(dev)
        p_dev, noise, worst = check_ticks_against_cpu(fleet_state, dev, FLEET_START)
        k3b = tick_result(max(k3b_worst, worst), p_dev, fleet_state, noise, plain_reps=1,
                          plain_warmup=0)
        time_big_fleet(dev)
    except Exception as exc:  # report and fail: no result line
        print(f"chip_smoke: FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")

    source = "agrifly_tpu_torch/csrc/{}.cu".format
    kernels = [
        {"name": "raycast", "route": "cuda", "source": source("raycast"),
         "replaces": "agrifly_tpu/render/pallas_raycast.py:167",
         "launches": launches["raycast"], **k1},
        {"name": "inflate", "route": "cuda", "source": source("inflate"),
         "replaces": "agrifly_tpu/planner/pallas_inflate.py:1174",
         "launches": launches["inflate"], **k2},
        {"name": "frame_ticks", "route": "cuda", "source": source("frame"),
         "replaces": "agrifly_tpu/sim/pallas_frame.py:144",
         "launches": launches["frame_ticks"], **k3},
        {"name": "frame_ticks_batched", "route": "cuda", "source": source("frame"),
         "replaces": "agrifly_tpu/sim/pallas_frame.py:315",
         "launches": fleet_launches["frame_ticks"], **k3b},
        {"name": "inflate_batched", "route": "cuda", "source": source("inflate"),
         "replaces": "agrifly_tpu/planner/pallas_inflate.py:1174",
         "launches": fleet_launches["inflate"], **k2b},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
