#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port, `agrifly_tpu_torch`.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the three CUDA kernels from `agrifly_tpu_torch/csrc` (one nvcc
each, in parallel) and holds each against its plain PyTorch version at the
shapes the orchard frame gives it: the raycaster and the pyramid inflation
bit for bit, the fused 16-tick block in five mission states within the
tick tolerances. It then flies the orchard perception-plan-act frame
(640x480 depth, 256 candidates, 16 ticks per frame) on the card through
`OrchardEnv.fly`: 100 frames in the default configuration, whose ticks are
the fused kernel, and 10 frames with `fused_ticks=False`, whose ticks are
plain torch. It checks that each flight went through its kernels and that
its output is sane, and holds a 16-tick block of the kernel on the card
against the plain block on the CPU. It prints the card's name and power
limit, build and kernel times, the frame time and its split, then one JSON
line with the kernels and, last, one JSON line with the device. It exits
non-zero, with no result, when anything fails or there is no CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

FRAMES = 100  # the default (fused) flight
PLAIN_FRAMES = 10  # the fused_ticks=False flight
SEED = 0
KERNELS = ("raycast", "inflate", "frame")


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


def check_raycast(dev):
    """The raycast kernel against raycast.render_depth at 640x480, B = 1 and 16."""
    import torch

    from agrifly_tpu_torch.ops import rotation as rot
    from agrifly_tpu_torch.render import cuda_raycast, orchard, raycast

    cfg, scene = raycast.make_config(640, 480), orchard.make_params(device=dev)
    g = torch.Generator().manual_seed(SEED)
    result = {}
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
        print(f"raycast B={B} 640x480: bit-equal; kernel {ms:.4f} ms (launch alone "
              f"{launch_ms:.4f} ms), plain {plain_ms:.4f} ms")
        result[B] = (err, ms, plain_ms)
    return result[1]


def check_inflate(dev):
    """The inflation kernel against rappids.inflate_pyramid on rendered
    orchard frames (pooled 240x320 with P = 10 and 20, full 480x640) and on
    a blocker-free gradient scene."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate, rappids
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
    main_case = None
    n_ok = 0
    for name, prm, img, sd, extra in cases:
        got = cuda_inflate.inflate_pyramids(prm, img, *sd, extra)
        ref = rappids.inflate_pyramid(prm, img, *sd, extra)
        ok = ref[0]
        _check(torch.equal(got[0], ok), f"inflate kernel: ok differs ({name})")
        diffs = torch.cat([(got[1] - ref[1])[ok], (got[2] - ref[2])[ok].flatten(),
                           torch.zeros(1, dtype=torch.int32, device=dev)])
        err = int(diffs.abs().max())
        _check(err == 0, f"inflate kernel: maxd/edges differ on ok seeds ({name})")
        n_ok += int(ok.sum())
        ms = cuda_ms(lambda: cuda_inflate.inflate_pyramids(prm, img, *sd, extra))
        rows = cuda_inflate.seed_rows(prm, *sd, extra)
        launch_ms = cuda_ms(lambda: cuda_inflate._launch(img, rows), reps=50)
        plain_ms = cuda_ms(lambda: rappids.inflate_pyramid(prm, img, *sd, extra), reps=3)
        print(f"inflate {name}: bit-equal ({int(ok.sum())} ok seeds); kernel {ms:.4f} ms "
              f"(launch alone {launch_ms:.4f} ms), plain {plain_ms:.4f} ms")
        if main_case is None:
            main_case = (err, ms, plain_ms)
    _check(n_ok > 0, "inflate: no seed inflated in any case; the comparison says nothing")
    return main_case


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


def check_frame_ticks(dev):
    """The fused tick kernel against frame_ticks_plain on the card, same
    states and noise, in five mission states."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    p_cpu = orchard_env.make_params(start_flight_time=0.3)
    p = orchard_env.OrchardEnv(p_cpu).to(dev).params
    noise = torch.randn((16, 2, 3), generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    worst = 0.0
    for name, s_cpu in tick_states(p_cpu).items():
        leaves, rebuild = convert.flatten_tensors(s_cpu)
        s = rebuild([t.to(dev) for t in leaves])
        got = cuda_frame.frame_ticks(p, s, noise)
        ref = orchard_env.frame_ticks_plain(p, s, noise)
        torch.cuda.synchronize()
        _check(int(got.base.step) == int(s.base.step) + 16, f"{name}: step did not advance 16")
        ratio = compare_ticks(got, ref, f"kernel vs plain, {name}")
        print(f"frame_ticks {name}: discrete leaves equal, worst float leaf {ratio:.4g} x bound "
              f"(mstage {int(s.mstage)} -> {int(got.mstage)})")
        worst = max(worst, ratio)
    ms = cuda_ms(lambda: cuda_frame.frame_ticks(p, s, noise), reps=20)
    leaves, _ = convert.flatten_tensors(s)
    pleaves = cuda_frame.param_leaves(p)
    launch_ms = cuda_ms(lambda: cuda_frame._launch(leaves, pleaves, noise), reps=50)
    plain_ms = cuda_ms(lambda: orchard_env.frame_ticks_plain(p, s, noise), reps=3, warmup=1)
    print(f"frame_ticks 16 ticks: kernel {ms:.4f} ms (launch alone {launch_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms")
    return worst, ms, plain_ms


def fly(dev, fused, frames, state=None):
    """The slice: OrchardEnv at full width flies `frames` frames on the
    card, from `state` or from the start; fused: the default configuration
    (the tick kernel), else fused_ticks=False (plain ticks)."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate
    from agrifly_tpu_torch.render import cuda_raycast, raycast
    from agrifly_tpu_torch.sim import cuda_frame, orchard_env

    env = orchard_env.OrchardEnv(
        orchard_env.make_params(start_flight_time=1.0, fused_ticks=fused)).to(dev)
    state = env.init_state() if state is None else state
    plans0 = int(state.plan_count)
    gen = torch.Generator(device=dev).manual_seed(SEED + fused)

    cuda_raycast.render_depth_batch.launches = 0
    cuda_inflate.inflate_pyramids.launches = 0
    cuda_frame.frame_ticks.launches = 0
    orchard_env.frame_ticks_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = env.fly(state, frames, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"raycast": cuda_raycast.render_depth_batch.launches,
                "inflate": cuda_inflate.inflate_pyramids.launches,
                "frame_ticks": cuda_frame.frame_ticks.launches,
                "frame_ticks_plain calls": orchard_env.frame_ticks_plain.calls}

    _check(launches["raycast"] == frames, f"raycast launched {launches['raycast']} times "
                                          f"in {frames} frames")
    _check(launches["inflate"] > 0, "the flight never launched the inflation kernel")
    ticks_k, ticks_p = (frames, 0) if fused else (0, frames)
    _check(launches["frame_ticks"] == ticks_k,
           f"frame_ticks launched {launches['frame_ticks']} times in {frames} frames")
    _check(launches["frame_ticks_plain calls"] == ticks_p,
           f"frame_ticks_plain ran {launches['frame_ticks_plain calls']} times in {frames} frames")
    pos = outs["pos"]
    _check(tuple(pos.shape) == (frames, 3) and bool(torch.isfinite(pos).all()),
           "non-finite or misshaped positions")
    _check(not bool((outs["panic"] != 0).any()), "the vehicle panicked")
    plans = int(state.plan_count) - plans0
    _check(plans > 0, "no plan was adopted")
    x = float(pos[-1, 0])
    _check(x > 1.0, f"no forward progress (x = {x:.3f} m)")
    frame_ms = 1e3 * seconds / frames
    print(f"flight ({'fused' if fused else 'plain'} ticks): {frames} frames at 640x480, 256 "
          f"candidates: {frame_ms:.3f} ms/frame; {plans} plans adopted, x = {x:.3f} m, "
          f"z = {float(pos[-1, 2]):.3f} m; {launches}")

    # where a frame's time goes, from the final state
    p = env.params
    u, noise = orchard_env.draw(p, gen, dev)
    cam_att = raycast.camera_attitude(state.base.plant.att)[None]
    render = cuda_ms(lambda: cuda_raycast.render_depth_batch(
        p.render_cfg, p.scene, state.base.plant.pos[None], cam_att), reps=5)
    percept = cuda_ms(lambda: orchard_env._frame_percept(p, state, u), reps=5)
    ticks = cuda_ms(lambda: orchard_env.frame_ticks(p, state, noise), reps=5)
    print(f"frame split ({'fused' if fused else 'plain'} ticks): render {render:.3f} ms, "
          f"plan {percept - render:.3f} ms, 16 ticks {ticks:.3f} ms")
    if fused:
        profile_frame(env, state, gen, frame_ms)
    return state, launches, frame_ms


def profile_frame(env, state, gen, frame_ms):
    """Device time over one profiled frame: the sum of its kernels' device
    times, their number, the port kernels' own times, and the busy share of
    the unprofiled frame time `frame_ms` (the profiler slows the host, so
    its own wall time would read the idle share high). Informational: a
    profiler that cannot trace the card prints "not measured" and fails
    nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            env.frame_step(state, gen)
            torch.cuda.synchronize()
        rows = prof.key_averages()
    except RuntimeError as exc:
        print(f"profiled frame: not measured ({exc})")
        return
    # device-side rows only: an operator's row repeats its kernels' time
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) * 1e-3
    if busy_ms <= 0:
        print("profiled frame: not measured (the profiler saw no device time)")
        return
    ours = ", ".join(f"{name} {e.self_device_time_total / e.count:.1f} us x{e.count}"
                     for e in kernels for name in KERNELS if f"{name}_kernel" in e.key)
    print(f"profiled frame: device busy {busy_ms:.3f} ms in {sum(e.count for e in kernels)} "
          f"kernels ({100 * busy_ms / frame_ms:.2f}% of the unprofiled {frame_ms:.3f} ms "
          f"frame); {ours}")


def check_ticks_against_cpu(state, dev):
    """One 16-tick block from the flight's final state: the kernel on the
    card against the plain ticks on the CPU, same noise, tick criteria."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import orchard_env

    noise = torch.randn((16, 2, 3), generator=torch.Generator().manual_seed(SEED))
    p_cpu = orchard_env.make_params(start_flight_time=1.0)
    p_dev = orchard_env.OrchardEnv(p_cpu).to(dev).params
    leaves, rebuild = convert.flatten_tensors(state)
    s_cpu = rebuild([t.cpu() for t in leaves])
    got = orchard_env.frame_ticks(p_dev, state, noise.to(dev))
    ref = orchard_env.frame_ticks_plain(p_cpu, s_cpu, noise)
    worst = compare_ticks(got, ref, "card kernel vs CPU plain")
    print(f"16 ticks, kernel on the card vs plain on the CPU: discrete leaves equal, worst "
          f"float leaf {worst:.4g} x bound")


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
    try:
        print(card_line())
        build_kernels()
        k1 = check_raycast(dev)
        k2 = check_inflate(dev)
        k3 = check_frame_ticks(dev)
        state, launches, _ = fly(dev, fused=True, frames=FRAMES)
        fly(dev, fused=False, frames=PLAIN_FRAMES, state=state)
        check_ticks_against_cpu(state, dev)
    except Exception as exc:  # report and fail: no result line
        print(f"chip_smoke: FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1

    kernels = [
        {"name": "raycast", "route": "cuda", "source": "agrifly_tpu_torch/csrc/raycast.cu",
         "replaces": "agrifly_tpu/render/pallas_raycast.py:75", "launches": launches["raycast"],
         "max_abs_err": k1[0], "ms": k1[1], "plain_ms": k1[2]},
        {"name": "inflate", "route": "cuda", "source": "agrifly_tpu_torch/csrc/inflate.cu",
         "replaces": "agrifly_tpu/planner/pallas_inflate.py:89", "launches": launches["inflate"],
         "max_abs_err": k2[0], "ms": k2[1], "plain_ms": k2[2]},
        {"name": "frame_ticks", "route": "cuda", "source": "agrifly_tpu_torch/csrc/frame.cu",
         "replaces": "agrifly_tpu/sim/pallas_frame.py:144",
         "launches": launches["frame_ticks"], "max_abs_err": k3[0], "ms": k3[1],
         "plain_ms": k3[2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
