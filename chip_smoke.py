#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port, `agrifly_tpu_torch`.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the two CUDA kernels from `agrifly_tpu_torch/csrc`, holds each
against its plain PyTorch version at the shapes the orchard frame gives it
(bit-equal), flies the orchard perception-plan-act frame (640x480 depth,
256 candidates, 16 ticks per frame) for 100 frames on the card through
`OrchardEnv.fly`, checks that the flight went through both kernels and
that its output is sane, and holds a 16-tick block on the card against the
same block on the CPU. It prints the card's name and power limit, build
and kernel times, the frame time and its split, then one JSON line with
the kernels and, last, one JSON line with the device. It exits non-zero,
with no result, when anything fails or there is no CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

FRAMES = 100
SEED = 0


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


def fly(dev):
    """The slice: OrchardEnv at full width flies FRAMES frames on the card."""
    import torch

    from agrifly_tpu_torch.planner import cuda_inflate
    from agrifly_tpu_torch.render import cuda_raycast, raycast
    from agrifly_tpu_torch.sim import orchard_env

    env = orchard_env.OrchardEnv(orchard_env.make_params(start_flight_time=1.0)).to(dev)
    state = env.init_state()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    cuda_raycast.render_depth_batch.launches = 0
    cuda_inflate.inflate_pyramids.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = env.fly(state, FRAMES, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"raycast": cuda_raycast.render_depth_batch.launches,
                "inflate": cuda_inflate.inflate_pyramids.launches}

    _check(launches["raycast"] == FRAMES, f"raycast launched {launches['raycast']} times "
                                          f"in {FRAMES} frames")
    _check(launches["inflate"] > 0, "the flight never launched the inflation kernel")
    pos = outs["pos"]
    _check(tuple(pos.shape) == (FRAMES, 3) and bool(torch.isfinite(pos).all()),
           "non-finite or misshaped positions")
    _check(not bool((outs["panic"] != 0).any()), "the vehicle panicked")
    plans = int(state.plan_count)
    _check(plans > 0, "no plan was adopted")
    x = float(pos[-1, 0])
    _check(x > 1.0, f"no forward progress (x = {x:.3f} m)")
    print(f"flight: {FRAMES} frames at 640x480, 256 candidates: {1e3 * seconds / FRAMES:.3f} "
          f"ms/frame; {plans} plans adopted, x = {x:.3f} m, z = {float(pos[-1, 2]):.3f} m; "
          f"kernel launches {launches}")

    # where a frame's time goes, from the final state
    p = env.params
    u, noise = orchard_env.draw(p, gen, dev)
    cam_att = raycast.camera_attitude(state.base.plant.att)[None]
    render = cuda_ms(lambda: cuda_raycast.render_depth_batch(
        p.render_cfg, p.scene, state.base.plant.pos[None], cam_att), reps=5)
    percept = cuda_ms(lambda: orchard_env._frame_percept(p, state, u), reps=5)
    ticks = cuda_ms(lambda: orchard_env.frame_ticks(p, state, noise), reps=5)
    print(f"frame split: render {render:.3f} ms, plan {percept - render:.3f} ms, "
          f"16 ticks {ticks:.3f} ms")
    profile_frame(env, state, gen, 1e3 * seconds / FRAMES)
    return state, launches, 1e3 * seconds / FRAMES


def profile_frame(env, state, gen, frame_ms):
    """Device time over one profiled frame: the sum of its kernels' device
    times, their number, the two port kernels' own times, and the busy
    share of the unprofiled frame time `frame_ms` (the profiler slows the
    host, so its own wall time would read the idle share high).
    Informational: a profiler that cannot trace the card prints "not
    measured" and fails nothing."""
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
                     for e in kernels for name in ("raycast", "inflate")
                     if f"{name}_kernel" in e.key)
    print(f"profiled frame: device busy {busy_ms:.3f} ms in {sum(e.count for e in kernels)} "
          f"kernels ({100 * busy_ms / frame_ms:.2f}% of the unprofiled {frame_ms:.3f} ms "
          f"frame); {ours}")


def check_ticks_against_cpu(state, dev):
    """One 16-tick block from the flight's final state on the card and on
    the CPU, same noise: discrete leaves equal, float leaves within
    1e-3 (|ref| + 1e-3); the commanded body rates (and their wire codes)
    within the controller's 1e-2 rad/s command floor."""
    import torch

    from agrifly_tpu_torch import convert
    from agrifly_tpu_torch.sim import orchard_env

    noise = torch.randn((16, 2, 3), generator=torch.Generator().manual_seed(SEED))
    p_cpu = orchard_env.make_params(start_flight_time=1.0)
    p_dev = orchard_env.OrchardEnv(p_cpu).to(dev).params
    leaves, rebuild = convert.flatten_tensors(state)
    s_cpu = rebuild([t.cpu() for t in leaves])
    got = orchard_env.frame_ticks(p_dev, state, noise.to(dev))
    ref = orchard_env.frame_ticks(p_cpu, s_cpu, noise)
    commands = {("base", "last_cmd_angvel"), ("base", "mocap", "pipe", "angvel")}
    worst = 0.0
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref)):
        a = a.cpu()
        if path == ("base", "ring", "fields"):
            _check(int((a - b).abs().max()) <= 10, f"wire codes differ: {path}")
        elif not a.is_floating_point():
            _check(torch.equal(a, b), f"discrete leaf differs on the card: {path}")
        else:
            d = (a.double() - b.double()).abs()
            if path in commands:
                bound = 1e-2 + 1e-3 * b.double().abs()
            else:
                bound = 1e-3 * (b.double().abs() + 1e-3)
            ratio = float((d / bound).max())
            _check(ratio <= 1.0, f"float leaf off on the card: {path} ({ratio:.3g} x bound)")
            worst = max(worst, ratio)
    print(f"16 ticks card vs CPU: discrete leaves equal, worst float leaf {worst:.3g} x bound")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from agrifly_tpu_torch import cuda_build
        from agrifly_tpu_torch.planner import cuda_inflate  # noqa: F401
        from agrifly_tpu_torch.render import cuda_raycast  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not here: {exc}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    try:
        card = card_line()
        print(card)
        t0 = time.perf_counter()
        for name in ("raycast", "inflate"):
            cuda_build.load(name)
        built = ", ".join(f"{k} {v:.1f} s" for k, v in cuda_build.build_seconds.items())
        print(f"kernel build: {built or 'up to date'} ({time.perf_counter() - t0:.1f} s)")

        k1 = check_raycast(dev)
        k2 = check_inflate(dev)
        state, launches, _ = fly(dev)
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
