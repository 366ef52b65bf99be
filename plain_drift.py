"""Where the plain tick on CUDA tensors parts from the same tick on the CPU.

The port's plain tick (`sim/env.step`, `rollout_plain`, the fleets' plain
rollouts) is plain PyTorch, so on CUDA tensors it should give what it gives
on the CPU, where it matches the JAX package. This script measures how far
the two runs part and finds the torch operations that part them:

1. Readings. `env.rollout_plain` from one state with the same noise, once on
   the card and once on the CPU, a tick at a time: the first tick at which a
   leaf differs at all, the first at which one leaves the tick criteria
   (tests/_torch_parity.py), and the worst leaves at the end. The same for
   `fleet_env.uwb_fleet_rollout_plain` in the rates mode after a position
   leg (the shared-UWB fleet's closed loop).
2. Operations. One tick on the card under a dispatch mode that runs every
   ATen operation a second time on CPU copies of its inputs and compares
   the two results bit for bit. Where they differ, it prints the operation,
   the port's line that called it, how often and the largest difference.
   For an elementwise operation the CPU path computes the correctly
   rounded float32 value (`ops/fmath` rounds sin, cos, exp and sqrt through
   float64 there; the CPU divides exactly), so such an operation counts
   only where the card's result is not that value (the operation in
   float64 on the CPU on float32 inputs, python numbers rounded to
   float32 first, then rounded). A float64 result (ops/fmath's
   intermediates) is compared as the float32 value the port keeps of it.

3. The planner. One `rappids.plan` call at the orchard default (640x480
   depth codes of a mid-flight frame, 256 candidates): a vehicle flies
   `--plan-frames` frames on the card, then one more frame's percept
   (`orchard_env._frame_percept`: the render, the mocap prediction, the
   plan and the mission's bookkeeping) runs under the same dispatch mode,
   with the planner's uniform draws made on the host. The inputs it hands
   `rappids.plan` are then planned again on the card and on CPU copies,
   and the plans are read against each other: `found`, the winner's index,
   cost and coefficients, the gates, the collision labels and the costs of
   every candidate. The cube root alone takes another path on the card
   (correctly rounded) than on the CPU (torch's float32 pow): how often the
   two differ is read apart, on a million magnitudes (a reading, not a
   gate).

Run on a machine with a card, from the repository root:

    python3 plain_drift.py [--steps 250] [--envs 8] [--op-ticks 40]
                           [--plan-frames 48] [--phase all|tick|plan]

It exits with 1 where the plain rollout on the card leaves the tick criteria
against the CPU run, where an operation on the card differs from its CPU
result, or where the plan on the card is not the CPU's bit for bit, and
prints `plain drift: none` otherwise.
"""

from __future__ import annotations

import argparse
import collections
import sys
import traceback

import numpy as np
import torch

FLOAT_REL, FLOAT_FLOOR = 1e-3, 1e-3  # tests/_torch_parity.py's tick criteria
COMMAND_FLOOR = 1e-2
COMMAND_LEAVES = {"last_cmd_angvel", "mocap.pipe.angvel"}
WIRE_MAX_CODES = int(np.ceil(COMMAND_FLOOR / (35.0 / 32768.0)))
ELEMENTWISE = ("sin", "cos", "exp", "sqrt", "div")  # correctly rounded on the CPU path


def leaf_ratios(got, ref):
    """(ratio to the tick bound, path) of every leaf of `got` against `ref`
    (both on the CPU), inf for a discrete leaf that differs; wire fields in
    codes over the command floor's codes."""
    from agrifly_tpu_torch import convert

    out = []
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref)):
        name = ".".join(path)
        a, b = a.cpu(), b.cpu()
        if name.endswith("ring.fields"):
            d = (a.long() - b.long()).abs().max().item() if a.numel() else 0
            out.append((d / WIRE_MAX_CODES, name))
        elif not a.is_floating_point():
            out.append((0.0 if torch.equal(a, b) else float("inf"), name))
        else:
            d = (a.double() - b.double()).abs()
            floor = COMMAND_FLOOR if any(name.endswith(c) for c in COMMAND_LEAVES) else 0.0
            bound = floor + FLOAT_REL * (b.double().abs() + (0.0 if floor else FLOAT_FLOOR))
            out.append((float((d / bound).max()) if d.numel() else 0.0, name))
    return sorted(out, reverse=True)


def bit_equal(got, ref):
    from agrifly_tpu_torch import convert

    return all(torch.equal(a.cpu(), b.cpu())
               for (_, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref)))


def to(tree, dev):
    from agrifly_tpu_torch import convert

    leaves, rebuild = convert.flatten_tensors(tree)
    return rebuild([t.to(dev) for t in leaves])


def env_case(dev, B, seed):
    from agrifly_tpu_torch.sim import env

    g = torch.Generator().manual_seed(seed)
    p = env.make_params(noise_scale=1.0, device="cpu")
    pos = torch.rand((B, 3), generator=g) * torch.tensor([4.0, 4.0, 0.0])
    s0 = env.init_state_fleet(p, pos)
    cmd = env.hover_command((0.0, 0.0, 1.5), device="cpu")
    return p, s0, cmd, g


def read_env(dev, B, steps, use_estimator, seed=0):
    """rollout_plain on the card and on the CPU a tick at a time; prints and
    returns the worst ratio at the end."""
    from agrifly_tpu_torch.sim import env

    p, s_cpu, cmd, g = env_case(dev, B, seed)
    noise = torch.randn((B, steps, 2, 3), generator=g)
    p_dev, s_dev, cmd_dev, noise_dev = to(p, dev), to(s_cpu, dev), to(cmd, dev), noise.to(dev)
    first_bits = first_out = None
    worst = []
    for k in range(steps):
        s_cpu, _ = env.rollout_plain(p, s_cpu, cmd, noise[:, k:k + 1], use_estimator)
        s_dev, _ = env.rollout_plain(p_dev, s_dev, cmd_dev, noise_dev[:, k:k + 1], use_estimator)
        if first_bits is None and not bit_equal(s_dev, s_cpu):
            first_bits = k + 1
            print(f"  first leaves apart after tick {k + 1}:",
                  [n for r, n in leaf_ratios(s_dev, s_cpu) if r > 0][:6])
        worst = leaf_ratios(s_dev, s_cpu)
        if first_out is None and worst[0][0] > 1.0:
            first_out = k + 1
    print(f"env.rollout_plain use_estimator={use_estimator}, {B} envs x {steps} ticks, card vs "
          f"CPU: first bit difference after tick {first_bits}, first past the tick criteria "
          f"after tick {first_out}; at the end worst leaves "
          + ", ".join(f"{n} {r:.4g}" for r, n in worst[:4]))
    return worst[0][0]


def read_uwb_fleet(dev, n_vehicles=32, n_anchors=1, n=120, seed=39):
    """uwb_fleet_rollout_plain in the rates mode after a position leg, on
    the card and on the CPU (the case of the K6 rates-mode card test)."""
    from agrifly_tpu_torch.sim import fleet_env

    g = torch.Generator().manual_seed(seed)
    ids = list(range(101, 101 + n_anchors))
    pos = (torch.rand((n_anchors, 3), generator=g) * torch.tensor([10.0, 10.0, 4.0])
           - torch.tensor([5.0, 5.0, 0.0])).tolist()
    w = fleet_env.make_wind((1.0, 0.0, 0.0), 0.5, 2.0, 0.01, device="cpu")
    p = fleet_env.make_uwb_fleet_params(n_vehicles, ids, pos, wind=w, comm_period=0.004,
                                        noise_std=0.05, device="cpu")
    s = fleet_env.init_uwb_fleet(p, spacing=1.0)
    des = torch.rand((n_vehicles, 3), generator=g) * 2.0 + torch.tensor([0.0, 0.0, 1.0])
    noise = torch.randn((n_vehicles, n, 2, 3), generator=g)
    gusts = torch.randn((n, n_vehicles, 3), generator=g)
    draws = torch.cat([torch.rand((n, 1), generator=g), torch.randn((n, 2), generator=g),
                       torch.rand((n, 1), generator=g)], 1)
    out = {}
    for d in ("cpu", dev):
        args = [to(x, d) for x in (p, s, des, noise, gusts, draws)]
        mid = fleet_env.uwb_fleet_rollout_plain(*args, "position")
        out[str(d)] = fleet_env.uwb_fleet_rollout_plain(args[0], mid, *args[2:], "rates")
    worst = leaf_ratios(out[str(dev)], out["cpu"])
    print(f"uwb_fleet_rollout_plain {n_vehicles} vehicles + {n_anchors} anchors, {n} ticks "
          f"position then {n} rates, card vs CPU: bit-equal "
          f"{bit_equal(out[str(dev)], out['cpu'])}; worst leaves "
          + ", ".join(f"{n_} {r:.4g}" for r, n_ in worst[:4]))
    return worst[0][0]


def port_site():
    """The innermost two frames of the port's code on the stack."""
    frames = [f for f in traceback.extract_stack()
              if "agrifly_tpu_torch" in f.filename and "plain_drift" not in f.filename]
    return " < ".join(f"{f.filename.split('agrifly_tpu_torch/')[-1]}:{f.lineno}"
                      for f in frames[-2:][::-1])


def op_finder():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    found = collections.OrderedDict()
    benign = collections.Counter()

    def cpu(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    def wide(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.detach().cpu().double()
        if isinstance(x, float):
            return float(np.float32(x))
        return cpu(x)

    class Compare(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in list(args) + list(kwargs.values())):
                return out
            name = str(func.overloadpacket.__name__)
            if name in ("copy_", "_to_copy", "empty", "empty_like", "new_empty", "detach",
                        "lift_fresh", "_local_scalar_dense", "clone"):
                return out
            try:
                ref = func(*tree_map(cpu, args), **tree_map(cpu, kwargs))
            except Exception:  # an op whose CPU form takes other arguments
                return out
            outs = out if isinstance(out, (tuple, list)) else (out,)
            refs = ref if isinstance(ref, (tuple, list)) else (ref,)
            for o, r in zip(outs, refs):
                if not isinstance(o, torch.Tensor) or not isinstance(r, torch.Tensor):
                    continue
                oc, r = o.detach().cpu(), r.detach().cpu()
                if oc.dtype == torch.float64:  # fmath's intermediates: what the port keeps
                    oc, r = oc.float(), r.float()
                if oc.shape != r.shape or oc.dtype != r.dtype:
                    continue
                same = (oc == r) | (oc.isnan() & r.isnan()) if oc.is_floating_point() \
                    else oc == r
                if bool(same.all()):
                    continue
                if name in ELEMENTWISE and oc.dtype == torch.float32:
                    cr = func(*tree_map(wide, args), **tree_map(wide, kwargs)).float()
                    if torch.equal(oc, cr):
                        benign[name] += 1  # the CPU path's value; the raw CPU op's is not
                        continue
                key = (name, port_site())
                e = found.setdefault(key, dict(calls=0, elems=0, max_abs=0.0))
                e["calls"] += 1
                e["elems"] += int((~same).sum())
                if oc.is_floating_point():
                    e["max_abs"] = max(e["max_abs"], float((oc.double() - r.double()).abs()
                                                           .nan_to_num().max()))
            return out

    return Compare, found, benign


def find_ops(dev, ticks, use_estimator):
    """One vehicle, `ticks` ticks of env.step on the card, every operation
    compared with the CPU's result on the same inputs."""
    from agrifly_tpu_torch.sim import env

    p, s, cmd, g = env_case(dev, 1, 1)
    noise = torch.randn((ticks, 2, 3), generator=g).to(dev)
    p, cmd = to(p, dev), to(cmd, dev)
    s = to(env.init_state(p, (0.5, -0.3, 0.0)), dev)
    Compare, found, benign = op_finder()
    with torch.inference_mode(), Compare():
        for k in range(ticks):
            s, _ = env.step(p, s, cmd, use_estimator, "rates", noise=noise[k])
    print(f"operations of env.step on the card (use_estimator={use_estimator}, {ticks} ticks) "
          f"whose result differs from the CPU path's on the same inputs: {len(found)} (calls "
          f"where only the raw CPU operation differs, the card giving the correctly rounded "
          f"value: {dict(benign)})")
    for (name, site), e in found.items():
        print(f"  {name} at {site}: {e['calls']} calls, {e['elems']} elements, max |d| "
              f"{e['max_abs']:.3g}")
    return found


def find_ops_fleet(dev, n=20):
    """The shared-UWB fleet (3 vehicles + 2 anchors, wind) for n position
    and n rates ticks of uwb_fleet_rollout_plain on the card, every
    operation compared as in find_ops."""
    from agrifly_tpu_torch.sim import fleet_env

    g = torch.Generator().manual_seed(5)
    w = fleet_env.make_wind((1.0, 0.0, 0.0), 0.5, 2.0, 0.01, device=dev)
    p = fleet_env.make_uwb_fleet_params(3, [101, 102], [[-3.0, 2.0, 0.5], [4.0, -1.0, 2.0]],
                                        wind=w, comm_period=0.004, noise_std=0.05, device=dev)
    s = fleet_env.init_uwb_fleet(p, spacing=1.0)
    des = (torch.rand((3, 3), generator=g) * 2.0 + torch.tensor([0.0, 0.0, 1.0])).to(dev)
    noise = torch.randn((3, n, 2, 3), generator=g).to(dev)
    gusts = torch.randn((n, 3, 3), generator=g).to(dev)
    draws = torch.cat([torch.rand((n, 1), generator=g), torch.randn((n, 2), generator=g),
                       torch.rand((n, 1), generator=g)], 1).to(dev)
    Compare, found, benign = op_finder()
    with Compare():
        for ctrl in ("position", "rates"):
            s = fleet_env.uwb_fleet_rollout_plain(p, s, des, noise, gusts, draws, ctrl)
    print(f"operations of uwb_fleet_rollout_plain on the card (3 vehicles + 2 anchors, {n} "
          f"position and {n} rates ticks) whose result differs from the CPU path's: "
          f"{len(found)} (calls where only the raw CPU operation differs: {dict(benign)})")
    for (name, site), e in found.items():
        print(f"  {name} at {site}: {e['calls']} calls, {e['elems']} elements, max |d| "
              f"{e['max_abs']:.3g}")
    return found


def plan_case(dev, frames):
    """A vehicle at the orchard default flies `frames` frames on the card
    (planning from 1 s); the next frame's percept runs under the op finder.
    Returns (what rappids.plan was called with, the finder's results)."""
    from agrifly_tpu_torch.planner import rappids
    from agrifly_tpu_torch.sim import orchard_env

    p = orchard_env.make_params(start_flight_time=1.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    s, _ = orchard_env.fly(p, orchard_env.init_state(p), frames, gen)
    u = torch.rand((4, p.n_candidates), generator=torch.Generator().manual_seed(1)).to(dev)
    call = {}
    real = rappids.plan

    def spy(*args, **kwargs):
        call.update(args=args, kwargs=kwargs)
        return real(*args, **kwargs)

    Compare, found, benign = op_finder()
    rappids.plan = spy
    try:
        with torch.inference_mode(), Compare():
            orchard_env._frame_percept(p, s, u)
    finally:
        rappids.plan = real
    return call, found, benign


def plan_arg(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return to(x, dev) if hasattr(x, "_fields") else x


def differ(a, b):
    """(elements apart, largest |difference|) of two tensors."""
    a, b = a.cpu(), b.cpu()
    same = (a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() else a == b
    if bool(same.all()):
        return 0, 0.0
    d = (a.double() - b.double()).abs().nan_to_num() if a.is_floating_point() else None
    return int((~same).sum()), 0.0 if d is None else float(d.max())


def read_plan(dev, frames):
    """The finder over one mid-flight frame's percept, then its plan on the
    card against the same plan on CPU copies of its inputs. Returns (ops
    apart, fields apart)."""
    from agrifly_tpu_torch.planner import rappids

    call, found, benign = plan_case(dev, frames)
    print(f"operations of a mid-flight frame's percept on the card (640x480, 256 candidates, "
          f"after {frames} frames) whose result differs from the CPU path's on the same "
          f"inputs: {len(found)} (calls where only the raw CPU operation differs: "
          f"{dict(benign)})")
    for (name, site), e in found.items():
        print(f"  {name} at {site}: {e['calls']} calls, {e['elems']} elements, max |d| "
              f"{e['max_abs']:.3g}")
    plans = {}
    for d in (dev, "cpu"):
        args = [plan_arg(a, d) for a in call["args"]]
        kwargs = call["kwargs"]
        params, depth, u = args[:3]
        with torch.inference_mode():
            res = rappids.plan(*args, **kwargs)
            core = rappids.plan_debug(params, depth, rappids.samples_from_uniform(params, u),
                                      *args[3:], **kwargs)
        tr, cost, feas, vel_ok, gate, free, pyrs = core
        plans[str(d)] = dict(
            found=res.found, best_idx=res.best_idx, best_cost=res.best_cost,
            num_feasible=res.num_feasible, num_velocity_admissible=res.num_velocity_admissible,
            num_collision_free=res.num_collision_free, num_pyramids=res.num_pyramids,
            **{f"winner.{k}": v for k, v in res.traj._asdict().items()},
            cost=cost, feasible=feas, velocity_ok=vel_ok, gate=gate, collision_free=free,
            **{f"pyramids.{k}": v for k, v in pyrs._asdict().items()})
    mine, ref = plans[str(dev)], plans["cpu"]
    apart = {k: differ(mine[k], ref[k]) for k in ref}
    apart = {k: v for k, v in apart.items() if v[0]}
    print(f"rappids.plan card vs CPU on the same inputs: found {bool(ref['found'])} / "
          f"{bool(mine['found'])}, winner {int(ref['best_idx'])} / {int(mine['best_idx'])}, "
          f"{int(ref['num_collision_free'])} / {int(mine['num_collision_free'])} free, "
          f"{int(ref['num_pyramids'])} / {int(mine['num_pyramids'])} pyramids; fields apart: "
          + (", ".join(f"{k} {n} elements (max |d| {m:.3g})" for k, (n, m) in apart.items())
             or "none (bit for bit)"))
    return len(found), len(apart)


def read_cbrt(dev, n=1_000_000, seed=0):
    """The one planner function whose card path is not the CPU path: the
    cube root (`ops/rootfind._cbrt`), correctly rounded on the card, torch's
    float32 pow on the CPU. Prints the share of n magnitudes (e**U(-20, 20))
    where the two differ and by how many ulps at most."""
    from agrifly_tpu_torch.ops import rootfind

    g = torch.Generator().manual_seed(seed)
    x = torch.exp(torch.rand(n, generator=g) * 40.0 - 20.0)
    ulps = (rootfind._cbrt(x.to(dev)).cpu().view(torch.int32)
            - rootfind._cbrt(x).view(torch.int32)).abs()
    print(f"cube root card vs CPU on {n} magnitudes: {float((ulps != 0).float().mean()):.6f} "
          f"of them apart, at most {int(ulps.max())} ulp")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--op-ticks", type=int, default=40)
    ap.add_argument("--plan-frames", type=int, default=48)
    ap.add_argument("--phase", choices=("all", "tick", "plan"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plain_drift.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    bad, worst = 0, 0.0
    if args.phase in ("all", "tick"):
        for mode in (True, False):
            bad += len(find_ops(dev, args.op_ticks, mode))
        bad += len(find_ops_fleet(dev))
        worst = max(read_env(dev, args.envs, args.steps, mode) for mode in (True, False))
        worst = max(worst, read_uwb_fleet(dev))
    if args.phase in ("all", "plan"):
        ops, fields = read_plan(dev, args.plan_frames)
        bad += ops + fields
        read_cbrt(dev)
    print("plain drift:", "none" if (bad == 0 and worst <= 1.0) else
          f"{bad} operations or plan fields differ, worst leaf {worst:.4g} x the tick bound")
    return 0 if (bad == 0 and worst <= 1.0) else 1


if __name__ == "__main__":
    sys.exit(main())
