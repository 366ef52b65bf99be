"""Multi-device scale-out: the env axis split over a process group.

Port of `agrifly_tpu/parallel/sharding.py`. The JAX package runs one
controller over a mesh of local devices and shards the env axis with
`shard_map`; PyTorch's idiom is one process per device, joined in a
`torch.distributed` process group, and the port takes it:

- a mesh is the process group (`Mesh`: the group, its size, this
  process's rank and its device), NCCL on the card and gloo on the CPU;
  `make_mesh` builds it over the default group, or makes a world of one
  where no group is initialised;
- state is sharded by rows: rank r holds rows [r k, (r + 1) k) of every
  leaf of an N-row fleet, k = N / world (`shard_rows`, `init_fleet`,
  `init_orchard_fleet`);
- envs never communicate (SURVEY.md §2), so each rank steps its own rows
  and the only collectives are the fleet metrics' reductions, and in the
  candidate-sharded planner one gather of the pyramid sets and the
  winner's selection.

The JAX package draws each vehicle's noise from its own state key, so a
sharded run equals the unsharded one. The port's rollouts draw from one
torch.Generator for the whole batch; so the sharded steps take the
caller's global draws (`noise=`, `draws=`, the planner's uniform block) or
a generator seeded the same on every rank, and each rank draws the global
block and keeps its own rows. A sharded run then equals the unsharded
`env.rollout` / `orchard_env.fly_fleet` bit for bit on every rank's rows,
at any world size.

No path falls back: a CUDA mesh whose NCCL set-up fails raises.
"""

from __future__ import annotations

import datetime
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from agrifly_tpu_torch import card_or_raise
from agrifly_tpu_torch.convert import flatten_tensors

TIMEOUT = datetime.timedelta(seconds=120)  # a collective that waits longer raises
NO_RANK = 2 ** 30  # the winner rank of a plan no rank found


class Mesh(NamedTuple):
    """A process group seen from one of its ranks. `owner`: the group was
    made by `make_mesh` (a world of one), and `close_mesh` destroys it."""

    group: object  # the torch.distributed process group
    world: int
    rank: int
    device: torch.device
    owner: bool = False


def _backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _check_backend(backend: str, device: torch.device):
    if _backend_for(device) != str(backend).lower():
        raise RuntimeError(f"a {backend} process group cannot carry {device} tensors "
                           f"(the port runs NCCL on the card and gloo on the CPU)")


def _probe(mesh: Mesh):
    """One collective, so a group that cannot communicate raises here."""
    one = torch.ones(1, device=mesh.device)
    dist.all_reduce(one, group=mesh.group)
    if int(one.item()) != mesh.world:
        raise RuntimeError(f"process group probe summed to {one.item()}, not {mesh.world}")


def make_mesh(device=None) -> Mesh:
    """The mesh over the default process group, on this rank's `device`
    (default: `multihost.local_device()` under NCCL, the CPU under gloo).
    Where no group is initialised, a world of one on `device` (default the
    card; it raises where there is none): rank 0 over an in-process store,
    NCCL on the card, gloo on the CPU; `close_mesh` destroys it."""
    if dist.is_initialized():
        backend = dist.get_backend()
        rank, world = dist.get_rank(), dist.get_world_size()
        if device is None:
            from agrifly_tpu_torch.parallel import multihost

            device = multihost.local_device(cpu=backend == "gloo")
        device = torch.device(device)
        _check_backend(backend, device)
        mesh = Mesh(dist.group.WORLD, world, rank, device)
        _probe(mesh)
        return mesh
    device = card_or_raise("cuda" if device is None else device, "sharding.make_mesh")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                              else device.index)
        torch.cuda.set_device(device)
    dist.init_process_group(_backend_for(device), store=dist.HashStore(), rank=0,
                            world_size=1, timeout=TIMEOUT)
    mesh = Mesh(dist.group.WORLD, 1, 0, device, owner=True)
    try:
        _probe(mesh)
    except BaseException:
        dist.destroy_process_group()
        raise
    return mesh


def close_mesh(mesh: Mesh):
    """Destroy the mesh's group where `make_mesh` made it; a group the
    caller initialised stays."""
    if mesh.owner and dist.is_initialized():
        dist.destroy_process_group()


def rows(mesh: Mesh, n_envs: int) -> slice:
    """This rank's rows of an n_envs-row fleet (n_envs % world == 0)."""
    if n_envs % mesh.world:
        raise ValueError(f"{n_envs} envs do not divide the {mesh.world}-device mesh")
    k = n_envs // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_rows(tree, mesh: Mesh):
    """This rank's rows of every tensor leaf of a global tree (a leading N
    on each), on the mesh's device."""
    leaves, rebuild = flatten_tensors(tree)
    if not leaves:
        return tree
    sl = rows(mesh, leaves[0].shape[0])
    return rebuild([t[sl].to(mesh.device) for t in leaves])


def gather_rows(tree, mesh: Mesh):
    """The global tree from every rank's rows (one all_gather a leaf), on
    every rank."""
    leaves, rebuild = flatten_tensors(tree)
    out = []
    for t in leaves:
        wire = t.contiguous().to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(wire) for _ in range(mesh.world)]
        dist.all_gather(parts, wire, group=mesh.group)
        full = torch.cat(parts)
        out.append(full.to(torch.bool) if t.dtype == torch.bool else full)
    return rebuild(out)


def _all_reduce(t, op, mesh: Mesh):
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def _own_rows(block, n_rows: int, sl: slice):
    """This rank's rows of a global block (n_rows on its leading axis)."""
    if block.shape[0] != n_rows:
        raise ValueError(f"need the global block ({n_rows} rows), got {tuple(block.shape)}")
    return block[sl]


# =============================================================================
# the physics fleet
# =============================================================================


def init_fleet(params, mesh: Mesh, n_envs: int):
    """This rank's n_envs / world rows of `env.init_state_fleet` at the
    origin (the port's state has no PRNG key, so the JAX package's
    base_seed has nothing to seed: the draws are the step's)."""
    from agrifly_tpu_torch.sim import env as env_mod

    sl = rows(mesh, n_envs)
    return env_mod.init_state_fleet(
        params, torch.zeros((sl.stop - sl.start, 3), device=params.dt_us.device))


class FleetMetrics(NamedTuple):
    """Cross-fleet reductions, the same on every rank."""

    mean_pos: torch.Tensor  # (3,)
    mean_speed: torch.Tensor  # scalar
    num_panicked: torch.Tensor  # int32
    max_tilt_cos: torch.Tensor  # scalar: worst (most tilted) cos(tilt)


def fleet_metrics(states, mesh: Mesh, n_envs: int) -> FleetMetrics:
    """FleetMetrics of the global fleet from this rank's rows: each sum is
    this rank's sum times 1/N, summed over the ranks (the JAX package's
    psum of the same); the tilt a MIN over the ranks (its -pmax(-min)).
    Two collectives: the sums (the panicked count among them, exact in
    float32 below 2^24 envs) and the MIN."""
    from agrifly_tpu_torch.models import logic as onboard
    from agrifly_tpu_torch.ops.fmath import norm3

    plant = states.plant
    inv_n = 1.0 / n_envs
    panicked = (states.logic.fs == onboard.FS_PANIC).sum(dtype=torch.int32)
    sums = torch.cat([plant.pos.sum(0) * inv_n, (norm3(plant.vel).sum() * inv_n)[None],
                      panicked.to(torch.float32)[None]])
    # the world z of the body's z axis, rotation.rotate(att, e_z)[..., 2]:
    # the (2, 2) entry of rotation.to_matrix, the same operations
    w, x, y, z = plant.att.unbind(-1)
    tilt = (w * w - x * x - y * y + z * z).min()[None]
    _all_reduce(sums, dist.ReduceOp.SUM, mesh)
    _all_reduce(tilt, dist.ReduceOp.MIN, mesh)
    return FleetMetrics(mean_pos=sums[:3], mean_speed=sums[3],
                        num_panicked=sums[4].to(torch.int32), max_tilt_cos=tilt[0])


def make_fleet_step(params, mesh: Mesh, n_envs: int, n_substeps: int = 1,
                    use_estimator=False):
    """step(states, cmds, noise=None, gen=None) -> (states, FleetMetrics):
    this rank's rows through `env.rollout` for n_substeps ticks (the
    rollout kernel on the card, `rollout_plain` on the CPU), then the
    metrics over the mesh.

    states: this rank's rows; cmds: one `env.Command` for every vehicle or
    this rank's rows of them. noise: the global (n_envs, n_substeps, 2, 3)
    IMU block, or drawn whole from `gen`; each rank keeps its rows.
    use_estimator: False (the true state), "mocap" or "gpsimu", as in
    `env`; the estimator's state is per vehicle, so it shards with the
    env axis."""
    from agrifly_tpu_torch.sim import env as env_mod

    sl = rows(mesh, n_envs)

    def step(states, cmds, noise=None, gen=None):
        if noise is None and gen is None:
            raise ValueError("pass the global IMU noise block or a torch.Generator (gen)")
        if noise is None:
            noise = torch.randn((n_envs, n_substeps, 2, 3), generator=gen, device=mesh.device)
        states, _ = env_mod.rollout(params, states, cmds, n_substeps, use_estimator=use_estimator,
                                    noise=_own_rows(noise, n_envs, sl).contiguous())
        return states, fleet_metrics(states, mesh, n_envs)

    return step


# =============================================================================
# the candidate-sharded RAPPIDS planner
# =============================================================================
#
# For one vehicle planning with a large candidate batch, each rank samples
# and gates its own columns of the candidates and inflates pyramids at its
# cheapest gated endpoints; the pyramid sets are all_gathered (small: P x
# 18 floats) so every rank checks its candidates against the union; the
# global winner is a MIN over the ranks. Collectives per plan: one
# all_gather, two MINs and two SUMs.

def _pack_pyramids(p):
    """A pyramid set as one (P, 18) float32 block: depth, bounds, normals,
    valid (one all_gather carries it)."""
    n = p.depth.shape[-1]
    return torch.cat([p.depth[:, None], p.bounds, p.normals.reshape(n, 12),
                      p.valid.to(torch.float32)[:, None]], dim=1)


def _unpack_pyramids(x):
    from agrifly_tpu_torch.planner import rappids

    return rappids.PyramidSet(depth=x[:, 0], bounds=x[:, 1:5],
                              normals=x[:, 5:17].reshape(-1, 4, 3), valid=x[:, 17] != 0)


def make_sharded_planner(planner_params, mesh: Mesh, n_candidates: int,
                         pyramid_capacity: int = 32, inflation_downsample: int = 2):
    """plan(depth_u16, u, vel0, acc0, grav, goal_cam) -> rappids.PlanResult,
    the candidate axis split over the mesh: rank r samples from columns
    [r n, (r + 1) n) of the global (4, n_candidates) uniform block u (the
    JAX package takes a key and splits it per device), n = n_candidates /
    world, and inflates pyramid_capacity / world pyramids. The result is
    the same on every rank; best_idx is 0, as in the JAX package."""
    from agrifly_tpu_torch.planner import cuda_plan, rappids, traj as traj_mod

    if n_candidates % mesh.world or pyramid_capacity % mesh.world:
        raise ValueError(f"{n_candidates} candidates and capacity {pyramid_capacity} must "
                         f"divide the {mesh.world}-device mesh")
    cols = rows(mesh, n_candidates)
    p_local = pyramid_capacity // mesh.world
    pp = planner_params

    def plan(depth_u16, u, vel0, acc0, grav, goal_cam):
        if tuple(u.shape) != (4, n_candidates):
            raise ValueError(f"need the global (4, {n_candidates}) uniform block, got "
                             f"{tuple(u.shape)}")
        tr = rappids.sample_candidates(pp, u[:, cols], vel0, acc0)
        cost = rappids.exploration_cost(tr, goal_cam)
        feas, vel_ok = cuda_plan.plan_gates(tr, grav, pp.fmin, pp.fmax, pp.wmax,
                                            pp.min_section_time, pp.vmax, static_max_tf=3.0)
        gate = feas & vel_ok

        epx, epy, endz = rappids.endpoint_seeds(pp, tr)
        order = torch.argsort(torch.where(gate, cost, math.inf), stable=True)[:p_local]
        local_pyrs = rappids.build_pyramid_set(
            pp, depth_u16, epx[order], epy[order], endz[order], gate[order], p_local,
            downsample=inflation_downsample)

        # the union of every rank's pyramids, sorted by depth (the same on all)
        wire = _pack_pyramids(local_pyrs)
        parts = [torch.empty_like(wire) for _ in range(mesh.world)]
        dist.all_gather(parts, wire, group=mesh.group)
        flat = _unpack_pyramids(torch.cat(parts))
        srt = torch.argsort(torch.where(flat.valid, flat.depth, math.inf), stable=True)
        pyrs = rappids.PyramidSet(*(x[srt] for x in flat))

        ok = gate & rappids.is_collision_free(pp, pyrs, tr)
        masked = torch.where(ok, cost, math.inf)
        local_idx = torch.argmin(masked)
        local_best = masked[local_idx]

        # the global winner: MIN the cost, the lowest rank among the ties,
        # then a SUM that selects its trajectory (every other rank adds 0)
        best = _all_reduce(local_best.clone()[None], dist.ReduceOp.MIN, mesh)[0]
        i_win = (local_best == best) & torch.isfinite(best)
        me = torch.full((1,), mesh.rank, dtype=torch.int32, device=mesh.device)
        win_rank = _all_reduce(torch.where(i_win, me, NO_RANK), dist.ReduceOp.MIN, mesh)[0]
        i_win = i_win & (me[0] == win_rank)
        packed = torch.cat([x[local_idx].reshape(-1) for x in tr])
        packed = _all_reduce(torch.where(i_win, packed, torch.zeros_like(packed)),
                             dist.ReduceOp.SUM, mesh)
        widths = [x[0].numel() for x in tr]
        wtraj = traj_mod.Traj(*(v.reshape(x.shape[1:]) for v, x in
                                zip(torch.split(packed, widths), tr)))
        count = lambda m: m.sum(dtype=torch.int32)  # noqa: E731
        stats = _all_reduce(torch.stack([count(feas), count(gate), count(ok),
                                         count(local_pyrs.valid)]), dist.ReduceOp.SUM, mesh)
        return rappids.PlanResult(
            found=torch.isfinite(best), best_idx=torch.zeros((), dtype=torch.int64,
                                                             device=mesh.device),
            best_cost=best, traj=wtraj, num_candidates=n_candidates,
            num_feasible=stats[0], num_velocity_admissible=stats[1],
            num_collision_free=stats[2], num_pyramids=stats[3])

    return plan


# =============================================================================
# the full perception-plan-act loop: the orchard fleet over the mesh
# =============================================================================
#
# Config #4 (BASELINE.md) at chip scale: N independent vehicles, each
# flying the complete render -> RAPPIDS -> track frame, the vehicle axis
# split over the mesh. Each rank renders, plans and tracks its own rows
# (one launch each of the render, inflation and tick kernels per frame for
# all of them); the only collectives are the fleet metrics.


class OrchardFleetMetrics(NamedTuple):
    mean_pos: torch.Tensor  # (3,)
    num_panicked: torch.Tensor  # int32
    num_plans: torch.Tensor  # int32: successful plans fleet-wide
    num_landed: torch.Tensor  # int32


def lane_spawns(n_envs: int, lane_spacing: float = 3.0):
    """(n_envs, 3) spawn points abreast in y, lane_spacing apart, centred
    on the origin (the JAX package's and the demo's fleet)."""
    lanes = (torch.arange(n_envs, dtype=torch.float32) - (n_envs - 1) / 2.0) * lane_spacing
    return torch.stack([torch.zeros(n_envs), lanes, torch.zeros(n_envs)], dim=1)


def init_orchard_fleet(params, mesh: Mesh, n_envs: int, lane_spacing: float = 3.0):
    """This rank's rows of an n_envs-vehicle orchard fleet abreast in y."""
    from agrifly_tpu_torch.sim import orchard_env

    return orchard_env.init_state_fleet(
        params, lane_spawns(n_envs, lane_spacing)[rows(mesh, n_envs)])


def orchard_metrics(states, mesh: Mesh, n_envs: int) -> OrchardFleetMetrics:
    from agrifly_tpu_torch.sim import orchard_env

    pos = _all_reduce(states.base.plant.pos.sum(0) * (1.0 / n_envs), dist.ReduceOp.SUM, mesh)
    counts = _all_reduce(torch.stack([
        (states.base.logic.panic_reason != 0).sum(dtype=torch.int32),
        states.plan_count.sum(dtype=torch.int32),
        (states.mstage == orchard_env.MSTAGE_COMPLETE).sum(dtype=torch.int32)]),
        dist.ReduceOp.SUM, mesh)
    return OrchardFleetMetrics(mean_pos=pos, num_panicked=counts[0], num_plans=counts[1],
                               num_landed=counts[2])


def make_orchard_fleet_step(params, mesh: Mesh, n_envs: int, n_frames: int = 1):
    """step(states, gen=None, draws=None) -> (states, OrchardFleetMetrics):
    n_frames full perception-plan-act frames of this rank's rows through
    `orchard_env.frame_step_fleet`, then the metrics over the mesh.

    draws: the global (u (n_frames, n_envs, 4, C), noise (n_frames, n_envs,
    ticks, 2, 3)); else each frame draws the global block from `gen` as
    `fly_fleet` does (`orchard_env.draw_fleet`). Each rank keeps its rows,
    so the run equals `fly_fleet` of the whole fleet row by row."""
    from agrifly_tpu_torch.sim import orchard_env

    sl = rows(mesh, n_envs)

    def step(states, gen=None, draws=None):
        if draws is None and gen is None:
            raise ValueError("pass the global draws or a torch.Generator (gen)")
        for i in range(n_frames):
            full = (orchard_env.draw_fleet(params, gen, n_envs, mesh.device) if draws is None
                    else (draws[0][i], draws[1][i]))
            states, _ = orchard_env.frame_step_fleet(
                params, states, draws=tuple(_own_rows(x, n_envs, sl) for x in full))
        return states, orchard_metrics(states, mesh, n_envs)

    return step
