"""Ranks of the port's mesh for the multi-device tests, on the CPU.

`start_ranks(world, argv, directory)` starts `world` fresh interpreters,
joined over gloo through the AGRIFLY_* variables on a free loopback port
(`agrifly_tpu_torch.parallel.multihost`), each with one torch thread;
`finish_ranks` waits for them (a timeout of its own) and returns their
output. `start_jobs` starts ranks of this file: every rank loads the same
list of jobs (`torch.save`d port trees: params, global states, global
draws), runs them in order on its mesh and saves what each returns, and
`finish_jobs` returns one list of results per rank. A job is (name of a
function below, its keyword arguments); each function takes the mesh
first. The caller works while the ranks run. This file imports no jax.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120  # [s] a rank's whole run


def start_ranks(world, argv, directory, name="jobs"):
    """Start `world` ranks of `python argv...` (argv may hold "{rank}");
    returns the handle `finish_ranks` takes."""
    from agrifly_tpu_torch.parallel import dryrun, multihost

    port = dryrun.free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
                   OMP_NUM_THREADS="1")
        env.update({multihost.ENV_COORD: f"127.0.0.1:{port}", multihost.ENV_NPROC: str(world),
                    multihost.ENV_PROC_ID: str(rank)})
        for var in (multihost.ENV_AUTO, multihost.TORCHRUN):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable] + [a.format(rank=rank) for a in argv], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs, Path(directory), name


def finish_ranks(handle, timeout=RANK_TIMEOUT):
    """Wait for the ranks (killing every one still running after `timeout`);
    asserts each exited 0 and returns their (stdout, stderr), rank by rank."""
    procs, _, _ = handle
    try:
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}: rc {p.returncode}\n{out[-2000:]}\n{err[-3000:]}"
    return logs


def start_jobs(world, jobs, directory, name="jobs"):
    """Start `world` ranks of this file on `jobs` (saved in `directory`)."""
    job_file = Path(directory) / f"{name}.pt"
    torch.save(jobs, job_file)
    return start_ranks(world, [__file__, str(job_file),
                               str(Path(directory) / f"{name}_rank{{rank}}.pt")], directory, name)


def finish_jobs(handle, timeout=RANK_TIMEOUT):
    """The jobs' results, one list per rank."""
    finish_ranks(handle, timeout)
    procs, directory, name = handle
    return [torch.load(directory / f"{name}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


# the jobs ---------------------------------------------------------------------


def fleet(mesh, params, state, cmd, noise, n_substeps, mode):
    """The sharded fleet step on this rank's rows of the global `state`."""
    from agrifly_tpu_torch.parallel import sharding

    step = sharding.make_fleet_step(params, mesh, noise.shape[0], n_substeps, mode)
    s, m = step(sharding.shard_rows(state, mesh), cmd, noise=noise)
    return dict(state=s, metrics=m)


def planner(mesh, params, depth, u, vel0, acc0, grav, goal, capacity):
    """The candidate-sharded planner on the global uniform block u."""
    from agrifly_tpu_torch.parallel import sharding

    plan = sharding.make_sharded_planner(params, mesh, u.shape[1], capacity)
    return plan(depth, u, vel0, acc0, grav, goal)


def orchard(mesh, params, state, draws):
    """The sharded orchard fleet step on this rank's rows of `state`,
    fed the global draws (one frame per leading row)."""
    from agrifly_tpu_torch.parallel import sharding

    n_frames, n_envs = draws[0].shape[:2]
    step = sharding.make_orchard_fleet_step(params, mesh, n_envs, n_frames)
    s, m = step(sharding.shard_rows(state, mesh), draws=draws)
    return dict(state=s, metrics=m)


def global_flight(mesh, env_params, orchard_params, n_envs, n_orchard, seed):
    """multihost's global fleet and orchard steps, each rank making its own
    rows, with generators seeded the same on every rank: 5 calls of 10
    hover substeps, then 2 calls of 2 orchard frames."""
    from agrifly_tpu_torch.parallel import multihost as mh
    from agrifly_tpu_torch.sim import env

    rank, world = mh.process_info()
    gen = torch.Generator().manual_seed(seed)
    states = mh.init_global_fleet(env_params, mesh, n_envs)
    step = mh.make_global_fleet_step(env_params, mesh, n_envs, n_substeps=10)
    cmd = env.hover_command((0.0, 0.0, 1.2), device="cpu")
    for _ in range(5):
        states, metrics = step(states, cmd, gen=gen)
    ostates = mh.init_global_orchard_fleet(orchard_params, mesh, n_orchard)
    ostep = mh.make_global_orchard_step(orchard_params, mesh, n_orchard, n_frames=2)
    for _ in range(2):
        ostates, ometrics = ostep(ostates, gen=gen)
    return dict(rank=rank, world=world, rows=int(states.step.shape[0]),
                orchard_rows=int(ostates.base.step.shape[0]), metrics=metrics, orchard=ometrics)


JOBS = {f.__name__: f for f in (fleet, planner, orchard, global_flight)}


def _rank_main(job_file, out_file):
    from agrifly_tpu_torch.parallel import multihost, sharding

    torch.set_num_threads(1)
    assert multihost.initialize_from_env(cpu=True), "the AGRIFLY_* variables are missing"
    try:
        mesh = sharding.make_mesh()
        jobs = torch.load(job_file, weights_only=False)
        torch.save([JOBS[name](mesh, **kw) for name, kw in jobs], out_file)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
