"""Multi-device dry run of the port: N processes, one device each.

Port of `agrifly_tpu/parallel/dryrun.py`. `run_dryrun` runs the three
phases of the JAX package's dry run on a mesh: the sharded fleet step with
the true state and with the mocap estimator, the candidate-sharded RAPPIDS
planner and the sharded orchard perception-plan-act fleet, with the same
assertions.

    python -m agrifly_tpu_torch.parallel.dryrun N [--envs-per-device 256 --substeps 50] [--cpu]

starts N worker processes joined through the AGRIFLY_* variables
(parallel/multihost) on a free loopback port: by default one per card over
NCCL (N must not exceed the cards of this host, else it raises), with
--cpu N gloo processes on the CPU (the JAX dry run's virtual mesh).
`spawn(n)` does the same from a clean interpreter and raises with the
workers' output on any failure.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

ENVS_PER_DEVICE = 256
SUBSTEPS = 50
WORKER_TIMEOUT = 600  # [s] per dry run, set-up included


def run_dryrun(mesh, envs_per_device: int = ENVS_PER_DEVICE, substeps: int = SUBSTEPS) -> None:
    """The dry run on `mesh` (parallel/sharding.Mesh): envs_per_device
    envs per rank stepped `substeps` ticks with the metrics reduced over the
    mesh, then the candidate-sharded planner (the pyramid sets gathered,
    the winner a MIN), then the orchard fleet's full frame."""
    import torch

    from agrifly_tpu_torch.parallel import sharding
    from agrifly_tpu_torch.planner import rappids
    from agrifly_tpu_torch.sim import env as env_mod
    from agrifly_tpu_torch.sim import orchard_env

    dev, world = mesh.device, mesh.world
    gen = torch.Generator(device=dev).manual_seed(0)  # the same on every rank
    params = env_mod.make_params(noise_scale=1.0, device=dev)
    n_envs = world * envs_per_device
    cmd = env_mod.hover_command((0.0, 0.0, 1.5), device=dev)

    fleet_step = sharding.make_fleet_step(params, mesh, n_envs, n_substeps=substeps)
    _, metrics = fleet_step(sharding.init_fleet(params, mesh, n_envs), cmd, gen=gen)
    assert tuple(metrics.mean_pos.shape) == (3,)
    assert int(metrics.num_panicked) == 0, (
        f"{int(metrics.num_panicked)} envs panicked during hover dryrun")

    # the estimator in the loop (config #2): the mocap estimator's state is
    # per vehicle, so it shards with the env axis
    est_step = sharding.make_fleet_step(params, mesh, n_envs, n_substeps=max(1, substeps // 5),
                                        use_estimator="mocap")
    _, metrics_est = est_step(sharding.init_fleet(params, mesh, n_envs), cmd, gen=gen)
    assert int(metrics_est.num_panicked) == 0

    cam = rappids.make_camera(160, 120, focal=80.0, depth_scale=10 / 256, device=dev)
    pp = rappids.make_params(cam, 0.116, 0.174)
    n_cand = 16 * world
    planner = sharding.make_sharded_planner(pp, mesh, n_candidates=n_cand,
                                            pyramid_capacity=2 * world)
    vec = lambda *v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    res = planner(torch.full((120, 160), 230, dtype=torch.int32, device=dev),
                  torch.rand((4, n_cand), generator=gen, device=dev), vec(0, 0, 0),
                  vec(0, 0, 0), vec(0.0, 9.81, 0.0), vec(0.0, 0.0, 20.0))
    assert bool(res.found), "sharded planner found no trajectory in open space"

    # the full perception-plan-act loop sharded over the mesh: config #4
    # (BASELINE.md) at chip scale
    oparams = orchard_env.make_params(width=96, height=72, n_candidates=32,
                                      pyramid_capacity=8, planner_rounds=1,
                                      start_flight_time=0.1, device=dev)
    n_o = 2 * world
    ostep = sharding.make_orchard_fleet_step(oparams, mesh, n_o, n_frames=3)
    _, ometrics = ostep(sharding.init_orchard_fleet(oparams, mesh, n_o), gen=gen)
    assert int(ometrics.num_panicked) == 0, "orchard fleet panicked in dryrun"
    assert tuple(ometrics.mean_pos.shape) == (3,)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(n_devices: int, envs_per_device: int = ENVS_PER_DEVICE, substeps: int = SUBSTEPS,
          cpu: bool = False, timeout: float = WORKER_TIMEOUT) -> str:
    """The dry run in n_devices fresh worker processes (one per card, or
    gloo processes on the CPU with cpu=True). Returns rank 0's output;
    raises RuntimeError with the workers' output if any fails, and stops
    every worker it started."""
    from agrifly_tpu_torch.parallel import multihost

    if not cpu:
        import torch

        have = torch.cuda.device_count()
        if n_devices > have:
            raise RuntimeError(f"need {n_devices} cards, have {have} (--cpu runs the dry run "
                               f"in {n_devices} gloo processes on the CPU)")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = free_port()
    procs = []
    try:
        for rank in range(n_devices):
            env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
            env.update({multihost.ENV_COORD: f"127.0.0.1:{port}",
                        multihost.ENV_NPROC: str(n_devices),
                        multihost.ENV_PROC_ID: str(rank)})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "agrifly_tpu_torch.parallel.dryrun", str(n_devices),
                 "--envs-per-device", str(envs_per_device), "--substeps", str(substeps)]
                + (["--cpu"] if cpu else []),
                env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tail = "\n".join(f"--- rank {r}:\n{log[-3000:]}" for r, log in enumerate(logs))
        raise RuntimeError(f"dryrun workers failed {failed}:\n{tail}")
    return logs[0]


def _worker(args) -> int:
    """One rank of a dry run started by `spawn`."""
    import torch

    from agrifly_tpu_torch.parallel import multihost, sharding

    if args.cpu:
        torch.set_num_threads(1)  # N processes share the host's cores
    assert multihost.initialize_from_env(cpu=args.cpu), "the AGRIFLY_* variables are missing"
    try:
        mesh = sharding.make_mesh()
        assert mesh.world == args.n_devices, (mesh.world, args.n_devices)
        run_dryrun(mesh, args.envs_per_device, args.substeps)
        if mesh.rank == 0:
            kind = "CPU processes" if args.cpu else f"x {torch.cuda.get_device_name(mesh.device)}"
            print(f"DRYRUN OK: {mesh.world} {kind} x {args.envs_per_device} envs x "
                  f"{args.substeps} substeps + sharded planner + sharded orchard loop")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    import argparse

    from agrifly_tpu_torch.parallel import multihost

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--envs-per-device", type=int, default=ENVS_PER_DEVICE)
    ap.add_argument("--substeps", type=int, default=SUBSTEPS)
    ap.add_argument("--cpu", action="store_true", help="N gloo processes on the CPU")
    args = ap.parse_args(argv)
    if multihost.ENV_PROC_ID in os.environ:
        return _worker(args)
    print(spawn(args.n_devices, args.envs_per_device, args.substeps, args.cpu), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
