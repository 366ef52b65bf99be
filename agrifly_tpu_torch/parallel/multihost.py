"""Multi-process (multi-host) scale-out: one process per device.

Port of `agrifly_tpu/parallel/multihost.py`. The JAX package forms one
runtime across processes with `jax.distributed.initialize`, after which
its sharded programs run over a process-spanning mesh. The port's mesh is
already a process group with one process per device (parallel/sharding),
so spanning hosts is `torch.distributed.init_process_group` over TCP:
every rank makes only its own rows of the fleet, and the only traffic
between processes is the fleet metrics' reductions (envs never
communicate, SURVEY §2).

Launch, one command per process (rank i of W):

    AGRIFLY_COORD=host0:5731 AGRIFLY_NPROC=W AGRIFLY_PROC_ID=<i> \\
        python your_script.py

or under torchrun (`torchrun --nproc-per-node=W your_script.py`, or
AGRIFLY_AUTO_INIT=1 with the `env://` variables set some other way).
`initialize_from_env()` returns False without these variables, so
single-process runs keep working. The backend is NCCL on the card and
gloo on the CPU, which is used only where the caller asks for it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

ENV_COORD = "AGRIFLY_COORD"
ENV_NPROC = "AGRIFLY_NPROC"
ENV_PROC_ID = "AGRIFLY_PROC_ID"
ENV_AUTO = "AGRIFLY_AUTO_INIT"
TORCHRUN = "TORCHELASTIC_RUN_ID"  # set by torchrun in every process it starts


def local_device(cpu: bool = False, rank=None) -> torch.device:
    """This process's device: the CPU where asked, else
    cuda:{LOCAL_RANK, or the rank (default the group's) modulo the cards
    on this host} (it raises where there is no card)."""
    from agrifly_tpu_torch import card_or_raise

    if cpu:
        return torch.device("cpu")
    card_or_raise("cuda", "multihost.local_device")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        rank = dist.get_rank() if rank is None else rank
        local = rank % torch.cuda.device_count()
    return torch.device("cuda", int(local))


def initialize_from_env(cpu: bool = False) -> bool:
    """Join the process group the launch environment asks for; returns True
    when it was initialised. With AGRIFLY_COORD / AGRIFLY_NPROC /
    AGRIFLY_PROC_ID: TCP at the coordinator's host:port; with
    AGRIFLY_AUTO_INIT=1, or under torchrun: `env://`. NCCL on this
    process's card (`local_device`), which becomes the current device;
    gloo only with cpu=True."""
    from agrifly_tpu_torch.parallel import sharding

    coord = os.environ.get(ENV_COORD)
    auto = os.environ.get(ENV_AUTO) == "1" or TORCHRUN in os.environ
    if coord is None and not auto:
        return False
    if coord is not None:
        rank, world = int(os.environ[ENV_PROC_ID]), int(os.environ[ENV_NPROC])
        kw = dict(init_method=f"tcp://{coord}", world_size=world, rank=rank)
    else:
        rank, kw = int(os.environ["RANK"]), dict(init_method="env://")
    if not cpu:
        torch.cuda.set_device(local_device(rank=rank))
    dist.init_process_group("gloo" if cpu else "nccl", timeout=sharding.TIMEOUT, **kw)
    return True


def process_info():
    """(rank, world size) of the process group."""
    return dist.get_rank(), dist.get_world_size()


def global_env_mesh(device=None):
    """The mesh over every process of the group (one device each), on this
    process's device: `sharding.make_mesh` over the default group."""
    from agrifly_tpu_torch.parallel import sharding

    return sharding.make_mesh(device)


def init_global_fleet(params, mesh, n_envs: int):
    """This process's rows of the global physics fleet; no process makes
    another's rows (the JAX package's init under an env-axis
    out_sharding)."""
    from agrifly_tpu_torch.parallel import sharding

    return sharding.init_fleet(params, mesh, n_envs)


def make_global_fleet_step(params, mesh, n_envs: int, n_substeps: int = 1,
                           use_estimator=False):
    """The sharded fleet step over a process-spanning mesh: the same step
    as `sharding.make_fleet_step`, whose reductions span the group."""
    from agrifly_tpu_torch.parallel import sharding

    return sharding.make_fleet_step(params, mesh, n_envs, n_substeps=n_substeps,
                                    use_estimator=use_estimator)


def init_global_orchard_fleet(params, mesh, n_envs: int, lane_spacing: float = 3.0):
    """This process's rows of the global orchard fleet (vehicles abreast in
    y); no process makes another's rows."""
    from agrifly_tpu_torch.parallel import sharding

    return sharding.init_orchard_fleet(params, mesh, n_envs, lane_spacing)


def make_global_orchard_step(params, mesh, n_envs: int, n_frames: int = 1):
    """The full perception-plan-act orchard frame (render -> RAPPIDS -> 16
    tracked ticks) over a process-spanning mesh: each process renders,
    plans and tracks its own vehicles and only the metrics cross between
    processes (`sharding.make_orchard_fleet_step`)."""
    from agrifly_tpu_torch.parallel import sharding

    return sharding.make_orchard_fleet_step(params, mesh, n_envs, n_frames=n_frames)
