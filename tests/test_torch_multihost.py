"""The port's multi-process path (`parallel/multihost`, `parallel/dryrun`,
`demo --mesh`) on the CPU: two gloo processes joined through the AGRIFLY_*
variables, each a fresh interpreter with one torch thread.

- multihost: each process makes only its own rows of a 16-env physics
  fleet and a 4-vehicle orchard fleet (64x48, tests/test_multihost.py's
  orchard), steps them with generators seeded the same on both, and both
  processes see the same metrics bit for bit; the fleet flew. Without the
  variables `initialize_from_env()` is False.
- dryrun: `python -m agrifly_tpu_torch.parallel.dryrun 2 --cpu` at a small
  size starts its two workers and passes.
- demo: `demo --cpu --mesh --fleet 2` over two processes prints the lines
  of `demo --cpu --fleet 2` (flown in this process meanwhile) with the
  `mesh:` line and the --csv refusal, rank 1 prints nothing, and rank 0's
  checkpoint (the whole fleet, gathered) holds the same final state bit
  for bit.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

import _torch_mesh
from agrifly_tpu_torch import convert, demo
from agrifly_tpu_torch.parallel import multihost
from agrifly_tpu_torch.sim import env, orchard_env
from agrifly_tpu_torch.utils import checkpoint

torch.set_num_threads(1)  # this process flies the reference beside five others

W = 2
DEMO = ["--cpu", "--image", "64x48", "--candidates", "16", "--frames", "8", "--fleet", "2"]
DRYRUN = ["2", "--cpu", "--envs-per-device", "4", "--substeps", "5"]


def _same_tree(a, b):
    la, lb = convert.flatten_tensors(a)[0], convert.flatten_tensors(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The global flight's ranks, the mesh demo's ranks and the dry run
    start first; the reference demo flies in this process meanwhile."""
    directory = tmp_path_factory.mktemp("multihost")
    orchard = orchard_env.make_params(width=64, height=48, n_candidates=16, pyramid_capacity=4,
                                      planner_rounds=1, start_flight_time=0.2, device="cpu")
    flight = _torch_mesh.start_jobs(W, [("global_flight", dict(
        env_params=env.make_params(noise_scale=0.0, device="cpu"), orchard_params=orchard,
        n_envs=16, n_orchard=4, seed=3))], directory, "flight")
    ckpt = directory / "mesh.pt"
    mesh_demo = _torch_mesh.start_ranks(W, ["-m", "agrifly_tpu_torch.demo", *DEMO, "--mesh",
                                            "--ckpt", str(ckpt), "--csv",
                                            str(directory / "refused.csv")], directory)
    env_vars = {k: v for k, v in os.environ.items()
                if k not in (multihost.ENV_COORD, multihost.ENV_AUTO, multihost.TORCHRUN)}
    dry = subprocess.Popen([sys.executable, "-m", "agrifly_tpu_torch.parallel.dryrun", *DRYRUN],
                           env=dict(env_vars, PYTHONPATH=str(_torch_mesh.REPO)),
                           cwd=_torch_mesh.REPO, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        import contextlib
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ref = demo.run(demo.parse_args(DEMO))
        dry_out = dry.communicate(timeout=_torch_mesh.RANK_TIMEOUT)[0]
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    return dict(flight=_torch_mesh.finish_jobs(flight),
                demo=_torch_mesh.finish_ranks(mesh_demo), ckpt=ckpt,
                csv=directory / "refused.csv", ref=ref, ref_out=out.getvalue(),
                dry=(dry.returncode, dry_out))


def test_initialize_from_env_is_false_without_variables(monkeypatch):
    for var in (multihost.ENV_COORD, multihost.ENV_AUTO, multihost.TORCHRUN):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_from_env() is False
    assert multihost.initialize_from_env(cpu=True) is False
    assert not torch.distributed.is_initialized()


def test_two_process_global_mesh(runs):
    r0, r1 = (r[0] for r in runs["flight"])
    assert {r0["rank"], r1["rank"]} == {0, 1} and r0["world"] == r1["world"] == W
    assert r0["rows"] == r1["rows"] == 8 and r0["orchard_rows"] == r1["orchard_rows"] == 2
    # the reductions are replicated: both processes see the same bits
    assert _same_tree(r0["metrics"], r1["metrics"])
    assert _same_tree(r0["orchard"], r1["orchard"])
    m, o = r0["metrics"], r0["orchard"]
    # the fleet flew: 50 hover ticks with perfect-state control climb
    assert float(m.mean_pos[2]) > 0.001 and int(m.num_panicked) == 0
    assert bool(torch.isfinite(m.mean_speed))
    # the orchard loop crossed the process boundary: 4 frames climbing off the ground
    assert float(o.mean_pos[2]) > 0.01 and int(o.num_panicked) == 0


def test_dryrun_on_two_cpu_processes(runs):
    rc, out = runs["dry"]
    assert rc == 0, out[-3000:]
    assert "DRYRUN OK: 2 CPU processes x 4 envs x 5 substeps" in out


def _masked(text):
    """The demo's lines with the wall-clock figures masked."""
    return [re.sub(r"in [0-9.]+s wall.*", "in <wall>", line) for line in text.splitlines()]


def test_demo_mesh_prints_and_flies_the_fleet(runs):
    (out0, _), (out1, _) = runs["demo"]
    mesh_lines = _masked(out0)
    assert mesh_lines[0] == "mesh: 2 devices, 1 vehicles/device"
    refusal = "--csv is not supported with --mesh (metrics-only outputs)"
    assert refusal in mesh_lines and not runs["csv"].exists()
    assert [line for line in mesh_lines[1:] if line != refusal and "checkpoint" not in line] \
        == _masked(runs["ref_out"])
    assert out1 == ""  # only rank 0 prints
    ref = runs["ref"]
    gen = torch.Generator()
    saved = checkpoint.restore(runs["ckpt"], ref.state, gen)
    assert _same_tree(saved, ref.state)
    assert torch.equal(gen.get_state(), ref.gen.get_state())
