"""The port's front doors on the CPU: `agrifly_tpu_torch.launch` against the
JAX package's `agrifly_tpu.launch`, and the demo's paced loop.

The launcher runs on the same arguments in both packages at 64x48 with 16
candidates (one JAX launch per module): the bags hold the same topics in
the same order, the same number of each and the same stamps. Their values
are not compared, because the two packages draw different noise. Without
`--cpu` and with no card, both entry points raise instead of running on the
CPU; `--mesh --fleet N` exits with the JAX package's message where N does
not divide the mesh.
"""

import json
import re

import pytest
import torch

from _torch_parity import COMMAND_FLOOR  # noqa: F401 (one torch thread)
from agrifly_tpu import launch as jlaunch
from agrifly_tpu_torch import demo, launch

SMALL = ["--cpu", "--image", "64x48", "--candidates", "16"]
LAUNCH = SMALL + ["--frames", "12", "--auto-start"]


def _bag(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _stamped(bag):
    """(topic, stamp, seq) of every message, in order."""
    out = []
    for line in bag:
        msg = line["msg"]
        header = msg.get("header", msg)
        out.append((line["topic"], header.get("stamp"), header.get("seq")))
    return out


@pytest.fixture(scope="module")
def jax_launch_bag(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_launch") / "bag.jsonl"
    assert jlaunch.main(LAUNCH + ["--record", str(path)]) == 0
    return _bag(path)


def test_launch_bag_matches_jax(jax_launch_bag, tmp_path):
    """launch --auto-start --frames 12: the same topics in the same order,
    counts and stamps as the JAX launcher's bag."""
    path = tmp_path / "bag.jsonl"
    assert launch.main(LAUNCH + ["--record", str(path)]) == 0
    mine = _bag(path)
    assert _stamped(mine) == _stamped(jax_launch_bag)
    assert sum(line["topic"] == "simulator_truth1" for line in mine) == 12
    assert {"planner_diagnostics1", "controller_diagnostics1", "imageReceivedFlag1",
            "mocap_output1", "telemetry1", "radio_command1"} <= {line["topic"] for line in mine}


def test_realtime_demo_holds_the_bands(capsys):
    """demo --realtime on the CPU at 20 ticks a second for 125 ticks (one tick
    a quantum): the mocap and telemetry bands hold, so rc 0. Wall-clock
    pacing is load-sensitive: where most quanta were late, the host was
    overloaded (as tests/test_realtime.py skips)."""
    rc = demo.main(["--cpu", "--realtime", "--rate", "20", "--duration", "6.25"])
    out = capsys.readouterr().out
    late = re.search(r"late (\d+)/(\d+) quanta", out)
    assert late is not None, out
    if int(late.group(1)) > 0.2 * int(late.group(2)):
        pytest.skip(f"host overloaded: {late.group(0)}")
    assert rc == 0, out
    assert "bands OK" in out and int(late.group(2)) == 125


@pytest.mark.parametrize("entry", ["demo", "launch"])
def test_without_cpu_and_without_a_card_they_raise(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = demo.main if entry == "demo" else launch.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--image", "64x48", "--candidates", "16", "--frames", "1"])


def test_mesh_exits_with_a_message(monkeypatch):
    """A world of one made in this process stands in for three ranks."""
    from agrifly_tpu_torch.parallel import sharding

    make = sharding.make_mesh
    monkeypatch.setattr(sharding, "make_mesh", lambda device=None: make(device)._replace(world=3))
    with pytest.raises(SystemExit, match="--fleet 2 must divide the 3-device mesh"):
        demo.main(SMALL + ["--fleet", "2", "--mesh"])
    assert not torch.distributed.is_initialized()
