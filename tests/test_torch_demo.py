"""`python -m agrifly_tpu_torch.demo` on the CPU, and `utils/checkpoint`.

The default path flies one 31-frame block at 64x48 with 16 candidates and
writes the CSV (from one more block flown with a copy of the generator),
the RGB frame and the checkpoint. The checkpoint holds the final state and
the generator that continues it, so frames flown from the restored
checkpoint equal the same frames flown from the state `run` returns, bit
for bit, and they are the CSV's first rows. A fleet of 3 flies the same
block as one batch, and the recorder publishes one frame a block.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import COMMAND_FLOOR  # noqa: F401 (one torch thread)
from agrifly_tpu_torch import convert, demo
from agrifly_tpu_torch.render import raycast
from agrifly_tpu_torch.sim import env, orchard_env
from agrifly_tpu_torch.utils import checkpoint, simlog

SMALL = ["--cpu", "--image", "64x48", "--candidates", "16", "--frames", "8"]


def _equal_trees(a, b):
    la, lb = convert.flatten_tensors(a)[0], convert.flatten_tensors(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _gen_copy(gen):
    g = torch.Generator()
    g.set_state(gen.get_state())
    return g


def test_default_path_writes_csv_rgb_and_a_checkpoint_that_resumes(tmp_path, capsys):
    csv, ppm, ckpt = tmp_path / "f.csv", tmp_path / "f.ppm", tmp_path / "f.pt"
    flight = demo.run(demo.parse_args(SMALL + ["--csv", str(csv), "--rgb", str(ppm),
                                              "--ckpt", str(ckpt)]))
    out = capsys.readouterr().out
    assert flight.rc == 0
    assert "flew 1.0s of sim time" in out and "t=  0.99s" in out
    assert int(flight.state.base.step) == demo.FRAMES_PER_BLOCK * 16

    lines = csv.read_text().splitlines()
    assert lines[0] == simlog.HEADER and len(lines) == 1 + demo.FRAMES_PER_BLOCK
    rows = np.array([[float(x) for x in line.split(",")] for line in lines[1:]])
    assert rows.shape[1] == len(simlog.HEADER.split(","))

    data = ppm.read_bytes()
    header = b"P6\n64 48\n255\n"
    p, s = flight.params, flight.state
    cam = raycast.camera_attitude(s.base.plant.att)
    image = raycast.render_rgb(p.render_cfg, p.scene, s.base.plant.pos[None], cam[None])[0]
    assert data[:len(header)] == header and data[len(header):] == image.numpy().tobytes()

    gen = torch.Generator()
    restored = checkpoint.restore(ckpt, orchard_env.init_state(p), gen)
    assert _equal_trees(restored, s)
    a, outs_a = orchard_env.fly(p, s, 2, _gen_copy(flight.gen))
    b, outs_b = orchard_env.fly(p, restored, 2, gen)
    assert _equal_trees(a, b) and all(torch.equal(outs_a[k], outs_b[k]) for k in outs_a)
    np.testing.assert_allclose(rows[:2, 1:4], outs_b["pos"].numpy(), rtol=0, atol=1e-6)


def test_fleet_flies_one_batched_block(capsys):
    flight = demo.run(demo.parse_args(SMALL + ["--fleet", "3"]))
    out = capsys.readouterr().out
    assert flight.rc == 0 and "fleet of 3" in out and "panics=0/3" in out
    pos = flight.state.base.plant.pos
    assert pos.shape == (3, 3) and bool(torch.isfinite(pos).all())
    assert bool((pos[1:, 1] > pos[:-1, 1]).all())  # spawned in lanes at y = -3, 0, 3


def test_record_publishes_every_frame(tmp_path, capsys):
    bag = tmp_path / "bag.jsonl"
    rc = demo.main(SMALL[:-1] + ["4", "--record", str(bag)])
    assert rc == 0 and "recorded" in capsys.readouterr().out
    lines = [json.loads(line) for line in bag.read_text().splitlines()]
    topics = {line["topic"] for line in lines}
    assert topics == {"simulator_truth1", "planner_diagnostics1", "controller_diagnostics1",
                      "mocap_output1", "telemetry1", "radio_command1"}
    assert sum(line["topic"] == "simulator_truth1" for line in lines) == 4


def test_checkpoint_round_trip_keeps_devices_dtypes_and_the_generator(tmp_path):
    p = env.make_params(device="cpu")
    g = torch.Generator().manual_seed(3)
    s, _ = env.rollout_plain(p, env.init_state(p), env.hover_command(device="cpu"),
                             torch.randn((20, 2, 3), generator=g), True)
    assert checkpoint.save(tmp_path / "c.pt", s, g) == "torch"
    g2 = torch.Generator().manual_seed(99)
    back = checkpoint.restore(tmp_path / "c.pt", env.init_state(p), g2)
    assert _equal_trees(back, s)
    assert torch.equal(torch.rand(8, generator=g), torch.rand(8, generator=g2))
    template = env.init_state(p)._replace(step=torch.zeros((), dtype=torch.int64))
    assert checkpoint.restore(tmp_path / "c.pt", template).step.dtype == torch.int64
    with pytest.raises(ValueError, match="leaf"):
        checkpoint.restore(tmp_path / "c.pt", template._replace(step=torch.zeros(2)))
    checkpoint.save(tmp_path / "n.pt", s)
    with pytest.raises(ValueError, match="no generator"):
        checkpoint.restore(tmp_path / "n.pt", s, g2)
