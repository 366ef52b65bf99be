"""The demo's operator loop on the CPU against the JAX package's.

`demo --teleop scripted:...` arms the mission with the start button and
kills it with the red button through the radio's delay line. On the CPU
both packages fly 4-frame blocks between operator polls, so the scripted
presses land on the same frames: the frame at which the onboard state
machine first reads FS_KILLED is the same in both (64x48, 16 candidates,
the kill early enough to land within 24 frames).
"""

import jax
import numpy as np

from _torch_parity import COMMAND_FLOOR  # noqa: F401 (one torch thread)
from agrifly_tpu import demo as jdemo
from agrifly_tpu.models import logic as jlogic
from agrifly_tpu.sim import orchard_env as jorchard
from agrifly_tpu_torch import demo
from agrifly_tpu_torch.models import logic
from agrifly_tpu_torch.sim import orchard_env

TELEOP = ["--cpu", "--image", "64x48", "--candidates", "16", "--frames", "24",
          "--teleop", "scripted:0.1:buttonStart,0.4:buttonRed"]


def test_teleop_kill_lands_on_the_frame_jax_lands_it(monkeypatch, capsys):
    jax_fs, mine_fs = [], []
    fly_jax, fly_mine = jorchard.fly, orchard_env.fly

    def record_jax(p, s, n):  # runs while the block is traced: a callback per call
        s2, outs = fly_jax(p, s, n)
        jax.debug.callback(lambda fs: jax_fs.append(np.asarray(fs)), outs["flight_state"],
                           ordered=True)
        return s2, outs

    def record_mine(p, s, n, gen):
        s2, outs = fly_mine(p, s, n, gen)
        mine_fs.append(outs["flight_state"].numpy())
        return s2, outs

    monkeypatch.setattr(jorchard, "fly", record_jax)
    monkeypatch.setattr(orchard_env, "fly", record_mine)
    assert jdemo.main(TELEOP) == 0
    theirs_out = capsys.readouterr().out
    assert demo.main(TELEOP) == 0
    out = capsys.readouterr().out
    theirs, mine = np.concatenate(jax_fs), np.concatenate(mine_fs)
    assert logic.FS_KILLED == jlogic.FS_KILLED
    killed = np.flatnonzero(mine == logic.FS_KILLED)
    assert killed.size and killed[0] == np.flatnonzero(theirs == jlogic.FS_KILLED)[0]
    assert len(mine) == len(theirs) == 24
    for text in (out, theirs_out):
        marks = [text.index(m) for m in ("ARMED", "KILL —", "KILLED_EXTERNALLY", "vehicle KILLED")]
        assert marks == sorted(marks)
