"""The port's SimBridge over an env with a UWB network, against the JAX
package's, on the CPU.

The env carries tests/test_torch_uwb.py's four anchors
(`with_uwb_anchors(make_params(noise_scale=1.0), ...)`), and the bridges
keep their defaults (the mocap estimator, the reference's rates). The JAX
bridge draws the IMU noise and the network's draws from its state's keys;
the port's takes the same values through its `draws` and `uwb_draws` hooks
(`_torch_parity.jax_tick_draws`, `jax_uwb_draws`). The bags compare line by
line by `_torch_parity.bag_bound` (the tick criteria, then the long-rollout
terms; telemetry within one code; integers and stamps equal). The port's
blocked path is held to its per-tick path: every value equal but the euler
angles, which the tick takes in float32 and a block in float64, within
2e-6 rad. A bridge without hooks draws both streams from its generator in
joint chunks, so a tick and a block take the same values.

The JAX bridge's blocks fly `bool(use_estimator)` (the mocap estimator where
the caller asked for "gpsimu"); the port's fly the mode given, as its ticks
do, and that is held here, not the JAX block's mode.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import bag_bound, compare_bags, jax_tick_draws, jax_uwb_draws, read_bag
from agrifly_tpu.io import bridge as jbridge
from agrifly_tpu.io import messages as jmsgs
from agrifly_tpu.io import radio as jradio
from agrifly_tpu.models import logic as jlogic
from agrifly_tpu.sim import env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.io import bridge as tbridge
from agrifly_tpu_torch.io import messages as tmsgs
from agrifly_tpu_torch.io import radio as tradio
from agrifly_tpu_torch.models import logic as tlogic
from agrifly_tpu_torch.sim import env as T
from agrifly_tpu_torch.sim import uwb as tuwb

ANCHOR_IDS = [101, 102, 103, 104]  # tests/test_torch_uwb.py's
ANCHOR_POS = [[-3.0, -3.0, 0.1], [3.0, -3.0, 0.2], [3.0, 3.0, 2.0], [-3.0, 3.0, 1.5]]
HOVER = (0.0, 0.0, 1.0)
N_BEFORE, N_AFTER = 45, 30  # ticks before and after the kill on radio_command1
BLOCK = 7  # run_blocked's ticks a block: a divisor of neither leg
YPR_FIELDS = ("attyaw", "attpitch", "attroll", "attitudeYPR")


def _uwb_params(module, **kw):
    return module.with_uwb_anchors(module.make_params(noise_scale=1.0, **kw), ANCHOR_IDS,
                                   ANCHOR_POS, noise_std=0.05, comm_period=0.01)


def _hook(rows):
    """A bridge hook serving the rows of `rows` (n, ...) in order."""
    rows = np.asarray(rows, np.float32)
    at = [0]

    def take(n):
        out = rows[at[0]:at[0] + n]
        assert out.shape[0] == n, "the test drew too few draws"
        at[0] += n
        return torch.from_numpy(out.copy())
    return take


def _kill(bus, msgs_mod, radio_mod):
    raw = radio_mod.fields_to_bytes(radio_mod.TYPE_EMERGENCY_KILL, 0, np.zeros(10, np.int64))
    bus.publish("radio_command1", msgs_mod.RadioCommand(raw=raw + b"\x00" * 9))


def _fly(br, path, cmd, msgs_mod, radio_mod, block=None):
    """N_BEFORE ticks, a kill on radio_command1, N_AFTER ticks (per tick, or
    in blocks of `block`), recorded to `path`: the bag and the flight state
    after each leg."""
    rec = (tbridge if msgs_mod is tmsgs else jbridge).MessageRecorder(br.bus, str(path))
    fs = []
    for leg, n in enumerate((N_BEFORE, N_AFTER)):
        if leg:
            _kill(br.bus, msgs_mod, radio_mod)
        br.run(n, cmd) if block is None else br.run_blocked(n, cmd, block=block)
        fs.append(int(br.state.logic.fs))
    rec.close()
    return read_bag(path), fs


def _same_but_euler(a, b):
    compare_bags(a, b, lambda topic, name, stamp, ref: 2e-6 if name in YPR_FIELDS else 0.0)


@pytest.mark.parametrize("use_estimator", [True, "gpsimu"], ids=["mocap", "gpsimu"])
def test_sim_bridge_over_uwb_matches_jax(tmp_path, use_estimator):
    """The JAX bridge and the port's fly per tick over the UWB env on the
    same draws, with a kill: the bags agree by bag_bound, both take ranges
    and reach FS_KILLED. The port's run_blocked on the same draws publishes
    what its run publishes (euler within 2e-6 rad) and ends in the same
    state; with "gpsimu" that is the GPS-IMU flight, not the JAX block's
    mocap one."""
    n = N_BEFORE + N_AFTER
    jb = jbridge.SimBridge(_uwb_params(J), vehicle_id=1, seed=0, use_estimator=use_estimator)
    noise, _ = jax_tick_draws(jb.state.key, n)
    draws = jax_uwb_draws(jb.state.uwb.key, n).numpy()
    tp = convert.env_params_from_numpy(jax.tree_util.tree_map(np.asarray, jb.params), "cpu")
    mine = {}
    for name, block in (("run", None), ("blocked", BLOCK)):
        br = tbridge.SimBridge(tp, vehicle_id=1, use_estimator=use_estimator,
                               draws=_hook(noise), uwb_draws=_hook(draws))
        bag, fs = _fly(br, tmp_path / f"{name}.jsonl", T.hover_command(HOVER, device="cpu"),
                       tmsgs, tradio, block)
        mine[name] = (bag, fs, br.state)
    theirs, their_fs = _fly(jb, tmp_path / "jax.jsonl", J.hover_command(HOVER), jmsgs, jradio)

    bag, fs, state = mine["run"]
    worst = compare_bags(bag, theirs, bag_bound)
    print(f"{len(bag)} messages; worst float {worst:.4g} x the tick bound")
    assert fs == their_fs and fs[0] != tlogic.FS_KILLED
    assert fs[1] == tlogic.FS_KILLED == jlogic.FS_KILLED
    assert int(state.logic.uwb_meas_count) > 0 and int(jb.state.logic.uwb_meas_count) > 0
    assert int(state.logic.uwb_meas_count) == int(jb.state.logic.uwb_meas_count)

    blocked, blocked_fs, blocked_state = mine["blocked"]
    _same_but_euler(blocked, bag)
    assert blocked_fs == fs
    for (path, x), (_, y) in zip(convert.leaves(blocked_state), convert.leaves(state)):
        assert torch.equal(x, y), path
    # the GPS-IMU estimator ran in the blocks exactly where it was asked for
    cold = convert.leaves(T.init_state(tp).gpsimu)
    ran = any(not torch.equal(x, y) for (_, x), (_, y) in
              zip(convert.leaves(blocked_state.gpsimu), cold))
    assert ran == (use_estimator == "gpsimu")


def test_generator_draws_alike_by_tick_and_by_block(tmp_path):
    """Bridges without hooks over the UWB env draw the IMU noise and the
    network's draws from their generators: run and run_blocked (blocks of
    7) past NOISE_CHUNK ticks publish the same bag (euler within 2e-6 rad)
    and end in the same state, so the two paths take the generator's
    values in the same order; the network ranged."""
    n = tbridge.NOISE_CHUNK + 6
    p = _uwb_params(T, device="cpu")
    cmd = T.hover_command(HOVER, device="cpu")
    bags, states = {}, {}
    for name in ("run", "blocked"):
        br = tbridge.SimBridge(p, vehicle_id=1, seed=7)
        rec = tbridge.MessageRecorder(br.bus, str(tmp_path / f"{name}.jsonl"))
        br.run(n, cmd) if name == "run" else br.run_blocked(n, cmd, block=BLOCK)
        rec.close()
        bags[name], states[name] = read_bag(tmp_path / f"{name}.jsonl"), br.state
    _same_but_euler(bags["blocked"], bags["run"])
    for (path, x), (_, y) in zip(convert.leaves(states["blocked"]),
                                 convert.leaves(states["run"])):
        assert torch.equal(x, y), path
    assert int(states["run"].logic.uwb_meas_count) > 0

    # the stream is the generator's noise chunk, then its UWB chunk
    gen = torch.Generator().manual_seed(7)
    noise = torch.randn((tbridge.NOISE_CHUNK, 2, 3), generator=gen)
    draws = tuwb.draw((tbridge.NOISE_CHUNK,), gen)
    br = tbridge.SimBridge(p, vehicle_id=1, seed=7)
    got_noise, got_draws = br._noise(3)
    assert torch.equal(got_noise, noise[:3]) and torch.equal(got_draws, draws[:3])


def test_generator_without_a_network_draws_as_before():
    """Without a network the bridge's stream is its generator's IMU chunks
    alone, and it passes no UWB draws."""
    br = tbridge.SimBridge(T.make_params(noise_scale=1.0, device="cpu"), seed=5)
    noise, draws = br._noise(tbridge.NOISE_CHUNK + 2)
    gen = torch.Generator().manual_seed(5)
    want = torch.cat([torch.randn((tbridge.NOISE_CHUNK, 2, 3), generator=gen)
                      for _ in range(2)])
    assert draws is None and torch.equal(noise, want[:tbridge.NOISE_CHUNK + 2])


@pytest.mark.parametrize("device_blocks", [False, True])
def test_sim_bridge_over_uwb_runs_realtime(device_blocks):
    """The paced loop over the UWB env runs in both branches (per tick, and
    device blocks): its ticks are flown and published. The wall-clock rate
    is not held here (tests/test_torch_bridge.py paces the loop)."""
    br = tbridge.SimBridge(_uwb_params(T, device="cpu"), vehicle_id=1)
    report = br.run_realtime(0.4, T.hover_command(HOVER, device="cpu"), rate_hz=25.0, block=5,
                             device_blocks=device_blocks)
    warm = 10 if not device_blocks else 5
    assert report["ticks"] == 10
    assert br.bus.counts["simulator_truth1"] == report["ticks"] + warm
    assert br.t_us == (report["ticks"] + warm) * 2000
    assert bool(torch.isfinite(br.state.plant.pos).all())
