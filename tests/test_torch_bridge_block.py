"""The port's SimBridge tick block (`cuda_rollout.tick_block`, on the CPU
its plain version `tick_block_plain`) against the JAX package's
`SimBridge._dispatch_tick_block` (one lax.scan under jit), on the CPU.

Both bridges start from the same state (the JAX bridge's, carried across
with `convert`) and fly one 40-tick block on the same IMU noise: the JAX
bridge draws it from its state's key, the port's takes those draws through
its `draws` hook (`_torch_parity.jax_tick_draws`). The telemetry fires
inside the block (every fifth tick). The wire rows agree: the float columns
to the tick criteria |d| <= 1e-3 (|ref| + 1e-3), the telemetry codes within
one code, the packet numbers equal; and so do the final states (the tick
criteria of tests/_torch_parity.py).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import compare_state, jax_tick_draws
from agrifly_tpu.io import bridge as jbridge
from agrifly_tpu.sim import env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.io import bridge as tbridge
from agrifly_tpu_torch.sim import cuda_rollout
from agrifly_tpu_torch.sim import env as T

HOVER = (0.0, 0.0, 1.0)
TICKS = 40
TEL = slice(tbridge._TB_TELD1.start, tbridge._TB_COLS)  # the telemetry codes


def _draws_from(noise):
    noise = np.asarray(noise, np.float32)
    at = [0]

    def draws(n):
        at[0] += n
        return torch.from_numpy(noise[at[0] - n:at[0]].copy())
    return draws


@pytest.mark.parametrize("use_estimator", [True, False], ids=["mocap", "true"])
def test_tick_block_matches_the_jax_block(use_estimator):
    """One 40-tick block from the same state on the same draws: the port's
    rows (tick_block_plain through SimBridge._dispatch_tick_block) against
    the JAX block's rows, and the final states."""
    jb = jbridge.SimBridge(J.make_params(noise_scale=1.0), vehicle_id=1, seed=3,
                           use_estimator=use_estimator)
    noise, _ = jax_tick_draws(jb.state.key, TICKS)
    tp = convert.env_params_from_numpy(jax.tree_util.tree_map(np.asarray, jb.params), "cpu")
    tb = tbridge.SimBridge(tp, vehicle_id=1, use_estimator=use_estimator,
                           draws=_draws_from(noise))
    tb.state = convert.env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jb.state), "cpu")

    _, theirs, their_fires, _ = jb._dispatch_tick_block(TICKS, J.hover_command(HOVER))
    _, mine, _, my_fires, _ = tb._dispatch_tick_block(TICKS, T.hover_command(HOVER, device="cpu"))
    theirs, mine = np.asarray(theirs, np.float64), mine.numpy().astype(np.float64)
    fire = their_fires["telemetry"]
    assert np.array_equal(fire, my_fires["telemetry"]) and 5 <= fire.sum() < TICKS
    assert mine.shape == theirs.shape == (TICKS, tbridge._TB_COLS)

    floats = slice(0, tbridge._TB_TELNUM)
    ratio = np.abs(mine[:, floats] - theirs[:, floats]) / (1e-3 * (np.abs(theirs[:, floats])
                                                                    + 1e-3))
    assert ratio.max() <= 1.0, (ratio.max(), np.unravel_index(ratio.argmax(), ratio.shape))
    assert np.array_equal(mine[:, tbridge._TB_TELNUM], theirs[:, tbridge._TB_TELNUM])
    assert np.array_equal(mine[:, tbridge._TB_TELNUM][fire], np.arange(fire.sum()))
    assert np.abs(mine[:, TEL] - theirs[:, TEL]).max() <= 1.0
    assert not mine[~fire][:, TEL].any() and mine[fire][:, tbridge._TB_TELD1].all()
    compare_state(tb.state, jb.state)


def _cpu_case(B=None, seed=5):
    g = torch.Generator().manual_seed(seed)
    p = T.make_params(noise_scale=1.0, device="cpu")
    if B is None:
        s = T.init_state(p)
        noise = torch.randn((7, 2, 3), generator=g)
    else:
        s = T.init_state_fleet(p, torch.rand((B, 3), generator=g) * 2.0)
        noise = torch.randn((B, 7, 2, 3), generator=g)
    return p, s, T.hover_command(HOVER, device="cpu"), noise


def test_tick_block_fleet_equals_each_vehicle():
    """A fleet's block (a leading B on every state leaf, the rows (B, n,
    64)) equals each vehicle's own block, telemetry firing on the first and
    the last tick."""
    p, s, cmd, noise = _cpu_case(B=2)
    fire = torch.tensor([1, 0, 0, 0, 0, 0, 1], dtype=torch.int8)
    fleet, rows = cuda_rollout.tick_block(p, s, cmd, noise, fire, True)
    assert rows.shape == (2, 7, cuda_rollout.ROW_WORDS)
    for b in range(2):
        one = T._tree_map(lambda t: t[b], s)
        got, got_rows = cuda_rollout.tick_block(p, one, cmd, noise[b], fire, True)
        assert torch.equal(rows[b], got_rows)
        for (path, x), (_, y) in zip(convert.leaves(got), convert.leaves(fleet)):
            assert torch.equal(x, y[b]), path
    assert torch.equal(fleet.logic.tel_counter, torch.full((2,), 2, dtype=torch.int32))
    assert torch.equal(rows[:, [0, 6], tbridge._TB_TELNUM], torch.tensor([[0.0, 1.0]] * 2))


@pytest.mark.parametrize("case", ["mask length", "mask dtype", "noise shape", "uwb draws"])
def test_tick_block_refuses_what_the_kernel_does_not_take(case):
    """The wrapper's checks hold on the CPU too, before it routes a call."""
    p, s, cmd, noise = _cpu_case()
    fire = torch.zeros(7, dtype=torch.int8)
    kwargs = {}
    if case == "mask length":
        fire = torch.zeros(6, dtype=torch.int8)
    elif case == "mask dtype":
        fire = torch.zeros(7, dtype=torch.float32)
    elif case == "noise shape":
        noise = noise[:, :1]
    else:
        kwargs["uwb_draws"] = torch.zeros((7, 4))
    with pytest.raises(ValueError):
        cuda_rollout.tick_block(p, s, cmd, noise, fire, True, **kwargs)
