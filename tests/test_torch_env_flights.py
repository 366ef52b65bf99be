"""`sim/env`'s long flights through the port's rollout, on the CPU.

tests/test_hover.py's takeoff and step-response envelopes and the
self-golden tests/golden/hover_traj_v1.npz, flown by the port's plain
rollout (CPU tensors) from the JAX package's states and draws. Beyond the
60 steps that tests/test_torch_env.py holds to the tick criteria, the port
is held to the JAX package's own terms for rollout_fast
(tests/test_extra_components.py): discrete outputs equal at every step,
final position within 0.05 m. A flight of 3000 plain ticks takes about a
minute on one CPU thread: a file of its own, so that pytest-xdist runs it
beside the parity tests.
"""

import functools
from pathlib import Path

import jax
import numpy as np
import torch

from agrifly_tpu.models import logic as jlogic
from agrifly_tpu.sim import env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.sim import env as T
from _torch_parity import TICK_DRAWS as DRAWS, jax_tick_draws
from test_torch_env import _jparams, _np, _t, _tparams


@functools.lru_cache(maxsize=None)
def _jax_hover():
    """The JAX package's noise-free hover runs (6 s each, one program): the
    takeoff to 1.5 m, the hover at 1 m, and the step from there to 2 m."""
    jp = _jparams(0.0)
    run = jax.jit(lambda s, c: J.rollout(jp, s, c, 3000))
    s0 = J.init_state(jp, jax.random.PRNGKey(0))
    takeoff = run(s0, J.hover_command((0.0, 0.0, 1.5)))
    hover = run(s0, J.hover_command((0.0, 0.0, 1.0)))
    step = run(hover[0], J.hover_command((0.0, 0.0, 2.0)))
    return _np(s0), _np(takeoff), _np(hover[0]), _np(step)


def _fly(state, des_pos, n=3000):
    """n noise-free ticks of the port's rollout_fast from a JAX state."""
    p = _tparams(0.0)
    cmd = T.hover_command(des_pos, device="cpu")
    return T.rollout_fast(p, convert.env_state_from_numpy(state, "cpu"), cmd, n,
                          noise=torch.zeros(n, 2, 3))


def _same_as_jax(final, traj, ref, ref_traj):
    for name in ("flight_state", "panic_reason"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      np.asarray(getattr(ref_traj, name)))
    assert np.abs(final.plant.pos.numpy() - ref.plant.pos).max() < 0.05


def test_hover_takeoff_envelope():
    """tests/test_hover.py's takeoff: 6 s to 1.5 m from the ground, noise off."""
    s0, (ref, ref_traj), _, _ = _jax_hover()
    final, traj = _fly(s0, (0.0, 0.0, 1.5))
    z = traj.pos[:, 2].numpy()
    assert abs(z[-1] - 1.5) < 0.05, z[-1]
    assert int(final.logic.panic_reason) == jlogic.PANIC_NO_PANIC
    assert int(final.logic.fs) == jlogic.FS_EXTERNAL_RATES_CONTROL
    assert np.abs(traj.pos[:, :2].numpy()).max() < 0.05
    _same_as_jax(final, traj, ref, ref_traj)


def test_hover_step_response_envelope():
    """tests/test_hover.py's step response: from the JAX package's 6 s
    hover at 1 m, the setpoint stepped to 2 m for 6 s, noise off: small
    overshoot, settled within 5% by 3.5 s."""
    _, _, warm, (ref, ref_traj) = _jax_hover()
    final, traj = _fly(warm, (0.0, 0.0, 2.0))
    z = traj.pos[:, 2].numpy()
    assert abs(z[-1] - 2.0) < 0.02
    assert (z.max() - 2.0) / 1.0 < 0.15
    assert np.all(np.abs(z[1750:] - 2.0) < 0.05)
    _same_as_jax(final, traj, ref, ref_traj)


def test_golden_hover_trajectory_through_the_port():
    """tests/golden/hover_traj_v1.npz (the JAX package's own 1500-step mocap
    hover from PRNGKey(1234), every 50th output) flown by the port with the
    JAX package's draws. Held to the rollout_fast terms, not the golden
    test's 1e-5: over 1500 closed-loop steps the ulp differences of any two
    programs (a fusion, a different but correct rounding) grow past 1e-5, as
    tests/test_extra_components.py says of rollout_fast against rollout. The
    first sample is held to its 1e-4."""
    golden = np.load(Path(__file__).parent / "golden" / "hover_traj_v1.npz")
    jp = _jparams()
    s0 = _np(J.init_state(jp, jax.random.PRNGKey(1234)))
    noise, _ = jax_tick_draws(s0.key, DRAWS)
    cmd = convert.command_from_numpy(_np(J.hover_command((0.3, -0.2, 1.2))), "cpu")
    final, traj = T.rollout_fast(_tparams(), convert.env_state_from_numpy(s0, "cpu"), cmd, DRAWS,
                                 True, noise=_t(noise))
    idx = np.arange(0, DRAWS, 50)
    np.testing.assert_allclose(traj.pos.numpy()[idx][0], golden["pos"][0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(traj.pos.numpy()[idx][-1], golden["pos"][-1], rtol=0, atol=0.05)
    np.testing.assert_allclose(final.logic.kf.pos.numpy(), golden["final_kf_pos"], rtol=0, atol=0.05)
    np.testing.assert_allclose(final.mocap.pos.numpy(), golden["final_mocap_pos"], rtol=0,
                               atol=0.05)
    assert int(final.logic.fs) == jlogic.FS_EXTERNAL_RATES_CONTROL
    assert int(final.logic.panic_reason) == jlogic.PANIC_NO_PANIC
