"""The port's `planner/traj` leftovers against the JAX package's: `jerk`,
`to_poly_coeffs`, the position-feasibility proof, the non-strict velocity
proof and the verdict codes, on the inputs of tests/test_traj.py.

Both run on the CPU (the JAX velocity proof compiled, the rest op by op);
the values are bit-equal and the verdicts equal, and each verdict also
holds against dense sampling of the port's own trajectory.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from agrifly_tpu.planner import traj as J
from agrifly_tpu_torch.ops import poly as tpoly
from agrifly_tpu_torch.planner import traj as T


def _pair(p0, v0, a0, tf, pf):
    n = len(tf)
    z = np.zeros((n, 3), np.float32)
    jt = J.generate(*(np.asarray(x, np.float32) for x in (p0, v0, a0, tf)),
                    goal_pos=np.asarray(pf, np.float32), goal_vel=z, goal_acc=z)
    return jt, T.Traj(*(torch.from_numpy(np.array(x)) for x in jt))


def _trajs(seed, n=32, z0=0.0):
    rng = np.random.default_rng(seed)
    p0 = np.tile([0.0, 0.0, z0], (n, 1))
    return _pair(p0, rng.uniform(-4, 4, (n, 3)), rng.uniform(-2, 2, (n, 3)),
                 rng.uniform(1.5, 3.0, n), rng.uniform(-3, 3, (n, 3)) + [0, 0, z0 + 0.5])


def test_verdict_codes_equal_the_jax_package():
    names = ("FEASIBLE", "INDETERMINABLE", "INFEASIBLE_THRUST_HIGH", "INFEASIBLE_THRUST_LOW",
             "STATE_FEASIBLE", "STATE_INFEASIBLE")
    assert [getattr(T, n) for n in names] == [getattr(J, n) for n in names]


def test_jerk_and_poly_coeffs_match_jax():
    jt, tt = _trajs(0)
    t = np.random.default_rng(1).uniform(0, 1.5, 32).astype(np.float32)
    np.testing.assert_array_equal(T.jerk(tt, torch.from_numpy(t)).numpy(),
                                  np.asarray(J.jerk(jt, jnp.asarray(t))))
    coeffs = T.to_poly_coeffs(tt)
    np.testing.assert_array_equal(coeffs.numpy(), np.asarray(J.to_poly_coeffs(jt)))
    # the coefficients evaluate to the trajectory (tests/test_traj.py's roundtrip)
    np.testing.assert_allclose(tpoly.position(coeffs, torch.from_numpy(t)).numpy(),
                               T.position(tt, torch.from_numpy(t)).numpy(), atol=1e-4)


def test_position_feasibility_matches_jax_and_sampling():
    """tests/test_traj.py's floor plane at z = 0.5 under trajectories from
    z = 2, and a tilted plane: verdicts equal, and a feasible verdict means
    no sampled point reaches the plane."""
    jt, tt = _trajs(6, z0=2.0)
    for point, normal in (([0.0, 0.0, 0.5], [0.0, 0.0, 1.0]), ([1.0, 0.0, 1.0], [-1.0, 0.3, 0.8])):
        point, normal = np.float32(point), np.float32(normal)
        got = T.check_position_feasibility(tt, torch.from_numpy(point), torch.from_numpy(normal))
        ref = np.asarray(J.check_position_feasibility(jt, point, normal))
        np.testing.assert_array_equal(got.numpy(), ref)
        n = normal / np.linalg.norm(normal)
        for i in np.flatnonzero(got.numpy()):
            ts = torch.linspace(0, float(tt.tf[i]), 3001)
            pos = T.position(T.Traj(*(x[i].expand((3001,) + x.shape[1:]) for x in tt)), ts).numpy()
            assert ((pos - point) @ n > 0).all(), i


def test_velocity_feasibility_not_strict_matches_jax():
    """Random primitives and tests/test_traj.py's degenerate axes (alpha = 0:
    the strict check rejects, the quadratic roots accept what stays below
    vmax and still reject what does not)."""
    jt, tt = _trajs(5)
    for strict in (True, False):
        np.testing.assert_array_equal(
            T.check_velocity_feasibility(tt, 5.0, strict_degenerate=strict).numpy(),
            np.asarray(jax.jit(functools.partial(J.check_velocity_feasibility, vmax=5.0,
                                                 strict_degenerate=strict))(jt)))
    z = np.zeros((2, 3), np.float32)
    v0 = np.float32([[1.0, 0.0, 0.0], [6.0, 0.0, 0.0]])
    a0 = np.float32([[0.0, 0.0, 0.5], [0.0, 0.0, 0.5]])
    jdeg = J.Traj(alpha=z, beta=z, gamma=z, a0=a0, v0=v0, p0=z, tf=np.float32([2.0, 2.0]),
                  cost=np.zeros(2, np.float32))
    tdeg = T.Traj(*(torch.from_numpy(np.array(x)) for x in jdeg))
    for strict, want in ((True, [False, False]), (False, [True, False])):
        got = T.check_velocity_feasibility(tdeg, 5.0, strict_degenerate=strict).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jax.jit(functools.partial(
            J.check_velocity_feasibility, vmax=5.0, strict_degenerate=strict))(jdeg)))
