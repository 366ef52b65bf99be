"""The GPS-IMU and GPS estimators of the port against the JAX package's
(`offboard/estimators.py`), on the CPU, with tests/test_estimator_loop.py's
inputs: discrete leaves equal, float leaves within the tick criteria of
tests/_torch_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import compare_state
from agrifly_tpu.offboard import estimators as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.models import ekf as tekf
from agrifly_tpu_torch.offboard import estimators as T


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_gpsimu_estimator_converges_as_jax():
    """tests/test_estimator_loop.py's stationary vehicle: 500 IMU
    predictions (gravity plus noise) and a GPS fix every fifth; the port
    converges as the JAX package does, and to the same state."""
    rng = np.random.default_rng(0)
    acc = (np.float32([0.0, 0.0, 9.81]) + 0.2 * rng.standard_normal((500, 3))).astype(np.float32)
    true_pos = np.float32([2.0, -1.0, 3.0])
    dt = np.float32(1.0 / 500.0)

    def body(s, xs):
        a, fire = xs
        s = J.gpsimu_predict(s, a, jnp.zeros(3, jnp.float32), dt)
        return J.gps_position_update(s, true_pos, fire), None

    fires = np.arange(500) % 5 == 4
    ref = _np(jax.jit(lambda s: jax.lax.scan(body, s, (acc, fires))[0])(J.gpsimu_init()))
    s = T.gpsimu_init("cpu")
    for a, fire in zip(acc, fires):
        s = T.gpsimu_predict(s, _t(a), torch.zeros(3), torch.tensor(dt))
        s = T.gps_position_update(s, _t(true_pos), torch.tensor(fire))
    compare_state(s, ref)
    assert np.allclose(s.pos.numpy(), true_pos, atol=0.15) and float(s.vel.norm()) < 0.3
    assert bool(s.uwb_init) and int(s.num_resets) == 1  # no complementary phase


def _filters():
    """Five GPS-IMU filters: an update, a singular innovation covariance
    (the bailout), a non-finite one, a filter without an IMU sample (the
    first fix is adopted), and apply=False."""
    rng = np.random.default_rng(1)
    n = 5
    A = rng.standard_normal((n, 9, 9)) * 0.3
    cov = (A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(9)).astype(np.float32)
    cov[1, :3, :3] = -0.0625 * np.eye(3)
    cov[2, 0, 0] = np.inf
    s = jax.vmap(lambda _: J.gpsimu_init())(jnp.arange(n))._replace(
        pos=jnp.asarray(rng.uniform(-2, 2, (n, 3)), jnp.float32),
        vel=jnp.asarray(rng.uniform(-1, 1, (n, 3)), jnp.float32), cov=jnp.asarray(cov),
        imu_init=jnp.asarray([True, True, True, False, True]),
        num_resets=jnp.ones(n, jnp.int32))
    meas = (np.asarray(s.pos) + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32)
    return s, meas, np.arange(n) != 4


def test_gps_position_update_matches_jax():
    s, meas, apply = _filters()
    ref = _np(jax.jit(jax.vmap(J.gps_position_update))(s, meas, apply))
    got = torch.func.vmap(T.gps_position_update)(
        convert.from_numpy(tekf.EkfState, _np(s), "cpu"), _t(meas), _t(apply))
    compare_state(got, ref)
    np.testing.assert_array_equal(ref.pos[1:4], meas[1:4])  # bailouts and the first fix
    np.testing.assert_array_equal(ref.uwb_init, [True, False, False, True, False])
    np.testing.assert_array_equal(ref.imu_init, [True, True, True, True, True])


def test_gps_estimator_update_over_20_fixes_matches_jax():
    """tests/test_estimator_loop.py's GPS estimator, 20 fixes 10 ms apart,
    with a command pushed into its prediction pipe before each (the replay
    propagates mean and covariance through them) and a prediction after:
    every state and prediction against the JAX package's."""
    rng = np.random.default_rng(2)
    js, ts = J.gps_init(), T.gps_init(device="cpu")
    push = jax.jit(lambda s, t, w, a: J.gps_set_predicted_values(s, t, jnp.int32(30000), w, a))
    update = jax.jit(lambda s, t, m: J.gps_update(s, t, m, jnp.int32(10000)))
    predict = jax.jit(lambda s, t: J.gps_get_prediction(s, t, jnp.int32(30000)))
    for k in range(20):
        t = np.int32(10000 * (k + 1))
        w = (0.2 * rng.standard_normal(3)).astype(np.float32)
        a = (0.5 * rng.standard_normal(3)).astype(np.float32)
        meas = (np.float32([1.0, 1.0, 2.0]) + 0.05 * rng.standard_normal(3)).astype(np.float32)
        js = update(push(js, t - 5000, w, a), t, meas)
        ts = T.gps_update(T.gps_set_predicted_values(ts, torch.tensor(t - 5000), torch.tensor(30000),
                                                     _t(w), _t(a)), torch.tensor(t), _t(meas), 10000)
        compare_state(ts, _np(js))
        for got, ref in zip(T.gps_get_prediction(ts, torch.tensor(t), torch.tensor(30000)),
                            predict(js, t)):
            ref = np.asarray(ref)
            assert (np.abs(got.numpy() - ref) <= 1e-3 * (np.abs(ref) + 1e-3)).all(), k
    assert np.allclose(ts.pos.numpy(), [1.0, 1.0, 2.0], atol=0.1)
    assert int(ts.pipe.count) >= 1 and bool(ts.initialized)
