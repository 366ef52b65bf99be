"""The port's ops against the JAX package's, elementwise.

Inputs are float32 arrays from numpy seeds; both sides run on the CPU.
Bound: 2 ulp of the output's scale (the largest magnitude the formula
combines), since XLA:CPU may contract a product and a sum into one FMA
where torch rounds both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrifly_tpu.ops import filters as jf, lin3 as jl, rootfind as jrf, rotation as jr, trig as jt
from agrifly_tpu_torch.ops import filters as tf, lin3 as tl, rootfind as trf, rotation as tr, trig as tt
from agrifly_tpu_torch.ops import fmath

ULP = 2


def assert_ulp(got, ref, scale=None, n=ULP):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    mag = np.abs(ref) if scale is None else np.maximum(np.abs(ref), scale)
    tol = n * np.spacing(mag.astype(np.float32)).astype(np.float64)
    bad = ~(np.abs(got - ref) <= tol) & ~(np.isnan(got) & np.isnan(ref))
    assert not bad.any(), (got[bad][:5], ref[bad][:5], int(bad.sum()))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["atan", "asin", "acos"])
def test_trig_unary(name):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 4000), 1 - rng.uniform(0, 1e-5, 500),
                        -1 + rng.uniform(0, 1e-5, 500), [-1.0, 1.0, 0.0, 0.5, -0.5]]).astype(np.float32)
    if name == "atan":
        x = np.concatenate([x * 50, x]).astype(np.float32)
    got = getattr(tt, name)(_t(x)).numpy()
    ref = np.asarray(getattr(jt, name)(jnp.asarray(x)))
    assert_ulp(got, ref, scale=1.0)


def test_trig_atan2_quadrants():
    rng = np.random.default_rng(1)
    y = np.concatenate([rng.standard_normal(3000), [0, 0, 1, -1, 0]]).astype(np.float32)
    x = np.concatenate([rng.standard_normal(3000), [0, -1, 0, 0, 1]]).astype(np.float32)
    assert_ulp(tt.atan2(_t(y), _t(x)).numpy(), np.asarray(jt.atan2(jnp.asarray(y), jnp.asarray(x))),
               scale=1.0)


def test_rotation_maps_and_guard():
    rng = np.random.default_rng(2)
    q1, q2 = _quats(rng, 2000), _quats(rng, 2000)
    # rotation vectors straddling the MIN_ANGLE guard and of ordinary size
    mags = np.concatenate([rng.uniform(0, 2 * tr.MIN_ANGLE, 1000), rng.uniform(0, 3, 1000)])
    axis = rng.standard_normal((2000, 3))
    rv = (axis / np.linalg.norm(axis, axis=1, keepdims=True) * mags[:, None]).astype(np.float32)
    v = rng.standard_normal((2000, 3)).astype(np.float32)
    wide = np.abs(q1[:, 0]) > 0.3

    pairs = [
        (tr.qmul(_t(q2), _t(q1)), jr.qmul(jnp.asarray(q2), jnp.asarray(q1))),
        (tr.qnormalize(_t(q1 * 3)), jr.qnormalize(jnp.asarray(q1 * 3))),
        (tr.from_rotation_vector(_t(rv)), jr.from_rotation_vector(jnp.asarray(rv))),
        # log map where asin is well conditioned (rotations below ~145 deg)
        (tr.to_rotation_vector(_t(q1[wide])), jr.to_rotation_vector(jnp.asarray(q1[wide]))),
        (tr.to_matrix(_t(q1)), jr.to_matrix(jnp.asarray(q1))),
        (tr.rotate(_t(q1), _t(v)), jr.rotate(jnp.asarray(q1), jnp.asarray(v))),
        (tr.rotate_back(_t(q1), _t(v)), jr.rotate_back(jnp.asarray(q1), jnp.asarray(v))),
        (tr.get_angle(_t(q1)), jr.get_angle(jnp.asarray(q1))),
    ]
    for got, ref in pairs:
        assert_ulp(got.numpy(), np.asarray(ref), scale=4.0)
    for a, b in zip(tr.to_euler_ypr(_t(q1)), jr.to_euler_ypr(jnp.asarray(q1))):
        assert_ulp(a.numpy(), np.asarray(b), scale=4.0)
    # the guard itself: below MIN_ANGLE the exp map is exactly the identity
    small = mags < tr.MIN_ANGLE * 0.999
    np.testing.assert_array_equal(tr.from_rotation_vector(_t(rv)).numpy()[small],
                                  np.tile([1.0, 0.0, 0.0, 0.0], (int(small.sum()), 1)))


def test_lin3_and_lp2_filter():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((500, 3, 3)).astype(np.float32)
    v = rng.standard_normal((500, 3)).astype(np.float32)
    assert_ulp(tl.mv3(_t(m), _t(v)).numpy(), np.asarray(jl.mv3(jnp.asarray(m), jnp.asarray(v))), scale=8.0)
    assert_ulp(tl.mv3t(_t(m), _t(v)).numpy(), np.asarray(jl.mv3t(jnp.asarray(m), jnp.asarray(v))), scale=8.0)

    jc, tc = jf.lp2_coeffs(0.002, 100.0), tf.lp2_coeffs(0.002, 100.0)
    for a, b in zip(tc, jc):
        assert a.item() == float(b)
    x = rng.standard_normal((200, 3)).astype(np.float32)
    js, ts = jf.lp2_init(jnp.zeros(3, jnp.float32)), tf.lp2_init(torch.zeros(3))
    for row in x:
        js, jo = jf.lp2_apply(jc, js, jnp.asarray(row))
        ts, to = tf.lp2_apply(tc, ts, _t(row))
        assert_ulp(to.numpy(), np.asarray(jo), scale=1.0)


def test_fmath_matches_reference_rounding():
    rng = np.random.default_rng(4)
    x = np.abs(rng.standard_normal(20000) * 10).astype(np.float32)
    np.testing.assert_array_equal(fmath.sqrt(_t(x)).numpy(), np.sqrt(x))
    np.testing.assert_array_equal(fmath.ipow(_t(x), 5).numpy(), np.asarray(jnp.asarray(x) ** 5))
    np.testing.assert_array_equal(fmath.ipow(_t(x), 4).numpy(), np.asarray(jnp.asarray(x) ** 4))


def _cubic_coeffs(rng, n):
    """Monic cubics: half with three distinct real roots, half with one."""
    r = rng.uniform(-3, 3, (n, 3))
    r[:, 1] = r[:, 0] + rng.uniform(0.3, 2, n)
    r[:, 2] = r[:, 1] + rng.uniform(0.3, 2, n)
    a3 = -(r[:, 0] + r[:, 1] + r[:, 2])
    b3 = r[:, 0] * r[:, 1] + r[:, 1] * r[:, 2] + r[:, 0] * r[:, 2]
    c3 = -r[:, 0] * r[:, 1] * r[:, 2]
    # (x - r0)(x^2 + p x + q) with p^2 < 4 q
    r0, p = rng.uniform(-3, 3, n), rng.uniform(-3, 3, n)
    q = p * p / 4 + rng.uniform(0.5, 2, n)
    a1, b1, c1 = p - r0, q - r0 * p, -r0 * q
    return (np.concatenate([a3, a1]).astype(np.float32),
            np.concatenate([b3, b1]).astype(np.float32),
            np.concatenate([c3, c1]).astype(np.float32))


# The root solvers' trigonometric branch goes through acos and cos, which in
# XLA:CPU are not correctly rounded (up to ~2 ulp each); the port's are.
# Cubic roots are held to ROOT_ULP ulp of the coefficient scale. The quartic
# feeds its resolvent cubic's root into differences of nearly equal terms
# (y +- sqrt(y^2 - 4d)), which multiplies that few-ulp difference: measured
# up to ~20 ulp of scale on these inputs, held to QUARTIC_ULP.
ROOT_ULP = 4
QUARTIC_ULP = 32


def _scale(*coeffs, k):
    return np.maximum(np.abs(np.stack(coeffs, 1)).max(1), 1.0)[:, None] * np.ones((1, k))


def test_solve_cubic_roots_and_masks():
    a, b, c = _cubic_coeffs(np.random.default_rng(5), 2000)
    rg, vg = trf.solve_cubic(_t(a), _t(b), _t(c))
    rj, vj = jrf.solve_cubic(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    np.testing.assert_array_equal(vg.numpy(), np.asarray(vj))
    v = np.asarray(vj)
    assert_ulp(rg.numpy()[v], np.asarray(rj)[v], scale=_scale(a, k=3)[v], n=ROOT_ULP)


def _quartic_coeffs(rng, n):
    """Monic quartics: half with four separated real roots, half with two
    real roots and a complex pair."""
    r = rng.uniform(-2, 2, (n, 1)) + np.cumsum(rng.uniform(0.4, 1.5, (n, 4)), 1)
    rows = [np.poly(row) for row in r]
    for row in r:
        p = rng.uniform(-2, 2)
        rows.append(np.polymul(np.poly(row[:2]), [1.0, p, p * p / 4 + rng.uniform(0.5, 2)]))
    C = np.array(rows)
    return [C[:, k].astype(np.float32) for k in range(1, 5)]


def test_solve_quartic_roots_and_masks():
    coeffs = _quartic_coeffs(np.random.default_rng(6), 1000)
    rg, vg = trf.solve_quartic(*(_t(x) for x in coeffs))
    rj, vj = jrf.solve_quartic(*(jnp.asarray(x) for x in coeffs))
    np.testing.assert_array_equal(vg.numpy(), np.asarray(vj))
    v = np.asarray(vj)
    assert v[:1000].all() and v[1000:].sum() == 2 * 1000
    assert_ulp(rg.numpy()[v], np.asarray(rj)[v], scale=_scale(*coeffs, k=4)[v], n=QUARTIC_ULP)
