"""The port's pyramid inflation against the JAX package's.

The plain batched `rappids.inflate_pyramid` (the plain version of the CUDA
inflation kernel) must give the same `ok` for every seed as
`jax.vmap(rappids.inflate_pyramid)` and as `pallas_inflate.inflate_pyramids`
in interpret mode, and the same integer edges and base depth for every seed
that is ok (the bounds of failed seeds are unspecified, as in the JAX
package). The CUDA kernel is held to the plain version the same way on
the card, in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gradient_scene, make_scene
from agrifly_tpu.planner import pallas_inflate as jpi, rappids as jrp
from agrifly_tpu_torch.planner import cuda_inflate, rappids as trp


def _params(W, H):
    return (jrp.make_params(jrp.make_camera(W, H, focal=W / 2.0), 0.116, 0.174),
            trp.make_params(trp.make_camera(W, H, focal=W / 2.0), 0.116, 0.174))


def _seeds(W, H, P, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(2, W - 2, P).astype(np.int32), rng.integers(2, H - 2, P).astype(np.int32),
            rng.uniform(1.5, 3.0, P).astype(np.float32))


def _assert_same(ok, maxd, edges, ok_ref, maxd_ref, edges_ref):
    np.testing.assert_array_equal(ok, ok_ref)
    np.testing.assert_array_equal(maxd[ok], maxd_ref[ok])
    np.testing.assert_array_equal(edges[ok], edges_ref[ok])


SCENES = [("clutter", 160, 120), ("clutter", 80, 60), ("gradient", 160, 120)]


@pytest.mark.parametrize("kind,W,H", SCENES)
@pytest.mark.parametrize("shrink_extra", [0, 1])
def test_plain_inflation_matches_jax(kind, W, H, shrink_extra):
    jp, tp = _params(W, H)
    img = make_scene(W, H, 8, seed=3) if kind == "clutter" else gradient_scene(W, H)
    x0, y0, md = _seeds(W, H, 24, seed=W + shrink_extra)
    ok, maxd, edges = (t.numpy() for t in trp.inflate_pyramid(
        tp, torch.from_numpy(img), torch.from_numpy(x0), torch.from_numpy(y0),
        torch.from_numpy(md), shrink_extra))
    assert ok.sum() >= 3

    # jnp reference: vmapped inflate_pyramid (bounds are float32 edges)
    ok_j, depth_j, bounds_j, _ = jax.vmap(
        lambda x, y, d: jrp.inflate_pyramid(jp, jnp.asarray(img), x, y, d, shrink_extra)
    )(jnp.asarray(x0), jnp.asarray(y0), jnp.asarray(md))
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(edges[ok].astype(np.float32), np.asarray(bounds_j)[ok])
    base = maxd.astype(np.float32) * np.float32(tp.cam.depth_scale) - np.float32(tp.plan_radius)
    np.testing.assert_array_equal(base[ok], np.asarray(depth_j)[ok])

    # the Pallas kernel (one seed per program), interpret mode
    ok_p, maxd_p, edges_p = (np.asarray(a) for a in jpi.inflate_pyramids(
        jp, jnp.asarray(img), jnp.asarray(x0), jnp.asarray(y0), jnp.asarray(md), shrink_extra,
        interpret=True))
    _assert_same(ok, maxd, edges, ok_p, maxd_p, edges_p)


@pytest.mark.parametrize("downsample", [1, 2])
def test_build_pyramid_set_matches_jax(downsample):
    W, H = 160, 120
    jp, tp = _params(W, H)
    img = make_scene(W, H, 6, seed=7)
    rng = np.random.default_rng(downsample)
    P = 16
    px = rng.uniform(5, W - 5, P).astype(np.float32)
    py = rng.uniform(5, H - 5, P).astype(np.float32)
    md = rng.uniform(1.5, 3.0, P).astype(np.float32)
    valid = np.ones(P, bool)
    valid[3] = False
    a = jrp.build_pyramid_set(jp, jnp.asarray(img), jnp.asarray(px), jnp.asarray(py),
                              jnp.asarray(md), jnp.asarray(valid), 10,
                              downsample=downsample, use_pallas=False)
    b = trp.build_pyramid_set(tp, torch.from_numpy(img), torch.from_numpy(px),
                              torch.from_numpy(py), torch.from_numpy(md),
                              torch.from_numpy(valid), 10, downsample=downsample)
    v = np.asarray(a.valid)
    assert v.sum() >= 3
    np.testing.assert_array_equal(b.valid.numpy(), v)
    np.testing.assert_array_equal(b.depth.numpy(), np.asarray(a.depth))
    np.testing.assert_array_equal(b.bounds.numpy()[v], np.asarray(a.bounds)[v])
    np.testing.assert_allclose(b.normals.numpy()[v], np.asarray(a.normals)[v], rtol=0, atol=1e-6)


def test_prefilter_never_kills_an_inflatable_seed():
    W, H = 160, 120
    jp, tp = _params(W, H)
    img = make_scene(W, H, 8, seed=5)
    x0, y0, md = _seeds(W, H, 40, seed=9)
    xf, yf = x0.astype(np.float32), y0.astype(np.float32)
    keep = trp.prefilter_seeds(tp, torch.from_numpy(img), torch.from_numpy(xf),
                               torch.from_numpy(yf), torch.from_numpy(md),
                               torch.ones(40, dtype=torch.bool)).numpy()
    ref = np.asarray(jrp.prefilter_seeds(jp, jnp.asarray(img), jnp.asarray(xf), jnp.asarray(yf),
                                         jnp.asarray(md), jnp.ones(40, bool)))
    np.testing.assert_array_equal(keep, ref)
    ok, _, _ = trp.inflate_pyramid(tp, torch.from_numpy(img), torch.from_numpy(x0),
                                    torch.from_numpy(y0), torch.from_numpy(md))
    ok = ok.numpy()
    assert not (ok & ~keep).any()


def test_cpu_image_takes_the_plain_version():
    W, H = 80, 60
    _, tp = _params(W, H)
    img = torch.from_numpy(make_scene(W, H, 8, seed=3))
    x0, y0, md = (torch.from_numpy(a) for a in _seeds(W, H, 8, seed=1))
    before = cuda_inflate.inflate_pyramids.launches
    a = cuda_inflate.inflate_pyramids(tp, img, x0, y0, md, 1)
    b = trp.inflate_pyramid(tp, img, x0, y0, md, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cuda_inflate.inflate_pyramids.launches == before
    with pytest.raises(ValueError):
        cuda_inflate.inflate_pyramids(tp, img.double(), x0, y0, md, 1)
