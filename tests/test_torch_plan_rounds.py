"""The planner's rounds as plain functions, one per kernel launch.

`rappids.round_seeds_plain` -> inflation -> `pyramid_set_plain` per
pre-planned round, then `lazy_seeds_plain` -> inflation ->
`pyramid_set_plain`, chained, equal the rounds as `_plan_core` ran them
before they were split (written out below from the functions that stay:
`inflate_pyramid`, `merge_pyramid_sets`, `find_containing_pyramid`,
`prefilter_seeds`, `_greedy_seed_dedupe`), bit for bit, invalid slots
included: on orchard views and clutter, with tied costs (-0.0, NaN and
+inf among them), no gated candidate, a set that fills, and fail points on
and beyond the image's edges. (The chain against the JAX package's
plan_debug under jit is test_torch_planner.py's
`test_round_chain_matches_jax_plan_debug`, which shares that file's
compiled program.) A numpy replica of the kernels' counting rank equals torch.argsort(stable=
True). On CPU tensors the kernels' wrappers run the plain versions.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrifly_tpu.render import orchard as jorch, raycast as jray
from agrifly_tpu_torch.planner import cuda_inflate, cuda_plan, cuda_rounds, rappids as trp
from test_torch_planner import CAP, H, N, W, _motion, _params, _samples, _scene

LAZY = 1
ROUNDS = 2


def _take(x, idx, vec_dims=0):
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * vec_dims), dim=-1 - vec_dims)


def _build_reference(params, img_u16, px, py, z, valid, capacity, k):
    """build_pyramid_set as it was: inflate_pyramid on the (pooled) image,
    then the base depth, bounds, normals and the `capacity` shallowest."""
    img = img_u16.to(torch.int32)
    work = params
    if k > 1:
        img, cam_small = trp._pooled(params, img, k)
        work = params._replace(cam=cam_small)
        px, py = px / k, py / k
    ok, maxd, edges = trp.inflate_pyramid(work, img, px, py, z, 1 if k > 1 else 0)
    base_depth = maxd.to(torch.float32) * params.cam.depth_scale - params.plan_radius
    e = edges.to(torch.float32)
    bounds, normals = trp._pyramid_from_edges(work.cam, e[..., 0], e[..., 1], e[..., 2],
                                              e[..., 3], base_depth)
    if k > 1:
        bounds = bounds * k
    ok = ok & valid
    depth = torch.where(ok, base_depth, math.inf)
    take = torch.argsort(depth, dim=-1, stable=True)[..., :capacity]
    return trp.PyramidSet(_take(depth, take), _take(bounds, take, 1), _take(normals, take, 2),
                          _take(ok, take))


def _lazy_reference(params, img_u16, gate, free, fpx, fpy, fz, cost, pyrs, pr, k):
    """_plan_core's lazy round as it was: (new set, failed)."""
    scale = params.cam.depth_scale
    img_i = img_u16.to(torch.int32)
    ignore_i = (params.true_radius / scale).to(torch.int32)
    failed = gate & ~free & (fz > 0)
    pxi = torch.clamp(fpx.to(torch.int32), 0, params.cam.width - 1)
    pyi = torch.clamp(fpy.to(torch.int32), 0, params.cam.height - 1)
    seed_code = _take(img_i.flatten(-2), pyi.long() * params.cam.width + pxi.long())
    minpyr_i = ((fz + scale + params.plan_radius) / scale).to(torch.int32)
    seedable = failed & ((seed_code <= ignore_i) | (seed_code >= minpyr_i))
    order2 = torch.argsort(torch.where(seedable, cost, math.inf), dim=-1, stable=True)
    take = order2[..., :4 * pr]
    px_t, py_t, z_t = _take(fpx, take), _take(fpy, take), _take(fz, take)
    covered, _ = trp.find_containing_pyramid(pyrs, px_t, py_t, z_t)
    seed_valid = _take(seedable, take) & ~covered
    seed_depth = z_t + scale
    seed_valid = trp.prefilter_seeds(params, img_u16, px_t, py_t, seed_depth, seed_valid,
                                     downsample=k)
    keep = trp._greedy_seed_dedupe(px_t, py_t, z_t, seed_valid, float(trp.LAZY_DEDUPE_PX),
                                   trp.LAZY_DEDUPE_Z_QUANTA * scale)
    sel = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[..., :2 * pr]
    new = _build_reference(params, img_u16, _take(px_t, sel), _take(py_t, sel),
                           _take(seed_depth, sel), _take(keep, sel), pr, k)
    return trp.merge_pyramid_sets(pyrs, new), failed


def _rounds_reference(params, img, tr, cost, gate, epx, epy, endz, k):
    """The pre-planned rounds, the first check and the lazy round as
    _plan_core ran them: (set, first-check outputs, lazy set, failed)."""
    order = torch.argsort(torch.where(gate, cost, math.inf), dim=-1, stable=True)
    pr = CAP // (ROUNDS + LAZY)
    pyrs = trp.empty_pyramid_set(CAP, img.device, gate.shape[:-1])
    for rnd in range(ROUNDS):
        take = order[..., rnd * pr:(rnd + 1) * pr]
        valid = _take(gate, take)
        px_t, py_t, z_t = _take(epx, take), _take(epy, take), _take(endz, take)
        if rnd > 0:
            f, _ = trp.find_containing_pyramid(pyrs, px_t, py_t, z_t)
            valid = valid & ~f
        new = _build_reference(params, img, px_t, py_t, z_t, valid, pr, k)
        base = pyrs if rnd > 0 else trp.empty_pyramid_set(CAP - pr, img.device, gate.shape[:-1])
        pyrs = trp.merge_pyramid_sets(base, new)
    check = trp.collision_check_plain(params, pyrs, tr, torch.ones_like(gate))
    lazy, failed = _lazy_reference(params, img, gate, *check, cost, pyrs, pr, k)
    return pyrs, check, lazy, failed


def _rounds_chain(params, img, tr, cost, gate, epx, epy, endz, k):
    """The same through the three plain round functions (the kernels'
    contracts) and inflation from seed rows."""
    work = trp.work_image(params, img, k)
    pr = CAP // (ROUNDS + LAZY)
    pyrs = None
    for rnd in range(ROUNDS):
        rows, valid = trp.round_seeds_plain(work, gate, cost, epx, epy, endz, pyrs, rnd, pr)
        out = cuda_inflate.inflate_rows(work.params, work.img, rows)
        pyrs = trp.pyramid_set_plain(params, work, out, valid, pr,
                                     CAP - pr if pyrs is None else pyrs)
    check = trp.collision_check_plain(params, pyrs, tr, torch.ones_like(gate))
    rows, valid, failed = trp.lazy_seeds_plain(params, work, img.to(torch.int32), gate, *check,
                                               cost, pyrs, pr)
    out = cuda_inflate.inflate_rows(work.params, work.img, rows)
    return pyrs, check, trp.pyramid_set_plain(params, work, out, valid, pr, pyrs), failed


@functools.lru_cache(maxsize=None)
def _render():
    cam = jray.camera_attitude(jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32))
    return jax.jit(lambda pos: jray.render_depth(jray.make_config(W, H), jorch.make_params(),
                                                 pos, cam))


def _image(kind, seed):
    """test_torch_planner's views, its orchard frames rendered by one jitted
    program."""
    if kind != "orchard":
        return torch.from_numpy(_scene(kind, seed))
    rng = np.random.default_rng(seed)
    pos = jnp.asarray([rng.uniform(2, 20), rng.uniform(-3, 3), 2.0], jnp.float32)
    return torch.from_numpy(np.array(_render()(pos)))


def _case(kind, seed, B=1):
    """Images (*L, H, W) and candidates for B views (L = () for one)."""
    _, tp = _params()
    imgs, cands = [], []
    for b in range(B):
        img = _image(kind, seed + b)
        vel, acc, _, goal = (torch.from_numpy(x) for x in _motion(seed + b))
        samples = tuple(torch.from_numpy(x) for x in _samples(seed + b))
        imgs.append(img)
        cands.append(trp.candidate_pass(tp, samples, vel, acc, goal))
    grav = torch.tensor([0.0, 9.81, 0.0])
    if B == 1:
        img, cand = imgs[0], cands[0]
    else:
        img = torch.stack(imgs)
        cand = trp.Candidates(*(
            type(parts[0])(*(torch.stack(f) for f in zip(*parts))) if isinstance(parts[0], tuple)
            else torch.stack(parts) for parts in zip(*cands)))
        grav = grav.expand(B, 3)
    feas, vel_ok = cuda_plan.plan_gates(cand.tr, grav[..., None, :], tp.fmin, tp.fmax, tp.wmax,
                                        tp.min_section_time, tp.vmax, static_max_tf=3.0)
    return tp, img, cand, feas & vel_ok


def _ties(cost):
    n = torch.arange(cost.shape[-1])
    q = torch.round(cost * 4.0) / 4.0
    q = torch.where(n % 17 == 3, -0.0, q)
    q = torch.where(n % 29 == 5, float("nan"), q)
    return torch.where(n % 31 == 7, float("inf"), q)


def _assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _assert_same(x, y)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y)


@pytest.mark.parametrize("kind,seed,B,k,variant", [
    ("orchard", 0, 1, 2, "as drawn"), ("orchard", 1, 1, 1, "as drawn"),
    ("clutter", 2, 1, 2, "as drawn"), ("orchard", 3, 3, 2, "as drawn"),
    ("orchard", 0, 1, 2, "tied costs"), ("clutter", 2, 3, 1, "tied costs"),
    ("orchard", 0, 1, 2, "no gated candidate"), ("clutter", 4, 1, 2, "every candidate gated"),
])
def test_round_chain_equals_the_plan_core_rounds(kind, seed, B, k, variant):
    """Every set, the first check's outputs, the lazy round's set and its
    failed mask, bit for bit."""
    tp, img, cand, gate = _case(kind, seed, B)
    cost = _ties(cand.cost) if variant == "tied costs" else cand.cost
    if variant == "no gated candidate":
        gate = torch.zeros_like(gate)
    elif variant == "every candidate gated":
        gate = torch.ones_like(gate)
    args = (tp, img, cand.tr, cost, gate, cand.epx, cand.epy, cand.endz, k)
    ref, got = _rounds_reference(*args), _rounds_chain(*args)
    _assert_same(got, ref)
    if variant == "as drawn":
        assert int(ref[2].valid.sum()) > 0


@pytest.mark.parametrize("full", [False, True])
def test_lazy_seeds_on_the_image_edges(full):
    """Fail points on the image's edges and beyond them, every candidate
    failed, against an empty set and a full one."""
    tp, img, cand, gate = _case("clutter", 5)
    n = torch.arange(N, dtype=torch.float32)
    fpx = torch.where(n % 4 == 0, 0.0, torch.where(n % 4 == 1, W - 1.0, n % W + 0.5))
    fpy = torch.where(n % 3 == 0, -3.0, torch.where(n % 3 == 1, H + 2.0, n % H + 0.25))
    fz = 0.5 + (n % 7) * 0.4
    pr = CAP // (ROUNDS + LAZY)
    pyrs = trp.empty_pyramid_set(CAP - pr, "cpu")
    if full:
        pyrs = trp.PyramidSet(torch.linspace(0.1, 0.5, CAP - pr),
                              torch.tensor([150.0, 5.0, 10.0, 115.0]).expand(CAP - pr, 4),
                              torch.full((CAP - pr, 4, 3), 0.5),
                              torch.ones(CAP - pr, dtype=torch.bool))
    ones, none = torch.ones(N, dtype=torch.bool), torch.zeros(N, dtype=torch.bool)
    ref = _lazy_reference(tp, img, ones, none, fpx, fpy, fz, cand.cost, pyrs, pr, 2)
    work = trp.work_image(tp, img, 2)
    rows, valid, failed = trp.lazy_seeds_plain(tp, work, img.to(torch.int32), ones, none, fpx,
                                               fpy, fz, cand.cost, pyrs, pr)
    out = cuda_inflate.inflate_rows(work.params, work.img, rows)
    _assert_same((trp.pyramid_set_plain(tp, work, out, valid, pr, pyrs), failed), ref)


def test_plan_debug_runs_the_chain():
    """plan_debug (the frame's plan) equals the chain's labels and set."""
    tp, img, cand, gate = _case("orchard", 0)
    vel, acc, grav, goal = (torch.from_numpy(x) for x in _motion(0))
    samples = tuple(torch.from_numpy(x) for x in _samples(0))
    _, cost, _, _, gate_d, free, pyrs = trp.plan_debug(tp, img, samples, vel, acc, grav, goal,
                                                       pyramid_capacity=CAP,
                                                       inflation_downsample=2)
    ref_set, check, lazy, failed = _rounds_reference(tp, img, cand.tr, cand.cost, gate,
                                                     cand.epx, cand.epy, cand.endz, 2)
    refree = trp.collision_check_plain(tp, lazy, cand.tr, failed)[0]
    _assert_same((gate_d, pyrs, free), (gate, lazy, torch.where(failed, refree, check[0])))


def counting_rank(keys):
    """The kernels' stable rank by counting (csrc/rounds.cu stable_rank),
    in numpy: rank i = #{j: k_j < k_i} + #{j < i: k_j = k_i}, NaN after
    +inf and equal to itself, -0.0 equal to +0.0."""
    k = np.asarray(keys, np.float32)
    nan = np.isnan(k)
    lt = (k[:, None] < k[None, :]) | (~nan[:, None] & nan[None, :])  # lt[j, i]: k_j < k_i
    eq = (k[:, None] == k[None, :]) | (nan[:, None] & nan[None, :])
    earlier = np.arange(len(k))[:, None] < np.arange(len(k))[None, :]
    return (lt | (eq & earlier)).sum(axis=0)


@pytest.mark.parametrize("case", ["ties", "inf", "nan", "negative zero", "mixed"])
def test_counting_rank_is_the_stable_argsort(case):
    rng = np.random.default_rng(7)
    k = np.round(rng.standard_normal(257) * 3).astype(np.float32)
    if case in ("inf", "mixed"):
        k[rng.integers(0, 257, 40)] = np.inf
        k[rng.integers(0, 257, 5)] = -np.inf
    if case in ("nan", "mixed"):
        k[rng.integers(0, 257, 30)] = np.nan
    if case in ("negative zero", "mixed"):
        k[rng.integers(0, 257, 30)] = -0.0
        k[rng.integers(0, 257, 30)] = 0.0
    order = torch.argsort(torch.from_numpy(k), stable=True).numpy()
    rank = counting_rank(k)
    assert sorted(rank.tolist()) == list(range(len(k)))
    np.testing.assert_array_equal(np.argsort(rank), order)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors cuda_rounds' wrappers return the plain versions'
    results and launch nothing."""
    tp, img, cand, gate = _case("orchard", 0)
    before = (cuda_rounds.round_seeds.launches, cuda_rounds.pyramid_set.launches,
              cuda_rounds.lazy_seeds.launches)
    work = trp.work_image(tp, img, 2)
    args = (work, gate, cand.cost, cand.epx, cand.epy, cand.endz, None, 0, 5)
    _assert_same(cuda_rounds.round_seeds(*args), trp.round_seeds_plain(*args))
    rows, valid = trp.round_seeds_plain(*args)
    out = cuda_inflate.inflate_rows(work.params, work.img, rows)
    pyrs = cuda_rounds.pyramid_set(tp, work, out, valid, 5, 11)
    _assert_same(pyrs, trp.pyramid_set_plain(tp, work, out, valid, 5, 11))
    check = trp.collision_check_plain(tp, pyrs, cand.tr, torch.ones_like(gate))
    args = (tp, work, img.to(torch.int32), gate, *check, cand.cost, pyrs, 5)
    _assert_same(cuda_rounds.lazy_seeds(*args), trp.lazy_seeds_plain(*args))
    assert before == (cuda_rounds.round_seeds.launches, cuda_rounds.pyramid_set.launches,
                      cuda_rounds.lazy_seeds.launches)
