"""The plain versions of the planner's candidate-pass kernels against the JAX package.

`csrc/plan.cu` holds K7 (the pyramid collision check) and K8 (the input and
velocity gates); on the card `tests/test_torch_kernels.py` holds them bit
for bit against their plain versions, `rappids.collision_check_plain`,
`traj.check_input_feasibility` and `traj.check_velocity_feasibility`. Here,
on the CPU, those plain versions meet the JAX package's functions on the
same seeded numpy inputs (the port's candidates and pyramid sets, carried
across as numpy), in the branches the kernels take: candidates that reach
MAX_CHECK_ITERS pops, sections wholly closer than min_check_dist, a
partial `enabled`, zdot quartics and face quartics that fall back to the
cubic, bisections that reach the static_max_tf cut, and degenerate velocity
axes, strict and not. Labels and masks are held equal, fail points within
FAIL_POINT_BOUND (most within 1e-5); the JAX side runs under jit, as its
planner does. On CPU tensors the `cuda_plan` wrappers load no library and return
the plain results, and `plan` still equals the JAX package's plan.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import make_scene
from chip_smoke import near_limit_trajs, random_trajs
from agrifly_tpu.planner import rappids as jrp, traj as jtraj
from agrifly_tpu_torch import convert, cuda_build
from agrifly_tpu_torch.planner import cuda_plan, rappids as trp, traj as ttraj

W, H, N, P = 160, 120, 64, 80
SCALE = 10.0 / 256.0
GRAV = np.array([0.0, 9.81, 0.0], np.float32)
# Fail points (px, py, depth [m]): the two packages' roots differ by ulps
# (XLA's float32 acos and cos against the port's correctly rounded ones),
# and where a section's remainder ends on a pyramid's face, the strict
# pixel-buffer tests can then pick the neighbouring pyramid and so another
# first uncovered section: its deepest point moves by pixels. Every point
# within these bounds, and 90% of the failed candidates' within 1e-5
# relative / 1e-3 absolute.
FAIL_POINT_BOUND = (2.5, 2.5, 0.05)


@functools.lru_cache(maxsize=None)
def _params():
    jp = jrp.make_params(jrp.make_camera(W, H, focal=W / 2.0, depth_scale=SCALE),
                         true_radius=0.116, plan_radius=0.174, min_check_dist=0.5)
    tp = convert.from_numpy(trp.PlannerParams, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def _candidates(seed, v0, depth=(1.5, 3.0), near=0):
    """N port candidates from seeded samples; the first `near` end
    between 0.2 and 0.45 m deep."""
    _, tp = _params()
    rng = np.random.default_rng(seed)
    dep = rng.uniform(*depth, N)
    dep[:near] = rng.uniform(0.2, 0.45, near)
    samples = (rng.uniform(0.1 * W, 0.9 * W, N), rng.uniform(0.1 * H, 0.9 * H, N), dep,
               rng.uniform(2.0, 3.0, N))
    return trp.candidates_from_samples(
        tp, *(torch.from_numpy(np.asarray(s, np.float32)) for s in samples),
        torch.tensor(v0, dtype=torch.float32), torch.zeros(3))


def _padded(pyrs):
    """A set padded to P slots with unused ones (the JAX programs take one shape)."""
    k = P - pyrs.depth.shape[-1]
    pad = trp.empty_pyramid_set(k, "cpu")
    return trp.PyramidSet(*(torch.cat([a, b]) for a, b in zip(pyrs, pad)))


def _strip_set():
    """Narrow full-height pyramids every 2 px, overlapping by 5 px: a
    section that sweeps across the image is covered a few pixels a pop."""
    _, tp = _params()
    left = torch.arange(0.0, W - 7.0, 2.0)
    K = left.numel()
    depth = torch.full((K,), 10.0)
    bounds, normals = trp._pyramid_from_edges(tp.cam, left + 7.0, torch.full((K,), 2.0), left,
                                              torch.full((K,), H - 2.0), depth)
    return _padded(trp.PyramidSet(depth, bounds, normals, torch.ones(K, dtype=torch.bool)))


def _scene_set(tr, seed):
    """Pyramids inflated at the candidates' endpoints on a cluttered scene."""
    _, tp = _params()
    img = torch.from_numpy(make_scene(W, H, 6, seed))
    return _padded(trp.build_pyramid_set(tp, img, *trp.endpoint_seeds(tp, tr),
                                         torch.ones(N, dtype=torch.bool), N))


def _jtree(cls, tree):
    return cls(*(jnp.asarray(x.numpy()) for x in tree))


@functools.lru_cache(maxsize=None)
def _jax_check():
    jp, _ = _params()
    return jax.jit(jax.vmap(lambda pyrs, one, en: jrp.collision_check(jp, pyrs, one, en),
                            in_axes=(None, 0, 0)))


def _case(name):
    if name == "iteration cap":
        tr = _candidates(1, (-1.5, 0.0, 1.5))
        return tr, _strip_set(), torch.ones(N, dtype=torch.bool)
    if name == "under min_check_dist":
        tr = _candidates(2, (0.0, 0.0, 0.3), near=N // 2)
        return tr, _scene_set(tr, 2), torch.ones(N, dtype=torch.bool)
    if name == "partial enabled":
        tr = _candidates(3, (0.0, 0.0, 1.5))
        en = torch.from_numpy(np.random.default_rng(3).uniform(size=N) < 0.5)
        return tr, _scene_set(tr, 3), en
    # the zdot quartic's leading term vanishes in a third of the candidates;
    # every face quartic's too in another third
    tr = _candidates(4, (0.3, -0.2, 1.5))
    alpha = tr.alpha.clone()
    alpha[: N // 3, 2] = 0.0
    alpha[N // 3: 2 * N // 3] = 0.0
    tr = tr._replace(alpha=alpha)
    return tr, _scene_set(tr, 4), torch.ones(N, dtype=torch.bool)


@pytest.mark.parametrize("name", ["iteration cap", "under min_check_dist", "partial enabled",
                                  "cubic fallback"])
def test_collision_check_plain_matches_jax(name):
    _, tp = _params()
    tr, pyrs, en = _case(name)
    got = trp.collision_check_plain(tp, pyrs, tr, en)
    ref = _jax_check()(_jtree(jrp.PyramidSet, pyrs), _jtree(jtraj.Traj, tr), jnp.asarray(en))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    failed = (got[3] > 0).numpy() | (np.asarray(ref[3]) > 0)
    for g, r, bound in zip(got[1:], ref[1:], FAIL_POINT_BOUND):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_allclose(g, r, atol=bound)
        if failed.any():
            assert np.isclose(g, r, rtol=1e-5, atol=1e-3)[failed].mean() >= 0.9
    free, fail_z = got[0], got[3]
    if name == "iteration cap":  # not free, yet no section was uncovered
        assert int((~free & (fail_z == 0)).sum()) > 0
    elif name == "under min_check_dist":  # every section skipped: free
        assert bool(free[: N // 2].any())
    elif name == "partial enabled":  # a disabled candidate is free with no fail point
        assert bool(free[~en].all()) and bool((fail_z[~en] == 0).all())
        assert bool((~free[en]).any()) and bool(free[en].any())
    else:
        assert bool((~free).any()) and bool(free.any())


# the trajectory sets chip_smoke.py and the card tests hold K8 on
_random_traj = functools.lru_cache(maxsize=None)(random_trajs)
_near_limit_traj = functools.lru_cache(maxsize=None)(near_limit_trajs)


@functools.lru_cache(maxsize=None)
def _jax_input(static_max_tf, max_depth):
    jp, _ = _params()
    return jax.jit(lambda tr, grav: jtraj.check_input_feasibility(
        tr, grav, jp.fmin, jp.fmax, jp.wmax, float(jp.min_section_time), max_depth=max_depth,
        static_max_tf=static_max_tf))


@pytest.mark.parametrize("static_max_tf,max_depth", [(3.0, 9), (None, 5)])
def test_input_feasibility_matches_jax_and_reaches_the_cut(static_max_tf, max_depth):
    _, tp = _params()
    a, b = _random_traj(3, 300), _near_limit_traj(3, 200)
    tr = ttraj.Traj(*(torch.cat([x, y]) for x, y in zip(a, b)))
    grav = torch.from_numpy(GRAV)
    got = ttraj.check_input_feasibility(tr, grav, tp.fmin, tp.fmax, tp.wmax, tp.min_section_time,
                                        max_depth=max_depth, static_max_tf=static_max_tf)
    ref = _jax_input(static_max_tf, max_depth)(_jtree(jtraj.Traj, tr), jnp.asarray(GRAV))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # rejected for want of a level: with sections down to 0.01 s, level 8
    # proves them; at tf >= 2.56 s no level-7 section is too narrow, so what
    # rejected them is the last level's split (at 3.0 the static_max_tf cut
    # at level 8, else max_depth)
    deeper = ttraj.check_input_feasibility(tr, grav, tp.fmin, tp.fmax, tp.wmax, 0.01,
                                           max_depth=8)
    assert int((~got & deeper & (tr.tf >= 2.56)).sum()) > 0
    assert 0 < int(got.sum()) < got.numel()


@functools.lru_cache(maxsize=None)
def _jax_velocity(strict):
    jp, _ = _params()
    return jax.jit(lambda tr: jtraj.check_velocity_feasibility(tr, jp.vmax, strict))


@pytest.mark.parametrize("strict", [True, False])
def test_velocity_feasibility_with_degenerate_axes_matches_jax(strict):
    _, tp = _params()
    tr = _random_traj(5, 1000)
    got = ttraj.check_velocity_feasibility(tr, tp.vmax, strict)
    ref = _jax_velocity(strict)(_jtree(jtraj.Traj, tr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    degenerate = (tr.alpha.abs() / 6.0 <= 1e-6).any(-1)
    assert int(degenerate.sum()) > 100 and 0 < int(got.sum()) < got.numel()
    if strict:
        assert not bool(got[degenerate].any())
    else:
        assert bool(got[degenerate].any())


def test_last_level_matches_the_plain_sweep():
    """cuda_plan.last_level, the deepest level K8 evaluates, is where the
    plain sweep stops: its break at the static cut, or max_depth."""
    for max_depth in range(10):
        for static_max_tf in (None, 3.0, 0.5, 0.01, 1e-3):
            for mst in (0.02, 0.019999999552965164, 0.1):
                want = max_depth
                for level in range(max_depth + 1):
                    if static_max_tf is not None and static_max_tf / (1 << level) < mst:
                        want = level - 1
                        break
                assert cuda_plan.last_level(max_depth, static_max_tf, mst) == want
    assert cuda_plan.last_level(9, 3.0, 0.019999999552965164) == 7
    assert cuda_plan.last_level(9, 0.01, 0.02) == -1


def _refuse(*args, **kw):
    raise AssertionError("a CPU tensor reached the kernel library")


def test_cpu_tensors_load_no_library_and_give_the_plain_results(monkeypatch):
    monkeypatch.setattr(cuda_build, "load", _refuse)
    _, tp = _params()
    tr, pyrs, en = _case("partial enabled")
    k7, k8 = cuda_plan.collision_check.launches, cuda_plan.plan_gates.launches
    for enabled in (en, None):
        got = cuda_plan.collision_check(tp, pyrs, tr, enabled)
        ref = trp.collision_check_plain(tp, pyrs, tr, torch.ones_like(en) if enabled is None
                                        else enabled)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(trp.is_collision_free(tp, pyrs, tr), ref[0])
    grav = torch.from_numpy(GRAV)
    for strict in (True, False):
        feas, vel = cuda_plan.plan_gates(tr, grav, tp.fmin, tp.fmax, tp.wmax,
                                         tp.min_section_time, tp.vmax, static_max_tf=3.0,
                                         strict_degenerate=strict)
        assert torch.equal(feas, ttraj.check_input_feasibility(
            tr, grav, tp.fmin, tp.fmax, tp.wmax, tp.min_section_time, static_max_tf=3.0))
        assert torch.equal(vel, ttraj.check_velocity_feasibility(tr, tp.vmax, strict))
    assert (cuda_plan.collision_check.launches, cuda_plan.plan_gates.launches) == (k7, k8)


def test_plan_on_the_cpu_equals_the_jax_plan_debug(monkeypatch):
    """rappids.plan on CPU tensors (no kernel library) against the JAX
    package's plan_debug on the same samples: the gates, the labels, the
    counts and the chosen candidate."""
    monkeypatch.setattr(cuda_build, "load", _refuse)
    jp, tp = _params()
    img = make_scene(W, H, 5, 7)
    rng = np.random.default_rng(7)
    u = rng.uniform(size=(4, 96)).astype(np.float32)
    vel, acc = np.array([0.2, -0.1, 1.5], np.float32), np.array([0.0, 0.3, 0.0], np.float32)
    goal = np.array([0.5, 0.0, 20.0], np.float32)
    t = trp.plan(tp, torch.from_numpy(img), torch.from_numpy(u), *(torch.from_numpy(x) for x in
                 (vel, acc, GRAV, goal)), pyramid_capacity=16, inflation_downsample=2)
    samples = trp.samples_from_uniform(tp, torch.from_numpy(u))
    j = jax.jit(lambda img, s, vel, acc, grav, goal: jrp.plan_debug(
        jp, img, None, vel, acc, grav, goal, pyramid_capacity=16, inflation_downsample=2,
        samples=s))(jnp.asarray(img), tuple(jnp.asarray(x.numpy()) for x in samples),
                    *(jnp.asarray(x) for x in (vel, acc, GRAV, goal)))
    _, cost_j, feas_j, vel_j, gate_j, free_j, pyrs_j = (np.asarray(x) if not isinstance(x, tuple)
                                                        else x for x in j)
    ok = gate_j & free_j
    assert bool(t.found) == bool(ok.any()) and bool(ok.any())
    assert int(t.best_idx) == int(np.argmin(np.where(ok, cost_j, np.inf)))
    assert int(t.num_feasible) == int(feas_j.sum())
    assert int(t.num_velocity_admissible) == int((feas_j & vel_j).sum())
    assert int(t.num_collision_free) == int(ok.sum())
    assert int(t.num_pyramids) == int(np.asarray(pyrs_j.valid).sum())
