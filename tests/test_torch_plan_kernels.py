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
cubic, candidates with five monotone sections that spend the budget in an
early section or are uncovered in a late one, bisections that reach the
static_max_tf cut, and degenerate velocity axes, strict and not. Labels
and masks are held equal, fail points within FAIL_POINT_BOUND (most within
1e-5); the JAX side runs under jit, as its planner does. K7 runs the
sections' chains side by side and replays them in order: its plain-torch
model (`chip_smoke.section_chains`, `replay`) equals
`collision_check_plain` bit for bit, pops included, and the plain pops and
bisection sections are the counts the kernels write. On CPU tensors the
`cuda_plan` wrappers load no library and return the plain results, and
`plan` still equals the JAX package's plan.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import make_scene
from chip_smoke import (chain_patterns, near_limit_trajs, random_trajs, replay, section_chains,
                        wavy_trajs)
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
    if name in ("budget spent early", "uncovered late"):  # five sections against the strips
        tr = wavy_trajs(0 if name == "budget spent early" else 3, N)
        return tr, _strip_set(), torch.ones(N, dtype=torch.bool)
    # the zdot quartic's leading term vanishes in a third of the candidates;
    # every face quartic's too in another third
    tr = _candidates(4, (0.3, -0.2, 1.5))
    alpha = tr.alpha.clone()
    alpha[: N // 3, 2] = 0.0
    alpha[N // 3: 2 * N // 3] = 0.0
    tr = tr._replace(alpha=alpha)
    return tr, _scene_set(tr, 4), torch.ones(N, dtype=torch.bool)


CASES = ["iteration cap", "under min_check_dist", "partial enabled", "cubic fallback",
         "budget spent early", "uncovered late"]


# The wavy cases' chains run up to the budget of MAX_CHECK_ITERS pops, and
# there the two packages may part: a face root an ulp apart moves where a
# remainder ends on a 2 px strip, a chain then takes a pop or a few more or
# fewer (seen: 22 pops in the port where JAX needs more than 24), and the
# budget ends the loop on another section. Held there: with the budget out
# of the way (BIG_BUDGET) every label is equal; at the real budget a label
# or fail point parts only where the budget decides it in one of the
# packages (it changes between the two budgets), on at most BUDGET_PARTS
# candidates; and the fail points of half the failed candidates, not 90%,
# lie within 1e-5 (seen: 68% and 79%; ulps compound over chains of up to
# 24 pops).
BIG_BUDGET, BUDGET_PARTS = 64, 4
WAVY = ("budget spent early", "uncovered late")


@functools.lru_cache(maxsize=None)
def _jax_check_big():
    jp, _ = _params()
    return jax.jit(jax.vmap(lambda pyrs, one, en: jrp.collision_check(jp, pyrs, one, en),
                            in_axes=(None, 0, 0)))


def _at_big_budget(monkeypatch, tp, pyrs, tr, en):
    """Both packages' (free, fail_px, fail_py, fail_depth) as numpy, with
    MAX_CHECK_ITERS at BIG_BUDGET."""
    with monkeypatch.context() as m:
        m.setattr(jrp, "MAX_CHECK_ITERS", BIG_BUDGET)
        m.setattr(trp, "MAX_CHECK_ITERS", BIG_BUDGET)
        ref = _jax_check_big()(_jtree(jrp.PyramidSet, pyrs), _jtree(jtraj.Traj, tr),
                               jnp.asarray(en))
        pops = torch.zeros(N, dtype=torch.int32)
        got = trp.collision_check_plain(tp, pyrs, tr, en, pops)
    assert int(pops.max()) < BIG_BUDGET
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


def _parts(a, b):
    """Candidates whose labels differ or whose fail points lie beyond FAIL_POINT_BOUND."""
    far = [np.abs(x - y) > bound for x, y, bound in zip(a[1:], b[1:], FAIL_POINT_BOUND)]
    return (a[0] != b[0]) | far[0] | far[1] | far[2]


@pytest.mark.parametrize("name", CASES)
def test_collision_check_plain_matches_jax(name, monkeypatch):
    _, tp = _params()
    tr, pyrs, en = _case(name)
    got = trp.collision_check_plain(tp, pyrs, tr, en)
    ref = _jax_check()(_jtree(jrp.PyramidSet, pyrs), _jtree(jtraj.Traj, tr), jnp.asarray(en))
    share = 0.9
    if name in WAVY:
        big_port, big_jax = _at_big_budget(monkeypatch, tp, pyrs, tr, en)
        np.testing.assert_array_equal(big_port[0], big_jax[0])
        port, jax_ = [g.numpy() for g in got], [np.asarray(r) for r in ref]
        parts = _parts(port, jax_)
        decided = _parts(port, big_port) | _parts(jax_, big_jax)
        assert not (parts & ~decided).any() and int(parts.sum()) <= BUDGET_PARTS
        # the parted candidates are accounted for: the checks below hold the rest
        got = tuple(torch.from_numpy(np.where(parts, r, g)) for g, r in zip(port, jax_))
        share = 0.5
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    failed = (got[3] > 0).numpy() | (np.asarray(ref[3]) > 0)
    for g, r, bound in zip(got[1:], ref[1:], FAIL_POINT_BOUND):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_allclose(g, r, atol=bound)
        if failed.any():
            assert np.isclose(g, r, rtol=1e-5, atol=1e-3)[failed].mean() >= share
    free, fail_z = got[0], got[3]
    if name == "iteration cap":  # not free, yet no section was uncovered
        assert int((~free & (fail_z == 0)).sum()) > 0
    elif name == "under min_check_dist":  # every section skipped: free
        assert bool(free[: N // 2].any())
    elif name == "partial enabled":  # a disabled candidate is free with no fail point
        assert bool(free[~en].all()) and bool((fail_z[~en] == 0).all())
        assert bool((~free[en]).any()) and bool(free[en].any())
    elif name in ("budget spent early", "uncovered late"):
        assert chain_patterns(section_chains(tp, pyrs, tr, en))[name] > 0
    else:
        assert bool((~free).any()) and bool(free.any())


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_section_replay_matches_the_plain_check(name, cut):
    """K7's decomposition: every monotone section's chain alone (up to
    MAX_CHECK_ITERS pops, or cut where the pops of it and the sections
    before it reach the budget, as the kernel's chains are), then the replay
    in section order, bit for bit collision_check_plain, pops included."""
    _, tp = _params()
    tr, pyrs, en = _case(name)
    pops = torch.zeros(N, dtype=torch.int32)
    ref = trp.collision_check_plain(tp, pyrs, tr, en, pops)
    got = replay(section_chains(tp, pyrs, tr, en, cut=cut))
    for g, r, what in zip(got, ref + (pops,), ("free", "fail_px", "fail_py", "fail_depth",
                                               "pops")):
        assert torch.equal(g, r), what
    if name == "iteration cap":
        assert int(pops.max()) == 24


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


def _depth_first(tr, grav, tp, static_max_tf, max_depth):
    """check_input_feasibility's verdict and evaluated sections for each
    candidate, walked depth first one section at a time."""
    last = cuda_plan.last_level(max_depth, static_max_tf, tp.min_section_time)
    out = []
    for i in range(tr.tf.shape[0]):
        one = ttraj.Traj(*(x[i:i + 1, None] for x in tr))
        level, idx, sections, ok = 0, 0, 0, last >= 0
        while ok:
            n = 1 << level
            if bool(one.tf / n < tp.min_section_time):
                ok = False
                break
            t1, t2 = one.tf * (idx / n), one.tf * ((idx + 1.0) / n)
            _, hard, split = ttraj._section_verdict(one, grav, t1, t2, tp.fmin, tp.fmax, tp.wmax)
            sections += 1
            if bool(hard) or (bool(split) and level == last):
                ok = False
            elif bool(split):
                level, idx = level + 1, 2 * idx
            else:
                while level > 0 and idx & 1:
                    level, idx = level - 1, idx >> 1
                if level == 0:
                    break
                idx += 1
        out.append((ok, sections))
    return out


@pytest.mark.parametrize("static_max_tf,max_depth", [(3.0, 9), (None, 5), (0.01, 9)])
def test_input_sections_count_the_depth_first_walk(static_max_tf, max_depth):
    """check_input_feasibility's `sections` (the count K8 writes, from the
    level sweep's record) against a walk of the dyadic sections depth first,
    one verdict at a time, that stops at the first section that rejects."""
    _, tp = _params()
    a, b = _random_traj(3, 300), _near_limit_traj(3, 200)
    tr = ttraj.Traj(*(torch.cat([x[:24], y[:24]]) for x, y in zip(a, b)))
    grav = torch.from_numpy(GRAV)
    sections = torch.zeros(tr.tf.shape, dtype=torch.int32)
    got = ttraj.check_input_feasibility(tr, grav, tp.fmin, tp.fmax, tp.wmax, tp.min_section_time,
                                        max_depth=max_depth, static_max_tf=static_max_tf,
                                        sections=sections)
    want = _depth_first(tr, grav, tp, static_max_tf, max_depth)
    assert got.tolist() == [ok for ok, _ in want]
    assert sections.tolist() == [n for _, n in want]
    if static_max_tf == 0.01:
        assert int(sections.sum()) == 0
    else:
        assert int(sections.max()) > 8


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
        pops, ref_pops = (torch.zeros(N, dtype=torch.int32) for _ in range(2))
        got = cuda_plan.collision_check(tp, pyrs, tr, enabled, pops=pops)
        ref = trp.collision_check_plain(tp, pyrs, tr, torch.ones_like(en) if enabled is None
                                        else enabled, ref_pops)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert torch.equal(pops, ref_pops) and int(pops.sum()) > 0
    assert torch.equal(trp.is_collision_free(tp, pyrs, tr), ref[0])
    grav = torch.from_numpy(GRAV)
    for strict in (True, False):
        sections, ref_sections = (torch.zeros(N, dtype=torch.int32) for _ in range(2))
        feas, vel = cuda_plan.plan_gates(tr, grav, tp.fmin, tp.fmax, tp.wmax,
                                         tp.min_section_time, tp.vmax, static_max_tf=3.0,
                                         strict_degenerate=strict, sections=sections)
        assert torch.equal(feas, ttraj.check_input_feasibility(
            tr, grav, tp.fmin, tp.fmax, tp.wmax, tp.min_section_time, static_max_tf=3.0,
            sections=ref_sections))
        assert torch.equal(sections, ref_sections) and int(sections.sum()) >= N
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
