"""The port's RAPPIDS evaluation path against the JAX package's.

The ray-sphere oracle, `is_collision_free`, the four self-evaluation
harnesses and the grouped-seed inflation route (`seeds_per_program > 1`),
on the CPU at 160x120: the scene with a post and the lazy-rounds scene of
tests/test_rappids.py and the cluttered scene of tests/test_pallas_inflate.py.
The harnesses take the JAX package's uniform draws `uniform(key, (4, N))`
where it takes the key. The JAX side runs under jit with its static
arguments closed over (its eager harnesses are slow).

Verdicts, counts and chosen candidates are held equal; costs within rtol
1e-5 (find_fastest_trajectory, as tests/test_torch_planner.py holds the
planner's costs) and 1e-6 (the direction cost alone). The grouped inflation
is held to JAX's one-seed kernel, never to its grouped kernel's base depth
on a blocker-free scene (ROADMAP.md Queue 3):
test_grouped_route_keeps_the_base_depth_jax_grouped_overclaims shows why.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gradient_scene, make_scene
from agrifly_tpu.planner import oracle as jor, pallas_inflate as jpi, rappids as jrp
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.planner import cuda_inflate, oracle as tor, rappids as trp
from agrifly_tpu_torch.render import orchard as torch_orch

W, H = 160, 120
SCALE = 10.0 / 256.0
VEL0 = np.array([0.0, 0.0, 1.5], np.float32)
ACC0 = np.zeros(3, np.float32)
GRAV = np.array([0.0, 9.81, 0.0], np.float32)
ZERO3 = np.zeros(3, np.float32)
GOAL = np.array([0.0, 0.0, 20.0], np.float32)
CSRC = Path(__file__).resolve().parents[1] / "agrifly_tpu_torch" / "csrc" / "inflate.cu"


@functools.lru_cache(maxsize=None)
def _params():
    jp = jrp.make_params(jrp.make_camera(W, H, focal=W / 2.0, depth_scale=SCALE),
                         true_radius=0.116, plan_radius=0.174, min_check_dist=0.5)
    tp = convert.from_numpy(trp.PlannerParams, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def _post_scene():
    """tests/test_rappids.py's scene_with_post(): a 2 m post on a 9 m wall."""
    img = np.full((H, W), int(round(9.0 / SCALE)), np.int32)
    img[:, 70:90] = int(round(2.0 / SCALE))
    return img


def _lazy_scene():
    """tests/test_rappids.py's lazy-rounds scene: three posts."""
    img = np.full((H, W), 230, np.int32)
    for x, w, d in [(40, 8, 50), (90, 10, 70), (130, 6, 45)]:
        img[:, x:x + w] = d
    return img


SCENES = {"post": _post_scene, "lazy": _lazy_scene, "clutter": lambda: make_scene(W, H, 8, 3)}


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _injected(seed, n=64):
    """n candidates' (px, py, depth, tf) samples from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1 * W, 0.9 * W, n).astype(np.float32),
            rng.uniform(0.1 * H, 0.9 * H, n).astype(np.float32),
            rng.uniform(1.5, 3.0, n).astype(np.float32),
            rng.uniform(2.0, 3.0, n).astype(np.float32))


def _candidates(samples):
    jp, tp = _params()
    return (jrp.candidates_from_samples(jp, *samples, VEL0, ACC0),
            trp.candidates_from_samples(tp, *_t(*samples), *_t(VEL0, ACC0)))


def _uniform(seed, n):
    """The JAX package's draws for key PRNGKey(seed): u (4, n)."""
    key = jax.random.PRNGKey(seed)
    return key, torch.from_numpy(np.asarray(jax.random.uniform(key, (4, n), jnp.float32)))


@functools.lru_cache(maxsize=None)
def _jax_oracle():
    jp, _ = _params()
    return jax.jit(lambda img, tr: jax.vmap(
        lambda one: jor.is_collision_free_ground_truth(jp, img, one))(tr))


@pytest.mark.parametrize("scene", list(SCENES))
def test_oracle_matches_jax(scene):
    """64 injected candidates: the port's batched, chunked oracle gives
    JAX's vmapped verdicts, some free and some colliding."""
    _, tp = _params()
    img = SCENES[scene]()
    trj, trt = _candidates(_injected(1))
    ref = np.asarray(_jax_oracle()(jnp.asarray(img), trj))
    got = tor.is_collision_free_ground_truth(tp, torch.from_numpy(img), trt).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size


def test_oracle_chunks_and_vehicle_axis(monkeypatch):
    """Chunks of 5 candidates over two images (L = (2,)) give the verdicts
    of one unchunked call per image."""
    _, tp = _params()
    imgs = torch.from_numpy(np.stack([_post_scene(), make_scene(W, H, 8, 3)]))
    samples = [torch.from_numpy(np.stack([a, b]))
               for a, b in zip(_injected(2, 24), _injected(3, 24))]
    tr = trp.candidates_from_samples(tp, *samples, *(torch.from_numpy(np.stack([v, v]))
                                                      for v in (VEL0, ACC0)))
    whole = [tor.is_collision_free_ground_truth(
        tp, imgs[i], trp.traj_mod.Traj(*(x[i] for x in tr))) for i in range(2)]
    monkeypatch.setattr(tor, "CHUNK_BYTES", 5 * tor.MAX_SAMPLES * H * W * 4 * 2)
    chunked = tor.is_collision_free_ground_truth(tp, imgs, tr)
    assert chunked.shape == (2, 24)
    assert torch.equal(chunked, torch.stack(whole))


@functools.lru_cache(maxsize=None)
def _jax_endpoint_check():
    jp, _ = _params()

    def run(img, tr):
        end = jrp.traj_mod.position(tr, tr.tf)
        epx, epy = jrp.project(jp.cam, end)
        pyrs = jrp.build_pyramid_set(jp, img, epx, epy, end[:, 2], jnp.ones(tr.tf.shape, bool),
                                     32, use_pallas=False)
        return pyrs, jax.vmap(lambda one: jrp.is_collision_free(jp, pyrs, one))(tr)

    return jax.jit(run)


@pytest.mark.parametrize("scene", list(SCENES))
def test_is_collision_free_matches_jax(scene):
    """The same endpoint pyramid set (JAX's, carried across): the port's
    batched is_collision_free frees JAX's candidates, and every one it
    frees is free by the oracle."""
    _, tp = _params()
    img = SCENES[scene]()
    trj, trt = _candidates(_injected(4))
    pyrs_j, free_j = _jax_endpoint_check()(jnp.asarray(img), trj)
    pyrs = convert.from_numpy(trp.PyramidSet, jax.tree_util.tree_map(np.asarray, pyrs_j), "cpu")
    free = trp.is_collision_free(tp, pyrs, trt)
    np.testing.assert_array_equal(free.numpy(), np.asarray(free_j))
    oracle = tor.is_collision_free_ground_truth(tp, torch.from_numpy(img), trt)
    assert not bool((free & ~oracle).any())
    assert int(free.sum()) > 0


@functools.lru_cache(maxsize=None)
def _jax_conservativeness():
    jp, _ = _params()
    return jax.jit(lambda img, key: jrp.measure_conservativeness(
        jp, img, key, VEL0, ACC0, GRAV, n_traj=64, pyramid_limit=32))


@pytest.mark.parametrize("scene", list(SCENES))
def test_measure_conservativeness_matches_jax(scene):
    """64 endpoint-seeded candidates: the two counts equal JAX's, and no
    candidate the pyramid check frees collides by the oracle."""
    _, tp = _params()
    img = SCENES[scene]()
    key, u = _uniform(10, 64)
    ref = _jax_conservativeness()(jnp.asarray(img), key)
    img_t = torch.from_numpy(img)
    got = trp.measure_conservativeness(tp, img_t, u, *_t(VEL0, ACC0, GRAV), pyramid_limit=32)
    assert [int(v) for v in got] == [int(v) for v in ref]
    tr = trp.sample_candidates(tp, u, *_t(VEL0, ACC0))
    pyrs = trp.build_pyramid_set(tp, img_t, *trp.endpoint_seeds(tp, tr),
                                 torch.ones(64, dtype=torch.bool), 32)
    free = trp.is_collision_free(tp, pyrs, tr)
    assert not bool((free & ~tor.is_collision_free_ground_truth(tp, img_t, tr)).any())


def test_harnesses_take_a_vehicle_axis():
    """measure_conservativeness over two images at once (L = (2,)) equals
    one call per image."""
    _, tp = _params()
    imgs = torch.from_numpy(np.stack([_lazy_scene(), make_scene(W, H, 8, 3)]))
    u = torch.stack([_uniform(s, 16)[1] for s in (20, 21)])
    vec = [torch.from_numpy(np.stack([v, v])) for v in (VEL0, ACC0, GRAV)]
    both = trp.measure_conservativeness(tp, imgs, u, *vec, pyramid_limit=8)
    for i in range(2):
        one = trp.measure_conservativeness(tp, imgs[i], u[i], *(v[i] for v in vec),
                                           pyramid_limit=8)
        assert [int(b[i]) for b in both] == [int(v) for v in one]


@functools.lru_cache(maxsize=None)
def _jax_plan_conservativeness(lazy_rounds):
    jp, _ = _params()
    return jax.jit(lambda img, key: jrp.measure_plan_conservativeness(
        jp, img, key, ZERO3, ZERO3, GRAV, GOAL, n_candidates=128, pyramid_capacity=16,
        rounds=2, lazy_rounds=lazy_rounds))


@pytest.mark.parametrize("lazy_rounds", [0, 1])
def test_measure_plan_conservativeness_matches_jax(lazy_rounds):
    """The lazy-rounds scene, 128 candidates, capacity 16 in 2 seeded
    rounds (+ lazy_rounds): the three counts equal JAX's."""
    _, tp = _params()
    img = _lazy_scene()
    key, u = _uniform(0, 128)
    ref = _jax_plan_conservativeness(lazy_rounds)(jnp.asarray(img), key)
    got = trp.measure_plan_conservativeness(
        tp, torch.from_numpy(img), u, *_t(ZERO3, ZERO3, GRAV, GOAL), pyramid_capacity=16,
        rounds=2, lazy_rounds=lazy_rounds)
    assert [int(v) for v in got] == [int(v) for v in ref]
    assert int(got[2]) > 0


def test_exploration_direction_cost_matches_jax():
    trj, trt = _candidates(_injected(5))
    direction = np.array([0.3, -0.2, 1.0], np.float32)
    ref = np.asarray(jrp.exploration_direction_cost(trj, direction))
    got = trp.exploration_direction_cost(trt, torch.from_numpy(direction)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_find_fastest_trajectory_matches_jax():
    """128 candidates on the cluttered scene, direction (0, 0, 1): the same
    candidate found, its cost within rtol 1e-5."""
    jp, tp = _params()
    img = make_scene(W, H, 8, 3)
    key, u = _uniform(3, 128)
    direction = np.array([0.0, 0.0, 1.0], np.float32)
    ref = jax.jit(lambda im, k: jrp.find_fastest_trajectory(
        jp, im, k, VEL0, ACC0, GRAV, direction, n_candidates=128))(jnp.asarray(img), key)
    got = trp.find_fastest_trajectory(tp, torch.from_numpy(img), u, *_t(VEL0, ACC0, GRAV),
                                      torch.from_numpy(direction))
    assert bool(got.found) == bool(ref.found) and bool(got.found)
    assert int(got.best_idx) == int(ref.best_idx)
    np.testing.assert_allclose(float(got.best_cost), float(ref.best_cost), rtol=1e-5)


def test_measure_collision_checking_speed_matches_jax():
    jp, tp = _params()
    img = make_scene(W, H, 8, 3)
    key, u = _uniform(7, 64)
    _, _, used_j = jrp.measure_collision_checking_speed(jp, jnp.asarray(img), key, VEL0, ACC0,
                                                        GRAV, n_traj=64)
    seconds, per_traj, used = trp.measure_collision_checking_speed(
        tp, torch.from_numpy(img), u, *_t(VEL0, ACC0, GRAV))
    assert used == used_j and used > 0
    assert seconds > 0 and per_traj == seconds / 64


def test_seed_rows_pad_to_groups_and_slice_back():
    """Ragged P: the pad rows are copies of row 0 with the ok flag cleared,
    and the launch's rows come back sliced to the P seeds; leading shapes
    are kept."""
    rows = torch.arange(2 * 13 * 12, dtype=torch.int32).reshape(2, 13, 12)
    rows[..., 7] = 1
    padded = cuda_inflate.pad_seed_rows(rows, 4)
    assert padded.shape == (2, 16, 12) and padded.is_contiguous()
    assert torch.equal(padded[:, :13], rows)
    pad = rows[:, :1].expand(2, 3, 12).clone()
    pad[..., 7] = 0
    assert torch.equal(padded[:, 13:], pad)
    assert torch.equal(cuda_inflate.pad_seed_rows(rows[:, :12], 4), rows[:, :12])
    seen = []

    def launch(p):
        seen.append(p.shape)
        return p[..., :8] * 2

    out = cuda_inflate.grouped_rows(rows, 4, launch)
    assert seen == [(2, 16, 12)]
    assert torch.equal(out, rows[..., :8] * 2)


@pytest.mark.parametrize("P,S,shrink_extra", [(24, 2, 0), (13, 4, 1), (5, 2, 1)])
def test_grouped_route_matches_jax_on_clutter(P, S, shrink_extra):
    """inflate_pyramids(seeds_per_program=S) (on the CPU, the plain version)
    against JAX's grouped Pallas kernel in interpret mode on the cluttered
    scene (the seeds of tests/test_pallas_inflate.py::test_grouped_kernel_parity):
    ok everywhere, maxd and edges wherever ok."""
    jp, tp = _params()
    img = make_scene(W, H, 8, 3)
    x0 = jax.random.randint(jax.random.PRNGKey(P), (P,), 2, W - 2)
    y0 = jax.random.randint(jax.random.PRNGKey(P + 1), (P,), 2, H - 2)
    md = jax.random.uniform(jax.random.PRNGKey(P + 2), (P,), jnp.float32, 1.5, 3.0)
    seeds = _t(np.asarray(x0, np.float32), np.asarray(y0, np.float32), md)
    ok_j, maxd_j, e_j = (np.asarray(a) for a in jpi.inflate_pyramids(
        jp, jnp.asarray(img), x0, y0, md, shrink_extra, interpret=True, seeds_per_program=S))
    ok, maxd, e = (t.numpy() for t in cuda_inflate.inflate_pyramids(
        tp, torch.from_numpy(img), *seeds, shrink_extra, seeds_per_program=S))
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(maxd[ok], maxd_j[ok])
    np.testing.assert_array_equal(e[ok], e_j[ok])
    assert ok.sum() >= 1


def test_grouped_route_keeps_the_base_depth_jax_grouped_overclaims():
    """On a blocker-free gradient scene the port's grouped route (on the
    CPU, the plain version; on the card K2g, whose pass B never skips)
    equals JAX's one-seed kernel, while JAX's grouped kernel (S = 2)
    skips pass B and reports maxd 65535 for every seed: a base depth far
    behind the scene, which would free candidates that collide."""
    jp, tp = _params()
    img = gradient_scene(W, H)
    rng = np.random.default_rng(0)
    x0 = rng.integers(30, W - 30, 4).astype(np.int32)
    y0 = rng.integers(30, H - 30, 4).astype(np.int32)
    md = rng.uniform(1.5, 3.0, 4).astype(np.float32)
    one, two = ([np.asarray(a) for a in jpi.inflate_pyramids(
        jp, jnp.asarray(img), jnp.asarray(x0), jnp.asarray(y0), jnp.asarray(md), 0,
        interpret=True, seeds_per_program=S)] for S in (1, 2))
    ok, maxd, e = (t.numpy() for t in cuda_inflate.inflate_pyramids(
        tp, torch.from_numpy(img), *_t(x0.astype(np.float32), y0.astype(np.float32), md),
        seeds_per_program=2))
    assert one[0].all()
    np.testing.assert_array_equal(ok, one[0])
    np.testing.assert_array_equal(maxd, one[1])
    np.testing.assert_array_equal(e, one[2])
    assert (maxd < 65535).all()
    assert (two[1] == 65535).all()  # the reference's fault (ADVICE.md, high)


@pytest.mark.parametrize("S", [0, 9, 2.5, True])
def test_seeds_per_program_is_checked(S):
    """S is an int from 1 to the largest compiled K2g instance, the
    kMaxGroup of csrc/inflate.cu; other values raise, on any device."""
    assert re.search(rf"kMaxGroup = {cuda_inflate.MAX_SEEDS_PER_PROGRAM};", CSRC.read_text())
    _, tp = _params()
    img = torch.from_numpy(make_scene(W, H, 8, 3))
    seeds = _t(np.array([80.0], np.float32), np.array([60.0], np.float32),
               np.array([2.0], np.float32))
    match = "largest compiled grouped kernel, 8" if S == 9 else "int >= 1"
    with pytest.raises(ValueError, match=match):
        cuda_inflate.inflate_pyramids(tp, img, *seeds, seeds_per_program=S)


def test_camera_and_orchard_default_to_the_card(monkeypatch):
    """make_camera and orchard.make_params build on the card by default and
    raise where there is none; device='cpu' builds on the CPU."""
    assert trp.make_camera(device="cpu").focal.device.type == "cpu"
    assert torch_orch.make_params(device="cpu").seed.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trp.make_camera()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_orch.make_params()
