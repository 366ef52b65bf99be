"""The orchard frame's percept head (`orchard_env.percept_head_plain`, the
plain version of K9) against the JAX package's `_frame_percept`.

The JAX side is `_frame_percept` itself (use_pallas=False), jitted, with
its render and its plan stood in for, while it is traced, by recorders:
the render records the camera attitude it is handed; the plan records its
camera-frame inputs, draws the uniform block from the key it is handed as
`sample_candidates` does, takes the package's own `sample_candidates` and
`exploration_cost` and `_plan_core`'s endpoint seeds, and returns
candidate 0 as found, so the returned state shows the adoption. So the
program compiles in about a second, and every value of the head is the
package's. The state's estimator carries a pipe of delayed commands drawn
with numpy (both sides get the same leaves through
`convert.state_from_numpy`); the port's head gets the recorded uniform
block. The camera-frame vectors, poses and goal are held to the tick
criteria of tests/_torch_parity.py, the mission integers equal, the
candidates' costs to rtol 1e-5 (tests/test_torch_planner.py's) and their
coefficients and seeds to the tick criteria.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import float_bound
from agrifly_tpu.planner import rappids as jrp
from agrifly_tpu.render import raycast as jray
from agrifly_tpu.sim import orchard_env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.sim import orchard_env as T

WAYPOINTS = ((0.6, 0.1, 1.9), (8.0, 1.0, 2.5))
KW = dict(width=160, height=120, n_candidates=96, pyramid_capacity=16, start_flight_time=0.5,
          waypoints=WAYPOINTS)


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@functools.lru_cache(maxsize=None)
def _jax_frame_percept(land):
    """(params, jitted s -> (_frame_percept's (state, key, plan_info), the
    recorders' values))."""
    jp = J.make_params(use_pallas=False, fused_ticks=False, land=land, **KW)
    rec = {}

    def render(cfg, scene, pos, cam_att):
        rec["cam_att"] = cam_att
        return jnp.zeros((cfg.height, cfg.width), jnp.uint16)

    def plan(params, depth, key, vel0, acc0, grav, goal_cam, n_candidates, **_):
        tr = jrp.sample_candidates(params, key, n_candidates, vel0, acc0, grav)
        cost = jrp.exploration_cost(tr, goal_cam)
        end = jrp.traj_mod.position(tr, tr.tf)  # _plan_core's endpoint seeds
        rec.update(u=jax.random.uniform(key, (4, n_candidates), jnp.float32), tr=tr,
                   cost=cost, seeds=(*jrp.project(params.cam, end), end[:, 2]),
                   goal_cam=goal_cam)
        zero = jnp.int32(0)
        return jrp.PlanResult(jnp.bool_(True), zero, cost[0],
                              jax.tree_util.tree_map(lambda x: x[0], tr), *(zero,) * 5)

    def run(s):
        with _patched(jray, "render_depth", render), _patched(jrp, "plan", plan):
            out = J._frame_percept(jp, s)
        return out, dict(rec)

    return jp, jax.jit(run)


def _state(jp, case):
    """An init state with a drawn estimator (prediction pipe included),
    body attitude, step and mission stage."""
    rng = np.random.default_rng(case["seed"])
    js = jax.tree_util.tree_map(np.asarray, J.init_state(jp, jax.random.PRNGKey(0)))
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    unit = lambda q: (q / np.linalg.norm(q)).astype(np.float32)  # noqa: E731
    step = np.int32(case["step"])
    now = int(step) * 2000
    est_us = np.int32(now - int(rng.integers(2000, 9000)))
    pipe = js.base.mocap.pipe._replace(
        active_us=np.sort(est_us + rng.integers(-6000, 40000, 8)).astype(np.int32),
        acc=f32(8, 3), angvel=f32(8, 3) * 0.5, ballistic=rng.integers(0, 2, 8).astype(np.int32),
        head=np.int32(rng.integers(0, 8)), count=np.int32(rng.integers(1, 9)))
    mocap = js.base.mocap._replace(
        initialized=np.bool_(True), pos=case["pos"] + f32(3) * 0.02, vel=f32(3),
        att=unit(np.array([1.0, 0.05, -0.03, 0.2], np.float32) + f32(4) * 0.05),
        angvel=f32(3) * 0.3, estimate_us=est_us, pipe=pipe)
    plant = js.base.plant._replace(
        att=unit(np.array([1.0, 0.0, 0.0, 0.1], np.float32) + f32(4) * 0.1))
    base = js.base._replace(mocap=mocap, plant=plant, step=step,
                            last_cmd_thrust=np.float32(9.0 + rng.standard_normal()))
    return js._replace(base=base, waypoint_idx=np.int32(case["wp"]),
                       mstage=np.int32(case["mstage"]))


CASES = {
    "cruise": dict(seed=0, step=600, pos=np.array([4.0, 0.0, 2.0], np.float32), wp=0, mstage=0),
    "at waypoint 0": dict(seed=1, step=700, pos=np.array([0.6, 0.1, 1.9], np.float32), wp=0,
                          mstage=0),
    "at the last": dict(seed=2, step=800, pos=np.array([8.0, 1.0, 2.5], np.float32), wp=1,
                        mstage=0),
    "before flight": dict(seed=3, step=100, pos=np.array([0.6, 0.1, 1.9], np.float32), wp=0,
                          mstage=0),
}


def _close(got, ref, name):
    got = got.numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    bound = float_bound(("percept", name), ref)
    assert np.all(np.abs(got - ref) <= bound), (name, float(np.max(np.abs(got - ref) / bound)))


@pytest.mark.parametrize("land", [False, True], ids=["cruise", "land"])
@pytest.mark.parametrize("case", list(CASES))
def test_percept_head_matches_jax(case, land):
    jp, run = _jax_frame_percept(land)
    js = _state(jp, CASES[case])
    (js2, _, info), rec = jax.tree_util.tree_map(np.asarray, run(js))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    h = T.percept_head_plain(tp, convert.state_from_numpy(js), torch.tensor(rec["u"]))
    for name, ref in (("cam_att", rec["cam_att"]), ("vel_cam", info["plan_vel_cam"]),
                      ("acc_cam", info["plan_acc_cam"]), ("grav_cam", info["plan_grav_cam"]),
                      ("goal_world", info["goal_world"]), ("goal_cam", rec["goal_cam"]),
                      ("land_pos", js2.land_pos)):
        _close(getattr(h, name), ref, name)
    for name in ("waypoint_idx", "mstage", "land_start_step"):
        assert getattr(h, name).numpy() == getattr(js2, name), name
    assert bool(h.in_flight) == bool(js.base.step >= jp.start_flight_step)
    # the plan adopts where in flight and cruising: the plan's pose is the head's
    adopt = bool(h.in_flight) and int(h.mstage) == T.MSTAGE_CRUISE
    assert int(js2.plan_count) == int(js.plan_count) + adopt
    if adopt:
        for name, ref in (("cam_att_est", js2.planned.att), ("est_pos", js2.planned.offset),
                          ("grav_cam", js2.planned.grav_cam)):
            _close(getattr(h, name), ref, name)
        assert int(js2.planned.start_step) == int(js.base.step)
    else:
        for a, b in zip(jax.tree_util.tree_leaves(js2.planned),
                        jax.tree_util.tree_leaves(js.planned)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(h.candidates.cost.numpy(), rec["cost"], rtol=1e-5)
    for name in ("alpha", "beta", "gamma", "tf"):
        _close(getattr(h.candidates.tr, name), getattr(rec["tr"], name), name)
    for got, ref, name in zip(h.candidates[2:], rec["seeds"], ("epx", "epy", "endz")):
        _close(got, ref, name)
    if case == "at waypoint 0":
        assert int(h.waypoint_idx) == 1
    if case == "at the last" and land:
        assert int(h.mstage) == T.MSTAGE_LANDING
        _close(h.est_pos, js2.land_pos, "est_pos")
