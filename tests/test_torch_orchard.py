"""The port's orchard frame against the JAX package's `frame_step`.

One frame from a mid-flight state (converted with `state_from_numpy`, with
the planner's uniform block and the IMU noise rebuilt from the JAX key
splits) is held to the tick criteria of tests/_torch_parity.py. A longer
flight cannot be compared bit for bit (plans diverge once one collision
label flips), so it is compared on its envelope.
"""

import collections
import functools
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import compare_state
from agrifly_tpu.sim import orchard_env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.sim import orchard_env as T

KW = dict(goal_world=(60.0, 0.0, 2.0), takeoff_height=2.0, start_flight_time=1.0,
          n_candidates=96, pyramid_capacity=16, width=160, height=120)
WARMUP, FRAMES = 40, 30  # planning starts at frame 32


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX params, its jitted frame_step, and the state after WARMUP frames
    (one compiled program serves every JAX frame of this file)."""
    jp = J.make_params(use_pallas=False, fused_ticks=False, **KW)
    step = jax.jit(lambda s: J.frame_step(jp, s))
    s = J.init_state(jp, jax.random.PRNGKey(0))
    for _ in range(WARMUP):
        s, _ = step(s)
    return jp, step, s


def _port(jp, js):
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return tp, convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def test_params_from_numpy_equal_port_make_params():
    jp, _, _ = _jax()
    tp, _ = _port(jp, _jax()[2])
    mine = T.make_params(fused_ticks=False, device="cpu", **KW)  # the JAX configuration's tick path
    assert tp._replace(base=None, scene=None, planner=None, waypoints=None, num_waypoints=None,
                       takeoff_height=None, start_flight_step=None, track_lookahead=None) == \
        mine._replace(base=None, scene=None, planner=None, waypoints=None, num_waypoints=None,
                      takeoff_height=None, start_flight_step=None, track_lookahead=None)
    theirs = dict(convert.leaves(tp))
    for path, t in convert.leaves(mine):
        np.testing.assert_allclose(t.numpy(), theirs[path].numpy(), rtol=2e-7, atol=0,
                                   err_msg=str(path))
        assert t.dtype == theirs[path].dtype, path


def test_one_frame_from_mid_flight_matches_jax():
    jp, step, js = _jax()
    assert int(js.plan_count) > 0  # the planner is live in this state
    _, sub, k_noise = jax.random.split(js.base.key, 3)
    u = np.asarray(jax.random.uniform(sub, (4, KW["n_candidates"]), jnp.float32))
    noise = np.asarray(jax.random.normal(k_noise, (16, 2, 3), jnp.float32))
    ref, ref_out = step(js)

    tp, ts = _port(jp, js)
    got, out = T.frame_step(tp, ts, draws=(torch.from_numpy(u), torch.from_numpy(noise)))
    compare_state(got, ref)
    for k in ("plan_found", "num_collision_free", "num_pyramids", "num_feasible",
              "num_velocity_admissible", "flight_state", "panic"):
        assert int(out[k]) == int(ref_out[k]), k
    np.testing.assert_allclose(float(out["best_cost"]), float(ref_out["best_cost"]), rtol=1e-5)


def test_fly_diag_one_frame_matches_jax():
    """One fly_diag frame from the mid-flight state with JAX's draws
    injected. JAX's fly_diag flies frame_step and appends _diag_extras of
    the new state each frame (agrifly_tpu/sim/orchard_env.py:562), so the
    file's cached frame program and a jitted _diag_extras give its row for
    one frame without a second compile of the frame. Float leaves meet the
    tick criteria (COMMAND_LEAVES as there), integer leaves are equal."""
    jp, step, js = _jax()
    _, sub, k_noise = jax.random.split(js.base.key, 3)
    u = np.asarray(jax.random.uniform(sub, (4, KW["n_candidates"]), jnp.float32))
    noise = np.asarray(jax.random.normal(k_noise, (16, 2, 3), jnp.float32))
    ref_state, ref_out = step(js)
    ref_out = dict(ref_out, **jax.jit(lambda s: J._diag_extras(jp, s))(ref_state))

    tp, ts = _port(jp, js)
    got_state, out = T.fly_diag(tp, ts, 1, draws=(torch.from_numpy(u)[None],
                                                  torch.from_numpy(noise)[None]))
    compare_state(got_state, ref_state)
    assert set(out) == set(ref_out)
    Row = collections.namedtuple("Row", sorted(out))
    got = Row(**{k: jax.tree_util.tree_map(lambda t: t[0], v) if k == "planned" else v[0]
                 for k, v in out.items()})
    worst = compare_state(got, Row(**{k: ref_out[k] for k in Row._fields}))
    print("fly_diag row, worst float leaves:", worst)
    assert int(out["plan_count"][0]) == int(ref_out["plan_count"]) > 0


def test_flight_envelope():
    jp, step, js = _jax()
    ref = js
    for _ in range(FRAMES):
        ref, _ = step(ref)
    tp, ts = _port(jp, js)
    env = T.OrchardEnv(tp)
    got, outs = env.fly(ts, FRAMES, torch.Generator().manual_seed(0))

    assert int(got.base.logic.panic_reason) == 0 and int(ref.base.logic.panic_reason) == 0
    assert not (outs["panic"] != 0).any()
    plans, ref_plans = int(got.plan_count - ts.plan_count), int(ref.plan_count - js.plan_count)
    print("plans", plans, ref_plans, "x", float(ts.base.plant.pos[0]),
          float(got.base.plant.pos[0]), float(ref.base.plant.pos[0]))
    assert ref_plans > 5
    assert abs(plans - ref_plans) <= 0.25 * ref_plans, (plans, ref_plans)
    x0, x_ref = float(ts.base.plant.pos[0]), float(ref.base.plant.pos[0])
    x = float(got.base.plant.pos[0])
    assert x - x0 > 0.3 and x_ref - x0 > 0.3, (x0, x, x_ref)
    assert abs((x - x0) - (x_ref - x0)) <= 0.5 * (x_ref - x0), (x0, x, x_ref)
    assert torch.isfinite(outs["pos"]).all() and outs["pos"].shape == (FRAMES, 3)
    assert int(got.frame_count) == int(ts.frame_count) + FRAMES


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports with jax
    blocked and loads no module of the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import agrifly_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(agrifly_tpu_torch.__path__,
                                                       "agrifly_tpu_torch.")]
        for name in names + ["chip_smoke"]:
            importlib.import_module(name)
        jaxy = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
        theirs = sorted(m for m in sys.modules if m.split(".")[0] == "agrifly_tpu")
        assert theirs == [], theirs
        assert "agrifly_tpu_torch.sim.orchard_env" in names and len(names) > 30, names
        entry = {"agrifly_tpu_torch." + m for m in (
            "demo", "launch", "io.teleop", "io.miniros", "io.ros_adapter", "io.native",
            "utils.checkpoint", "utils.simlog", "utils.perf", "parallel.sharding",
            "parallel.multihost", "parallel.dryrun")}
        assert entry <= set(names), sorted(entry - set(names))
        print("ok", jaxy)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok ['jax']", res.stdout
