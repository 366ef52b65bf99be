"""Helpers for the PyTorch port's parity tests against the JAX package.

Both packages get the same inputs, made with numpy from a seed; randomness
the JAX package draws from its PRNG key is drawn there and injected into the
port. JAX runs on the CPU (tests/conftest.py) with x64 enabled, so inputs
are explicit float32/int32 arrays.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from agrifly_tpu_torch import convert

# The suite runs several pytest workers on one machine beside wall-clock-paced
# tests (tests/test_realtime.py). The port's tensors here are small, so torch's
# intra-op thread pool would only compete with them for cores.
torch.set_num_threads(1)

# Float leaves: elementwise |d| <= FLOAT_REL * (|ref| + FLOAT_FLOOR), the
# criterion of the JAX package's frame-parity artifact (VERIFY_r05_frame.json).
FLOAT_REL = 1e-3
FLOAT_FLOOR = 1e-3

# The commanded body rates carry the attitude controller's acos of a cosine
# within a few ulps of 1 (attitude errors of ~1e-3 rad): one ulp of input
# moves the angle by percent, times the 25 /s gain. The JAX package records
# a ~1e-2 rad/s intrinsic command agreement floor against the C++ reference
# for the same reason. Leaves that hold those commands, and the
# wire codes that quantize them (35/32768 per code), are held to that floor.
COMMAND_FLOOR = 1e-2
COMMAND_LEAVES = {(*pre, *leaf) for pre in ((), ("base",), ("envs",))
                  for leaf in (("last_cmd_angvel",), ("mocap", "pipe", "angvel"))}
WIRE_LEAVES = {(*pre, "ring", "fields") for pre in ((), ("base",), ("envs",))}  # env, orchard, fleet
WIRE_MAX_CODES = int(np.ceil(COMMAND_FLOOR / (35.0 / 32768.0)))

# Where the GPS-IMU estimator closes the loop from its first tick, the
# roundings that XLA:CPU's contracted multiply-adds leave in the estimate
# reach the commands (a wire code one apart, within the command floor) and
# so the plant's attitude. The accelerometer's low-pass filter carries the
# specific force, a vector of norm ~g: its near-zero components then move
# by ~1e-5 absolute, past 1e-3 (|ref| + 1e-3). Those leaves alone are held
# to FLOAT_REL * (|ref| + CLOSED_LOOP_FLOOR), 1e-5 absolute near zero
# (measured: 1.1e-5 over 60 GPS-IMU ticks, 1.05 x the tick bound). With the
# JAX reference compiled without FMA (XLA_FLAGS=--xla_cpu_max_isa=AVX)
# every leaf agrees with the port within 0.013 of the tick bound
# (tests/test_torch_env.py::test_gpsimu_fleet_without_fma_matches_jax; the
# readings leaf by leaf: closed_loop_readings below).
CLOSED_LOOP_FLOOR = 1e-2
CLOSED_LOOP_LEAVES = {("logic", "acc_lp", name) for name in ("xm0", "xm1", "ym0", "ym1")}
NO_FMA_FLAGS = "--xla_cpu_max_isa=AVX"  # XLA:CPU without FMA instructions: no contraction


def jax_leaf(tree, path):
    for name in path:
        tree = getattr(tree, name)
    return np.asarray(tree)


def float_bound(path, ref, closed_loop=False):
    """The elementwise bound on |port - ref| of the float leaf at `path`:
    the command floor for COMMAND_LEAVES, else FLOAT_REL * (|ref| +
    FLOAT_FLOOR) (with closed_loop, CLOSED_LOOP_FLOOR for
    CLOSED_LOOP_LEAVES)."""
    if path in COMMAND_LEAVES:
        return COMMAND_FLOOR + FLOAT_REL * np.abs(ref)
    floor = CLOSED_LOOP_FLOOR if closed_loop and path in CLOSED_LOOP_LEAVES else FLOAT_FLOOR
    return FLOAT_REL * (np.abs(ref) + floor)


def compare_state(port_state, jax_state, closed_loop=False):
    """Hold every leaf of a port state against the JAX state's leaf of the
    same name (floats to FLOAT_REL * (|ref| + FLOAT_FLOOR); with
    closed_loop, CLOSED_LOOP_LEAVES to CLOSED_LOOP_FLOOR). Returns the worst
    (ratio, path) float leaves; asserts."""
    failures, worst = [], []
    for path, t in convert.leaves(port_state):
        ref = jax_leaf(jax_state, path)
        got = t.cpu().numpy()
        assert got.shape == ref.shape, (path, got.shape, ref.shape)
        if path in WIRE_LEAVES:
            d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
            if d.max(initial=0) > WIRE_MAX_CODES:
                failures.append((path, int(d.max())))
        elif ref.dtype.kind in "biu":
            if not np.array_equal(got, ref):
                failures.append((path, "discrete leaf differs"))
        else:
            d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
            ratio = float((d / float_bound(path, ref, closed_loop)).max(initial=0.0))
            worst.append((ratio, path))
            if ratio > 1.0:
                failures.append((path, ratio))
    worst.sort(reverse=True)
    assert not failures, (failures, worst[:5])
    return worst[:5]


# The bridges' bags against the JAX package's. A closed loop meets the tick
# criteria for TICK_CRITERIA_TICKS ticks; later the commanded body rates (an
# acos of a cosine within ulps of 1) part by up to the command floor and the
# plant follows them, so the JAX package's terms for a long rollout hold
# (tests/test_torch_env.py): integers and stamps equal, positions within
# FINAL_POS_M. Over the whole flight the wire holds: telemetry values within
# one code of their field's range, the command stream's codes within
# WIRE_MAX_CODES, the commanded rates within the command floor.
TICK_CRITERIA_TICKS = 60
FINAL_POS_M = 0.05
POSITION_FIELDS = ("posx", "posy", "posz", "position", "position_estimate_W",
                   "position_reference_W", "translation")
TEL_RANGES = {"accelerometer": (-30.0, 30.0), "rateGyro": (-35.0, 35.0),
              "position": (-30.0, 30.0), "attitude": (-1.0, 1.0), "velocity": (-30.0, 30.0),
              "motorForces": (0.0, 10.0), "debugVals": (-100.0, 100.0),
              "batteryVoltage": (0.0, 15.0)}  # io/telemetry's ranges, by message field


def bag_bound(topic, name, stamp, ref, dt=0.002):
    """compare_bags' bound for a bridge's float against the JAX bridge's
    (see TICK_CRITERIA_TICKS); None where the long-rollout terms check
    nothing."""
    if topic.startswith("telemetry") and name in TEL_RANGES:
        lo, hi = TEL_RANGES[name]
        return (hi - lo) / 65536.0 * (1 + 1e-6)
    if name == "codes":  # a radio command's field codes (see compare_bags' callers)
        return float(WIRE_MAX_CODES)
    if name == "angular_velocity_command_B":
        return COMMAND_FLOOR + FLOAT_REL * abs(ref)
    if stamp > TICK_CRITERIA_TICKS * dt + 1e-9:
        return FINAL_POS_M if name in POSITION_FIELDS else None
    return FLOAT_REL * (abs(ref) + FLOAT_FLOOR)


def read_bag(path):
    """The lines of a MessageRecorder bag (JSONL)."""
    import json

    with open(path) as f:
        return [json.loads(line) for line in f]


def compare_bags(mine, theirs, bound_of):
    """Two recorder bags (lists of JSON lines) line by line: the same topics
    in the same order, the same keys, equal strings, integers and stamps;
    each other float within bound_of(topic, field, stamp, ref) (NaN
    equal to NaN; a bound of None leaves the value unchecked). Returns the
    worst float ratio."""
    assert len(mine) == len(theirs)
    worst = 0.0

    def walk(a, b, path, topic, stamp):
        nonlocal worst
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], path + (k,), topic, stamp)
        elif isinstance(b, list):
            assert isinstance(a, list) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,), topic, stamp)
        elif isinstance(b, (bool, int, str)) or b is None or path[-1] == "stamp":
            assert type(a) is type(b) and a == b, (path, a, b)
        else:
            assert isinstance(a, float), (path, a, b)
            if np.isnan(b) or np.isnan(a):
                assert np.isnan(a) and np.isnan(b), (path, a, b)
                return
            name = next(p for p in reversed(path) if isinstance(p, str))
            bound = bound_of(topic, name, stamp, b)
            if bound is None:
                return
            if bound:
                worst = max(worst, abs(a - b) / bound)
            assert abs(a - b) <= bound, (path, a, b, bound)

    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert a["topic"] == b["topic"], (i, a["topic"], b["topic"])
        stamp = b["msg"]["header"]["stamp"]
        walk(a["msg"], b["msg"], (i, a["topic"]), a["topic"], stamp)
    return worst


def make_scene(W, H, n_obstacles, seed):
    """Random box obstacles on a far background (int32 depth codes): the
    scene of tests/test_pallas_inflate.py, in numpy."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 230, np.int32)
    for _ in range(n_obstacles):
        x = rng.integers(5, W - 5)
        y = rng.integers(5, H - 5)
        w = rng.integers(3, max(4, W // 8))
        h = rng.integers(5, max(6, H // 2))
        d = rng.integers(25, 140)
        img[max(0, y - h // 2):y + h // 2, max(0, x - w // 2):x + w // 2] = d
    return img


def gradient_scene(W, H):
    """Sparse, blocker-free far background: a depth gradient with no pixel
    nearer than any pyramid's required depth (the case in which a wrong
    base-depth tile skip shows)."""
    ys, xs = np.mgrid[0:H, 0:W]
    return (20000 + 3 * xs + 7 * ys).astype(np.int32)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


TICK_DRAWS = 1500  # the longest chain of JAX tick draws a test takes (the golden flight)


@functools.lru_cache(maxsize=None)
def _tick_draw_chain():
    import jax
    import jax.numpy as jnp

    def chain(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            k1, k2 = jax.random.split(sub)
            return k, (k, jnp.stack([jax.random.normal(k1, (3,), jnp.float32),
                                     jax.random.normal(k2, (3,), jnp.float32)]))
        return jax.lax.scan(body, key, None, length=TICK_DRAWS)[1]
    return jax.jit(jax.vmap(chain))


def jax_tick_draws(keys, n):
    """The IMU noise (..., n, 2, 3) the JAX package's env.step draws over n
    ticks from each state key of `keys` (..., 2) (`key, sub = split(key)`,
    then `k1, k2 = split(sub)`, gyro from k1 and acc from k2), and each
    chain's key after them."""
    keys = np.asarray(keys)
    lead = keys.shape[:-1]
    ks, noise = _tick_draw_chain()(keys.reshape(-1, 2))
    noise = np.asarray(noise)[:, :n].reshape(lead + (n, 2, 3))
    return noise, np.asarray(ks)[:, n - 1].reshape(lead + (2,))


def jax_frame_draws(key, n, n_candidates, ticks=16):
    """The draws of n orchard frames from the JAX state's key: each frame
    `key, sub, k_noise = split(key, 3)`, the planner's uniform block from
    sub and the IMU noise from k_noise. Returns u (n, 4, n_candidates),
    noise (n, ticks, 2, 3) float32 and the key after them."""
    import jax
    import jax.numpy as jnp

    us, noises = [], []
    key = np.asarray(key)
    for _ in range(n):
        key, sub, k_noise = jax.random.split(key, 3)
        us.append(np.asarray(jax.random.uniform(sub, (4, n_candidates), jnp.float32)))
        noises.append(np.asarray(jax.random.normal(k_noise, (ticks, 2, 3), jnp.float32)))
    return np.stack(us), np.stack(noises), np.asarray(key)


def jax_uwb_draws(keys, n):
    """The draws sim/uwb.step takes over n ticks from each JAX network key of
    `keys` (..., 2): `split(key, 5)` a tick, then u_outlier, n_outlier,
    n_noise, u_fail; (..., n, 4) float32, the port's `uwb_draws`. (The IMU
    noise of env.step: `jax_tick_draws`.)"""
    import jax
    import jax.numpy as jnp

    def tick(k, _):
        k, k1, k2, k3, k4 = jax.random.split(k, 5)
        return k, jnp.stack([jax.random.uniform(k1), jax.random.normal(k2),
                             jax.random.normal(k3), jax.random.uniform(k4)])

    chain = jax.vmap(lambda key: jax.lax.scan(tick, key, None, length=n)[1])
    keys = np.asarray(keys)
    out = np.asarray(jax.jit(chain)(keys.reshape(-1, 2)))
    return torch.from_numpy(out.reshape(keys.shape[:-1] + (n, 4)).astype(np.float32))


def jax_wind_draws(key, n_steps, n_vehicles):
    """The gust normals sim/fleet_env's fleet_step and uwb_fleet_step draw
    over n_steps ticks from a fleet's JAX key: `split(key)` a tick, then a
    (N, 3) normal from the second half; (n_steps, N, 3) float32, the port's
    `wind_noise`, and the key after them."""
    import jax

    def tick(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.normal(sub, (n_vehicles, 3), np.float32)

    key, out = jax.jit(lambda k: jax.lax.scan(tick, k, None, length=n_steps))(np.asarray(key))
    return torch.from_numpy(np.array(out, np.float32)), np.asarray(key)


def leaf_readings(port_state, jax_state):
    """Every leaf's distance from the JAX state's, worst first: (ratio to
    the tick criteria's float_bound, path, max |d|) for float leaves, (codes
    apart, path, "codes") for wire leaves, (inf, path, ...) for a discrete
    leaf that differs."""
    out = []
    for path, t in convert.leaves(port_state):
        ref, got = jax_leaf(jax_state, path), t.cpu().numpy()
        if path in WIRE_LEAVES:
            d = np.abs(got.astype(np.int64) - ref.astype(np.int64)).max(initial=0)
            out.append((float(d), path, "codes"))
        elif ref.dtype.kind not in "biu":
            d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
            ratio = float((d / float_bound(path, ref)).max(initial=0.0))
            out.append((ratio, path, float(d.max(initial=0.0))))
        elif not np.array_equal(got, ref):
            out.append((float("inf"), path, "discrete leaf differs"))
    return sorted(out, key=lambda r: -r[0])


def closed_loop_readings():
    """Print the worst leaves of the port's closed estimator loops against
    the JAX package: the GPS-IMU fleet run of tests/test_torch_env.py (60
    ticks, 3 envs) and the onboard-UWB flight of tests/test_torch_uwb.py
    (150 ticks). From the repository root, as compiled by default and
    without FMA:

        PYTHONPATH=. python tests/_torch_parity.py
        PYTHONPATH=. XLA_FLAGS=--xla_cpu_max_isa=AVX python tests/_torch_parity.py
    """
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import test_torch_env as te
    import test_torch_uwb as tu
    from agrifly_tpu_torch.sim import env as T

    print("XLA_FLAGS:", os.environ.get("XLA_FLAGS", ""))
    s0, ref, _ = te._jax_fleet_run("gpsimu")
    noise, _ = jax_tick_draws(s0.key, te.N)
    got, _ = T.rollout(te._tparams(), convert.env_state_from_numpy(s0, "cpu"),
                       convert.command_from_numpy(te._np(te._jcommand()), "cpu"), te.N,
                       "gpsimu", noise=te._t(noise))
    print(f"GPS-IMU fleet, {te.B} envs x {te.N} ticks:")
    for r in leaf_readings(got, ref)[:8]:
        print("  ", r)
    jp, s0, ref, _ = tu._jax_uwb_flight(tu.N_FLIGHT)
    p, s, cmd, noise, draws = tu._port_inputs(jp, s0, tu.N_FLIGHT)
    got, _ = T.rollout(p, s, cmd, tu.N_FLIGHT, False, "position", noise=noise, uwb_draws=draws)
    print(f"onboard-UWB flight, {tu.N_FLIGHT} ticks:")
    for r in leaf_readings(got, ref)[:8]:
        print("  ", r)


if __name__ == "__main__":
    closed_loop_readings()
