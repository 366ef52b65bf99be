"""sim/fleet_env in the port against the JAX package, on the CPU: the wind
fleet (`fleet_rollout`), also with a UWB network on every vehicle (base
params built by `env.with_uwb_anchors`), and the fleet sharing one UWB
network (`uwb_fleet_rollout`), with the plain versions that K5's wind
builds and K6 stand for (the kernels run on the card:
tests/test_torch_kernels.py, chip_smoke.py).

The JAX package draws from its keys: each vehicle's IMU noise from its env
key (`_torch_parity.jax_tick_draws`), the gust normals from the fleet's key
(`_torch_parity.jax_wind_draws`), a network's draws from its key
(`_torch_parity.jax_uwb_draws`; a vehicle's own network has a key of its
own); the port takes them pre-drawn.
Tolerances: the tick criteria of tests/_torch_parity.py: discrete leaves
equal (flight state, panic, counters, the network's pending, ids and
acc_us, latch_start), float leaves within 1e-3 (|ref| + 1e-3) (the gust
velocity too), the commanded body rates within the command floor.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import compare_state, jax_uwb_draws, jax_wind_draws
from agrifly_tpu.sim import env as J
from agrifly_tpu.sim import fleet_env as JF
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.sim import cuda_fleet_uwb, cuda_rollout
from agrifly_tpu_torch.sim import env as T
from agrifly_tpu_torch.sim import fleet_env as TF
from agrifly_tpu_torch.sim import uwb as tuwb
from _torch_parity import jax_tick_draws

N_VEHICLES = 3
WIND_TICKS = 40
UWB_WARMUP, UWB_TICKS = 1500, 60  # tests/test_fleet_and_bridge.py's idle warm-up, then position
ANCHOR_IDS = [101, 102, 103, 104, 105]  # tests/test_fleet_and_bridge.py's
ANCHOR_POS = [[-5.0, -4.0, 0.1], [6.0, -4.0, 3.0], [6.0, 6.0, 0.2], [-5.0, 6.0, 3.0],
              [0.5, 1.0, 4.0]]
UWB_DES = [[0.0, 0.0, 1.5], [0.5, 1.5, 1.5], [1.0, 3.0, 1.5]]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _wind_des():
    return np.stack([[0.3 * i, 2.0 * i - 0.2, 1.0] for i in range(N_VEHICLES)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_wind():
    """(params, state) of the wind fleet: N_VEHICLES vehicles, mean (2, 0, 0),
    sigma 1.0, gain 0.02, the reference IMU noise."""
    params = JF.FleetParams(base=J.make_params(noise_scale=1.0),
                            wind=JF.make_wind(mean=(2.0, 0.0, 0.0), gust_std=1.0,
                                              force_gain=0.02))
    return params, JF.init_fleet(params, N_VEHICLES, base_seed=3, spacing=2.0)


@functools.lru_cache(maxsize=None)
def _jax_wind_run(use_estimator):
    params, s0 = _jax_wind()
    final, _ = jax.jit(lambda s: JF.fleet_rollout(params, s, jnp.asarray(_wind_des()),
                                                  WIND_TICKS, use_estimator))(s0)
    return _np(final)


@pytest.mark.parametrize("use_estimator", [True, False])
def test_wind_fleet_matches_jax(use_estimator):
    """40 ticks of the wind fleet, mocap estimator and true state."""
    params, s0 = _jax_wind()
    ref = _jax_wind_run(use_estimator)
    noise, last = jax_tick_draws(s0.envs.key, WIND_TICKS)
    np.testing.assert_array_equal(last, ref.envs.key)
    gusts, key = jax_wind_draws(s0.key, WIND_TICKS, N_VEHICLES)
    np.testing.assert_array_equal(key, ref.key)
    tp = convert.fleet_params_from_numpy(_np(params), "cpu")
    ts = convert.fleet_state_from_numpy(_np(s0), "cpu")
    got, traj = TF.fleet_rollout(tp, ts, torch.from_numpy(_wind_des()), WIND_TICKS,
                                 use_estimator, noise=torch.from_numpy(np.array(noise)),
                                 wind_noise=gusts)
    assert traj is None
    compare_state(got, ref)
    assert np.abs(ref.wind_vel - [2.0, 0.0, 0.0]).max() > 1e-2  # the gusts moved
    assert (ref.envs.logic.panic_reason == 0).all()


def test_wind_fleet_draws_from_a_generator_in_order():
    """gen draws the IMU noise (N, n, 2, 3), then the gust normals (n, N, 3);
    init_fleet lines the vehicles up at (0, i spacing, 0) at the mean wind."""
    tp = TF.FleetParams(T.make_params(device="cpu"), TF.make_wind(device="cpu"))
    s = TF.init_fleet(tp, 2, spacing=1.5)
    np.testing.assert_array_equal(s.envs.plant.pos.numpy(), [[0, 0, 0], [0, 1.5, 0]])
    np.testing.assert_array_equal(s.wind_vel.numpy(), [[2.0, 0.5, 0.0]] * 2)
    des = torch.tensor([0.0, 0.0, 1.0])
    got, _ = TF.fleet_rollout(tp, s, des, 3, gen=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    noise = torch.randn((2, 3, 2, 3), generator=g)
    gusts = torch.randn((3, 2, 3), generator=g)
    want, _ = TF.fleet_rollout(tp, s, des, 3, noise=noise, wind_noise=gusts)
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(want)):
        assert torch.equal(a, b), path


def test_wind_leaf_table_matches_the_fleet():
    """K5's wind build reads FleetState's and FleetParams' leaves in order."""
    specs, pspecs = cuda_rollout.leaf_table(wind=True)
    tp = TF.FleetParams(T.make_params(device="cpu"), TF.make_wind(device="cpu"))
    s = TF.init_fleet(tp, 2)
    assert [sp.path[-1] for sp in specs] == [p[-1] for p, _ in convert.leaves(s)]
    assert [sp.path for sp in pspecs[-4:]] == [p for p, _ in convert.leaves(tp)][-4:]
    assert len(pspecs) == len(list(convert.leaves(tp)))


@functools.lru_cache(maxsize=None)
def _jax_wind_uwb():
    """(params, state) of the wind fleet of `_jax_wind` whose base carries a
    UWB network of its own on tests/test_fleet_and_bridge.py's anchors
    (noise_std 0.05): every vehicle ranges its own anchors."""
    params, _ = _jax_wind()
    base = J.with_uwb_anchors(params.base, ANCHOR_IDS, ANCHOR_POS, comm_period=0.005,
                              noise_std=0.05)
    params = params._replace(base=base)
    return params, JF.init_fleet(params, N_VEHICLES, base_seed=3, spacing=2.0)


@functools.lru_cache(maxsize=None)
def _jax_wind_uwb_run(use_estimator):
    params, s0 = _jax_wind_uwb()
    final, _ = jax.jit(lambda s: JF.fleet_rollout(params, s, jnp.asarray(_wind_des()),
                                                  WIND_TICKS, use_estimator))(s0)
    return _np(final)


@pytest.mark.parametrize("use_estimator", [True, False])
def test_wind_fleet_with_onboard_uwb_matches_jax(use_estimator):
    """40 ticks of the wind fleet whose vehicles each range their own
    anchors, mocap estimator and true state: every leaf, each vehicle's
    network (pending, ids, acc_us) included, by the tick criteria."""
    params, s0 = _jax_wind_uwb()
    ref = _jax_wind_uwb_run(use_estimator)
    noise, last = jax_tick_draws(s0.envs.key, WIND_TICKS)
    np.testing.assert_array_equal(last, ref.envs.key)
    gusts, key = jax_wind_draws(s0.key, WIND_TICKS, N_VEHICLES)
    np.testing.assert_array_equal(key, ref.key)
    draws = jax_uwb_draws(s0.envs.uwb.key, WIND_TICKS)
    tp = convert.fleet_params_from_numpy(_np(params), "cpu")
    ts = convert.fleet_state_from_numpy(_np(s0), "cpu")
    assert tp.base.uwb.radio_ids.tolist() == [1] + ANCHOR_IDS
    assert tuple(ts.envs.uwb.acc_us.shape) == (N_VEHICLES,)
    got, traj = TF.fleet_rollout(tp, ts, torch.from_numpy(_wind_des()), WIND_TICKS,
                                 use_estimator, noise=torch.from_numpy(np.array(noise)),
                                 wind_noise=gusts, uwb_draws=draws)
    assert traj is None
    compare_state(got, ref)
    assert np.abs(ref.wind_vel - [2.0, 0.0, 0.0]).max() > 1e-2  # the gusts moved
    assert (ref.envs.logic.uwb_meas_count > 0).all()  # every vehicle took ranges
    assert (ref.envs.logic.panic_reason == 0).all()


def test_wind_fleet_with_onboard_uwb_draws_from_a_generator_in_order():
    """With a network on every vehicle, init_fleet gives each its own idle
    network state, and gen draws the IMU noise, the gust normals, then the
    UWB draws (N, n, 4) as `env.rollout` draws them; a network-free fleet
    draws from gen as before, and its rollout refuses UWB draws."""
    base = T.with_uwb_anchors(T.make_params(device="cpu"), ANCHOR_IDS[:2], ANCHOR_POS[:2],
                              comm_period=0.002, noise_std=0.05)
    tp = TF.FleetParams(base, TF.make_wind(device="cpu"))
    s = TF.init_fleet(tp, 2, spacing=1.5)
    for _, t in convert.leaves(s.envs.uwb):
        assert t.shape == (2,) and not bool(t.to(torch.int32).any())
    des = torch.tensor([0.0, 0.0, 1.0])
    got, _ = TF.fleet_rollout(tp, s, des, 3, gen=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    noise = torch.randn((2, 3, 2, 3), generator=g)
    gusts = torch.randn((3, 2, 3), generator=g)
    draws = tuwb.draw((2, 3), g)
    want = s
    for k in range(3):
        want, _ = TF.fleet_step(tp, want, des, True, noise[:, k], gusts[k], draws[:, k])
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(want)):
        assert torch.equal(a, b), path
    assert bool(got.envs.uwb.pending.all())  # each network latched a transaction
    with pytest.raises(ValueError, match="uwb_draws"):
        TF.fleet_step(tp, s, des, True, noise[:, 0], gusts[0])

    free = TF.FleetParams(T.make_params(device="cpu"), TF.make_wind(device="cpu"))
    s = TF.init_fleet(free, 2, spacing=1.5)
    assert s.envs.uwb is None
    got, _ = TF.fleet_rollout(free, s, des, 3, gen=torch.Generator().manual_seed(5))
    want, _ = TF.fleet_rollout(free, s, des, 3, noise=noise, wind_noise=gusts)
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(want)):
        assert torch.equal(a, b), path
    with pytest.raises(ValueError, match="no UWB network"):
        TF.fleet_rollout(free, s, des, 3, noise=noise, wind_noise=gusts, uwb_draws=draws)


def test_wind_uwb_leaf_table_matches_the_fleet():
    """K5's TICK_WIND + TICK_UWB build reads the leaves of a wind fleet with
    a network on every vehicle in order: the env's, its network's, then the
    gusts; the radio table padded to MAX_RADIOS, the WindParams after it."""
    specs, pspecs = cuda_rollout.leaf_table(uwb=True, wind=True)
    base = T.with_uwb_anchors(T.make_params(device="cpu"), ANCHOR_IDS, ANCHOR_POS)
    tp = TF.FleetParams(base, TF.make_wind(device="cpu"))
    s = TF.init_fleet(tp, 2)
    assert [sp.path[-1] for sp in specs] == [p[-1] for p, _ in convert.leaves(s)]
    assert [sp.path[-2:] for sp in specs[-5:-1]] == [p[-2:] for p, _ in convert.leaves(s)][-5:-1]
    pleaves = list(convert.leaves(tp))
    assert [sp.path for sp in pspecs[-4:]] == [p for p, _ in pleaves][-4:]
    assert [sp.path for sp in pspecs[-12:-4]] == [p[1:] for p, _ in pleaves][-12:-4]
    assert len(pspecs) == len(pleaves)
    kernel = cuda_rollout.param_leaves(tp)
    radios = [sp.path for sp in pspecs].index(("uwb", "radio_ids"))
    assert kernel[radios].tolist() == [1] + ANCHOR_IDS + [0] * (cuda_rollout.MAX_RADIOS - 6)
    assert [t.numel() for t in kernel] == [max(sp.numel, 1) for sp in pspecs]
    state_specs, _ = cuda_rollout.leaf_table(uwb=True, wind=True)
    from agrifly_tpu_torch import cuda_build
    cuda_build.check_leaves(state_specs, convert.flatten_tensors(s)[0], torch.device("cpu"),
                            "state", 2, "tick.cuh")
    cuda_build.check_leaves(pspecs, kernel, torch.device("cpu"), "params", None, "tick.cuh")


@functools.lru_cache(maxsize=None)
def _jax_uwb():
    """tests/test_fleet_and_bridge.py's shared-UWB fleet after its 1500-tick
    idle warm-up: (params, state then)."""
    params = JF.make_uwb_fleet_params(N_VEHICLES, ANCHOR_IDS, ANCHOR_POS, comm_period=0.005,
                                      noise_std=0.05, noise_scale=1.0)
    s0 = JF.init_uwb_fleet(params, spacing=1.5)
    warm, _ = jax.jit(lambda s: JF.uwb_fleet_rollout(params, s, jnp.asarray(UWB_DES),
                                                     UWB_WARMUP, "idle"))(s0)
    return params, warm


def test_uwb_fleet_matches_jax():
    """60 position ticks of the shared-UWB fleet from JAX's warmed-up state:
    every vehicle's leaves, the gusts, the network and latch_start."""
    params, s0 = _jax_uwb()
    ref, _ = jax.jit(lambda s: JF.uwb_fleet_rollout(params, s, jnp.asarray(UWB_DES),
                                                    UWB_TICKS))(s0)
    ref = _np(ref)
    noise, _ = jax_tick_draws(s0.envs.key, UWB_TICKS)
    gusts, key = jax_wind_draws(s0.key, UWB_TICKS, N_VEHICLES)
    np.testing.assert_array_equal(key, ref.key)
    draws = jax_uwb_draws(np.asarray(s0.uwb.key)[None], UWB_TICKS)[0]
    tp = convert.uwb_fleet_params_from_numpy(_np(params), "cpu")
    ts = convert.uwb_fleet_state_from_numpy(_np(s0), "cpu")
    got, _ = TF.uwb_fleet_rollout(tp, ts, torch.tensor(UWB_DES), UWB_TICKS,
                                  noise=torch.from_numpy(np.array(noise)), wind_noise=gusts,
                                  uwb_draws=draws)
    compare_state(got, ref)
    # the window holds ranges to more than one vehicle, and the warm-up
    # left every EKF past its complementary phase
    assert int(ref.latch_start) > int(_np(s0).latch_start) + 1
    assert ref.envs.logic.kf.uwb_init.all()


def test_uwb_fleet_params_and_the_radio_cap():
    """make_uwb_fleet_params' radio table (vehicles 1..N, then the anchors),
    the default calm wind; K6's cap (N <= 32, N + anchors <= 33) raises
    before any work, on the CPU too."""
    tp = TF.make_uwb_fleet_params(3, ANCHOR_IDS, ANCHOR_POS, device="cpu")
    assert tp.uwb.radio_ids.tolist() == [1, 2, 3] + ANCHOR_IDS
    assert tp.base.logic.target_ids[:5].tolist() == ANCHOR_IDS and int(tp.base.logic.num_targets) == 5
    assert float(tp.wind.force_gain) == 0.0 and float(tp.wind.gust_std) == 0.0
    s = TF.init_uwb_fleet(tp, spacing=1.5)
    assert s.envs.uwb is None and int(s.latch_start) == 0
    np.testing.assert_array_equal(s.envs.plant.pos[:, 1].numpy(), [0.0, 1.5, 3.0])
    big = TF.make_uwb_fleet_params(29, ANCHOR_IDS, ANCHOR_POS, device="cpu")
    with pytest.raises(ValueError, match="at most 33 radios"):
        TF.uwb_fleet_rollout(big, TF.init_uwb_fleet(big), torch.zeros(3), 1,
                             gen=torch.Generator().manual_seed(0))
    assert cuda_fleet_uwb.rollout.launches == 0


def test_fleet_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults build there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.make_wind()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.make_uwb_fleet_params(2, [101], [[0.0, 0.0, 0.0]])


def test_uwb_fleet_draws_from_a_generator_in_order():
    """gen draws the IMU noise, the gust normals, then the network's draws
    (`uwb.draw`'s order); two steps of the plain version equal a rollout."""
    tp = TF.make_uwb_fleet_params(2, ANCHOR_IDS[:2], ANCHOR_POS[:2], comm_period=0.002,
                                  device="cpu")
    s = TF.init_uwb_fleet(tp)
    des = torch.tensor([[0.0, 0.0, 1.0], [0.0, 2.0, 1.0]])
    got, _ = TF.uwb_fleet_rollout(tp, s, des, 2, gen=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    noise = torch.randn((2, 2, 2, 3), generator=g)
    gusts = torch.randn((2, 2, 3), generator=g)
    draws = tuwb.draw((2,), g)
    want = s
    for k in range(2):
        want, _ = TF.uwb_fleet_step(tp, want, des, "position", noise[:, k], gusts[k], draws[k])
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(want)):
        assert torch.equal(a, b), path
