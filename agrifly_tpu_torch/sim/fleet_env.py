"""Config #5: a fleet of vehicles under wind, alone or sharing one UWB network.

Port of `agrifly_tpu/sim/fleet_env.py`. The fleet is a leading vehicle axis
on every leaf of `sim/env`'s state; each vehicle carries an
Ornstein-Uhlenbeck gust velocity on top of a mean wind, and flies under an
aerodynamic-style force proportional to the relative wind:

    w' = w + dt/tau (mean - w) + sqrt(2 dt / tau) sigma N(0, 1)
    F  = gain * (w' - v_vehicle)

`fleet_step` / `fleet_rollout` fly such a fleet with `env.step` (rates
commands to per-vehicle setpoints; the mocap estimator by default). Its
base params may carry a UWB network of their own (`env.with_uwb_anchors`):
each vehicle then ranges its own anchors on its own network state, and its
onboard EKF fuses the ranges.
`uwb_fleet_step` / `uwb_fleet_rollout` fly vehicles that share ONE ranging
network with fixed anchors: every tick the plants move (phase A), the
network steps once over the vehicles' new positions and the anchors (the
radio table's vehicle rows rotated by `latch_start % N`, so each vehicle in
turn is seen first; `latch_start` advances on each valid measurement), the
range reaches its requester only, and each vehicle's onboard logic and
offboard loop (on the true state; position commands by default, so the
vehicles fly on their onboard UWB navigation) finish the tick.

On CUDA tensors a rollout is one kernel launch: `fleet_rollout` the wind
build of the env rollout kernel (`cuda_rollout.fleet_rollout`, K5 built
with TICK_WIND, and with TICK_UWB too where the base has a network),
`uwb_fleet_rollout` the shared-network kernel
(`cuda_fleet_uwb.rollout`, K6). On CPU tensors they run the plain versions
here, tick by tick.

Randomness: the port's states have no PRNG key. A step takes the tick's
IMU unit normals `noise` (N, 2, 3) and gust unit normals `wind_noise`
(N, 3), and the network's four draws `uwb_draws` in `sim/uwb.draw`'s
order: (N, 4), a row per vehicle, for a wind fleet whose base has a
network; (4,) for the UWB fleet's shared one. A rollout takes them
pre-drawn, `noise` (N, n_steps, 2, 3), `wind_noise` (n_steps, N, 3) and
`uwb_draws` (N, n_steps, 4) or (n_steps, 4), or draws them from a
`torch.Generator` on the state's device in that order: the IMU noise, then
the gust normals, then the network's draws. The UWB fleet's base params
carry no network of their own (its network is the shared one).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from agrifly_tpu_torch import card_or_raise
from agrifly_tpu_torch.models import logic as onboard
from agrifly_tpu_torch.ops import fmath
from agrifly_tpu_torch.sim import env as env_mod
from agrifly_tpu_torch.sim import uwb as uwb_mod


class WindParams(NamedTuple):
    mean: torch.Tensor  # (3,) mean wind velocity [m/s]
    gust_std: torch.Tensor  # [m/s]
    gust_tau: torch.Tensor  # [s]
    force_gain: torch.Tensor  # [N/(m/s)] force per unit relative wind


def make_wind(mean=(2.0, 0.5, 0.0), gust_std=1.0, gust_tau=2.0, force_gain=0.02,
              device="cuda") -> WindParams:
    """The JAX package's defaults, on the card unless `device` names
    another (with no card the default raises)."""
    device = card_or_raise(device, "fleet_env.make_wind")
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return WindParams(mean=f32(tuple(mean)), gust_std=f32(gust_std), gust_tau=f32(gust_tau),
                      force_gain=f32(force_gain))


class FleetParams(NamedTuple):
    base: env_mod.EnvParams
    wind: WindParams


class FleetState(NamedTuple):
    envs: env_mod.EnvState  # leading axis = vehicle
    wind_vel: torch.Tensor  # (N, 3)


def _line(params: env_mod.EnvParams, n, spacing):
    """n vehicles at rest at (0, i spacing, 0) (each with its own network
    state where the params have a UWB network)."""
    dev = params.dt_us.device
    ys = torch.arange(n, dtype=torch.float32, device=dev) * spacing
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    return env_mod.init_state_fleet(params, torch.stack([z, ys, z], dim=1))


def init_fleet(params: FleetParams, n, spacing=2.0) -> FleetState:
    """N vehicles on a line, `spacing` apart, the gusts at the mean wind."""
    return FleetState(envs=_line(params.base, n, spacing),
                      wind_vel=params.wind.mean.expand(n, 3).clone())


def _gusts(params: env_mod.EnvParams, w: WindParams, wind_vel, vel, wind_noise):
    """The tick's gust velocities (N, 3) and the wind force on each vehicle."""
    dt = params.dt_us.to(torch.float32) * 1e-6
    wind_vel = (wind_vel + dt / w.gust_tau * (w.mean - wind_vel)
                + fmath.sqrt(2.0 * dt / w.gust_tau) * w.gust_std * wind_noise)
    return wind_vel, w.force_gain * (wind_vel - vel)


def _fleet_command(des_pos, ext_force) -> env_mod.Command:
    """Per-vehicle setpoints (N, 3), no feed-forward, no yaw, the wind force."""
    z3 = torch.zeros_like(ext_force)
    return env_mod.Command(des_pos=torch.as_tensor(des_pos, dtype=torch.float32,
                                                   device=ext_force.device).expand_as(z3),
                           des_vel=z3, des_acc=z3, des_yaw=z3[:, 0], ext_force=ext_force,
                           ext_torque=z3)


def fleet_step(params: FleetParams, s: FleetState, des_pos, use_estimator=True, noise=None,
               wind_noise=None, uwb_draws=None):
    """One 2 ms tick of the whole fleet: the gusts, then `env.step` (rates
    commands) under their force. des_pos: (N, 3) per-vehicle setpoints;
    noise: the tick's IMU normals (N, 2, 3); wind_noise: its gust normals
    (N, 3); uwb_draws: where the base has a UWB network, each vehicle's
    network draws (N, 4). Returns (state, outputs) with a leading vehicle
    axis."""
    if noise is None or wind_noise is None:
        raise ValueError("fleet_step needs the tick's IMU noise and gust normals")
    wind_vel, ext_force = _gusts(params.base, params.wind, s.wind_vel, s.envs.plant.vel,
                                 wind_noise)
    envs, outs = env_mod.step(params.base, s.envs, _fleet_command(des_pos, ext_force),
                              use_estimator, noise=noise, uwb_draws=uwb_draws)
    return FleetState(envs=envs, wind_vel=wind_vel), outs


def _draw(s_envs, n_steps, noise, wind_noise, gen):
    """The IMU noise (N, n_steps, 2, 3) and gust normals (n_steps, N, 3): as
    given, or drawn from gen (the noise first)."""
    n = s_envs.step.shape[0]
    dev = s_envs.step.device
    if (noise is None or wind_noise is None) and gen is None:
        raise ValueError("pass the IMU noise and gust normals or a torch.Generator (gen)")
    if noise is None:
        noise = torch.randn((n, n_steps, 2, 3), generator=gen, device=dev)
    if wind_noise is None:
        wind_noise = torch.randn((n_steps, n, 3), generator=gen, device=dev)
    for name, t, shape in (("noise", noise, (n, n_steps, 2, 3)),
                           ("wind_noise", wind_noise, (n_steps, n, 3))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"need {shape} float32 {name}, got {tuple(t.shape)} {t.dtype}")
    return noise, wind_noise


def _draw_uwb(base: env_mod.EnvParams, s_envs, n_steps, uwb_draws, gen):
    """Each vehicle's network draws (N, n_steps, 4) where the base has a UWB
    network (as given, or drawn from gen as `env.rollout` draws them), else
    None."""
    n = s_envs.step.shape[0]
    if base.uwb is not None and uwb_draws is None:
        if gen is None:
            raise ValueError("the base has a UWB network: pass its draws (uwb_draws) or a "
                             "torch.Generator (gen)")
        uwb_draws = uwb_mod.draw((n, n_steps), gen, s_envs.step.device)
    return env_mod._check_draws(base, uwb_draws, (n, n_steps, uwb_mod.N_DRAWS))


def fleet_rollout_plain(params: FleetParams, s: FleetState, des_pos, noise, wind_noise,
                        use_estimator=True, uwb_draws=None):
    """`fleet_step` over noise's n_steps ticks in plain torch, on any
    device (under torch.inference_mode); uwb_draws (N, n_steps, 4) where
    the base has a UWB network. The reference for K5's wind builds. Returns
    the final state."""
    with torch.inference_mode():
        for k in range(noise.shape[1]):
            s, _ = fleet_step(params, s, des_pos, use_estimator, noise[:, k], wind_noise[k],
                              None if uwb_draws is None else uwb_draws[:, k])
        return env_mod._tree_map(torch.Tensor.contiguous, s)


def fleet_rollout(params: FleetParams, s: FleetState, des_pos, n_steps: int,
                  use_estimator=True, noise=None, wind_noise=None, gen=None, uwb_draws=None):
    """`fleet_step` scanned n_steps times. noise (N, n_steps, 2, 3),
    wind_noise (n_steps, N, 3) and, where the base has a UWB network,
    uwb_draws (N, n_steps, 4), or drawn from gen in that order. CUDA
    tensors: one launch of the env rollout kernel's wind build (with the
    network, its TICK_WIND + TICK_UWB build); CPU tensors:
    `fleet_rollout_plain`. Returns (state, None), as the JAX package's scan
    does."""
    from agrifly_tpu_torch.sim import cuda_rollout

    noise, wind_noise = _draw(s.envs, n_steps, noise, wind_noise, gen)
    uwb_draws = _draw_uwb(params.base, s.envs, n_steps, uwb_draws, gen)
    return cuda_rollout.fleet_rollout(params, s, des_pos, noise, wind_noise, use_estimator,
                                      uwb_draws), None


# =============================================================================
# a fleet sharing one UWB ranging network (vehicle-to-vehicle and anchors)
# =============================================================================

class UwbFleetParams(NamedTuple):
    base: env_mod.EnvParams  # logic carries the anchor target table
    wind: WindParams
    uwb: uwb_mod.UwbParams  # radio table: vehicles first, then anchors
    vehicle_ids: torch.Tensor  # (N,) int32
    anchor_positions: torch.Tensor  # (A, 3)


class UwbFleetState(NamedTuple):
    envs: env_mod.EnvState  # leading axis = vehicle (no uwb leaf)
    wind_vel: torch.Tensor  # (N, 3)
    uwb: uwb_mod.UwbState  # the shared network
    latch_start: torch.Tensor  # int32 fairness rotation


def make_uwb_fleet_params(n_vehicles, anchor_ids, anchor_positions, wind=None,
                          comm_period=0.01, noise_std=0.05, device="cuda",
                          **env_kw) -> UwbFleetParams:
    """Vehicles 1..n_vehicles and the anchors in one radio table; the anchors
    are every vehicle's ranging targets. On the card unless `device` names
    another (with no card the default raises); env_kw go to
    `env.make_params`. wind: WindParams, calm by default."""
    base = env_mod.make_params(device=device, **env_kw)
    dev = base.dt_us.device
    base = base._replace(logic=onboard.with_ranging_targets(base.logic, anchor_ids,
                                                            anchor_positions))
    vehicle_ids = list(range(1, n_vehicles + 1))
    uwb_p = uwb_mod.make_params(vehicle_ids + list(anchor_ids), comm_period=comm_period,
                                noise_std=noise_std, device=dev)
    return UwbFleetParams(
        base=base,
        wind=wind if wind is not None else make_wind((0.0, 0.0, 0.0), 0.0, 2.0, 0.0, dev),
        uwb=uwb_p,
        vehicle_ids=torch.tensor(vehicle_ids, dtype=torch.int32, device=dev),
        anchor_positions=torch.tensor(anchor_positions, dtype=torch.float32,
                                      device=dev).reshape(-1, 3))


def init_uwb_fleet(params: UwbFleetParams, spacing=2.0) -> UwbFleetState:
    """The vehicles on a line, `spacing` apart; the network idle."""
    if params.base.uwb is not None:
        raise ValueError("a UWB fleet's base params carry no UWB network of their own")
    n = params.vehicle_ids.shape[0]
    dev = params.vehicle_ids.device
    return UwbFleetState(envs=_line(params.base, n, spacing),
                         wind_vel=params.wind.mean.expand(n, 3).clone(),
                         uwb=uwb_mod.init_state(dev),
                         latch_start=torch.zeros((), dtype=torch.int32, device=dev))


_ENV_DIMS = env_mod.EnvState(*(0,) * (len(env_mod.EnvState._fields) - 1), uwb=None)


def _phase_a(p, envs, ext_force, noise):
    """physics_phase_a of every vehicle (vmapped)."""
    z3 = torch.zeros(3, dtype=torch.float32, device=ext_force.device)
    return torch.func.vmap(lambda st, f, nz: env_mod.physics_phase_a(st, p, f, z3, nz),
                           in_dims=(_ENV_DIMS, 0, 0))(envs, ext_force, noise)


def _finish(p, envs, cmds, phase_a, override, ctrl_mode):
    """Each vehicle's logic (with its range override), estimate (the true
    state) and offboard loop after phase A (vmapped)."""
    def one(st, c, a, ov):
        z3 = torch.zeros(3, dtype=torch.float32, device=c.des_pos.device)
        half = env_mod.physics_tick(st, p, z3, z3, False, uwb_override=ov, phase_a=a)
        return env_mod._offboard_and_finish(p, st, c, half, False, ctrl_mode)

    return torch.func.vmap(one, in_dims=(_ENV_DIMS, 0, 0, 0),
                           out_dims=(_ENV_DIMS, 0))(envs, cmds, phase_a, override)


def uwb_fleet_step(params: UwbFleetParams, s: UwbFleetState, des_pos,
                   ctrl_mode: str = "position", noise=None, wind_noise=None, uwb_draws=None):
    """One 2 ms tick: the gusts, every plant's phase A, ONE shared ranging
    transaction step, then every vehicle's logic (the range to its
    requester only) and offboard loop on the true state. noise (N, 2, 3),
    wind_noise (N, 3), uwb_draws (4,): the tick's draws."""
    env_mod._check_modes(False, ctrl_mode)
    if noise is None or wind_noise is None or uwb_draws is None:
        raise ValueError("uwb_fleet_step needs the tick's IMU noise, gust normals and UWB draws")
    n = s.wind_vel.shape[0]
    p = params.base
    dev = s.wind_vel.device
    wind_vel, ext_force = _gusts(p, params.wind, s.wind_vel, s.envs.plant.vel, wind_noise)
    phase_a = _phase_a(p, s.envs, ext_force, noise)

    # the shared network over [vehicles..., anchors...], its vehicle rows
    # rotated by latch_start % n
    positions = torch.cat([phase_a["plant"].pos, params.anchor_positions], dim=0)
    veh_targets = torch.where(p.logic.num_targets > 0,
                              p.logic.target_ids[s.envs.logic.next_target_idx],
                              torch.zeros(n, dtype=torch.int32, device=dev))
    n_radios = params.uwb.radio_ids.shape[0]
    rot = (torch.arange(n, device=dev) + s.latch_start % n) % n  # jnp.roll(x, -roll)
    rows = torch.cat([rot, torch.arange(n, n_radios, device=dev)])
    next_all = torch.cat([veh_targets[rot],
                          torch.zeros(n_radios - n, dtype=torch.int32, device=dev)])
    uwb_rot = params.uwb._replace(radio_ids=params.uwb.radio_ids[rows])
    new_uwb, meas = uwb_mod.step(uwb_rot, s.uwb, positions[rows], next_all, p.dt_us, uwb_draws)
    latch_start = torch.where(meas.valid, s.latch_start + 1, s.latch_start)

    # the range reaches its requester only
    mine = params.vehicle_ids == meas.requester_id
    override = (mine & meas.valid, meas.range.expand(n), meas.responder_id.expand(n),
                meas.failure.expand(n))
    envs, outs = _finish(p, s.envs, _fleet_command(des_pos, ext_force), phase_a, override,
                         ctrl_mode)
    return UwbFleetState(envs=envs, wind_vel=wind_vel, uwb=new_uwb,
                         latch_start=latch_start), outs


def uwb_fleet_rollout_plain(params: UwbFleetParams, s: UwbFleetState, des_pos, noise,
                            wind_noise, uwb_draws, ctrl_mode: str = "position"):
    """`uwb_fleet_step` over noise's n_steps ticks in plain torch, on any
    device (under torch.inference_mode). The reference for K6. Returns the
    final state."""
    with torch.inference_mode():
        for k in range(noise.shape[1]):
            s, _ = uwb_fleet_step(params, s, des_pos, ctrl_mode, noise[:, k], wind_noise[k],
                                  uwb_draws[k])
        return env_mod._tree_map(torch.Tensor.contiguous, s)


def uwb_fleet_rollout(params: UwbFleetParams, s: UwbFleetState, des_pos, n_steps: int,
                      ctrl_mode: str = "position", noise=None, wind_noise=None,
                      uwb_draws=None, gen=None):
    """`uwb_fleet_step` scanned n_steps times. noise (N, n_steps, 2, 3),
    wind_noise (n_steps, N, 3) and uwb_draws (n_steps, 4), or drawn from gen
    in that order. CUDA tensors: one launch of K6; CPU tensors:
    `uwb_fleet_rollout_plain`. Returns (state, None), as the JAX package's
    scan does."""
    from agrifly_tpu_torch.sim import cuda_fleet_uwb

    noise, wind_noise = _draw(s.envs, n_steps, noise, wind_noise, gen)
    if uwb_draws is None:
        if gen is None:
            raise ValueError("pass the UWB draws or a torch.Generator (gen)")
        uwb_draws = uwb_mod.draw((n_steps,), gen, s.wind_vel.device)
    if tuple(uwb_draws.shape) != (n_steps, uwb_mod.N_DRAWS) or uwb_draws.dtype != torch.float32:
        raise ValueError(f"need ({n_steps}, {uwb_mod.N_DRAWS}) float32 UWB draws, got "
                         f"{tuple(uwb_draws.shape)} {uwb_draws.dtype}")
    return cuda_fleet_uwb.rollout(params, s, des_pos, noise, wind_noise, uwb_draws,
                                  ctrl_mode), None
