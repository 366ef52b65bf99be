"""The env rollout through the hand-written CUDA kernel K5.

The counterpart of the JAX package's `jax.vmap` of `sim/env.py::rollout_fast`
(jnp under jit, vmap and scan: it reaches no pallas_call), the workload
`bench.py` times. `rollout` runs `csrc/rollout.cu` on CUDA tensors: one
launch advances B envs (a leading B on every state leaf, or one env)
through the noise block's n_steps ticks of `env.step` and writes the final
state and the (B, n_steps, ...) `StepOutputs` trajectory, in every
estimator mode (the launch takes it as `EST`'s int). The kernel takes each
tick's cadences from the accumulators, as `env.rollout` does, so it serves
`env.rollout` and `env.rollout_fast` alike. UWB is a variant of the build:
a state with a `uwb` leaf (params built by `env.with_uwb_anchors`) runs
`rollout.cu` built with TICK_UWB, which also steps the ranging network on
the UWB draws and runs the onboard range update. A group of `GROUP` lanes
runs each env (the kernel is built for each of `GROUPS`, and every group
size gives the same values bit for bit). On CPU tensors it runs the plain
version: `env.rollout_plain`, with `env.fast_flags` for `rollout_fast`.
Wind is another build variant: `fleet_rollout` runs `sim/fleet_env`'s wind
fleet (`fleet_env.fleet_rollout`) through `rollout.cu` built with
TICK_WIND, which carries each vehicle's gust velocity and runs the gust
process and its force in front of every tick; a wind fleet whose base has
a UWB network runs the build with both TICK_WIND and TICK_UWB (on CPU
tensors, `fleet_env.fleet_rollout_plain`).
`tick_block` is the topic bridge's block of ticks (`io/bridge.SimBridge`):
one launch of the kernel's wire-row instance, which writes each tick's
(64,) wire row in place of the trajectory and runs the telemetry encode on
the ticks a mask selects; on CPU tensors `tick_block_plain`.

The kernel reads each state and parameter leaf through its own device
pointer, and a command leaf shared by the fleet through a stride of 0. It
writes every state leaf and the trajectory into two flat buffers (float32;
int32 with the bool leaves' bytes at its end); the returned leaves are
views into them. `tick.cuh` declares the leaves in X-macro tables (the UWB
variant's in two more), and every call is held to them: a state or parameter
tree is checked in full the first time, and later calls with the same tree
(the last one accepted) compare only each leaf's version counter and data
pointer, which an in-place change of shape, dtype or layout, or a
rebinding to other memory moves (a new tensor makes a new tree). The
pointer tables are built once per accepted tree. A chain of tick blocks
hands each call the tree the last one returned: `tick_block` keeps its own
output tree, whose views it made, and accepts it again by its leaves' data
pointers (and version counters, where they keep any) without the full check.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import NamedTuple

import torch

from agrifly_tpu_torch import convert, cuda_build
from agrifly_tpu_torch.io import telemetry as tel_codec
from agrifly_tpu_torch.ops import filters
from agrifly_tpu_torch.ops import rotation as rot_ops
from agrifly_tpu_torch.sim import env as env_mod
from agrifly_tpu_torch.sim import uwb as uwb_mod

CTRL = {"rates": 0, "position": 1, "idle": 2}
EST = {"true": 0, "mocap": 1, "gpsimu": 2}  # env._est_mode's name -> the launch's est
UWB_DEFINES = ("TICK_UWB",)  # the build of the UWB variant
WIND_DEFINES = ("TICK_WIND",)  # the build of the wind fleet
MAX_RADIOS = 33  # tick.cuh's radio table: the vehicle and up to 32 anchors
GROUPS = (1, 2, 4, 8)  # lanes per env that rollout.cu is built for
GROUP = 8  # the default: the fastest measured at bench.py's shape (PERF.md)
TRAJ_WIDTHS = (3, 3, 4, 3, 4)  # the float trajectory leaves' last axis; then 3 int32 leaves
ROW_WORDS = 64  # a tick's wire row (rollout.cu's kRowWords; io/bridge.py's _TB_* layout)
TICK_BLOCK_GROUP = 8  # lanes an env in the wire-row instance (rollout.cu's kTickBlockGroup)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_TICK_BLOCK_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_version = operator.attrgetter("_version")
_data_ptr = torch.Tensor.data_ptr


@functools.lru_cache(maxsize=None)
def leaf_table(uwb=False, wind=False):
    """(state leaves, parameter leaves) as `tick.cuh` declares them (with
    uwb, the UWB variant's; with wind, the wind fleet's). The kernel writes
    every state leaf."""
    state, params = cuda_build.leaf_rows("tick.cuh", uwb=uwb, wind=wind)
    return tuple(s._replace(written=True) for s in state), tuple(params)


def param_leaves(params):
    """The parameter tensors the kernel reads, in its table's order: a UWB
    radio table (`radio_ids`) padded with unused slots to MAX_RADIOS."""
    return [_padded_radios(t) if path[-1] == "radio_ids" else t
            for path, t in convert.leaves(params)]


def _padded_radios(ids):
    if ids.dim() == 1 and ids.numel() < MAX_RADIOS:
        return torch.cat([ids, ids.new_zeros(MAX_RADIOS - ids.numel())])
    return ids


def fleet_draw_words(wind_noise, uwb_draws=None):
    """A wind fleet's draws as K5 reads them, (N, n_steps, words): for each
    tick the UWB draws `uwb_draws` ((N, n_steps, 4); where the base has a
    network), then the gust normals `wind_noise` ((n_steps, N, 3))."""
    gusts = wind_noise.transpose(0, 1)
    return (gusts if uwb_draws is None else torch.cat([uwb_draws, gusts], dim=2)).contiguous()


@functools.lru_cache(maxsize=None)
def _launcher(uwb=False, wind=False):
    fn = cuda_build.load("rollout", (UWB_DEFINES if uwb else ())
                         + (WIND_DEFINES if wind else ())).env_rollout_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tick_block_launcher(uwb=False):
    fn = cuda_build.load("rollout", UWB_DEFINES if uwb else ()).env_tick_block_launch
    fn.argtypes = _TICK_BLOCK_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _runs(uwb=False, wind=False):
    """The state leaves of each dtype as rollout.cu lays them out in its
    output buffer: ordered by elements per env (table order among equals),
    in runs [(elements per env, [leaf indices])]; and each buffer's
    elements per env."""
    specs, _ = leaf_table(uwb, wind)
    runs = {}
    for ty in cuda_build._DTYPES.values():
        rows = sorted((max(s.numel, 1), i) for i, s in enumerate(specs)
                      if s.written and s.dtype == ty)
        runs[ty] = [(n, [i for m, i in rows if m == n]) for n in sorted({n for n, _ in rows})]
    return runs, {ty: sum(n * len(idx) for n, idx in r) for ty, r in runs.items()}


class _Accepted(NamedTuple):
    """A tree whose leaves passed the full check: the tree (kept, so its
    leaves' ids are not reused), its leaves, rebuild, and each leaf's
    version counter and data pointer then; `table`: the ctypes pointer
    array the launch takes (for the parameters, of `host`, the leaves'
    copies in host memory, which the launch packs into the kernel's
    argument); `reshape`: for a state, {B: the written leaves (index,
    shape) that the output runs do not shape}, filled at its first launch.
    `versions` is None for a tree with an inference tensor."""
    tree: object
    leaves: list
    rebuild: object
    versions: list
    ptrs: list
    device: torch.device
    table: object
    host: list
    reshape: dict


_accepted = {}  # the last accepted tree of each kind, and "own": tick_block's last output


def _pointer_table(ptrs):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _versions(leaves):
    """Each leaf's version counter, or None where a leaf keeps none (an
    inference tensor, such as the plain rollout's outputs): such a tree is
    checked in full at every call."""
    try:
        return list(map(_version, leaves))
    except RuntimeError:
        return None


def _accept(kind, tree, device, check):
    """The accepted entry of `tree` ("state" or "params"): the last one if
    it is the same tree on the same device and its leaves have not moved,
    else the tree checked in full by check(leaves) (which raises); a new
    parameter entry copies the leaves, as the kernel's table has them
    (`param_leaves`), to the host (a device sync, once per parameter tree
    and after any in-place change to it)."""
    entry = _accepted.get(kind)
    if (entry is not None and entry.versions is not None and entry.tree is tree
            and entry.device == device and _versions(entry.leaves) == entry.versions
            and list(map(_data_ptr, entry.leaves)) == entry.ptrs):
        return entry
    own = _accepted.get("own") if kind == "state" else None
    if (own is not None and own.tree is tree and own.device == device
            and list(map(_data_ptr, own.leaves)) == own.ptrs
            and (own.versions is None or _versions(own.leaves) == own.versions)):
        return own
    leaves, rebuild = convert.flatten_tensors(tree)
    kernel_leaves = param_leaves(tree) if kind == "params" else leaves
    check(kernel_leaves)
    ptrs = list(map(_data_ptr, leaves))
    host = [t.cpu() for t in kernel_leaves] if kind == "params" else []
    entry = _Accepted(tree, leaves, rebuild, _versions(leaves), ptrs, device,
                      _pointer_table(list(map(_data_ptr, host)) if host else ptrs), host, {})
    _accepted[kind] = entry
    return entry


def _command(cmd, B, device):
    """The command's six leaves (float32, contiguous) and their strides
    between envs: 0 for a leaf the fleet shares, else its row length."""
    n = 1 if B is None else B
    leaves, strides = [], []
    for name, t, base in zip(env_mod.Command._fields, cmd, env_mod._BASE_DIMS):
        t = torch.as_tensor(t, dtype=torch.float32)
        per_env = B is not None and t.dim() == base + 1 and t.shape[0] == n
        if (t.device != device or tuple(t.shape[per_env:]) != (3,) * base
                or (t.dim() != base and not per_env)):
            raise ValueError(f"command leaf {name}: {t.dtype} {tuple(t.shape)} on {t.device}; "
                             f"rollout.cu takes float32 ({'' if B is None else f'{B}, '}"
                             f"{'3' * base}) or a shared ({'3' * base}) on {device}")
        leaves.append(t.contiguous())
        strides.append(3 ** base if per_env else 0)
    return leaves, strides


def _outputs(state, B, traj_rows, uwb=False, wind=False, dev=None):
    """The output buffers of a launch on B envs (`state`: the accepted
    entry) that writes `traj_rows` trajectory rows: (f_buf, i_buf, the new
    state's leaves, the float trajectory's parts, the int32 trajectory's
    parts), the leaves and parts views of the two buffers (bools in the
    int buffer's tail), which the kernel fills."""
    runs, per_env = _runs(uwb, wind)
    f_state, i_state = B * per_env[torch.float32], B * per_env[torch.int32]
    f_buf = torch.empty(f_state + traj_rows * sum(TRAJ_WIDTHS), dtype=torch.float32, device=dev)
    i_words = i_state + 3 * traj_rows
    i_buf = torch.empty(i_words + (B * per_env[torch.bool] + 3) // 4, dtype=torch.int32,
                        device=dev)
    f_part, *traj_f = f_buf.split([f_state] + [traj_rows * w for w in TRAJ_WIDTHS])
    i_part, *traj_i, _ = i_buf.split([i_state] + [traj_rows] * 3 + [i_buf.numel() - i_words])
    b_part = i_buf.view(torch.uint8)[4 * i_words:4 * i_words + B * per_env[torch.bool]]
    new = list(state.leaves)
    for ty, part in ((torch.float32, f_part), (torch.int32, i_part),
                     (torch.bool, b_part.view(torch.bool))):
        for (k, idx), run in zip(runs[ty], part.split([B * k * len(idx) for k, idx in runs[ty]])):
            for i, t in zip(idx, run.view((len(idx), B, k) if k > 1 else (len(idx), B)).unbind()):
                new[i] = t
    if B not in state.reshape:
        state.reshape[B] = [(i, old.shape) for i, (t, old) in enumerate(zip(new, state.leaves))
                            if t is not old and t.shape != old.shape]
    for i, shape in state.reshape[B]:
        new[i] = new[i].view(shape)
    return f_buf, i_buf, new, traj_f, traj_i


def _inputs(state, params, cmd, noise, draws):
    """The launch functions' leading arguments: the state's and params'
    pointer tables, the command's and its strides, the noise, the draws."""
    cmd_leaves, cmd_strides = cmd
    return (state.table, params.table, _pointer_table(list(map(_data_ptr, cmd_leaves))),
            (ctypes.c_int * 6)(*cmd_strides), noise.data_ptr(),
            None if draws is None else draws.data_ptr())


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None


def _launch(state, params, cmd, noise, est, ctrl, group=None, launcher=None, draws=None,
            uwb=False, wind=False):
    """Run the kernel on B envs (`state`, `params`: accepted entries with a
    leading B on every state leaf, or one env with none; `cmd`: `_command`'s
    leaves and strides; noise (B, n_steps, 2, 3); est: a use_estimator; draws:
    the UWB variant's (B, n_steps, 4) with uwb, the wind build's
    `fleet_draw_words` with wind, None for the other build) with
    `group` lanes per env (GROUP by default; chip_smoke.py and the card
    tests run every one of GROUPS) through `launcher` (the variant's default
    build's env_rollout_launch, or another build's); returns (the new
    state's leaves, the trajectory's leaves)."""
    group = GROUP if group is None else group
    fn = launcher or _launcher(uwb, wind)
    B, n = noise.shape[:2]
    dev = noise.device
    f_buf, i_buf, new, traj_f, traj_i = _outputs(state, B, B * n, uwb, wind, dev)
    status = fn(*_inputs(state, params, cmd, noise, draws), f_buf.data_ptr(), i_buf.data_ptr(),
                B, n, EST[env_mod._est_mode(est)], CTRL[ctrl], group, _stream(dev))
    cuda_build.check(status, "env_rollout_launch")
    (fleet_rollout if wind else rollout).launches += 1
    traj = ([t.view(B, n, w) for t, w in zip(traj_f, TRAJ_WIDTHS)]
            + [t.view(B, n) for t in traj_i])
    return new, traj


def _launch_rows(state, params, cmd, noise, est, ctrl, fire_tel, launcher=None, draws=None,
                 uwb=False):
    """Run the wire-row instance (env_tick_block_launch; `launcher`: another
    build's) on B envs: `_launch`'s arguments but `group` and `wind`, and
    the telemetry mask `fire_tel` ((n_steps,) int8, contiguous). Returns
    (the new state's leaves, the (B, n_steps, ROW_WORDS) rows)."""
    fn = launcher or _tick_block_launcher(uwb)
    B, n = noise.shape[:2]
    dev = noise.device
    f_buf, i_buf, new, _, _ = _outputs(state, B, 0, uwb, False, dev)  # it writes no trajectory
    rows = torch.empty((B, n, ROW_WORDS), dtype=torch.float32, device=dev)
    status = fn(*_inputs(state, params, cmd, noise, draws), fire_tel.data_ptr(),
                f_buf.data_ptr(), i_buf.data_ptr(), rows.data_ptr(), B, n,
                EST[env_mod._est_mode(est)], CTRL[ctrl], _stream(dev))
    cuda_build.check(status, "env_tick_block_launch")
    tick_block.launches += 1
    return new, rows


def _check_noise(noise, B):
    n_dims = 3 if B is None else 4
    if (noise.dim() != n_dims or tuple(noise.shape[-2:]) != (2, 3)
            or noise.dtype != torch.float32 or (B is not None and noise.shape[0] != B)):
        raise ValueError(f"need {'' if B is None else f'({B}, '}n_steps, 2, 3) float32 noise, "
                         f"got {tuple(noise.shape)} {noise.dtype}")


def _accept_env(params, state, device, B, uwb):
    """The accepted (state, params) entries of an env call, held to
    tick.cuh's tables."""
    state_specs, param_specs = leaf_table(uwb)
    s_entry = _accept("state", state, device, lambda leaves: cuda_build.check_leaves(
        state_specs, leaves, device, "state", B, "tick.cuh"))
    p_entry = _accept("params", params, device, lambda leaves: cuda_build.check_leaves(
        param_specs, leaves, device, "params", None, "tick.cuh"))
    return s_entry, p_entry


def _check_uwb(params, state):
    uwb = params.uwb is not None
    if uwb != (state.uwb is not None):
        raise ValueError("UWB: the params have a network and the state none, or the reverse "
                         "(make the state with env.init_state of the params)")
    return uwb


def rollout(params, state, cmd, noise, use_estimator=False, ctrl_mode="rates", fast=False,
            entry_phase=None, uwb_draws=None):
    """Advance `state` (an `env.EnvState`, one env or a fleet of B) by the
    ticks of `noise` ((n_steps, 2, 3), a fleet (B, n_steps, 2, 3), float32
    unit normals: gyro, acc) under the command `cmd` (leaves shared or with
    a leading B); with anchors, `uwb_draws` ((..., n_steps, 4) float32) are
    the network's draws. Returns (state, traj) as `env.rollout` does.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version (fast: `rollout_fast`'s, with entry_phase). Every call is
    checked against tick.cuh's leaf tables."""
    env_mod._check_modes(use_estimator, ctrl_mode)
    B = env_mod._fleet_size(state)
    _check_noise(noise, B)
    uwb = _check_uwb(params, state)
    draws = env_mod._check_draws(params, uwb_draws, noise.shape[:-2] + (uwb_mod.N_DRAWS,))
    device = noise.device
    s_entry, p_entry = _accept_env(params, state, device, B, uwb)
    if not noise.is_cuda:
        flags = env_mod.fast_flags(params, state, noise.shape[-3], entry_phase) if fast else None
        return env_mod.rollout_plain(params, state, cmd, noise, use_estimator, ctrl_mode, flags,
                                     draws)

    noise = noise.contiguous()
    if draws is not None:
        draws = draws.to(device).contiguous()
        draws = draws if B is not None else draws[None]
    new, traj = _launch(s_entry, p_entry, _command(cmd, B, device),
                        noise if B is not None else noise[None], use_estimator, ctrl_mode,
                        draws=draws, uwb=uwb)
    if B is None:
        traj = [t[0] for t in traj]
    return s_entry.rebuild(new), env_mod.StepOutputs(*traj)


rollout.launches = 0  # kernel launches since the last reset (the env builds')


def tick_block(params, state, cmd, noise, fire_tel, use_estimator, ctrl_mode="rates",
               uwb_draws=None):
    """The topic bridge's block of ticks: advance `state` (one env, or a
    fleet of B) by the ticks of `noise` ((n_steps, 2, 3), a fleet's (B,
    n_steps, 2, 3), float32) under `cmd`, running the telemetry encode
    (io/telemetry.encode_from_logic, which advances the packet counter and
    clears the warnings) after each tick that `fire_tel` ((n_steps,) int8
    or bool, on the noise's device) selects; with anchors, `uwb_draws`
    ((..., n_steps, 4)) are the network's draws. Returns (state, rows):
    each tick's wire row ((n_steps, ROW_WORDS), a fleet's (B, n_steps,
    ROW_WORDS) float32, io/bridge.py's _TB_* layout) from the state after
    it and after its encode.

    CUDA tensors: one launch of K5's wire-row instance (counted in
    `tick_block.launches`), nothing read back, or it raises; CPU tensors
    take `tick_block_plain`. Every call is checked against tick.cuh's leaf
    tables, but the tree this wrapper returned last, which it accepts
    again as it made it."""
    env_mod._check_modes(use_estimator, ctrl_mode)
    B = env_mod._fleet_size(state)
    _check_noise(noise, B)
    n = noise.shape[-3]
    if (fire_tel.dim() != 1 or fire_tel.shape[0] != n
            or fire_tel.dtype not in (torch.int8, torch.bool) or fire_tel.device != noise.device):
        raise ValueError(f"need a ({n},) int8 or bool telemetry mask on {noise.device}, got "
                         f"{tuple(fire_tel.shape)} {fire_tel.dtype} on {fire_tel.device}")
    uwb = _check_uwb(params, state)
    draws = env_mod._check_draws(params, uwb_draws, noise.shape[:-2] + (uwb_mod.N_DRAWS,))
    device = noise.device
    s_entry, p_entry = _accept_env(params, state, device, B, uwb)
    if not noise.is_cuda:
        return tick_block_plain(params, state, cmd, noise, fire_tel, use_estimator, ctrl_mode,
                                draws)

    if draws is not None:
        draws = draws.contiguous()
        draws = draws if B is not None else draws[None]
    noise = noise.contiguous()
    new, rows = _launch_rows(s_entry, p_entry, _command(cmd, B, device),
                             noise if B is not None else noise[None], use_estimator, ctrl_mode,
                             fire_tel.contiguous().view(torch.int8), draws=draws, uwb=uwb)
    out = s_entry.rebuild(new)
    ptrs = list(map(_data_ptr, new))
    _accepted["own"] = s_entry._replace(tree=out, leaves=new, versions=_versions(new), ptrs=ptrs,
                                        table=_pointer_table(ptrs))
    return out, rows if B is not None else rows[0]


tick_block.launches = 0  # wire-row instance launches since the last reset


def wire_tick(params, state, cmd, noise, fire, use_estimator, ctrl_mode="rates",
              uwb_draws=None):
    """One tick of tick_block_plain, a function of tensors alone (so that a
    CUDA graph can capture it): `env.step`, then `encode_from_logic` on its
    logic, taken where the 0-d `fire` (int8 or bool) is set (torch.where
    over every logic leaf and the row's codes; nothing is read back), then
    the tick's wire row from the state after both. Returns (state, row)."""
    s, out = env_mod.step(params, state, cmd, use_estimator, ctrl_mode, noise=noise,
                          uwb_draws=uwb_draws)
    on = fire.bool()
    pkts, encoded = tel_codec.encode_from_logic(s.logic)
    kept, rebuild = convert.flatten_tensors(s.logic)
    s = s._replace(logic=rebuild([torch.where(on, a, b) for a, b in
                                  zip(convert.flatten_tensors(encoded)[0], kept)]))
    codes = torch.cat([pkts.packet_number[..., None], pkts.data1, pkts.data2],
                      dim=-1).to(torch.float32)
    m = s.mocap
    return s, torch.cat([
        out.pos, out.vel, out.att, out.angvel,
        filters.lp2_value(s.logic.acc_lp), filters.lp2_value(s.logic.gyro_lp),
        rot_ops.rotate_back(out.att, out.vel),
        m.pos, m.vel, m.att, m.angvel, torch.where(on, codes, torch.zeros_like(codes))], dim=-1)


@torch.inference_mode()
def tick_block_plain(params, state, cmd, noise, fire_tel, use_estimator, ctrl_mode="rates",
                     uwb_draws=None):
    """tick_block's plain version: `wire_tick` over the block's ticks, on
    any device."""
    s, rows = state, []
    for i in range(noise.shape[-3]):
        s, row = wire_tick(params, s, cmd, noise[..., i, :, :], fire_tel[i], use_estimator,
                           ctrl_mode, None if uwb_draws is None else uwb_draws[..., i, :])
        rows.append(row)
    return s, torch.stack(rows, dim=-2) if rows else torch.zeros(
        noise.shape[:-3] + (0, ROW_WORDS), device=noise.device)


def fleet_rollout(params, state, des_pos, noise, wind_noise, use_estimator=True,
                  uwb_draws=None):
    """Advance a wind fleet (`fleet_env.FleetParams`, `FleetState` of N
    vehicles) by the ticks of `noise` ((N, n_steps, 2, 3) float32) under
    the gust normals `wind_noise` ((n_steps, N, 3)), rates commands to the
    setpoints des_pos ((N, 3) or a shared (3,)); where the base has a UWB
    network, `uwb_draws` ((N, n_steps, 4) float32) are each vehicle's
    network draws. Returns the final state.

    CUDA tensors launch K5's wind build (or raise), with the network its
    TICK_WIND + TICK_UWB build: one launch, counted in
    `fleet_rollout.launches`; CPU tensors take
    `fleet_env.fleet_rollout_plain`. Every call is checked against
    tick.cuh's leaf tables."""
    from agrifly_tpu_torch.sim import fleet_env

    env_mod._check_modes(use_estimator, "rates")
    uwb = params.base.uwb is not None
    if uwb != (state.envs.uwb is not None):
        raise ValueError("UWB: the base params have a network and the vehicles none, or the "
                         "reverse (make the state with fleet_env.init_fleet of the params)")
    B = state.wind_vel.shape[0]
    if (noise.dim() != 4 or tuple(noise.shape[-2:]) != (2, 3) or noise.shape[0] != B
            or noise.dtype != torch.float32):
        raise ValueError(f"need ({B}, n_steps, 2, 3) float32 noise, got "
                         f"{tuple(noise.shape)} {noise.dtype}")
    n = noise.shape[1]
    if tuple(wind_noise.shape) != (n, B, 3) or wind_noise.dtype != torch.float32:
        raise ValueError(f"need ({n}, {B}, 3) float32 gust normals, got "
                         f"{tuple(wind_noise.shape)} {wind_noise.dtype}")
    draws = env_mod._check_draws(params.base, uwb_draws, (B, n, uwb_mod.N_DRAWS))
    state_specs, param_specs = leaf_table(uwb, wind=True)
    device = noise.device
    s_entry = _accept("state", state, device, lambda leaves: cuda_build.check_leaves(
        state_specs, leaves, device, "state", B, "tick.cuh"))
    p_entry = _accept("params", params, device, lambda leaves: cuda_build.check_leaves(
        param_specs, leaves, device, "params", None, "tick.cuh"))
    if not noise.is_cuda:
        return fleet_env.fleet_rollout_plain(params, state, des_pos, noise, wind_noise,
                                             use_estimator, draws)
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    cmd = env_mod.Command(des_pos=torch.as_tensor(des_pos, dtype=torch.float32), des_vel=z3,
                          des_acc=z3, des_yaw=z3[0], ext_force=z3, ext_torque=z3)
    words = fleet_draw_words(wind_noise.to(device), None if draws is None else draws.to(device))
    new, _ = _launch(s_entry, p_entry, _command(cmd, B, device), noise.contiguous(),
                     use_estimator, "rates", draws=words, wind=True, uwb=uwb)
    return s_entry.rebuild(new)


fleet_rollout.launches = 0  # the wind builds' launches since the last reset
