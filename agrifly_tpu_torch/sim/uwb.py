"""Simulated ultra-wideband ranging network.

Port of `agrifly_tpu/sim/uwb.py` (UWB{Radio,Network}.{hpp,cpp}): radios are
rows of a position table (vehicles first, then fixed anchors); the network
runs one ranging transaction per communication period in two phases (latch
a requester/responder pair, then complete the measurement one period
later) and broadcasts the result. Gaussian range noise, an outlier branch,
reported failures, and silence beyond `max_range`.

Randomness: the port's `UwbState` has no PRNG key. `step` takes the tick's
four draws as a (4,) tensor `draws`: u_outlier (uniform [0, 1)),
n_outlier and n_noise (unit normals) and u_fail (uniform), the values the
JAX package takes from its key in that order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from agrifly_tpu_torch.ops.fmath import norm3

N_DRAWS = 4  # u_outlier, n_outlier, n_noise, u_fail


class UwbParams(NamedTuple):
    comm_period_us: torch.Tensor  # int32
    noise_std: torch.Tensor  # f32 range noise
    outlier_prob: torch.Tensor  # f32
    outlier_std: torch.Tensor  # f32
    radio_ids: torch.Tensor  # (R,) int32: vehicles then anchors; 0 = unused slot
    num_radios: torch.Tensor  # int32
    failure_prob: torch.Tensor  # f32: the transaction completes but is reported failed
    max_range: torch.Tensor  # f32: beyond it the responder never hears (silence)


class UwbState(NamedTuple):
    acc_us: torch.Tensor  # int32 accumulator since the last network action
    pending: torch.Tensor  # bool: a transaction is latched
    requester_id: torch.Tensor  # int32
    responder_id: torch.Tensor  # int32


class UwbMeasurement(NamedTuple):
    valid: torch.Tensor  # bool: a broadcast happened this step
    range: torch.Tensor  # f32
    responder_id: torch.Tensor  # int32
    requester_id: torch.Tensor  # int32 (who initiated the two-way ranging)
    failure: torch.Tensor  # bool


def make_params(radio_ids, comm_period=0.01, noise_std=0.0, outlier_prob=0.0,
                outlier_std=0.0, failure_prob=0.0, max_range=math.inf, device=None) -> UwbParams:
    """failure_prob: the probability that a completed transaction is
    reported failed (onboard skips the update). max_range: a transaction
    whose true range exceeds it never completes."""
    ids = np.asarray(radio_ids, np.int32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    return UwbParams(comm_period_us=i32(round(comm_period * 1e6)), noise_std=f32(noise_std),
                     outlier_prob=f32(outlier_prob), outlier_std=f32(outlier_std),
                     radio_ids=torch.from_numpy(ids).to(device), num_radios=i32(len(ids)),
                     failure_prob=f32(failure_prob), max_range=f32(max_range))


def init_state(device=None) -> UwbState:
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    return UwbState(acc_us=i0, pending=torch.zeros((), dtype=torch.bool, device=device),
                    requester_id=i0, responder_id=i0)


def draw(shape, gen=None, device=None):
    """(*shape, 4) float32 draws: uniforms by torch.rand and normals by
    torch.randn from gen, in the order the module docstring gives."""
    u = torch.rand(tuple(shape) + (2,), generator=gen, device=device)
    n = torch.randn(tuple(shape) + (2,), generator=gen, device=device)
    return torch.stack([u[..., 0], n[..., 0], n[..., 1], u[..., 1]], dim=-1)


def _first(mask):
    """The index of the first True of a 1-d mask (0 where none is)."""
    return torch.argmax(mask.to(torch.int32))


def step(p: UwbParams, s: UwbState, positions, next_target_ids, dt_us, draws):
    """One network tick. positions: (R, 3) true radio positions (the anchor
    rows static); next_target_ids: (R,) int32, each radio's desired ranging
    target (0 = none; anchors pass 0); draws: (4,) float32 (module
    docstring). Returns (state, UwbMeasurement)."""
    acc = torch.clamp(s.acc_us + dt_us, max=10 ** 8)
    due = acc >= p.comm_period_us
    slot_used = torch.arange(p.radio_ids.shape[0], device=acc.device) < p.num_radios

    # phase 1: latch the first radio that wants to range
    wants = slot_used & (next_target_ids != 0)
    any_wants = torch.any(wants)
    first = _first(wants)
    zero = torch.zeros_like(s.requester_id)
    latch_req = torch.where(any_wants, p.radio_ids[first], zero)
    latch_res = torch.where(any_wants, next_target_ids[first], zero)

    # phase 2: complete the pending transaction
    req_match = slot_used & (p.radio_ids == s.requester_id)
    res_match = slot_used & (p.radio_ids == s.responder_id)
    have_both = torch.any(req_match) & torch.any(res_match)
    req_pos = positions[_first(req_match)]
    res_pos = positions[_first(res_match)]

    is_outlier = draws[0] < p.outlier_prob
    outlier_range = draws[1] * p.outlier_std
    true_range = norm3(req_pos - res_pos)
    noisy_range = true_range + draws[2] * p.noise_std
    meas_range = torch.where(is_outlier, outlier_range, noisy_range)

    # out-of-range radios never hear each other: no broadcast, so the
    # onboard timeout panics can fire; in range, a transaction can still be
    # reported failed
    in_range = true_range <= p.max_range
    failed = draws[3] < p.failure_prob

    complete = due & s.pending & have_both & in_range
    finish = due & s.pending  # cleared even if a party vanished
    latch = due & ~s.pending  # a latch attempt (resets the period timer)
    meas = UwbMeasurement(
        valid=complete,
        range=torch.where(complete & ~failed, meas_range, torch.zeros_like(meas_range)),
        responder_id=torch.where(complete, s.responder_id, zero),
        requester_id=torch.where(complete, s.requester_id, zero),
        failure=complete & failed)

    # completing does not reset the period timer (UWBNetwork.cpp:49-90); only
    # a latch does, so transactions complete once per period
    new_state = UwbState(
        acc_us=torch.where(latch, torch.zeros_like(acc), acc),
        pending=torch.where(latch, any_wants, s.pending & ~finish),
        requester_id=torch.where(latch, latch_req, torch.where(finish, zero, s.requester_id)),
        responder_id=torch.where(latch, latch_res, torch.where(finish, zero, s.responder_id)))
    return new_state, meas
