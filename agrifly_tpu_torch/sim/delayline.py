"""Fixed-size FIFO modeling radio transport latency.

Port of `agrifly_tpu/sim/delayline.py` (CommunicationsDelay.hpp:10-52): a
ring of static capacity whose messages become visible `delay` after being
pushed. Slots are addressed with one-hot masks, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CAPACITY = 32


class RadioRing(NamedTuple):
    types: torch.Tensor  # (K,) int32
    flags: torch.Tensor  # (K,) int32
    fields: torch.Tensor  # (K, 10) int32
    send_step: torch.Tensor  # (K,) int32
    head: torch.Tensor  # int32
    count: torch.Tensor  # int32


def init(device=None) -> RadioRing:
    z = torch.zeros(CAPACITY, dtype=torch.int32, device=device)
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    return RadioRing(types=z, flags=z, fields=torch.zeros((CAPACITY, 10), dtype=torch.int32,
                                                          device=device),
                     send_step=z, head=i0, count=i0)


def _onehot(idx):
    return torch.arange(CAPACITY, dtype=torch.int32, device=idx.device) == idx


def push(ring: RadioRing, msg_type, msg_flags, msg_fields, step, do_push):
    """Append a message (dropped silently if full, like a saturated radio)."""
    slot = (ring.head + ring.count) % CAPACITY
    can = do_push & (ring.count < CAPACITY)
    si = _onehot(slot) & can
    return ring._replace(
        types=torch.where(si, msg_type, ring.types),
        flags=torch.where(si, msg_flags, ring.flags),
        fields=torch.where(si[:, None], msg_fields[None, :], ring.fields),
        send_step=torch.where(si, step, ring.send_step),
        count=ring.count + can.to(torch.int32),
    )


def pop_due(ring: RadioRing, step, dt_us, delay_us):
    """Pop the front message if its transport delay has elapsed.

    Returns (ring, delivered: bool, type, flags, fields)."""
    has = ring.count > 0
    front = _onehot(ring.head)
    zero = torch.zeros_like(ring.types)
    front_send = torch.where(front, ring.send_step, zero).sum(dtype=torch.int32)
    due = has & ((step - front_send) * dt_us > delay_us)
    mtype = torch.where(front, ring.types, zero).sum(dtype=torch.int32)
    mflags = torch.where(front, ring.flags, zero).sum(dtype=torch.int32)
    mfields = torch.where(front[:, None], ring.fields, 0).sum(0, dtype=torch.int32)
    new_ring = ring._replace(
        head=torch.where(due, (ring.head + 1) % CAPACITY, ring.head),
        count=torch.where(due, ring.count - 1, ring.count),
    )
    return new_ring, due, mtype, mflags, mfields
