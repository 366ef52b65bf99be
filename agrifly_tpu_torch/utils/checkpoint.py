"""Checkpoint / resume: snapshot the whole sim as one tree of tensors.

The reference has no checkpointing (SURVEY.md §5); its closest artifact is
CSV logs. The port keeps the whole simulation (plant, onboard logic,
estimators, radio rings, planner state) in one NamedTuple tree of tensors,
so a snapshot is that tree's leaves. `torch.save` writes them, and
`torch.load(weights_only=True)` reads them back.

Port of `agrifly_tpu/utils/checkpoint.py`, which saves with orbax. The JAX
state carries its PRNG key; the port's draws come from a
`torch.Generator`, so `save(path, state, gen)` stores the generator's state
beside the tree and `restore(path, template, gen)` sets it again.
Restoring then reproduces the run bit-exactly.
"""

from __future__ import annotations

import pathlib

import torch

from agrifly_tpu_torch.convert import flatten_tensors


def save(path, state, gen: torch.Generator | None = None) -> str:
    """Save any NamedTuple tree of tensors (and `gen`'s state, where given)
    to `path`. Returns the format's name."""
    leaves, _ = flatten_tensors(state)
    blob = {"leaves": [t.detach().cpu() for t in leaves],
            "gen": None if gen is None else gen.get_state()}
    torch.save(blob, pathlib.Path(path))
    return "torch"


def restore(path, template, gen: torch.Generator | None = None):
    """The tree saved at `path`, in the structure of `template` (the same
    NamedTuple tree), each leaf on its template leaf's device and dtype.
    Where `gen` is given, it is set to the saved generator state."""
    blob = torch.load(pathlib.Path(path), weights_only=True)
    leaves, rebuild = flatten_tensors(template)
    saved = blob["leaves"]
    if len(saved) != len(leaves):
        raise ValueError(f"{path}: {len(saved)} leaves, the template has {len(leaves)}")
    for i, (s, t) in enumerate(zip(saved, leaves)):
        if s.shape != t.shape:
            raise ValueError(f"{path}: leaf {i} is {tuple(s.shape)}, the template's "
                             f"{tuple(t.shape)}")
    if gen is not None:
        if blob["gen"] is None:
            raise ValueError(f"{path} holds no generator state")
        gen.set_state(blob["gen"])
    return rebuild([s.to(device=t.device, dtype=t.dtype) for s, t in zip(saved, leaves)])
