"""Parameters and state between the JAX package and the port.

`params_from_numpy` and `state_from_numpy` turn the JAX package's
`OrchardEnvParams` / `OrchardEnvState`, given as NamedTuples of numpy
arrays (for instance `jax.tree_util.tree_map(np.asarray, state)`), into the
port's NamedTuples on a device. Fields are matched by name, following the
port's annotations: a `torch.Tensor` field becomes a tensor of the same
dtype, an `int`/`float`/`bool` field a python number, a NamedTuple field
recurses. Fields the port does not have (the PRNG key, UWB, the imported-
world mesh, the kernel switches) are dropped. This module imports no jax.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

_DTYPES = (np.float32, np.int32, np.bool_)


def _is_namedtuple_type(t) -> bool:
    return isinstance(t, type) and issubclass(t, tuple) and hasattr(t, "_fields")


def from_numpy(cls, tree, device=None):
    """Build the port NamedTuple `cls` from a same-shaped tree of numpy
    leaves (matched by field name)."""
    hints = typing.get_type_hints(cls)
    values = {}
    for name in cls._fields:
        hint, leaf = hints[name], getattr(tree, name)
        if _is_namedtuple_type(hint):
            values[name] = from_numpy(hint, leaf, device)
        elif hint is torch.Tensor:
            arr = np.array(leaf)
            if arr.dtype.type not in _DTYPES:
                raise TypeError(f"{cls.__name__}.{name}: unexpected dtype {arr.dtype}")
            values[name] = torch.from_numpy(arr).to(device)
        elif hint in (int, float, bool):
            values[name] = hint(np.asarray(leaf).item())
        else:
            raise TypeError(f"{cls.__name__}.{name}: unsupported annotation {hint}")
    return cls(**values)


def params_from_numpy(tree, device=None):
    """The port's OrchardEnvParams from the JAX package's, as numpy leaves."""
    from agrifly_tpu_torch.sim.orchard_env import OrchardEnvParams

    return from_numpy(OrchardEnvParams, tree, device)


def state_from_numpy(tree, device=None):
    """The port's OrchardEnvState from the JAX package's, as numpy leaves."""
    from agrifly_tpu_torch.sim.orchard_env import OrchardEnvState

    return from_numpy(OrchardEnvState, tree, device)


def leaves(tree, prefix=()):
    """Yield (field path, tensor) for every tensor leaf of a port NamedTuple."""
    for name, value in zip(tree._fields, tree):
        if isinstance(value, torch.Tensor):
            yield prefix + (name,), value
        elif isinstance(value, tuple) and hasattr(value, "_fields"):
            yield from leaves(value, prefix + (name,))


def flatten_tensors(tree):
    """(tensor leaves, rebuild) for a NamedTuple tree; rebuild(new_leaves)
    returns the same tree with its tensors replaced in order."""
    flat = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            flat.append(node)
            return lambda it: next(it)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            parts = [walk(v) for v in node]
            return lambda it: type(node)(*(p(it) for p in parts))
        return lambda it: node

    build = walk(tree)
    return flat, lambda new: build(iter(new))
