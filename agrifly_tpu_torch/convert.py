"""Parameters and state between the JAX package and the port.

`params_from_numpy` and `state_from_numpy` turn the JAX package's
`OrchardEnvParams` / `OrchardEnvState`, given as NamedTuples of numpy
arrays (for instance `jax.tree_util.tree_map(np.asarray, state)`), into the
port's NamedTuples on a device; `env_params_from_numpy`,
`env_state_from_numpy` and `command_from_numpy` do the same for `sim/env`'s
`EnvParams`, `EnvState` (their UWB network included) and `Command`;
`fleet_*` and `uwb_fleet_*` for `sim/fleet_env`'s fleets, and `MODULE_TREES`
names the small modules' params and states (`sim/mission`,
`offboard/safetynet`, `sim/aruco`) for `module_from_numpy`. Fields
are matched by name, following the port's annotations: a `torch.Tensor`
field becomes a tensor of the same dtype, an `int`/`float`/`bool` field a
python number, a NamedTuple field recurses, an Optional one stays None
where the tree's is. Fields the port does not have (the PRNG keys, the
env's, the fleets' and the UWB network's, the imported-world mesh,
`use_pallas`) are dropped.
This module imports no jax.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

_DTYPES = (np.float32, np.int32, np.bool_)


def _is_namedtuple_type(t) -> bool:
    return isinstance(t, type) and issubclass(t, tuple) and hasattr(t, "_fields")


def _convert(hint, leaf, device, where):
    args = typing.get_args(hint)
    if typing.get_origin(hint) is typing.Union and len(args) == 2 and type(None) in args:
        if leaf is None:
            return None
        hint = next(a for a in args if a is not type(None))
    if _is_namedtuple_type(hint):
        return from_numpy(hint, leaf, device)
    if hint is torch.Tensor:
        arr = np.array(leaf)
        if arr.dtype.type not in _DTYPES:
            raise TypeError(f"{where}: unexpected dtype {arr.dtype}")
        return torch.from_numpy(arr).to(device)
    if hint in (int, float, bool):
        return hint(np.asarray(leaf).item())
    raise TypeError(f"{where}: unsupported annotation {hint}")


def from_numpy(cls, tree, device=None):
    """Build the port NamedTuple `cls` from a same-shaped tree of numpy
    leaves (matched by field name)."""
    hints = typing.get_type_hints(cls)
    return cls(**{name: _convert(hints[name], getattr(tree, name), device,
                                 f"{cls.__name__}.{name}")
                  for name in cls._fields})


def params_from_numpy(tree, device=None):
    """The port's OrchardEnvParams from the JAX package's, as numpy leaves."""
    from agrifly_tpu_torch.sim.orchard_env import OrchardEnvParams

    return from_numpy(OrchardEnvParams, tree, device)


def state_from_numpy(tree, device=None):
    """The port's OrchardEnvState from the JAX package's, as numpy leaves."""
    from agrifly_tpu_torch.sim.orchard_env import OrchardEnvState

    return from_numpy(OrchardEnvState, tree, device)


def env_params_from_numpy(tree, device=None):
    """The port's env.EnvParams from the JAX package's, as numpy leaves."""
    from agrifly_tpu_torch.sim.env import EnvParams

    return from_numpy(EnvParams, tree, device)


def env_state_from_numpy(tree, device=None):
    """The port's env.EnvState from the JAX package's, as numpy leaves (a
    vmapped state keeps its leading B); the PRNG keys are dropped."""
    from agrifly_tpu_torch.sim.env import EnvState

    return from_numpy(EnvState, tree, device)


def command_from_numpy(tree, device=None):
    """The port's env.Command from the JAX package's, as numpy leaves."""
    from agrifly_tpu_torch.sim.env import Command

    return from_numpy(Command, tree, device)


def fleet_params_from_numpy(tree, device=None):
    """The port's fleet_env.FleetParams from the JAX package's."""
    from agrifly_tpu_torch.sim.fleet_env import FleetParams

    return from_numpy(FleetParams, tree, device)


def fleet_state_from_numpy(tree, device=None):
    """The port's fleet_env.FleetState from the JAX package's (the keys
    dropped)."""
    from agrifly_tpu_torch.sim.fleet_env import FleetState

    return from_numpy(FleetState, tree, device)


def uwb_fleet_params_from_numpy(tree, device=None):
    """The port's fleet_env.UwbFleetParams from the JAX package's."""
    from agrifly_tpu_torch.sim.fleet_env import UwbFleetParams

    return from_numpy(UwbFleetParams, tree, device)


def uwb_fleet_state_from_numpy(tree, device=None):
    """The port's fleet_env.UwbFleetState from the JAX package's (the keys
    dropped)."""
    from agrifly_tpu_torch.sim.fleet_env import UwbFleetState

    return from_numpy(UwbFleetState, tree, device)


# the small modules' trees: name -> (port module, NamedTuple class name)
MODULE_TREES = {
    "mission_params": ("sim.mission", "MissionParams"),
    "mission_state": ("sim.mission", "MissionState"),
    "safetynet_params": ("offboard.safetynet", "SafetyNetParams"),
    "safetynet_state": ("offboard.safetynet", "SafetyState"),
    "aruco_params": ("sim.aruco", "ArucoParams"),
    "aruco_state": ("sim.aruco", "ArucoState"),
}


def module_from_numpy(name, tree, device=None):
    """The port's tree `name` (a key of MODULE_TREES) from the JAX package's
    tree of the same class, as numpy leaves."""
    import importlib

    module, cls = MODULE_TREES[name]
    return from_numpy(getattr(importlib.import_module(f"agrifly_tpu_torch.{module}"), cls),
                      tree, device)


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
    flat, plan = [], []  # plan: the tree in post-order, None for a tensor

    def walk(node):
        if isinstance(node, torch.Tensor):
            flat.append(node)
            plan.append(None)
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for v in node:
                walk(v)
            plan.append((type(node)._make, len(node)))
        else:
            plan.append((node,))

    walk(tree)

    def rebuild(new):
        leaves, stack = iter(new), []
        for op in plan:
            if op is None:
                stack.append(next(leaves))
            elif len(op) == 1:
                stack.append(op[0])
            else:
                make, n = op
                node = make(stack[-n:])
                del stack[-n:]
                stack.append(node)
        return stack[0]

    return flat, rebuild
