"""Procedural almond-orchard scene.

Port of `agrifly_tpu/render/orchard.py`: trees sit on a row/column grid
and each cell's tree (presence, jitter, trunk, two canopy spheres) comes
from an int32 hash of the cell coordinates. int32 tensors wrap on overflow
exactly as the JAX package's int32 arrays do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from agrifly_tpu_torch import card_or_raise
from agrifly_tpu_torch.ops.fmath import sqrt


class OrchardParams(NamedTuple):
    row_spacing: torch.Tensor  # [m] distance between tree rows (y)
    tree_spacing: torch.Tensor  # [m] distance between trees in a row (x)
    presence: torch.Tensor  # probability a grid cell holds a tree
    jitter: torch.Tensor  # [m] max |offset| of trunk from cell center
    trunk_radius: torch.Tensor
    trunk_height: torch.Tensor
    canopy_radius: torch.Tensor
    canopy_height: torch.Tensor
    seed: torch.Tensor  # int32 world seed
    clear_radius: torch.Tensor  # [m] no trees within this distance of origin


# the float fields in the order the raycast kernel reads them
FLOAT_FIELDS = ("row_spacing", "tree_spacing", "presence", "jitter",
                "trunk_radius", "trunk_height", "canopy_radius",
                "canopy_height", "clear_radius")


def make_params(row_spacing=6.0, tree_spacing=4.0, presence=0.95, jitter=0.3,
                trunk_radius=0.18, trunk_height=1.2, canopy_radius=1.35,
                canopy_height=2.6, seed=0, clear_radius=3.0,
                device="cuda") -> OrchardParams:
    """Every tree's geometry must stay inside its own grid cell, which is
    what makes the renderer's single-pass DDA exact. The tensors are built
    on the card unless `device` names another; with no card, the default
    raises instead of building on the CPU."""
    device = card_or_raise(device, "orchard.make_params")
    extent = jitter + 1.2 * canopy_radius  # 1.2 = max per-tree size factor
    if extent > min(row_spacing, tree_spacing) / 2.0 + 1e-6:
        raise ValueError(f"tree extent {extent} overflows the grid cell")
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return OrchardParams(
        row_spacing=f32(row_spacing), tree_spacing=f32(tree_spacing),
        presence=f32(presence), jitter=f32(jitter),
        trunk_radius=f32(trunk_radius), trunk_height=f32(trunk_height),
        canopy_radius=f32(canopy_radius), canopy_height=f32(canopy_height),
        seed=torch.tensor(seed, dtype=torch.int32, device=device),
        clear_radius=f32(clear_radius),
    )


def contained(p: OrchardParams) -> torch.Tensor:
    """Whether every tree lies inside its own grid cell (a 0-d bool tensor
    on the scene's device): the jitter plus the widest of the trunk (1.2
    trunk_radius), the first canopy sphere (1.2 canopy_radius) and the
    second (offset up to 0.3 m, radius 0.84 canopy_radius) within half the
    smaller spacing. `make_params` checks only the first sphere; the second
    can leave its cell. The plain version of `csrc/raycast.cu`'s
    `contained`, in its float32 operations; a NaN field fails it."""
    jit, can = torch.abs(p.jitter), torch.abs(p.canopy_radius)
    half = 0.5 * torch.minimum(p.tree_spacing, p.row_spacing)
    return ((p.tree_spacing > 0) & (p.row_spacing > 0)
            & (jit + 1.2 * torch.abs(p.trunk_radius) <= half) & (jit + 1.2 * can <= half)
            & (jit + (0.3 + 0.84 * can) <= half))


def canopy_top(p: OrchardParams) -> torch.Tensor:
    """A height above every tree (a 0-d float32 tensor on the scene's
    device): 1.2 max(|canopy_height| + 1.5 |canopy_radius|, |trunk_height|).
    `tree_fields`' first canopy sphere reaches (canopy_height +
    |canopy_radius|) size, the second (canopy_height + 0.8 canopy_radius)
    size + 0.7 |canopy_radius| size, the trunk trunk_height size, with size
    < 1.2. The plain version of `csrc/raycast.cu`'s `canopy_top`, in its
    float32 operations."""
    return 1.2 * torch.maximum(torch.abs(p.canopy_height) + 1.5 * torch.abs(p.canopy_radius),
                               torch.abs(p.trunk_height))


def _mix(h):
    h = h ^ (h >> 13)
    h = h * 1274126177
    return h ^ (h >> 16)


def cell_rand(ix, iy, seed, salt: int):
    """Deterministic uniform [0,1) from int32 cell coords."""
    h = ix * 374761393 + iy * 668265263
    h = h + seed * 974634599 + salt * 1446648
    h = _mix(h)
    return (h & 0x7FFFFF).to(torch.float32) / float(0x800000)


class TreeGeom(NamedTuple):
    present: torch.Tensor  # bool
    trunk_center: torch.Tensor  # (..., 2) x, y
    trunk_radius: torch.Tensor
    trunk_height: torch.Tensor
    canopy_center: torch.Tensor  # (..., 3)
    canopy_radius: torch.Tensor
    canopy2_center: torch.Tensor  # (..., 3) upper canopy sphere
    canopy2_radius: torch.Tensor


def tree_fields(p: OrchardParams, ix, iy):
    """Per-cell tree parameters as a dict of tensors shaped like ix/iy."""
    r0 = cell_rand(ix, iy, p.seed, 0)
    r1 = cell_rand(ix, iy, p.seed, 1)
    r2 = cell_rand(ix, iy, p.seed, 2)
    r3 = cell_rand(ix, iy, p.seed, 3)
    r4 = cell_rand(ix, iy, p.seed, 4)

    cx = (ix.to(torch.float32) + 0.5) * p.tree_spacing + (r1 - 0.5) * 2.0 * p.jitter
    cy = (iy.to(torch.float32) + 0.5) * p.row_spacing + (r2 - 0.5) * 2.0 * p.jitter

    present = (r0 < p.presence) & (sqrt(cx * cx + cy * cy) > p.clear_radius)

    size = 0.8 + 0.4 * r3  # per-tree scale factor
    can_r = p.canopy_radius * size
    can_h = p.canopy_height * size
    return dict(
        present=present,
        cx=cx, cy=cy,
        trunk_r=p.trunk_radius * size,
        trunk_h=p.trunk_height * size,
        can_r=can_r, can_h=can_h,
        c2x=cx + (r4 - 0.5) * 0.6,
        c2y=cy + (r2 - 0.5) * 0.6,
        c2z=can_h + 0.8 * can_r,
        c2r=can_r * 0.7,
    )


def tree_at_cell(p: OrchardParams, ix, iy) -> TreeGeom:
    """Tree parameters for grid cell (ix, iy), shaped like ix/iy."""
    f = tree_fields(p, ix, iy)
    return TreeGeom(
        present=f["present"],
        trunk_center=torch.stack([f["cx"], f["cy"]], dim=-1),
        trunk_radius=f["trunk_r"],
        trunk_height=f["trunk_h"],
        canopy_center=torch.stack([f["cx"], f["cy"], f["can_h"]], dim=-1),
        canopy_radius=f["can_r"],
        canopy2_center=torch.stack([f["c2x"], f["c2y"], f["c2z"]], dim=-1),
        canopy2_radius=f["c2r"],
    )
