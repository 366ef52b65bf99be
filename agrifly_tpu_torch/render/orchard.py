"""Procedural almond-orchard scene.

Port of `agrifly_tpu/render/orchard.py`: trees sit on a row/column grid
and each cell's tree (presence, jitter, trunk, two canopy spheres) comes
from an int32 hash of the cell coordinates. int32 tensors wrap on overflow
exactly as the JAX package's int32 arrays do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
                device=None) -> OrchardParams:
    """Every tree's geometry must stay inside its own grid cell, which is
    what makes the renderer's single-pass DDA exact."""
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
