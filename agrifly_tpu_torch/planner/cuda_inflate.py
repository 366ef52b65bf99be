"""Batched pyramid inflation through the hand-written CUDA kernels.

Port of `agrifly_tpu/planner/pallas_inflate.py`, batched over images as
`jax.vmap` batches it over a fleet's vehicles. With one seed per program
(the JAX package's default, `DEFAULT_SEEDS_PER_PROGRAM = 1`) P seeds on
each of B images are one launch of B x P blocks (K2); with
`seeds_per_program=S > 1` they are one launch of B x ceil(P/S) clusters of
S blocks (K2g: a block per seed for its passes A to C, the group's corner
sweeps split over the cluster), the seed rows padded to a multiple of S.
The prologue (seed validity, initial rectangle, thresholds) stays in float32 torch,
`rappids.seed_setup`, shared with the plain version; the kernels
(`csrc/inflate.cu`) run the integer passes. Both give K2's results, seed
for seed. On CPU tensors `inflate_pyramids` runs the plain version,
`rappids.inflate_pyramid`, for any S.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from agrifly_tpu_torch import cuda_build
from agrifly_tpu_torch.planner import rappids

DEFAULT_SEEDS_PER_PROGRAM = 1
MAX_SEEDS_PER_PROGRAM = 8  # the largest K2g instance csrc/inflate.cu compiles (kMaxGroup, a cluster)
CLUSTER_SIZES = (2, 4, 8)  # the K2c cluster sizes csrc/inflate.cu takes (kMaxCluster = 8)
MAX_SLAB_BYTES = 200 * 1024  # the largest row slab a K2c block stages (kMaxSlabBytes)
# K2c's grid at most this many blocks a SM: on an H100 K2c beat K2 at 80-160
# blocks (one image, 10 or 20 seeds, C = 8) and lost at 320-1024 (PERF.md)
CLUSTER_BLOCKS_PER_SM = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"inflate_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
               "inflate_grouped_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P]}


def _fn(name: str):
    fn = getattr(cuda_build.load("inflate"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _out_for(img, seeds):
    return torch.empty(seeds.shape[:-1] + (8,), dtype=torch.int32, device=img.device)


def _stream(img):
    return torch.cuda.current_stream(img.device).cuda_stream


def slab_bytes(H: int, W: int, C: int) -> int:
    """The int32 row slab a K2c block of a C-block cluster stages: ceil(H / C)
    rows, rounded up to 16 bytes."""
    return (-(-H // C) * W * 4 + 15) // 16 * 16


def cluster_size(B: int, P: int, H: int, W: int, sms: int) -> int:
    """Blocks per seed for B x P seeds on H x W images on a card of `sms`
    SMs: the largest cluster whose slab fits and whose grid stays within
    CLUSTER_BLOCKS_PER_SM blocks a SM (K2c); 1 (K2) where none does."""
    fits = [C for C in CLUSTER_SIZES if slab_bytes(H, W, C) <= MAX_SLAB_BYTES
            and B * P * C <= CLUSTER_BLOCKS_PER_SM * sms]
    return max(fits, default=1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(img: torch.Tensor, seeds: torch.Tensor, cluster: int | None = None) -> torch.Tensor:
    """One K2 or K2c launch for contiguous images (*L, H, W) int32 and seed
    rows (*L, P, 12) int32; returns (*L, P, 8) int32. cluster: the blocks
    per seed (None: `cluster_size`'s choice; 1 is K2)."""
    H, W = img.shape[-2:]
    B = img.numel() // (H * W)
    P = seeds.shape[-2]
    if cluster is None:
        cluster = cluster_size(B, P, H, W, _sm_count(img.device.index))
    out = _out_for(img, seeds)
    status = _fn("inflate_launch")(img.data_ptr(), seeds.data_ptr(), out.data_ptr(), B, P, H, W,
                                   cluster, _stream(img))
    cuda_build.check(status, "inflate_launch")
    if cluster == 1:
        inflate_pyramids.launches += 1
    else:
        inflate_pyramids.cluster_launches += 1
    return out


def _launch_grouped(img: torch.Tensor, seeds: torch.Tensor, S: int) -> torch.Tensor:
    """One K2g launch for contiguous images (*L, H, W) int32 and seed rows
    (*L, G*S, 12) int32, a cluster of S blocks per group of S seeds; returns
    (*L, G*S, 8) int32. Raises where the card refuses the launch."""
    H, W = img.shape[-2:]
    B = img.numel() // (H * W)
    out = _out_for(img, seeds)
    status = _fn("inflate_grouped_launch")(img.data_ptr(), seeds.data_ptr(), out.data_ptr(), B,
                                           seeds.shape[-2] // S, S, H, W, _stream(img))
    cuda_build.check(status, "inflate_grouped_launch")
    inflate_pyramids.grouped_launches += 1
    return out


def seed_rows(params: rappids.PlannerParams, x0s, y0s, min_depths, shrink_extra: int):
    """The kernel's (*L, P, 12) int32 seed rows: `rappids.seed_setup` packed."""
    s = rappids.seed_setup(params, x0s, y0s, min_depths, shrink_extra)
    full = lambda v: v.to(torch.int32).expand(x0s.shape)  # noqa: E731
    return torch.stack(
        [s.x0, s.y0, s.min_pyr_depth, s.left0, s.right0, s.top0, s.bottom0,
         s.ok0.to(torch.int32), full(s.edge_off), full(s.ignore), full(s.numer),
         torch.full(x0s.shape, shrink_extra, dtype=torch.int32, device=x0s.device)],
        dim=-1).contiguous()


def pad_seed_rows(rows: torch.Tensor, S: int) -> torch.Tensor:
    """(*L, P, 12) seed rows padded to (*L, ceil(P/S)*S, 12) with copies of
    row 0 whose ok flag (column 7) is cleared: they fail at once in the
    kernel, and their output rows are sliced off."""
    P = rows.shape[-2]
    n_pad = -(-P // S) * S - P
    if n_pad == 0:
        return rows
    pad = rows[..., :1, :].expand(rows.shape[:-2] + (n_pad, 12)).clone()
    pad[..., 7] = 0
    return torch.cat([rows, pad], dim=-2).contiguous()


def grouped_rows(rows: torch.Tensor, S: int, launch) -> torch.Tensor:
    """`launch(padded rows)` -> (*L, Ppad, 8) output rows on the rows padded
    to a multiple of S, sliced back to the P seeds of `rows`."""
    return launch(pad_seed_rows(rows, S))[..., :rows.shape[-2], :]


def _seeds_per_program(seeds_per_program) -> int:
    S = DEFAULT_SEEDS_PER_PROGRAM if seeds_per_program is None else seeds_per_program
    if isinstance(S, bool) or not isinstance(S, int) or S < 1:
        raise ValueError(f"seeds_per_program must be an int >= 1, got {S!r}")
    if S > MAX_SEEDS_PER_PROGRAM:
        raise ValueError(f"seeds_per_program={S} is above the largest compiled grouped kernel, "
                         f"{MAX_SEEDS_PER_PROGRAM} seeds (one cluster of as many blocks)")
    return S


def inflate_pyramids(params: rappids.PlannerParams, img, x0s, y0s, min_depths,
                     shrink_extra: int = 0, seeds_per_program=None):
    """Inflate P seeds (x0s, y0s, min_depths: (*L, P)) on (*L, H, W) int32
    images of depth codes, seed row l on image l, in one launch.

    Same contract as `rappids.inflate_pyramid`: returns (ok (*L, P) bool,
    maxd (*L, P) int32, edges (*L, P, 4) int32 [right, top, left, bottom]),
    bit-identical to it wherever ok. seeds_per_program S (None: 1) picks
    the kernel: K2 (or K2c) for S = 1, K2g with S seeds per cluster for 1 < S <=
    MAX_SEEDS_PER_PROGRAM. CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version for any S."""
    S = _seeds_per_program(seeds_per_program)
    H, W = params.cam.height, params.cam.width
    if img.dim() < 2 or img.shape[-2:] != (H, W) or img.dtype != torch.int32:
        raise ValueError(f"need (..., {H}, {W}) int32 images, got {tuple(img.shape)} {img.dtype}")
    lead = img.shape[:-2]
    for v in (x0s, y0s, min_depths):
        if v.dim() != len(lead) + 1 or v.shape[:-1] != lead:
            raise ValueError(f"need seeds of shape {tuple(lead)} + (P,), got {tuple(v.shape)}")
    if not img.is_cuda:
        return rappids.inflate_pyramid(params, img, x0s, y0s, min_depths, shrink_extra)
    if x0s.device != img.device:
        raise ValueError(f"seeds on {x0s.device}, image on {img.device}")
    if x0s.numel() == 0:
        z = torch.zeros(x0s.shape, dtype=torch.int32, device=img.device)
        return z.bool(), z, z[..., None].expand(x0s.shape + (4,))
    img = img.contiguous()
    rows = seed_rows(params, x0s, y0s, min_depths, shrink_extra)
    if S == 1:
        out = _launch(img, rows)
    else:
        out = grouped_rows(rows, S, lambda padded: _launch_grouped(img, padded, S))
    return out[..., 0] > 0, out[..., 1], out[..., 2:6]


inflate_pyramids.launches = 0  # K2 launches since the last reset
inflate_pyramids.cluster_launches = 0  # K2c launches since the last reset
inflate_pyramids.grouped_launches = 0  # K2g launches since the last reset
