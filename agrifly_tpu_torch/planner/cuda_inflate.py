"""Batched pyramid inflation through the hand-written CUDA kernel.

Port of `agrifly_tpu/planner/pallas_inflate.py` with one seed per thread
block (the JAX package's default of one seed per program). The prologue
(seed validity, initial rectangle, thresholds) stays in float32 torch,
`rappids.seed_setup`, shared with the plain version; the kernel
(`csrc/inflate.cu`) runs the integer passes. On CPU tensors
`inflate_pyramids` runs the plain version, `rappids.inflate_pyramid`.
"""

from __future__ import annotations

import ctypes

import torch

from agrifly_tpu_torch import cuda_build
from agrifly_tpu_torch.planner import rappids

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch(img: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    lib = cuda_build.load("inflate")
    fn = lib.inflate_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    P = seeds.shape[0]
    H, W = img.shape
    out = torch.empty((P, 8), dtype=torch.int32, device=img.device)
    status = fn(img.data_ptr(), seeds.data_ptr(), out.data_ptr(), P, H, W,
                torch.cuda.current_stream(img.device).cuda_stream)
    cuda_build.check(status, "inflate_launch")
    inflate_pyramids.launches += 1
    return out


def seed_rows(params: rappids.PlannerParams, x0s, y0s, min_depths, shrink_extra: int):
    """The kernel's (P, 12) int32 seed rows: `rappids.seed_setup` packed."""
    P = x0s.shape[0]
    s = rappids.seed_setup(params, x0s, y0s, min_depths, shrink_extra)
    full = lambda v: v.to(torch.int32).expand(P)  # noqa: E731
    return torch.stack(
        [s.x0, s.y0, s.min_pyr_depth, s.left0, s.right0, s.top0, s.bottom0,
         s.ok0.to(torch.int32), full(s.edge_off), full(s.ignore), full(s.numer),
         torch.full((P,), shrink_extra, dtype=torch.int32, device=x0s.device)],
        dim=1).contiguous()


def inflate_pyramids(params: rappids.PlannerParams, img, x0s, y0s, min_depths,
                     shrink_extra: int = 0):
    """Inflate P seeds on one (H, W) int32 image of depth codes.

    Same contract as `rappids.inflate_pyramid`: returns (ok (P,) bool,
    maxd (P,) int32, edges (P, 4) int32 [right, top, left, bottom]), bit-
    identical to it wherever ok. CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    H, W = params.cam.height, params.cam.width
    if img.shape != (H, W) or img.dtype != torch.int32:
        raise ValueError(f"need an ({H}, {W}) int32 image, got {tuple(img.shape)} {img.dtype}")
    if not img.is_cuda:
        return rappids.inflate_pyramid(params, img, x0s, y0s, min_depths, shrink_extra)
    if x0s.device != img.device:
        raise ValueError(f"seeds on {x0s.device}, image on {img.device}")
    P = x0s.shape[0]
    if P == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=img.device)
        return z.bool(), z, z.reshape(0, 4)
    out = _launch(img.contiguous(), seed_rows(params, x0s, y0s, min_depths, shrink_extra))
    return out[:, 0] > 0, out[:, 1], out[:, 2:6]


inflate_pyramids.launches = 0  # kernel launches since the last reset
