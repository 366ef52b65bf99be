"""Batched pyramid inflation through the hand-written CUDA kernel.

Port of `agrifly_tpu/planner/pallas_inflate.py` with one seed per thread
block (the JAX package's default of one seed per program), batched over
images as `jax.vmap` batches it over a fleet's vehicles: P seeds on each
of B images are one launch of B x P blocks. The prologue (seed validity,
initial rectangle, thresholds) stays in float32 torch,
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
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch(img: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """One launch for contiguous images (*L, H, W) int32 and seed rows
    (*L, P, 12) int32; returns (*L, P, 8) int32."""
    lib = cuda_build.load("inflate")
    fn = lib.inflate_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    H, W = img.shape[-2:]
    P = seeds.shape[-2]
    B = img.numel() // (H * W)
    out = torch.empty(seeds.shape[:-1] + (8,), dtype=torch.int32, device=img.device)
    status = fn(img.data_ptr(), seeds.data_ptr(), out.data_ptr(), B, P, H, W,
                torch.cuda.current_stream(img.device).cuda_stream)
    cuda_build.check(status, "inflate_launch")
    inflate_pyramids.launches += 1
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


def inflate_pyramids(params: rappids.PlannerParams, img, x0s, y0s, min_depths,
                     shrink_extra: int = 0):
    """Inflate P seeds (x0s, y0s, min_depths: (*L, P)) on (*L, H, W) int32
    images of depth codes, seed row l on image l, in one launch.

    Same contract as `rappids.inflate_pyramid`: returns (ok (*L, P) bool,
    maxd (*L, P) int32, edges (*L, P, 4) int32 [right, top, left, bottom]),
    bit-identical to it wherever ok. CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
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
    out = _launch(img.contiguous(), seed_rows(params, x0s, y0s, min_depths, shrink_extra))
    return out[..., 0] > 0, out[..., 1], out[..., 2:6]


inflate_pyramids.launches = 0  # kernel launches since the last reset
