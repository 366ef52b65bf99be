"""Batched depth rendering through the hand-written CUDA raycast kernel.

Port of `agrifly_tpu/render/pallas_raycast.py`. `render_depth_batch` runs
`csrc/raycast.cu` on CUDA tensors; on CPU tensors it runs the plain
version, `raycast.render_depth`. The kernel's codes equal the plain
version's bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from agrifly_tpu_torch import cuda_build
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.render import orchard as orch
from agrifly_tpu_torch.render import raycast
from agrifly_tpu_torch.render.raycast import RenderConfig

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _launch(cfg: RenderConfig, scene: orch.OrchardParams, cam: torch.Tensor) -> torch.Tensor:
    lib = cuda_build.load("raycast")
    fn = lib.raycast_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    scene_f = torch.stack([getattr(scene, k) for k in orch.FLOAT_FIELDS]).contiguous()
    seed = scene.seed.to(torch.int32).contiguous()
    for t in (scene_f, seed):
        if t.device != cam.device:
            raise ValueError(f"scene on {t.device}, cameras on {cam.device}")
    B = cam.shape[0]
    out = torch.empty((B, cfg.height, cfg.width), dtype=torch.int32, device=cam.device)
    status = fn(cam.data_ptr(), scene_f.data_ptr(), seed.data_ptr(), out.data_ptr(),
                B, cfg.height, cfg.width, cfg.focal, cfg.far / 256.0, cfg.dda_steps,
                torch.cuda.current_stream(cam.device).cuda_stream)
    cuda_build.check(status, "raycast_launch")
    render_depth_batch.launches += 1
    return out


def render_depth_batch(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att):
    """Render a batch of frames. cam_pos (B, 3), cam_att (B, 4) world-from-
    camera quaternions, float32. Returns (B, H, W) int32 codes.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if cam_pos.dim() != 2 or cam_pos.shape[1] != 3 or cam_att.shape != (cam_pos.shape[0], 4):
        raise ValueError(f"need cam_pos (B,3) and cam_att (B,4), got "
                         f"{tuple(cam_pos.shape)} and {tuple(cam_att.shape)}")
    if cam_pos.dtype != torch.float32 or cam_att.dtype != torch.float32:
        raise ValueError("cam_pos and cam_att must be float32")
    if cam_pos.device != cam_att.device:
        raise ValueError("cam_pos and cam_att on different devices")
    if not cam_pos.is_cuda:
        return raycast.render_depth(cfg, scene, cam_pos, cam_att)
    return _launch(cfg, scene, camera_rows(cam_pos, cam_att))


def camera_rows(cam_pos, cam_att):
    """The kernel's (B, 12) float32 camera rows: position, then the
    world-from-camera rotation matrix row by row."""
    B = cam_pos.shape[0]
    return torch.cat([cam_pos, rot.to_matrix(cam_att).reshape(B, 9)], dim=1).contiguous()


render_depth_batch.launches = 0  # kernel launches since the last reset


def render_depth_body_batch(cfg: RenderConfig, scene: orch.OrchardParams,
                            body_pos, body_att):
    """Batch render from vehicle poses (applies the depth-camera mount)."""
    return render_depth_batch(cfg, scene, body_pos, raycast.camera_attitude(body_att))
