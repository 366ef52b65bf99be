"""Batched orchard rendering through the hand-written CUDA raycast kernels.

Port of `agrifly_tpu/render/pallas_raycast.py`. `render_depth_batch` runs
`csrc/raycast.cu`'s depth kernel (K1) on CUDA tensors; on CPU tensors it
runs the plain version, `raycast.render_depth`. The kernel's codes equal
the plain version's bit for bit; `raycast.render_depth_exit` mirrors its
early exit. `render_rgb_batch` runs the same file's RGB instance (K1-rgb,
which replaces no TPU kernel: the JAX package's RGB pass is jnp) on CUDA
tensors and `raycast.render_rgb` on CPU tensors, with the same bytes.
"""

from __future__ import annotations

import ctypes

import torch

from agrifly_tpu_torch import cuda_build
from agrifly_tpu_torch.render import orchard as orch
from agrifly_tpu_torch.render import raycast
from agrifly_tpu_torch.render.raycast import RenderConfig

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"raycast_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P],
             "raycast_rgb_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _F, _F, _F, _P],
             "raycast_rgb_cells_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _F,
                                          _F, _F, _P]}

# the last scene's table, with the scene itself (so its tensors' ids are
# not reused while the entry lives) and the tensors' versions (which an
# in-place change bumps): (scene, versions, table)
_last_table = None


def scene_table(scene: orch.OrchardParams):
    """The kernel's scene table, (9 float32 fields in the order of
    orchard.FLOAT_FIELDS, 1 int32 seed), on the scene's device: built once
    while one OrchardParams is rendered and left unchanged (device-side
    stack and cast, no host read)."""
    global _last_table
    versions = tuple(t._version for t in scene)
    if (_last_table is not None and versions == _last_table[1]
            and all(a is b for a, b in zip(scene, _last_table[0]))):
        return _last_table[2]
    table = (torch.stack([getattr(scene, k) for k in orch.FLOAT_FIELDS]).contiguous(),
             scene.seed.to(torch.int32).reshape(1).contiguous())
    _last_table = (scene, versions, table)
    return table


def _function(name: str, scene: orch.OrchardParams, cam_pos: torch.Tensor):
    """The launch function `name` and the scene's table, on cam_pos's device."""
    fn = getattr(cuda_build.load("raycast"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    scene_f, seed = scene_table(scene)
    if scene_f.device != cam_pos.device:
        raise ValueError(f"scene on {scene_f.device}, cameras on {cam_pos.device}")
    return fn, scene_f, seed


def _cells_checked(cells, shape, device):
    """cells, where given, as the kernels take it: a contiguous int32 (B, H,
    W) tensor on the cameras' device."""
    if cells is not None and (tuple(cells.shape) != tuple(shape) or cells.dtype != torch.int32
                              or cells.device != device or not cells.is_contiguous()):
        raise ValueError(f"cells must be a contiguous int32 {tuple(shape)} tensor on {device}")
    return cells


def _launch(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos: torch.Tensor,
            cam_att: torch.Tensor, cells: torch.Tensor | None = None,
            launcher=None) -> torch.Tensor:
    """One launch for B cameras: cam_pos (B, 3), cam_att (B, 4) float32 on
    the card. `cells`, a (B, H, W) int32 tensor, receives the cells each
    pixel evaluated (the frame passes none). launcher: another build's
    raycast_launch with the same C interface (chip_smoke.py's parent check)."""
    fn, scene_f, seed = _function("raycast_launch", scene, cam_pos)
    fn = launcher or fn
    B = cam_pos.shape[0]
    out = torch.empty((B, cfg.height, cfg.width), dtype=torch.int32, device=cam_pos.device)
    _cells_checked(cells, out.shape, out.device)
    pos, att = cam_pos.contiguous(), cam_att.contiguous()
    status = fn(pos.data_ptr(), att.data_ptr(), scene_f.data_ptr(), seed.data_ptr(),
                out.data_ptr(), None if cells is None else cells.data_ptr(), B, cfg.height,
                cfg.width, cfg.focal, cfg.far / 256.0, cfg.dda_steps,
                torch.cuda.current_stream(cam_pos.device).cuda_stream)
    cuda_build.check(status, "raycast_launch")
    render_depth_batch.launches += 1
    return out


def _launch_rgb(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos: torch.Tensor,
                cam_att: torch.Tensor, cells: torch.Tensor | None = None,
                launcher=None) -> torch.Tensor:
    """One K1-rgb launch for B cameras (as _launch): (B, H, W, 3) uint8.
    `cells`, a (B, H, W) int32 tensor, receives the cells each pixel
    evaluated (raycast_rgb_cells_launch; the bridge frame passes none).
    launcher: another build's raycast_rgb_launch with the same C interface
    (chip_smoke.py's parent check)."""
    name = "raycast_rgb_launch" if cells is None else "raycast_rgb_cells_launch"
    fn, scene_f, seed = _function(name, scene, cam_pos)
    fn = launcher or fn
    B = cam_pos.shape[0]
    out = torch.empty((B, cfg.height, cfg.width, 3), dtype=torch.uint8, device=cam_pos.device)
    cells = () if cells is None else (_cells_checked(cells, out.shape[:-1], out.device).data_ptr(),)
    pos, att = cam_pos.contiguous(), cam_att.contiguous()
    status = fn(pos.data_ptr(), att.data_ptr(), scene_f.data_ptr(), seed.data_ptr(),
                out.data_ptr(), *cells, B, cfg.height, cfg.width, cfg.focal, cfg.far,
                cfg.dda_steps, *raycast.SUN, torch.cuda.current_stream(cam_pos.device).cuda_stream)
    cuda_build.check(status, name)
    render_rgb_batch.launches += 1
    return out


def _check_cameras(cam_pos, cam_att):
    if cam_pos.dim() != 2 or cam_pos.shape[1] != 3 or cam_att.shape != (cam_pos.shape[0], 4):
        raise ValueError(f"need cam_pos (B,3) and cam_att (B,4), got "
                         f"{tuple(cam_pos.shape)} and {tuple(cam_att.shape)}")
    if cam_pos.dtype != torch.float32 or cam_att.dtype != torch.float32:
        raise ValueError("cam_pos and cam_att must be float32")
    if cam_pos.device != cam_att.device:
        raise ValueError("cam_pos and cam_att on different devices")


def render_depth_batch(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att):
    """Render a batch of frames. cam_pos (B, 3), cam_att (B, 4) world-from-
    camera quaternions, float32. Returns (B, H, W) int32 codes.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    _check_cameras(cam_pos, cam_att)
    if not cam_pos.is_cuda:
        return raycast.render_depth(cfg, scene, cam_pos, cam_att)
    return _launch(cfg, scene, cam_pos, cam_att)


render_depth_batch.launches = 0  # kernel launches since the last reset


def render_depth_body_batch(cfg: RenderConfig, scene: orch.OrchardParams,
                            body_pos, body_att):
    """Batch render from vehicle poses (applies the depth-camera mount)."""
    return render_depth_batch(cfg, scene, body_pos, raycast.camera_attitude(body_att))


def render_rgb_batch(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att):
    """RGB frames of a batch of cameras (K1-rgb): the same arguments as
    render_depth_batch. Returns (B, H, W, 3) uint8.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version, raycast.render_rgb."""
    _check_cameras(cam_pos, cam_att)
    if not cam_pos.is_cuda:
        return raycast.render_rgb(cfg, scene, cam_pos, cam_att)
    return _launch_rgb(cfg, scene, cam_pos, cam_att)


render_rgb_batch.launches = 0  # kernel launches since the last reset


def render_rgb_body_batch(cfg: RenderConfig, scene: orch.OrchardParams, body_pos, body_att):
    """Batch RGB render from vehicle poses (applies the camera mount)."""
    return render_rgb_batch(cfg, scene, body_pos, raycast.camera_attitude(body_att))
