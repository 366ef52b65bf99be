"""Batched imported-world depth rendering through hand-written CUDA kernels.

Port of `agrifly_tpu/render/pallas_meshscene.py`. `csrc/meshscene.cu` holds
two kernels: the strip-culled one (K4, `render_depth_strips_batch`, the
default of `render_depth_batch`) and the window one (K4w,
`render_depth_window_batch`). On CUDA tensors the wrappers launch them (or
raise); on CPU tensors they run the plain versions,
`meshscene.render_strips` and `meshscene.render_depth_window`, whose codes
the kernels equal bit for bit. K4 culls the window's rows per 16-row
strip itself, as `strip_windows` does on the CPU; `select_window` is plain
torch on the tensors' device. Nothing is read back to the host.
"""

from __future__ import annotations

import ctypes
import math

import torch

from agrifly_tpu_torch import cuda_build
from agrifly_tpu_torch.render import meshscene
from agrifly_tpu_torch.render.meshscene import ROW_WIDTH, MeshScene
from agrifly_tpu_torch.render.raycast import RenderConfig, camera_attitude

TILE_H = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "meshscene_strips_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F,
                                _P],
    "meshscene_window_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
}


def frustum(cfg: RenderConfig):
    """strip_windows' horizontal and far-plane constants, in float64 (the
    launch rounds each to float32, as PyTorch rounds a python float in a
    float32 op): ex_min, ex_max, sqrt(1 + ex_min^2), sqrt(1 + ex_max^2), far."""
    ex_min = -cfg.width / (2.0 * cfg.focal)
    ex_max = (cfg.width - 1 - cfg.width / 2.0) / cfg.focal
    return (ex_min, ex_max, math.sqrt(1.0 + ex_min * ex_min), math.sqrt(1.0 + ex_max * ex_max),
            cfg.far)


def _launch(name: str, cfg: RenderConfig, cam_pos: torch.Tensor, cam_att: torch.Tensor,
            windows: torch.Tensor, nvis: torch.Tensor | None = None) -> torch.Tensor:
    """Launch `name` on B cameras (cam_pos (B, 3), cam_att (B, 4)) and their
    windows (B, K, ROW_WIDTH). K4 (meshscene_strips_launch) writes each
    strip's n_vis into `nvis`, a (B, H / TILE_H) int32 tensor, where one is
    given (the frame passes none)."""
    lib = cuda_build.load("meshscene")
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    B, K = windows.shape[:2]
    out = torch.empty((B, cfg.height, cfg.width), dtype=torch.int32, device=windows.device)
    pos, att, win = cam_pos.contiguous(), cam_att.contiguous(), windows.contiguous()
    args = [pos.data_ptr(), att.data_ptr(), win.data_ptr(), out.data_ptr()]
    if name == "meshscene_strips_launch":
        want = (B, cfg.height // TILE_H)
        if nvis is not None and (tuple(nvis.shape) != want or nvis.dtype != torch.int32
                                 or nvis.device != out.device or not nvis.is_contiguous()):
            raise ValueError(f"nvis must be a contiguous int32 {want} tensor on {out.device}")
        args.append(None if nvis is None else nvis.data_ptr())
    args += [B, K, cfg.height, cfg.width, cfg.focal, cfg.far / 256.0]
    if name == "meshscene_strips_launch":
        args += list(frustum(cfg))
    status = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    cuda_build.check(status, name)
    return out


def _check_inputs(cfg: RenderConfig, windows, cam_pos, cam_att):
    if cam_pos.dim() != 2 or cam_pos.shape[1] != 3 or cam_att.shape != (cam_pos.shape[0], 4):
        raise ValueError(f"need cam_pos (B,3) and cam_att (B,4), got "
                         f"{tuple(cam_pos.shape)} and {tuple(cam_att.shape)}")
    if windows.dim() != 3 or windows.shape[0] != cam_pos.shape[0] or \
            windows.shape[2] != ROW_WIDTH:
        raise ValueError(f"need windows (B,K,{ROW_WIDTH}) for B = {cam_pos.shape[0]}, got "
                         f"{tuple(windows.shape)}")
    if any(t.dtype != torch.float32 for t in (windows, cam_pos, cam_att)):
        raise ValueError("windows, cam_pos and cam_att must be float32")
    if not (windows.device == cam_pos.device == cam_att.device):
        raise ValueError("windows, cam_pos and cam_att on different devices")
    if cfg.height % TILE_H:
        raise ValueError(f"image height {cfg.height} is not a multiple of {TILE_H}")


def render_depth_window_batch(cfg: RenderConfig, windows, cam_pos, cam_att):
    """K4w: every window row against every pixel. windows (B, K,
    ROW_WIDTH), cam_pos (B, 3), cam_att (B, 4) world-from-camera, float32.
    Returns (B, H, W) int32 codes."""
    _check_inputs(cfg, windows, cam_pos, cam_att)
    if not cam_pos.is_cuda:
        return meshscene.render_depth_window(cfg, windows, cam_pos, cam_att)
    out = _launch("meshscene_window_launch", cfg, cam_pos, cam_att, windows)
    render_depth_window_batch.launches += 1
    return out


def render_depth_strips_batch(cfg: RenderConfig, windows, cam_pos, cam_att):
    """K4: per 16-row strip, only the window rows whose bounding sphere
    meets the strip's ray cone (conservative, so the codes equal K4w's).
    On the card one launch culls and renders; on the CPU
    `meshscene.strip_windows` culls and `meshscene.render_strips` renders.
    Same arguments and result as render_depth_window_batch."""
    _check_inputs(cfg, windows, cam_pos, cam_att)
    if not cam_pos.is_cuda:
        strips, _ = meshscene.strip_windows(cfg, windows, cam_pos, cam_att, TILE_H)
        return meshscene.render_strips(cfg, strips, cam_pos, cam_att)
    out = _launch("meshscene_strips_launch", cfg, cam_pos, cam_att, windows)
    render_depth_strips_batch.launches += 1
    return out


render_depth_window_batch.launches = 0  # kernel launches since the last reset
render_depth_strips_batch.launches = 0


def render_depth_batch(cfg: RenderConfig, scene: MeshScene, cam_pos, cam_att,
                       window_capacity: int = 192, strip_culling: bool = True):
    """select_window per camera, then K4 (strip_culling, the default) or
    K4w; the same codes either way. cam_pos (B, 3), cam_att (B, 4)."""
    if scene.prims.device != cam_pos.device:
        raise ValueError(f"scene on {scene.prims.device}, cameras on {cam_pos.device}")
    windows = meshscene.select_window(scene, cam_pos, cfg.far * meshscene.slant_factor(cfg),
                                      window_capacity)
    render = render_depth_strips_batch if strip_culling else render_depth_window_batch
    return render(cfg, windows, cam_pos, cam_att)


def render_depth_body_batch(cfg: RenderConfig, scene: MeshScene, body_pos, body_att,
                            window_capacity: int = 192):
    """Batch render from vehicle poses (applies the depth-camera mount)."""
    return render_depth_batch(cfg, scene, body_pos, camera_attitude(body_att),
                              window_capacity)
