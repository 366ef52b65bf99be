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

The RGB pass (`render_rgb_batch`) launches a third kernel of the same file,
K4-rgb (`render_rgb_strips_batch`), which replaces no TPU kernel: the JAX
package's RGB pass is jnp. It is K4's strip-culled scan without the far
clip, its rows staged in window order with their window row, material
and what their shading reads, then the shading in the same thread; its
bytes equal `meshscene.render_rgb_strips`', which CPU tensors run.
"""

from __future__ import annotations

import ctypes
import math

import torch

from agrifly_tpu_torch import cuda_build
from agrifly_tpu_torch.render import meshscene
from agrifly_tpu_torch.render.meshscene import ROW_WIDTH, MeshScene
from agrifly_tpu_torch.render.raycast import SUN, RenderConfig, camera_attitude

TILE_H = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "meshscene_strips_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F,
                                _P],
    "meshscene_window_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "meshscene_rgb_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                             _F, _P],
}


def frustum(cfg: RenderConfig):
    """strip_windows' horizontal and far-plane constants, in float64 (the
    launch rounds each to float32, as PyTorch rounds a python float in a
    float32 op): ex_min, ex_max, sqrt(1 + ex_min^2), sqrt(1 + ex_max^2), far."""
    ex_min = -cfg.width / (2.0 * cfg.focal)
    ex_max = (cfg.width - 1 - cfg.width / 2.0) / cfg.focal
    return (ex_min, ex_max, math.sqrt(1.0 + ex_min * ex_min), math.sqrt(1.0 + ex_max * ex_max),
            cfg.far)


def _function(name: str):
    fn = getattr(cuda_build.load("meshscene"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, cfg: RenderConfig, cam_pos: torch.Tensor, cam_att: torch.Tensor,
            windows: torch.Tensor, nvis: torch.Tensor | None = None,
            launcher=None) -> torch.Tensor:
    """Launch `name` on B cameras (cam_pos (B, 3), cam_att (B, 4)) and their
    windows (B, K, ROW_WIDTH). K4 (meshscene_strips_launch) writes each
    strip's n_vis into `nvis`, a (B, H / TILE_H) int32 tensor, where one is
    given (the frame passes none). launcher: another build's `name` with the
    same C interface (chip_smoke.py's parent check)."""
    fn = launcher or _function(name)
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


def _launch_rgb(cfg: RenderConfig, cam_pos: torch.Tensor, cam_att: torch.Tensor,
                windows: torch.Tensor, mats: torch.Tensor, launcher=None) -> torch.Tensor:
    """One K4-rgb launch on B cameras and their windows (as _launch) with the
    rows' (B, K) int32 materials: (B, H, W, 3) uint8. launcher: another
    build's meshscene_rgb_launch (chip_smoke.py's parent check and section
    timers)."""
    fn = launcher or _function("meshscene_rgb_launch")
    B, K = windows.shape[:2]
    out = torch.empty((B, cfg.height, cfg.width, 3), dtype=torch.uint8, device=windows.device)
    pos, att, win = cam_pos.contiguous(), cam_att.contiguous(), windows.contiguous()
    mat = mats.contiguous()
    ex_min, ex_max, sx_min, sx_max, _ = frustum(cfg)
    status = fn(pos.data_ptr(), att.data_ptr(), win.data_ptr(), mat.data_ptr(), out.data_ptr(),
                B, K, cfg.height, cfg.width, cfg.focal, cfg.far, ex_min, ex_max, sx_min, sx_max,
                *SUN, torch.cuda.current_stream(out.device).cuda_stream)
    cuda_build.check(status, "meshscene_rgb_launch")
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


def render_rgb_strips_batch(cfg: RenderConfig, windows, mats, cam_pos, cam_att):
    """K4-rgb: RGB frames from windows (B, K, ROW_WIDTH) and their rows'
    materials mats (B, K) int32, cam_pos (B, 3), cam_att (B, 4)
    world-from-camera. Returns (B, H, W, 3) uint8. On the card one launch
    culls (without the far clip), scans and shades; on the CPU
    `meshscene.render_rgb_strips` does, with the same bytes."""
    _check_inputs(cfg, windows, cam_pos, cam_att)
    if mats.shape != windows.shape[:2] or mats.dtype != torch.int32 or \
            mats.device != windows.device:
        raise ValueError(f"need int32 materials {tuple(windows.shape[:2])} on {windows.device}, "
                         f"got {mats.dtype} {tuple(mats.shape)} on {mats.device}")
    if not cam_pos.is_cuda:
        return meshscene.render_rgb_strips(cfg, windows, mats, cam_pos, cam_att, TILE_H)
    out = _launch_rgb(cfg, cam_pos, cam_att, windows, mats)
    render_rgb_strips_batch.launches += 1
    return out


render_rgb_strips_batch.launches = 0  # kernel launches since the last reset


def render_rgb_batch(cfg: RenderConfig, scene: MeshScene, cam_pos, cam_att,
                     window_capacity: int = 192, strip_cull: bool | None = None):
    """select_window per camera with its rows' materials, then the RGB scan:
    cam_pos (B, 3), cam_att (B, 4). Returns (B, H, W, 3) uint8. CUDA
    tensors launch K4-rgb whatever `strip_cull` says, since the
    strip-culled and the plain scan give the same image bit for bit; CPU
    tensors run the plain scan that `strip_cull` names (meshscene.render_rgb's
    choice). H must be a multiple of 16, as for render_depth_batch."""
    if scene.prims.device != cam_pos.device:
        raise ValueError(f"scene on {scene.prims.device}, cameras on {cam_pos.device}")
    windows, order, ok = meshscene.select_window(
        scene, cam_pos, cfg.far * meshscene.slant_factor(cfg), window_capacity, return_order=True)
    mats = meshscene.window_materials(scene, windows, order, ok)
    if cam_pos.is_cuda or strip_cull is not False:
        return render_rgb_strips_batch(cfg, windows, mats, cam_pos, cam_att)
    _check_inputs(cfg, windows, cam_pos, cam_att)
    return meshscene.render_rgb_window(cfg, windows, mats, cam_pos, cam_att)


def render_rgb_body_batch(cfg: RenderConfig, scene: MeshScene, body_pos, body_att,
                          window_capacity: int = 192):
    """Batch RGB render from vehicle poses (applies the camera mount)."""
    return render_rgb_batch(cfg, scene, body_pos, camera_attitude(body_att), window_capacity)
