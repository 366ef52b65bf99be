"""CSV run logging with the demo's column schema.

The reference writes a wide CSV row per offboard tick
(Simulator/Rappids_Simulator/main.cpp:266-270): sim time, true state,
motor forces, estimator state, desired state, panic flag, last radio
command. This logger consumes stacked rollout outputs and writes the same
schema through the native buffered writer (`io/native`).

Port of `agrifly_tpu/utils/simlog.py`: the leaves may be tensors on any
device or numpy arrays; the euler angles come from the port's
`ops/rotation.to_euler_ypr`, in float32 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from agrifly_tpu_torch.io.native import NativeCsvLogger
from agrifly_tpu_torch.ops import rotation as rot

HEADER = (
    "t,posx,posy,posz,velx,vely,velz,attY,attP,attR,angvelx,angvely,angvelz,"
    "m1,m2,m3,m4,"
    "estposx,estposy,estposz,estvelx,estvely,estvelz,esty,estp,estr,"
    "estangx,estangy,estangz,"
    "desposx,desposy,desposz,desvelx,desvely,desvelz,panic,r1,r2,r3,r4"
)


def _np(x, dtype=np.float64):
    """A host numpy copy of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def write_rollout_csv(path, traj_outputs, dt=1.0 / 500.0, des_pos=None,
                      est=None, last_cmd=None):
    """traj_outputs: stacked (T, ...) leaves pos, vel, att, angvel,
    motor_speeds, panic_reason (env.StepOutputs or any object with them)."""
    pos = _np(traj_outputs.pos)
    vel = _np(traj_outputs.vel)
    att = _np(traj_outputs.att, np.float32)
    angvel = _np(traj_outputs.angvel)
    speeds = _np(traj_outputs.motor_speeds)
    panic = _np(traj_outputs.panic_reason)
    T = pos.shape[0]

    y, p, r = rot.to_euler_ypr(torch.from_numpy(att))
    ypr = np.stack([y.numpy(), p.numpy(), r.numpy()], axis=1).astype(np.float64)

    zeros3 = np.zeros((T, 3))
    est_pos = _np(est[0]) if est else zeros3
    est_vel = _np(est[1]) if est else zeros3
    est_ypr = _np(est[2]) if est else zeros3
    est_av = _np(est[3]) if est else zeros3
    des = np.broadcast_to(_np(des_pos), (T, 3)) if des_pos is not None else zeros3
    cmd = _np(last_cmd) if last_cmd is not None else np.zeros((T, 4))

    t = (np.arange(T) + 1) * dt
    rows = np.concatenate(
        [
            t[:, None], pos, vel, ypr, angvel, speeds,
            est_pos, est_vel, est_ypr, est_av,
            des, zeros3[:, :3], panic[:, None], cmd,
        ],
        axis=1,
    )
    with NativeCsvLogger(path, HEADER) as lg:
        lg.write_rows(rows)
    return rows.shape
