"""Radio command wire codec, device side.

Port of the tensor half of `agrifly_tpu/io/radio.py`
(RadioTypes.hpp:39-248): commands travel as (type int32, flags int32,
fields (10,) int32 uint16 codes), and the onboard logic sees the decoded,
quantized floats.
"""

from __future__ import annotations

import torch

from agrifly_tpu_torch.ops.fmath import const

# message types (RadioTypes.hpp:17-25)
TYPE_INVALID = 0
TYPE_EMERGENCY_KILL = 2
TYPE_POSITION_CMD = 3
TYPE_EXTERNAL_ACC_CMD = 4
TYPE_EXTERNAL_RATES_CMD = 5
TYPE_IDLE_CMD = 6

# reserved flag bits (RadioTypes.hpp:28-37)
FLAG_CALIBRATE_MOTORS = 0x01
FLAG_DISABLE_SAFETY_CHECKS = 0x02

# field scaling limits (RadioTypes.hpp:54-61)
MAX_CMD_THRUST = 35.0
MAX_CMD_ANG_RATES = 35.0
MAX_CMD_POS = 20.0
MAX_CMD_VEL = 10.0
MAX_CMD_ACC = 30.0
MAX_DEFAULT = 1.0

NUM_FIELDS = 10
_HALF = 32768  # 2^15
_MAX = 65536

_LIM_RATES = (MAX_CMD_THRUST,) + (MAX_CMD_ANG_RATES,) * 9
_LIM_POS = (MAX_CMD_POS,) * 3 + (MAX_CMD_VEL,) * 3 + (MAX_CMD_ACC,) * 3 + (MAX_DEFAULT,)
_LIM_ACC = (MAX_CMD_ACC,) * 3 + (MAX_CMD_ANG_RATES,) + (MAX_DEFAULT,) * 6


def encode_field(val, limit):
    """float -> uint16 code, matching encodeToRadioByte (RadioTypes.hpp:75-98)."""
    in_range = (val > -limit) & (val < limit)
    code = (val * _HALF / limit + 0.5).to(torch.int32) + _HALF
    hi = torch.where(val >= limit, _MAX - 1, 0).to(torch.int32)
    return torch.where(in_range, code, hi)


def decode_field(code, limit):
    """uint16 code -> float, matching decodeFromRadioBytes (RadioTypes.hpp:100-113)."""
    return limit * (code.to(torch.float32) - _HALF) / float(_HALF)


def make_rates_command(thrust, ang_vel):
    """Rates command: fields[0] = thrust, 1:4 = angvel (RadioTypes.hpp:160-175).
    Returns (type, flags, fields) as int32 tensors."""
    dev = ang_vel.device
    vals = torch.cat([thrust[None], ang_vel])
    codes = encode_field(vals, const(_LIM_RATES[:4], dev))
    fields = torch.cat([codes, torch.zeros(NUM_FIELDS - 4, dtype=torch.int32, device=dev)])
    return (const(TYPE_EXTERNAL_RATES_CMD, dev, torch.int32),
            const(0, dev, torch.int32), fields)


def make_position_command(des_pos, des_vel, des_acc):
    """Position command: fields 0:3 = des_pos, 3:6 = des_vel, 6:9 = des_acc
    (the JAX package's `make_position_command`); the tenth field stays a
    raw 0. Returns (type, flags, fields) as int32 tensors."""
    dev = des_pos.device
    vals = torch.cat([des_pos, des_vel, des_acc])
    codes = encode_field(vals, const(_LIM_POS[:9], dev))
    fields = torch.cat([codes, torch.zeros(NUM_FIELDS - 9, dtype=torch.int32, device=dev)])
    return (const(TYPE_POSITION_CMD, dev, torch.int32), const(0, dev, torch.int32), fields)


def make_kill_command(device=None, flags=0):
    """Emergency kill: no fields (RadioTypes.hpp). Returns (type, flags,
    fields) as int32 tensors on `device`."""
    return (const(TYPE_EMERGENCY_KILL, device, torch.int32), const(flags, device, torch.int32),
            const((0,) * NUM_FIELDS, device, torch.int32))


def make_idle_command(device=None, flags=0):
    """Idle: motors off, no fields. Returns (type, flags, fields) as int32
    tensors on `device`."""
    return (const(TYPE_IDLE_CMD, device, torch.int32), const(flags, device, torch.int32),
            const((0,) * NUM_FIELDS, device, torch.int32))


def decode_message(msg_type, fields):
    """uint16 codes -> 10 floats with the per-type limits (RadioTypes.hpp:189-240)."""
    dev = fields.device
    out = torch.where(msg_type == TYPE_POSITION_CMD, decode_field(fields, const(_LIM_POS, dev)),
                      decode_field(fields, MAX_DEFAULT))
    out = torch.where(msg_type == TYPE_EXTERNAL_RATES_CMD,
                      decode_field(fields, const(_LIM_RATES, dev)), out)
    return torch.where(msg_type == TYPE_EXTERNAL_ACC_CMD,
                       decode_field(fields, const(_LIM_ACC, dev)), out)
