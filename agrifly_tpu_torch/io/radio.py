"""Radio command wire codec.

Port of `agrifly_tpu/io/radio.py` (RadioTypes.hpp:39-248). The only channel
from offboard to onboard is a 23-byte packet: 1 type byte, 1 reserved, 1
flags, then 10 big-endian uint16 scaled floats. Two halves:

- tensors: commands travel as (type int32, flags int32, fields (10,) int32
  uint16 codes), and the onboard logic sees the decoded, quantized floats;
- the host (numpy): the same codes without a device dispatch
  (`make_rates_command_np`) and the 23-byte packets for a topic bridge.
"""

from __future__ import annotations

import numpy as np
import torch

from agrifly_tpu_torch.ops.fmath import const

# message types (RadioTypes.hpp:17-25)
TYPE_INVALID = 0
TYPE_RESERVED = 1
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

RAW_PACKET_SIZE = 23

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


def quantize(val, limit):
    """Round-trip a float through the wire quantization."""
    return decode_field(encode_field(val, limit), limit)


def _flags(flags, dev):
    """flags as an int32 tensor on dev (a python int or a tensor)."""
    if isinstance(flags, torch.Tensor):
        return flags.to(device=dev, dtype=torch.int32)
    return const(int(flags), dev, torch.int32)


def _command(msg_type, vals, limits, flags):
    """(type, flags, fields): vals encoded into the first len(vals) fields,
    the rest raw 0 like the reference's zero-initialized packet."""
    dev = vals.device
    n = vals.shape[-1]
    codes = encode_field(vals, const(limits[:n], dev))
    fields = torch.cat([codes, torch.zeros(NUM_FIELDS - n, dtype=torch.int32, device=dev)])
    return const(msg_type, dev, torch.int32), _flags(flags, dev), fields


def make_rates_command(thrust, ang_vel, flags=0):
    """Rates command: fields[0] = thrust, 1:4 = angvel (RadioTypes.hpp:160-175).
    Returns (type, flags, fields) as int32 tensors."""
    return _command(TYPE_EXTERNAL_RATES_CMD, torch.cat([thrust[None], ang_vel]), _LIM_RATES,
                    flags)


def make_position_command(des_pos, des_vel, des_acc, flags=0):
    """Position command: fields 0:3 = des_pos, 3:6 = des_vel, 6:9 = des_acc;
    the tenth field stays a raw 0. Returns (type, flags, fields) as int32
    tensors."""
    return _command(TYPE_POSITION_CMD, torch.cat([des_pos, des_vel, des_acc]), _LIM_POS, flags)


def make_acceleration_command(acc, yaw_rate, flags=0):
    """Acceleration command: fields 0:3 = acc, 3 = yaw rate. Returns (type,
    flags, fields) as int32 tensors."""
    return _command(TYPE_EXTERNAL_ACC_CMD, torch.cat([acc, yaw_rate[None]]), _LIM_ACC, flags)


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


# ----------------------------------------------------------------------------
# host side (numpy): the same codes, and the 23-byte packets
# ----------------------------------------------------------------------------


def encode_field_np(val, limit):
    """encode_field in numpy: the same codes, in float32 arithmetic."""
    val = np.asarray(val, np.float32)
    limit = np.asarray(limit, np.float32)
    code = (val * np.float32(_HALF) / limit + np.float32(0.5)).astype(np.int32) + _HALF
    in_range = (val > -limit) & (val < limit)
    return np.where(in_range, code, np.where(val >= limit, _MAX - 1, 0)).astype(np.int32)


def make_rates_command_np(thrust, ang_vel, flags=0):
    """make_rates_command's wire codes on the host, without a device
    dispatch: a topic bridge encodes the offboard node's command stream from
    host frame rows with it. Returns (type, flags, (10,) int32 fields)."""
    vals = np.array([thrust, ang_vel[0], ang_vel[1], ang_vel[2]], np.float32)
    fields = np.zeros(NUM_FIELDS, np.int32)
    fields[:4] = encode_field_np(vals, np.array(_LIM_RATES[:4], np.float32))
    return TYPE_EXTERNAL_RATES_CMD, int(flags), fields


def fields_to_bytes(msg_type: int, flags: int, fields) -> bytes:
    """Pack into the 23-byte wire format (big-endian uint16 fields)."""
    raw = np.zeros(RAW_PACKET_SIZE, np.uint8)
    raw[0] = msg_type
    raw[1] = 0
    raw[2] = flags
    f = np.asarray(fields, np.int64)
    raw[3::2] = (f >> 8) & 0xFF
    raw[4::2] = f & 0xFF
    return raw.tobytes()


def bytes_to_fields(raw: bytes):
    """(type, flags, (10,) int32 fields) of a 23-byte packet."""
    b = np.frombuffer(raw, np.uint8)
    fields = (b[3::2].astype(np.int64) << 8) + b[4::2].astype(np.int64)
    return int(b[0]), int(b[2]), fields.astype(np.int32)
