"""Telemetry wire codec: 2 packets x 14 uint16 quantized fields.

Port of `agrifly_tpu/io/telemetry.py` (Common/Common/DataTypes/
TelemetryPacket.hpp): floats are mapped from per-field ranges to [-1, 1],
then to uint16 via 32768 + 32767 t, truncated (0 encodes out-of-range and
decodes to NaN). Packet 1 carries accel / gyro / motor forces / position /
battery; packet 2 velocity / attitude (vector part) / debug / panic /
warnings. The tensor side carries int32 codes and takes any leading axis;
the host side (numpy) quantizes frame rows (`wire_quantize_np`) and packs
the 30-byte wire structs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from agrifly_tpu_torch.ops import filters
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const, scalar

PACKET_TYPE_PT1 = 0
PACKET_TYPE_PT2 = 1
PACKET_TYPE_GENERIC_FLOAT = 100

# ranges (TelemetryPacket.hpp:80-98)
RANGE_ACC = (-30.0, 30.0)
RANGE_GYRO = (-35.0, 35.0)
RANGE_FORCE = (0.0, 10.0)
RANGE_BATT = (0.0, 15.0)
RANGE_POS = (-30.0, 30.0)
RANGE_VEL = (-30.0, 30.0)
RANGE_ATT = (-1.0, 1.0)
RANGE_GENERIC = (-100.0, 100.0)

NUM_CODES = 14


class TelemetryPackets(NamedTuple):
    """Two wire packets as int32 tensors (type, packet_number, 14 codes each)."""

    type1: torch.Tensor
    type2: torch.Tensor
    packet_number: torch.Tensor
    data1: torch.Tensor  # (..., 14) int32
    data2: torch.Tensor  # (..., 14) int32


def encode_ones(t):
    """[-1, 1] float32 -> uint16 code (truncated); out of range -> 0
    (hpp:55-63)."""
    code = (32768.0 + 32767.0 * t).to(torch.int32)
    ok = (t >= -1.0) & (t <= 1.0)
    return torch.where(ok, code, 0).to(torch.int32)


def decode_ones(code):
    """uint16 code -> float32 in [-1, 1]; 0 -> NaN (hpp:66-71)."""
    val = (code.to(torch.float32) - 32768.0) / 32768.0
    return torch.where(code == 0, torch.nan, val)


def _to_ones(x, rng):
    a, b = rng
    return ((x - a) / scalar(b - a, x)) * 2.0 - 1.0


def _from_ones(t, rng):
    a, b = rng
    return ((t + 1.0) / 2.0) * (b - a) + a


def _encode(x, rng):
    return encode_ones(_to_ones(x, rng))


def encode_from_logic(logic_state) -> tuple:
    """Both telemetry packets from a LogicState (any leading axis).

    Returns (packets, new_logic_state): the warnings are cleared once sent
    and the packet counter advances (QuadcopterLogic.cpp:621-679)."""
    s = logic_state
    d1 = torch.cat([
        _encode(filters.lp2_value(s.acc_lp), RANGE_ACC),
        _encode(filters.lp2_value(s.gyro_lp), RANGE_GYRO),
        _encode(s.des_motor_forces, RANGE_FORCE),
        _encode(s.kf.pos, RANGE_POS),
        _encode(s.batt_voltage, RANGE_BATT)[..., None],
    ], dim=-1)
    d2 = torch.cat([
        _encode(s.kf.vel, RANGE_VEL),
        _encode(rot.to_vector_part(s.kf.att), RANGE_ATT),
        _encode(s.debug, RANGE_GENERIC),
        s.panic_reason[..., None].to(torch.int32),
        s.warnings[..., None].to(torch.int32),
    ], dim=-1)
    dev = d1.device
    pkts = TelemetryPackets(
        type1=const(PACKET_TYPE_PT1, dev, torch.int32),
        type2=const(PACKET_TYPE_PT2, dev, torch.int32),
        packet_number=(s.tel_counter % 256).to(torch.int32), data1=d1, data2=d2)
    new_state = s._replace(tel_counter=s.tel_counter + 1, warnings=torch.zeros_like(s.warnings))
    return pkts, new_state


class DecodedTelemetry(NamedTuple):
    accel: torch.Tensor
    gyro: torch.Tensor
    motor_forces: torch.Tensor
    position: torch.Tensor
    batt_voltage: torch.Tensor
    velocity: torch.Tensor
    attitude: torch.Tensor  # vector part of the quaternion
    debug: torch.Tensor
    panic_reason: torch.Tensor
    warnings: torch.Tensor


def decode(pkts: TelemetryPackets) -> DecodedTelemetry:
    d1, d2 = pkts.data1, pkts.data2
    return DecodedTelemetry(
        accel=_from_ones(decode_ones(d1[..., 0:3]), RANGE_ACC),
        gyro=_from_ones(decode_ones(d1[..., 3:6]), RANGE_GYRO),
        motor_forces=_from_ones(decode_ones(d1[..., 6:10]), RANGE_FORCE),
        position=_from_ones(decode_ones(d1[..., 10:13]), RANGE_POS),
        batt_voltage=_from_ones(decode_ones(d1[..., 13]), RANGE_BATT),
        velocity=_from_ones(decode_ones(d2[..., 0:3]), RANGE_VEL),
        attitude=_from_ones(decode_ones(d2[..., 3:6]), RANGE_ATT),
        debug=_from_ones(decode_ones(d2[..., 6:12]), RANGE_GENERIC),
        panic_reason=d2[..., 12],
        warnings=d2[..., 13],
    )


def wire_quantize_np(x, rng):
    """Host-side (numpy) round trip through the telemetry wire:
    `_from_ones(decode_ones(encode_ones(_to_ones(x))))` with every step in
    float32, as the tensor codec computes it on float32 inputs, widened to
    float64 only at the end. A bridge builds its telemetry messages from
    host frame rows with it; its values equal the tensor decode's bit for
    bit. rng: (a, b), scalars or per-element arrays (a whole row of
    ranges in one call; every operation is elementwise, so that equals
    one call per element)."""
    a, b = rng
    a32 = np.asarray(a, np.float32)
    span32 = (np.asarray(b, np.float64) - np.asarray(a, np.float64)).astype(np.float32)
    x32 = np.asarray(x, np.float32)
    t32 = ((x32 - a32) / span32) * np.float32(2.0) - np.float32(1.0)
    code = (32768.0 + 32767.0 * t32).astype(np.int32)
    code = np.where((t32 >= -1.0) & (t32 <= 1.0), code, 0)
    val = np.where(code == 0, np.float32(np.nan),
                   (code.astype(np.float32) - np.float32(32768.0))
                   / np.float32(32768.0)).astype(np.float32)
    out = ((val + np.float32(1.0)) / np.float32(2.0)) * span32 + a32
    return out.astype(np.float64)


def pack_bytes(ptype: int, packet_number: int, data) -> bytes:
    """Host-side: one packet as the 30-byte wire struct (type, packet
    number, 14 little-endian uint16 codes)."""
    out = np.zeros(30, np.uint8)
    out[0] = ptype
    out[1] = packet_number
    out[2:30] = np.asarray(data, np.uint16).view(np.uint8)[:28]
    return out.tobytes()


def unpack_bytes(raw: bytes):
    """Host-side: (type, packet number, (14,) int32 codes) of a wire struct."""
    b = np.frombuffer(raw, np.uint8)
    return int(b[0]), int(b[1]), b[2:30].view(np.uint16).astype(np.int32)


def encode_float_packet(floats) -> TelemetryPackets:
    """Generic float packet: up to 14 floats in [-1, 1]
    (TelemetryPacket.hpp:243-268); unused slots encode 0.0 (valid), as the
    reference fills them. Returns a packet pair with data2 unused."""
    floats = torch.as_tensor(floats, dtype=torch.float32)
    dev = floats.device
    padded = torch.zeros(NUM_CODES, dtype=torch.float32, device=dev)
    padded[:min(floats.shape[0], NUM_CODES)] = floats[:NUM_CODES]
    kind = const(PACKET_TYPE_GENERIC_FLOAT, dev, torch.int32)
    return TelemetryPackets(type1=kind, type2=kind, packet_number=const(0, dev, torch.int32),
                            data1=encode_ones(padded),
                            data2=torch.zeros(NUM_CODES, dtype=torch.int32, device=dev))


def decode_float_packet(pkts: TelemetryPackets, num_floats=NUM_CODES):
    """Inverse of encode_float_packet (values in [-1, 1]; a 0 code -> NaN)."""
    return decode_ones(pkts.data1[..., :num_floats])
