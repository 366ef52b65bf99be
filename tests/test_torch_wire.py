"""The port's wire codecs and host helpers against the JAX package's.

Mirrors tests/test_wire_codecs.py on `agrifly_tpu_torch.io.radio` and
`agrifly_tpu_torch.io.telemetry`, and holds each against its JAX
counterpart on the same inputs, made with numpy from a seed: the radio
codes, the command builders (with their flags) and the 23-byte packets;
the telemetry packets built from a logic state carried across several
readouts (codes, packet numbers, the cleared warnings and the advanced
counter); `wire_quantize_np` bit for bit against the tensor codec's round
trip; the float packet and the 30-byte structs. Also the logic's host
helpers (`format_status`, `set_gyro_calibration`) and
`rotation.from_vector_part`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from agrifly_tpu.io import radio as jradio, telemetry as jtel
from agrifly_tpu.models import constants as jconst, logic as jlogic
from agrifly_tpu.ops import rotation as jrot
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.io import radio, telemetry
from agrifly_tpu_torch.models import logic
from agrifly_tpu_torch.ops import rotation as rot

STEP = 2 * 35 / 32768  # two quantization steps of the widest radio field


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


# ----------------------------------------------------------------------
# radio
# ----------------------------------------------------------------------


def test_radio_field_quantization_reference_formula():
    # encode: int(v * 32768 / limit + 0.5) + 32768 (C++ int() truncates
    # toward zero); decode: limit * (code - 32768) / 32768
    limit = 35.0
    for v in [0.0, 1.234, -1.234, 34.99, -34.99, 0.0005, -0.0005]:
        code = int(radio.encode_field(_f32(v), limit))
        assert code == int(np.float32(v) * 32768 / limit + 0.5) + 32768, v
        assert code == int(jradio.encode_field(jnp.float32(v), limit))
        dec = float(radio.decode_field(torch.tensor(code, dtype=torch.int32), limit))
        assert abs(dec - v) <= 2 * limit / 32768
        assert float(radio.quantize(_f32(v), limit)) == float(jradio.quantize(jnp.float32(v),
                                                                              limit))


def test_radio_field_saturation_and_nan():
    assert int(radio.encode_field(_f32(100.0), 35.0)) == 65535
    assert int(radio.encode_field(_f32(-100.0), 35.0)) == 0
    assert int(radio.encode_field(_f32(np.nan), 35.0)) == 0


@pytest.mark.parametrize("kind", ["rates", "position", "acceleration"])
def test_command_builders_match_jax(kind):
    """The codes of every builder equal JAX's, the flags given are returned
    (a python int or a tensor), and the default is 0."""
    rng = np.random.default_rng(5)
    for flags in (0, radio.FLAG_CALIBRATE_MOTORS | radio.FLAG_DISABLE_SAFETY_CHECKS):
        if kind == "rates":
            args = (np.float32(rng.uniform(0, 30)), rng.uniform(-5, 5, 3).astype(np.float32))
            mine, theirs = radio.make_rates_command, jradio.make_rates_command
        elif kind == "position":
            args = tuple(rng.uniform(-8, 8, 3).astype(np.float32) for _ in range(3))
            mine, theirs = radio.make_position_command, jradio.make_position_command
        else:
            args = (rng.uniform(-20, 20, 3).astype(np.float32), np.float32(rng.uniform(-3, 3)))
            mine, theirs = radio.make_acceleration_command, jradio.make_acceleration_command
        got = mine(*(_f32(a) for a in args), flags=flags) if flags else mine(*map(_f32, args))
        ref = theirs(*(jnp.asarray(a) for a in args), flags=flags)
        assert [int(got[0]), int(got[1])] == [int(ref[0]), int(ref[1])] == [int(ref[0]), flags]
        assert got[2].dtype == torch.int32
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        floats = radio.decode_message(got[0], got[2]).numpy()
        np.testing.assert_array_equal(floats, np.asarray(jradio.decode_message(ref[0], ref[2])))
    flags = torch.tensor(3, dtype=torch.int32)
    assert int(radio.make_rates_command(_f32(1.0), _f32([0, 0, 0]), flags=flags)[1]) == 3


def test_command_roundtrips():
    t, _, fields = radio.make_rates_command(_f32(12.5), _f32([1.0, -2.0, 0.5]))
    assert int(t) == radio.TYPE_EXTERNAL_RATES_CMD
    floats = radio.decode_message(t, fields).numpy()
    assert abs(floats[0] - 12.5) < STEP
    assert np.allclose(floats[1:4], [1.0, -2.0, 0.5], atol=STEP)
    t, _, fields = radio.make_position_command(_f32([1.5, -2.5, 3.0]), _f32([0.5, 0.0, -0.5]),
                                               torch.zeros(3))
    floats = radio.decode_message(t, fields).numpy()
    assert np.allclose(floats[0:3], [1.5, -2.5, 3.0], atol=2 * 20 / 32768)
    assert np.allclose(floats[3:6], [0.5, 0.0, -0.5], atol=2 * 10 / 32768)


def test_radio_host_half_matches_jax():
    """encode_field_np, make_rates_command_np (also equal to the tensor
    builder's codes), the 23-byte packets and their constants."""
    assert (radio.TYPE_RESERVED, radio.RAW_PACKET_SIZE) == (jradio.TYPE_RESERVED,
                                                             jradio.RAW_PACKET_SIZE) == (1, 23)
    rng = np.random.default_rng(8)
    vals = np.concatenate([rng.uniform(-40, 40, 200), [35.0, -35.0, np.nan, 0.0]])
    np.testing.assert_array_equal(radio.encode_field_np(vals, 35.0),
                                  jradio.encode_field_np(vals, 35.0))
    for _ in range(20):
        thrust, angvel = np.float32(rng.uniform(0, 36)), rng.uniform(-36, 36, 3)
        t, f, fields = radio.make_rates_command_np(thrust, angvel, flags=2)
        jt, jf, jfields = jradio.make_rates_command_np(thrust, angvel, flags=2)
        assert (t, f) == (jt, jf) == (radio.TYPE_EXTERNAL_RATES_CMD, 2)
        np.testing.assert_array_equal(fields, jfields)
        dev = radio.make_rates_command(_f32(thrust), _f32(angvel))[2].numpy()
        np.testing.assert_array_equal(fields, dev)
        raw = radio.fields_to_bytes(t, f, fields)
        assert raw == jradio.fields_to_bytes(t, f, fields) and len(raw) == 23
        back = radio.bytes_to_fields(raw)
        assert back[:2] == (t, f) and back[2].dtype == np.int32
        np.testing.assert_array_equal(back[2], fields)


# ----------------------------------------------------------------------
# telemetry
# ----------------------------------------------------------------------


def test_telemetry_ones_range():
    assert int(telemetry.encode_ones(_f32(2.0))) == 0  # out of range
    assert np.isnan(float(telemetry.decode_ones(torch.tensor(0, dtype=torch.int32))))
    t = _f32(np.linspace(-1.2, 1.2, 301))
    codes = telemetry.encode_ones(t)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jtel.encode_ones(t.numpy())))
    dec = telemetry.decode_ones(codes).numpy()
    np.testing.assert_array_equal(dec, np.asarray(jtel.decode_ones(jnp.asarray(codes.numpy()))))
    inside = np.abs(t.numpy()) <= 1.0
    assert np.all(np.abs(dec[inside] - t.numpy()[inside]) < 2.0 / 32768)


def _logic_states(seed):
    """A JAX logic state with random telemetry sources and the port's copy."""
    rng = np.random.default_rng(seed)
    p = jlogic.make_params(jconst.vehicle_params(jconst.QC_TYPE_CF_MINIQUAD))
    s = jlogic.init_state(p)
    f32 = lambda *shape, scale=1.0: jnp.asarray(  # noqa: E731
        rng.normal(0, scale, shape).astype(np.float32))
    q = rng.normal(size=4)
    s = s._replace(
        acc_lp=s.acc_lp._replace(ym1=f32(3, scale=12.0)),
        gyro_lp=s.gyro_lp._replace(ym1=f32(3, scale=20.0)),
        batt_lp=s.batt_lp._replace(ym1=f32(scale=4.0) + 7.0),
        des_motor_forces=jnp.abs(f32(4, scale=3.0)),
        kf=s.kf._replace(pos=f32(3, scale=20.0), vel=f32(3, scale=20.0),
                         att=jnp.asarray((q / np.linalg.norm(q)).astype(np.float32)),
                         angvel=f32(3)),
        batt_voltage=f32(scale=4.0) + 7.0, batt_current=f32(),
        debug=f32(6, scale=80.0), warnings=jnp.int32(0x15), panic_reason=jnp.int32(4),
        tel_counter=jnp.int32(254), gyro_bias=f32(3, scale=0.01),
        gyro_cal_enabled=jnp.bool_(True), gyro_cal_accum=f32(3), gyro_cal_count=jnp.int32(37),
        cycle_count=jnp.int32(1234), loop_lpdt=jnp.float32(0.002), fs=jnp.int32(2))
    as_np = jax.tree_util.tree_map(np.asarray, s)
    return (p, s), (convert.from_numpy(logic.LogicParams, jax.tree_util.tree_map(np.asarray, p)),
                    convert.from_numpy(logic.LogicState, as_np))


def test_encode_from_logic_matches_jax():
    """Three readouts in a row: the codes, the packet numbers (254, 255, 0),
    the cleared warnings and the advanced counter, all equal to JAX's, and
    the decode."""
    (_, js), (_, ts) = _logic_states(1)
    for _ in range(3):
        ref, js = jtel.encode_from_logic(js)
        got, ts = telemetry.encode_from_logic(ts)
        for name in ("type1", "type2", "packet_number", "data1", "data2"):
            g, r = getattr(got, name), np.asarray(getattr(ref, name))
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
        assert int(ts.warnings) == int(js.warnings) == 0
        assert int(ts.tel_counter) == int(js.tel_counter)
        dec, jdec = telemetry.decode(got), jtel.decode(ref)
        for name, g in zip(dec._fields, dec):
            np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(jdec, name)), name)
    assert int(got.packet_number) == 0 and int(got.data2[13]) == 0  # wrapped; warnings sent once


def test_wire_quantize_np_equals_the_tensor_round_trip():
    """The host round trip equals decode(encode(x)) of the tensor codec bit
    for bit (NaN where out of range), one range at a time and a row of
    per-element ranges at once, and JAX's wire_quantize_np."""
    rng = np.random.default_rng(2)
    ranges = [telemetry.RANGE_ACC, telemetry.RANGE_GYRO, telemetry.RANGE_FORCE,
              telemetry.RANGE_BATT, telemetry.RANGE_ATT, telemetry.RANGE_GENERIC]
    for a, b in ranges:
        x = rng.uniform(a - 0.1 * (b - a), b + 0.1 * (b - a), 500).astype(np.float32)
        x[:3] = (a, b, 0.5 * (a + b))
        host = telemetry.wire_quantize_np(x, (a, b))
        codes = telemetry.encode_ones(telemetry._to_ones(torch.from_numpy(x), (a, b)))
        dev = telemetry._from_ones(telemetry.decode_ones(codes), (a, b)).numpy()
        assert host.dtype == np.float64
        np.testing.assert_array_equal(host, dev.astype(np.float64))
        np.testing.assert_array_equal(host, jtel.wire_quantize_np(x, (a, b)))
    lo = np.array([r[0] for r in ranges], np.float64)
    hi = np.array([r[1] for r in ranges], np.float64)
    row = rng.uniform(lo, hi).astype(np.float32)
    np.testing.assert_array_equal(
        telemetry.wire_quantize_np(row, (lo, hi)),
        [telemetry.wire_quantize_np(v, r)[()] for v, r in zip(row, ranges)])


def test_telemetry_bytes_and_float_packet():
    data = np.arange(14, dtype=np.int32) * 1000 + 7
    raw = telemetry.pack_bytes(1, 42, data)
    assert raw == jtel.pack_bytes(1, 42, data) and len(raw) == 30
    t, n, d = telemetry.unpack_bytes(raw)
    assert (t, n) == (1, 42) and np.array_equal(d, data)
    vals = [0.1, -0.9, 0.5]
    pkts, ref = telemetry.encode_float_packet(vals), jtel.encode_float_packet(jnp.array(vals))
    for name in ("type1", "packet_number", "data1", "data2"):
        np.testing.assert_array_equal(getattr(pkts, name).numpy(), np.asarray(getattr(ref, name)))
    dec = telemetry.decode_float_packet(pkts, 3).numpy()
    assert np.allclose(dec, vals, atol=2 / 32768)


# ----------------------------------------------------------------------
# logic helpers and from_vector_part
# ----------------------------------------------------------------------


def test_format_status_matches_jax():
    (jp, js), (tp, ts) = _logic_states(3)
    got = logic.format_status(tp, ts, vehicle_id=2)
    assert got == jlogic.format_status(jp, js, vehicle_id=2)
    assert "FS_FULLY_AUTONOMOUS" in got and "RADIO_CMD_TIMEOUT" in got
    assert logic.PANIC_REASON_NAMES == jlogic.PANIC_REASON_NAMES
    assert logic.FS_NAMES == jlogic.FS_NAMES


@pytest.mark.parametrize("enable", [False, True])
def test_set_gyro_calibration_matches_jax(enable):
    """Stopping a running calibration sets the bias to the mean of its
    samples; starting one (or stopping none) keeps it."""
    (_, js), (_, ts) = _logic_states(4)
    for running in (True, False):
        ref = jlogic.set_gyro_calibration(js._replace(gyro_cal_enabled=jnp.bool_(running)), enable)
        got = logic.set_gyro_calibration(ts._replace(gyro_cal_enabled=torch.tensor(running)),
                                         enable)
        assert bool(got.gyro_cal_enabled) == bool(ref.gyro_cal_enabled) == enable
        np.testing.assert_array_equal(got.gyro_bias.numpy(), np.asarray(ref.gyro_bias))
        assert torch.equal(got.gyro_bias, ts.gyro_bias) == (enable or not running)


def test_from_vector_part_matches_jax():
    """The vector part of a w >= 0 unit quaternion rebuilds it (within the
    rotation tests' 1e-5), as JAX's does."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(32, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[q[:, 0] < 0] *= -1.0
    v = q[:, 1:4].astype(np.float32)
    got = rot.from_vector_part(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, q, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jrot.from_vector_part(jnp.asarray(v))), atol=1e-6)
    assert float(rot.from_vector_part(_f32([1.0, 1.0, 0.0]))[0]) == 0.0  # |v| > 1: w = 0
