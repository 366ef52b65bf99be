"""ctypes bindings for the native host runtime (native/wire_runtime.cpp).

The hot host-side IO: batch radio/telemetry byte codecs and the buffered
CSV logger used by the log writers. On first use the repository's own
`native/wire_runtime.cpp` is compiled with g++ into
`agrifly_tpu_torch/_build/libwire_runtime.so` (rebuilt when the source is
newer). A failed build raises with the compiler's output: there is no
quiet fallback. `io/radio`'s and `io/telemetry`'s numpy codecs stay the
plain versions the codecs are held against.

The same bindings as `agrifly_tpu/io/native.py`, whose library lives in
`native/`; the port's build does not touch it.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SRC = _PKG.parent / "native" / "wire_runtime.cpp"
LIB = _PKG / "_build" / "libwire_runtime.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None


def _build():
    LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB)  # atomic: concurrent builders each install a whole library


def get_lib():
    """The native library, built from SRC on first use."""
    global _lib
    if _lib is not None:
        return _lib
    if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(LIB))

    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)

    lib.af_radio_encode_rates.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_uint8, u8p]
    lib.af_radio_encode_rates.restype = None
    lib.af_radio_encode_position.argtypes = [f32p, f32p, f32p, ctypes.c_int, ctypes.c_uint8, u8p]
    lib.af_radio_encode_position.restype = None
    lib.af_radio_encode_simple.argtypes = [ctypes.c_uint8, ctypes.c_int, ctypes.c_uint8, u8p]
    lib.af_radio_encode_simple.restype = None
    lib.af_radio_decode.argtypes = [u8p, ctypes.c_int, i32p, i32p, f32p]
    lib.af_radio_decode.restype = None
    lib.af_telemetry_pack.argtypes = [u8p, u8p, u16p, ctypes.c_int, u8p]
    lib.af_telemetry_pack.restype = None
    lib.af_telemetry_unpack.argtypes = [u8p, ctypes.c_int, u8p, u8p, u16p]
    lib.af_telemetry_unpack.restype = None
    lib.af_logger_open.restype = ctypes.c_void_p
    lib.af_logger_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.af_logger_write_rows.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                                         ctypes.c_int, ctypes.c_int]
    lib.af_logger_write_rows.restype = None
    lib.af_logger_close.argtypes = [ctypes.c_void_p]
    lib.af_logger_close.restype = None

    _lib = lib
    return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def radio_encode_rates(thrust: np.ndarray, angvel: np.ndarray, flags=0) -> np.ndarray:
    """(N,), (N,3) -> (N, 23) uint8 packets."""
    lib = get_lib()
    thrust = np.ascontiguousarray(thrust, np.float32)
    angvel = np.ascontiguousarray(angvel, np.float32)
    n = thrust.shape[0]
    if angvel.shape != (n, 3):
        raise ValueError(f"angvel must be ({n}, 3), got {angvel.shape}")
    out = np.zeros((n, 23), np.uint8)
    lib.af_radio_encode_rates(
        _ptr(thrust, ctypes.c_float), _ptr(angvel, ctypes.c_float), n, flags,
        _ptr(out, ctypes.c_uint8),
    )
    return out


def radio_decode(raw: np.ndarray):
    """(N, 23) uint8 -> (types (N,), flags (N,), floats (N, 10))."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.ndim != 2 or raw.shape[1] != 23:
        raise ValueError(f"raw must be (N, 23), got {raw.shape}")
    n = raw.shape[0]
    types = np.zeros(n, np.int32)
    flags = np.zeros(n, np.int32)
    floats = np.zeros((n, 10), np.float32)
    lib.af_radio_decode(
        _ptr(raw, ctypes.c_uint8), n, _ptr(types, ctypes.c_int32),
        _ptr(flags, ctypes.c_int32), _ptr(floats, ctypes.c_float),
    )
    return types, flags, floats


def telemetry_pack(types: np.ndarray, numbers: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(N,), (N,), (N, 14) -> (N, 30) uint8 packets."""
    lib = get_lib()
    types = np.ascontiguousarray(types, np.uint8)
    numbers = np.ascontiguousarray(numbers, np.uint8)
    data = np.ascontiguousarray(data, np.uint16)
    n = types.shape[0]
    if numbers.shape != (n,) or data.shape != (n, 14):
        raise ValueError(f"need numbers ({n},) and data ({n}, 14), got {numbers.shape}, "
                         f"{data.shape}")
    out = np.zeros((n, 30), np.uint8)
    lib.af_telemetry_pack(
        _ptr(types, ctypes.c_uint8), _ptr(numbers, ctypes.c_uint8),
        _ptr(data, ctypes.c_uint16), n, _ptr(out, ctypes.c_uint8),
    )
    return out


def telemetry_unpack(raw: np.ndarray):
    """(N, 30) uint8 -> (types (N,), numbers (N,), data (N, 14))."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.ndim != 2 or raw.shape[1] != 30:
        raise ValueError(f"raw must be (N, 30), got {raw.shape}")
    n = raw.shape[0]
    types = np.zeros(n, np.uint8)
    numbers = np.zeros(n, np.uint8)
    data = np.zeros((n, 14), np.uint16)
    lib.af_telemetry_unpack(
        _ptr(raw, ctypes.c_uint8), n, _ptr(types, ctypes.c_uint8),
        _ptr(numbers, ctypes.c_uint8), _ptr(data, ctypes.c_uint16),
    )
    return types, numbers, data


class NativeCsvLogger:
    """Buffered CSV writer backed by the C++ logger."""

    def __init__(self, path, header: str):
        self._lib = get_lib()
        self._handle = self._lib.af_logger_open(str(path).encode(), header.encode())
        if not self._handle:
            raise OSError(f"cannot open {path} for writing")

    def write_rows(self, rows: np.ndarray):
        rows = np.ascontiguousarray(np.atleast_2d(rows), np.float64)
        self._lib.af_logger_write_rows(
            self._handle, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            rows.shape[0], rows.shape[1],
        )

    def close(self):
        if self._handle is not None:
            self._lib.af_logger_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
