"""ctypes bindings to the C math library's float32 entry points.

Host-side bit-parity with the reference engine requires the *same* libm
the reference binary uses (glibc's sinf/cosf/powf are not always correctly
rounded, so computing in f64 and rounding differs by 1 ulp on some inputs).
Only used in host-side precompute paths (wavetable generation, filter
coefficients, frequency math) — never on the device."""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")

for _name in ("sinf", "cosf", "powf", "fmodf", "expf", "logf"):
    _f = getattr(_libm, _name)
    _f.restype = ctypes.c_float
    _f.argtypes = [ctypes.c_float] * (2 if _name in ("powf", "fmodf") else 1)


def sinf(x) -> np.float32:
    return np.float32(_libm.sinf(ctypes.c_float(float(x))))


def cosf(x) -> np.float32:
    return np.float32(_libm.cosf(ctypes.c_float(float(x))))


def powf(x, y) -> np.float32:
    return np.float32(_libm.powf(ctypes.c_float(float(x)), ctypes.c_float(float(y))))


def fmodf(x, y) -> np.float32:
    return np.float32(_libm.fmodf(ctypes.c_float(float(x)), ctypes.c_float(float(y))))


def sinf_array(x: np.ndarray) -> np.ndarray:
    return np.array([_libm.sinf(ctypes.c_float(float(v))) for v in x], dtype=np.float32)
