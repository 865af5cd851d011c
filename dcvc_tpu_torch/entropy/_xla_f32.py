"""The f32 exp / softplus / sigmoid / tanh that XLA's CPU backend emits.

The factorized-prior tables (bit_estimator.build_factorized_tables) are a
quantization of f32 CDF values. XLA:CPU evaluates exp, log1p and tanh with
its own polynomials, which differ from PyTorch's (libm-accurate) results in
the last ulp for a large share of inputs, and those ulps flip quantized CDF
entries in a few percent of channels. These numpy versions repeat XLA's
instruction sequence (each op rounded to f32, a fused multiply-add wherever
the backend contracts a multiply into an add), so the port bakes tables
byte-identical to the JAX package's and streams stay interchangeable
between the two packages.
Host-only; used for table baking, never on the device path.
"""

from __future__ import annotations

import struct

import numpy as np

f32 = np.float32


def _c(hex64: str) -> np.float32:
    """An f32 constant as LLVM IR prints it (the double's hex pattern)."""
    return f32(struct.unpack(">d", bytes.fromhex(hex64))[0])


_EXP_LO, _EXP_HI = _c("C055F33340000000"), _c("4056333340000000")
_LOG2E = _c("3FF7154760000000")
_LN2_HI, _LN2_LO = _c("3FE6300000000000"), _c("BF2BD01060000000")
_EXP_P = [_c(h) for h in ("3F2A0D2CE0000000", "3F56E879C0000000",
                          "3F81112100000000", "3FA5553820000000",
                          "3FC5555540000000")]
_LOG_SQRTHF = _c("3FE6A09E60000000")
_LOG_P = [_c(h) for h in ("3FB2043760000000", "BFBD7A3700000000",
                          "3FBDE4A340000000", "BFBFCBA9E0000000",
                          "3FC23D37E0000000", "BFC555CA00000000",
                          "3FC999D580000000", "BFCFFFFF80000000",
                          "3FD5555540000000")]
_LOG1P_SMALL = _c("3FDA8279A0000000")
_LOG1P_DEN = [_c(h) for h in ("402E2035A0000000", "4054C30B60000000",
                              "406BB865A0000000", "4073519460000000",
                              "406B0DB140000000", "404E0F3040000000")]
_LOG1P_NUM = [_c(h) for h in ("3F07BC0960000000", "3FDFE818A0000000",
                              "401A509F40000000", "403DE97380000000",
                              "404E798EC0000000", "404C8E75A0000000",
                              "40340A2020000000")]
_TANH_CLAMP = f32(7.99881172180175781)
_TANH_NUM = [f32(v) for v in (-2.76076847742355e-16, 2.00018790482477e-13,
                              -8.60467152213735e-11, 5.12229709037114e-08,
                              1.48572235717979e-05, 6.37261928875436e-04,
                              4.89352455891786e-03)]
_TANH_DEN = [f32(v) for v in (1.19825839466702e-06, 1.18534705686654e-04,
                              2.26843463243900e-03, 4.89352518554385e-03)]


def _fma(a, b, c):
    # a * b is exact in f64; one f64 rounding of the sum, then f32
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def exp(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, f32)
    x = np.where(x < _EXP_LO, _EXP_LO, x)
    x = np.where(x > _EXP_HI, _EXP_HI, x)
    m = np.clip(np.floor(_fma(x, _LOG2E, f32(0.5))), f32(-127), f32(127))
    r = _fma(-m, _LN2_LO, _fma(-m, _LN2_HI, x))
    p = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in (*_EXP_P[2:], f32(0.5)):
        p = _fma(p, r, c)
    y = _fma(p, r * r, r) + f32(1.0)
    with np.errstate(over="ignore"):
        return y * ((m.astype(np.int32) + 127) << 23).view(f32)


def _log(u: np.ndarray) -> np.ndarray:
    """log for u >= 1 (the only range softplus feeds it)."""
    u = np.maximum(u, _c("3810000000000000"))
    bits = u.view(np.int32)
    e1 = ((bits >> 23) - 127).astype(f32) + f32(1.0)
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(f32)
    small = mant < _LOG_SQRTHF
    xm = (mant + f32(-1.0)) + np.where(small, mant, f32(0.0))
    ee = e1 - np.where(small, f32(1.0), f32(0.0))
    x2 = xm * xm
    x3 = x2 * xm
    a = _LOG_P
    y1 = _fma(_fma(xm, a[0], a[1]), xm, a[2])
    y2 = _fma(_fma(xm, a[3], a[4]), xm, a[5])
    y3 = _fma(_fma(xm, a[6], a[7]), xm, a[8])
    y = _fma(_fma(y1, x3, y2), x3, y3)
    y = _fma(y, x3, ee * _LN2_LO)
    return _fma(ee, _LN2_HI, _fma(x2, f32(-0.5), xm) + y)


def _log1p(e: np.ndarray) -> np.ndarray:
    x2 = e * e
    den = e + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, e, c)
    num = np.full_like(e, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, e, c)
    small = e + _fma(x2, f32(-0.5), (e * x2) * (num / den))
    return np.where(np.abs(e) < _LOG1P_SMALL, small, _log(e + f32(1.0)))


def softplus(x: np.ndarray) -> np.ndarray:
    """jax.nn.softplus = logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    x = np.asarray(x, f32)
    return np.maximum(x, f32(0.0)) + _log1p(exp(-np.abs(x)))


def sigmoid(x: np.ndarray) -> np.ndarray:
    return f32(1.0) / (exp(-np.asarray(x, f32)) + f32(1.0))


def tanh(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, f32)
    xc = np.clip(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    p = np.full_like(xc, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        p = _fma(x2, p, c)
    q = np.full_like(xc, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        q = _fma(x2, q, c)
    return np.where(np.abs(x) < f32(0.0004), x, (xc * p) / q)
