"""ctypes binding for the native rANS entropy-coding core (``csrc/rans.cpp``).

The port's own copy of ``dcvc_tpu/ops/rans.py``'s native path: the same C
ABI and the same stream format, built with ``g++`` at first use into the
package's build directory. There is no pure-Python fallback: when the
native build fails, the coder raises.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ._build import build_shared

_SRC = Path(__file__).resolve().parent / "csrc" / "rans.cpp"
_CXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LOCK = threading.Lock()
_LIB = None

_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def _load_library():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path, _ = build_shared(_SRC, "rans", _CXX)
        lib = ctypes.CDLL(str(path))
        lib.rans_encoder_new.restype = ctypes.c_void_p
        lib.rans_encoder_new.argtypes = [ctypes.c_int]
        lib.rans_encoder_delete.argtypes = [ctypes.c_void_p]
        lib.rans_encoder_reset.argtypes = [ctypes.c_void_p]
        lib.rans_encoder_encode.argtypes = [
            ctypes.c_void_p, _I16P, _I16P, ctypes.c_int64,
            _I32P, ctypes.c_int64, ctypes.c_int64, _I32P, _I32P]
        lib.rans_encoder_flush.restype = ctypes.c_int64
        lib.rans_encoder_flush.argtypes = [ctypes.c_void_p]
        lib.rans_encoder_get_stream.argtypes = [ctypes.c_void_p, _U8P]
        lib.rans_decoder_new.restype = ctypes.c_void_p
        lib.rans_decoder_new.argtypes = [ctypes.c_int]
        lib.rans_decoder_delete.argtypes = [ctypes.c_void_p]
        lib.rans_decoder_set_stream.argtypes = [
            ctypes.c_void_p, _U8P, ctypes.c_int64]
        lib.rans_decoder_decode.argtypes = [
            ctypes.c_void_p, _I16P, ctypes.c_int64,
            _I32P, ctypes.c_int64, ctypes.c_int64, _I32P, _I32P, _I16P]
        lib.pmf_to_quantized_cdf.restype = ctypes.c_int
        lib.pmf_to_quantized_cdf.argtypes = [
            _F32P, ctypes.c_int64, ctypes.c_int, _I32P]
        _LIB = lib
        return _LIB


def _as_i16(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype=np.int16)


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


class RansEncoder:
    """N-way partitioned rANS encoder (one native thread per stream part)."""

    def __init__(self, stream_part: int = 1):
        self._lib = _load_library()
        self._h = self._lib.rans_encoder_new(int(stream_part))
        self._nbytes = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rans_encoder_delete(self._h)
            self._h = None

    def reset(self):
        self._lib.rans_encoder_reset(self._h)

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_sizes, offsets):
        symbols = _as_i16(symbols)
        indexes = _as_i16(indexes)
        if symbols.size != indexes.size:
            raise ValueError(f"{symbols.size} symbols vs {indexes.size} "
                             f"indexes")
        cdfs = _as_i32(cdfs)
        cdf_sizes = _as_i32(cdf_sizes).reshape(-1)
        offsets = _as_i32(offsets).reshape(-1)
        self._lib.rans_encoder_encode(
            self._h, symbols.ctypes.data_as(_I16P),
            indexes.ctypes.data_as(_I16P), symbols.size,
            cdfs.ctypes.data_as(_I32P), cdfs.shape[0], cdfs.shape[1],
            cdf_sizes.ctypes.data_as(_I32P), offsets.ctypes.data_as(_I32P))

    def flush(self):
        self._nbytes = self._lib.rans_encoder_flush(self._h)

    def get_encoded_stream(self) -> np.ndarray:
        out = np.empty(self._nbytes, dtype=np.uint8)
        self._lib.rans_encoder_get_stream(self._h, out.ctypes.data_as(_U8P))
        return out


class RansDecoder:
    def __init__(self, stream_part: int = 1):
        self._lib = _load_library()
        self._h = self._lib.rans_decoder_new(int(stream_part))
        self._stream = None

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rans_decoder_delete(self._h)
            self._h = None

    def set_stream(self, stream):
        # the native decoder reads from this buffer until the next set_stream
        self._stream = np.frombuffer(bytes(stream), dtype=np.uint8).copy()
        self._lib.rans_decoder_set_stream(
            self._h, self._stream.ctypes.data_as(_U8P), self._stream.size)

    def decode_stream(self, indexes, cdfs, cdf_sizes, offsets) -> np.ndarray:
        indexes = _as_i16(indexes)
        cdfs = _as_i32(cdfs)
        cdf_sizes = _as_i32(cdf_sizes).reshape(-1)
        offsets = _as_i32(offsets).reshape(-1)
        out = np.empty(indexes.size, dtype=np.int16)
        self._lib.rans_decoder_decode(
            self._h, indexes.ctypes.data_as(_I16P), indexes.size,
            cdfs.ctypes.data_as(_I32P), cdfs.shape[0], cdfs.shape[1],
            cdf_sizes.ctypes.data_as(_I32P), offsets.ctypes.data_as(_I32P),
            out.ctypes.data_as(_I16P))
        return out


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Quantize a pmf into a strictly increasing integer CDF (sum 2^precision)."""
    pmf = np.ascontiguousarray(np.asarray(pmf, dtype=np.float32).reshape(-1))
    out = np.empty(pmf.size + 1, dtype=np.int32)
    rc = _load_library().pmf_to_quantized_cdf(
        pmf.ctypes.data_as(_F32P), pmf.size, precision,
        out.ctypes.data_as(_I32P))
    if rc != 0:
        raise ValueError("pmf_to_quantized_cdf: degenerate pmf")
    return out
