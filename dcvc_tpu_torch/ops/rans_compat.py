"""Old-generation (CompressAI-style) rANS binding surface.

Parity target: the list-based pybind API of the older repos —
`BufferedRansEncoder.encode_with_indexes/flush/reset`, `RansDecoder.
set_stream/decode_stream` (DCVC-HEM/src/cpp/rans/rans_interface.cpp:246-261)
plus DCVC-TCM's `set_cdf`/`decode_with_indexes`/`decode_stream_only_indexes`
fast paths (DCVC-TCM/src/cpp/rans/rans_interface.cpp:369-392). Thin shims
over the array-API native coder (ops/rans.py) — symbols/indexes may be
python lists exactly as the reference passes them; streams are `bytes`.
The port's own copy of ``dcvc_tpu/ops/rans_compat.py``, over the port's
``ops/rans.py``: the same stream bytes.
"""

from __future__ import annotations

import numpy as np

from .rans import RansDecoder as _ArrayDecoder
from .rans import RansEncoder as _ArrayEncoder

__all__ = ["BufferedRansEncoder", "RansEncoder", "RansDecoder"]


class BufferedRansEncoder:
    """Buffers (symbols, indexes, tables) per call; `flush()` encodes and
    returns the stream bytes (reference rans_interface.cpp:102-144)."""

    def __init__(self):
        self._enc = _ArrayEncoder(stream_part=1)
        self._cached_cdf = None

    def reset(self):
        self._enc.reset()

    def set_cdf(self, cdfs, cdf_lengths, offsets):
        """TCM fast path: cache the tables for encode/decode_with_indexes."""
        self._cached_cdf = (cdfs, cdf_lengths, offsets)

    def encode_with_indexes(self, symbols, indexes, cdfs=None,
                            cdf_lengths=None, offsets=None):
        if cdfs is None:
            cdfs, cdf_lengths, offsets = self._cached_cdf
        self._enc.encode_with_indexes(symbols, indexes, cdfs, cdf_lengths,
                                      offsets)

    def flush(self) -> bytes:
        self._enc.flush()
        out = bytes(self._enc.get_encoded_stream())
        self._enc.reset()
        return out


class RansEncoder(BufferedRansEncoder):
    """The old one-shot encoder: encode_with_indexes returns the bytes
    directly (rans_interface.cpp:311-324)."""

    def encode_with_indexes(self, symbols, indexes, cdfs=None,
                            cdf_lengths=None, offsets=None):
        super().encode_with_indexes(symbols, indexes, cdfs, cdf_lengths,
                                    offsets)
        return self.flush()


class RansDecoder:
    def __init__(self):
        self._dec = _ArrayDecoder(stream_part=1)
        self._cached_cdf = None
        self._stream = None

    def set_stream(self, stream):
        self._stream = stream
        self._dec.set_stream(stream)

    def set_cdf(self, cdfs, cdf_lengths, offsets):
        self._cached_cdf = (cdfs, cdf_lengths, offsets)

    def decode_stream(self, indexes, cdfs=None, cdf_lengths=None,
                      offsets=None) -> list:
        if cdfs is None:
            cdfs, cdf_lengths, offsets = self._cached_cdf
        out = self._dec.decode_stream(indexes, cdfs, cdf_lengths, offsets)
        return np.asarray(out).tolist()

    def decode_stream_only_indexes(self, indexes) -> list:
        """TCM fast path over the cached tables."""
        return self.decode_stream(indexes)

    def decode_with_indexes(self, stream, indexes, cdfs=None,
                            cdf_lengths=None, offsets=None) -> list:
        """One-shot: set the stream then decode (rans_interface.cpp:326)."""
        self.set_stream(stream)
        return self.decode_stream(indexes, cdfs, cdf_lengths, offsets)
