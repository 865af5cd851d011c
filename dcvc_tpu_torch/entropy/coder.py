"""Host-side entropy coder over the native rANS core.

Counterpart of ``dcvc_tpu/entropy/coder.py`` (parity target: EntropyCoder,
reference DCVC-DC/src/models/entropy_models.py:9-55). Takes numpy symbol and
cdf-index planes, clamps symbols to the int16 range, and drives the
partitioned native coder. ``AsyncEntropyCoder`` overlaps encoding with
device compute on a worker thread (ctypes calls release the GIL).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from ..ops.rans import RansDecoder, RansEncoder
from ..utils import trace


@dataclass
class CdfTable:
    """Baked quantized-CDF tables shared by encoder and decoder."""

    quantized_cdf: np.ndarray  # int32 [num_cdfs, max_len + 2]
    cdf_length: np.ndarray     # int32 [num_cdfs]
    offset: np.ndarray         # int32 [num_cdfs]


def np_i16_symbols(x) -> np.ndarray:
    a = np.asarray(x).reshape(-1)
    return np.clip(a, -30000, 30000).astype(np.int16)


class EntropyCoder:
    """The boundary to the native coder: each call below is a ``rans``
    span (its ``op``), and ``rans.symbols`` counts the symbols encoded
    plus those decoded."""

    def __init__(self, stream_part: int = 1):
        self.encoder = RansEncoder(stream_part)
        self.decoder = RansDecoder(stream_part)

    def reset(self):
        self.encoder.reset()

    def encode_with_indexes(self, symbols, indexes, table: CdfTable):
        with trace.span("rans", op="encode_with_indexes"):
            sym = np_i16_symbols(symbols)
            self.encoder.encode_with_indexes(
                sym, np.asarray(indexes).reshape(-1).astype(np.int16),
                table.quantized_cdf, table.cdf_length, table.offset)
        trace.count("rans.symbols", sym.size)

    def flush(self):
        with trace.span("rans", op="flush"):
            self.encoder.flush()

    def get_encoded_stream(self) -> bytes:
        with trace.span("rans", op="get_encoded_stream"):
            return self.encoder.get_encoded_stream().tobytes()

    def set_stream(self, stream: bytes):
        with trace.span("rans", op="set_stream"):
            self.decoder.set_stream(stream)

    def decode_stream(self, indexes, table: CdfTable) -> np.ndarray:
        with trace.span("rans", op="decode_stream"):
            out = self.decoder.decode_stream(
                np.asarray(indexes).reshape(-1).astype(np.int16),
                table.quantized_cdf, table.cdf_length, table.offset)
        trace.count("rans.symbols", out.size)
        return out


class AsyncEntropyCoder(EntropyCoder):
    """Encoder work runs on a background thread, overlapping device compute.

    Every submitted job is read back: an encode failure is re-raised at the
    next ``get_encoded_stream``."""

    def __init__(self, stream_part: int = 1):
        super().__init__(stream_part)
        self._q: queue.Queue = queue.Queue()
        self._flushed = threading.Event()
        self._error: BaseException | None = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            kind, payload = item
            try:
                if kind == "encode":
                    super().encode_with_indexes(*payload)
                elif kind == "flush":
                    super().flush()
            except Exception as e:  # reported by get_encoded_stream
                self._error = e
            if kind == "flush":
                self._flushed.set()

    def reset(self):
        self._drain()
        super().reset()
        self._flushed.clear()
        self._error = None

    def encode_with_indexes(self, symbols, indexes, table: CdfTable):
        self._q.put(("encode", (np.asarray(symbols), np.asarray(indexes),
                                table)))

    def flush(self):
        self._q.put(("flush", None))

    def get_encoded_stream(self) -> bytes:
        self._flushed.wait()
        self._flushed.clear()
        if self._error is not None:
            raise RuntimeError("asynchronous encode failed") from self._error
        return super().get_encoded_stream()

    def _drain(self):
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=60)
