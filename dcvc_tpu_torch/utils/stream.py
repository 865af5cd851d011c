"""Bitstream containers of the write-stream paths, in memory and as
``.bin`` files.

The port's own copy of ``dcvc_tpu/utils/stream.py``'s DC containers
(parity target: DCVC-DC/src/utils/stream_helper.py:94-139, I/P headers with
a q_in_ckpt flag and a 6-bit q_index), its HEM/EVC I container (a rounded-q
ushort in the header, ``encode_i_ushort_q``), ``get_rounded_q``
(DCVC-HEM stream_helper.py:41-45) and the gen-1 multi-substream
containers (``pack_strings``, ``encode_i_strings``; DCVC/src/utils/
stream_helper.py:108-163). Byte-identical to the JAX package's
containers.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def filesize(filepath: str) -> int:
    return Path(filepath).stat().st_size


def get_rounded_q(q_scale: float):
    """Quantize q_scale to 1/100 into a ushort."""
    q_scale = float(np.clip(q_scale, 0.01, 655.0))
    q_index = int(round(q_scale * 100))
    return q_index / 100, q_index


def pack_i(height, width, q_in_ckpt, q_index, bit_stream) -> bytes:
    return (struct.pack(">2I", height, width)
            + struct.pack(">B", (int(q_in_ckpt) << 7) + (q_index << 1))
            + struct.pack(">I", len(bit_stream))
            + bytes(bit_stream))


def unpack_i(data: bytes):
    height, width = struct.unpack(">2I", data[:8])
    flag = data[8]
    q_in_ckpt = (flag >> 7) > 0
    q_index = (flag & 0x7F) >> 1
    length = struct.unpack(">I", data[9:13])[0]
    return height, width, q_in_ckpt, q_index, data[13:13 + length]


def pack_p(string, q_in_ckpt, q_index, frame_idx) -> bytes:
    return (struct.pack(">B", (int(q_in_ckpt) << 7) + (q_index << 1))
            + struct.pack(">B", frame_idx)
            + struct.pack(">I", len(string))
            + bytes(string))


def unpack_p(data: bytes):
    flag = data[0]
    q_in_ckpt = (flag >> 7) > 0
    q_index = (flag & 0x7F) >> 1
    frame_idx = data[1]
    length = struct.unpack(">I", data[2:6])[0]
    return q_in_ckpt, q_index, frame_idx, data[6:6 + length]


def encode_i(height, width, q_in_ckpt, q_index, bit_stream, output):
    Path(output).write_bytes(pack_i(height, width, q_in_ckpt, q_index,
                                    bit_stream))


def decode_i(inputpath):
    return unpack_i(Path(inputpath).read_bytes())


def encode_p(string, q_in_ckpt, q_index, frame_idx, output):
    Path(output).write_bytes(pack_p(string, q_in_ckpt, q_index, frame_idx))


def decode_p(inputpath):
    return unpack_p(Path(inputpath).read_bytes())


# -- HEM/EVC style: rounded-q ushort in the header --------------------------

def pack_i_ushort_q(height, width, q_index, bit_stream) -> bytes:
    return (struct.pack(">2I", height, width) + struct.pack(">H", q_index)
            + struct.pack(">I", len(bit_stream)) + bytes(bit_stream))


def unpack_i_ushort_q(data: bytes):
    height, width = struct.unpack(">2I", data[:8])
    q_index = struct.unpack(">H", data[8:10])[0]
    length = struct.unpack(">I", data[10:14])[0]
    return height, width, q_index, data[14:14 + length]


def encode_i_ushort_q(height, width, q_index, bit_stream, output):
    Path(output).write_bytes(pack_i_ushort_q(height, width, q_index,
                                             bit_stream))


def decode_i_ushort_q(inputpath):
    return unpack_i_ushort_q(Path(inputpath).read_bytes())


# -- gen-1 style: N length-prefixed substreams ------------------------------

def pack_strings(strings) -> bytes:
    """Length-prefix N substreams into one payload (gen-1 P-frames carry
    mv_z / mv_y / z / y apart, DCVC/src/utils/stream_helper.py:127-146)."""
    out = [struct.pack(">B", len(strings))]
    for s in strings:
        out.append(struct.pack(">I", len(s)))
        out.append(s)
    return b"".join(out)


def unpack_strings(payload: bytes) -> list:
    if len(payload) < 1:
        raise ValueError("empty substream container")
    n = payload[0]
    strings, off = [], 1
    for i in range(n):
        if off + 4 > len(payload):
            raise ValueError(f"corrupt substream container: truncated length "
                             f"field for part {i}")
        length = struct.unpack(">I", payload[off:off + 4])[0]
        off += 4
        if off + length > len(payload):
            raise ValueError(f"corrupt substream container: part {i} wants "
                             f"{length} bytes, {len(payload) - off} left")
        strings.append(payload[off:off + length])
        off += length
    return strings


def encode_i_strings(height, width, strings, output):
    """The zoo's I-frame file: h, w and its latents' strings, each with its
    length."""
    Path(output).write_bytes(struct.pack(">2I", height, width)
                             + pack_strings(strings))


def decode_i_strings(inputpath):
    data = Path(inputpath).read_bytes()
    height, width = struct.unpack(">2I", data[:8])
    return height, width, unpack_strings(data[8:])
