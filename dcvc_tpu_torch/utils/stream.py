"""In-memory bitstream containers of the DCVC-DC write-stream path.

The port's own copy of ``dcvc_tpu/utils/stream.py``'s DC containers
(parity target: DCVC-DC/src/utils/stream_helper.py:94-139, I/P headers with
a q_in_ckpt flag and a 6-bit q_index) and of ``get_rounded_q`` (DCVC-HEM
stream_helper.py:41-45). Byte-identical to the JAX package's containers.
"""

from __future__ import annotations

import struct

import numpy as np


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
