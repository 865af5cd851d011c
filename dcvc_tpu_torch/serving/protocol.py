"""Wire framing of the warm codec server (``serving/server.py``), the port's
own copy of ``dcvc_tpu/serving/protocol.py``: the same bytes, so either
package's client talks to either package's server.

One message = a JSON header plus zero or more binary payloads:

    u32be header_len | header (UTF-8 JSON) | u32be n_payloads
    repeat n_payloads times: u32be payload_len | payload bytes

The same framing is used for requests and responses. Responses carry
``{"ok": true, ...}`` or ``{"ok": false, "error": "..."}`` in the header.
"""

from __future__ import annotations

import json
import socket
import struct


def send_msg(sock: socket.socket, header: dict, payloads=()) -> None:
    hb = json.dumps(header).encode("utf-8")
    parts = [struct.pack(">I", len(hb)), hb,
             struct.pack(">I", len(payloads))]
    for p in payloads:
        p = bytes(p)
        parts.append(struct.pack(">I", len(p)))
        parts.append(p)
    sock.sendall(b"".join(parts))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket):
    """Returns (header_dict, [payload bytes, ...]); None on clean EOF."""
    first = sock.recv(4)
    if not first:
        return None
    while len(first) < 4:
        chunk = sock.recv(4 - len(first))
        if not chunk:
            raise ConnectionError("peer closed mid-length")
        first += chunk
    (hlen,) = struct.unpack(">I", first)
    header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    payloads = []
    for _ in range(n):
        (plen,) = struct.unpack(">I", _recv_exact(sock, 4))
        payloads.append(_recv_exact(sock, plen))
    return header, payloads
