"""Base128 varints and tagged length-prefix framing, byte-identical to the
JAX package's client plane (counterpart: ``_varint``, ``_read_varint`` and
``frame`` of janus_tpu/net/client.py). The DAG plane's subtype framing:
the frame's field number names the message type (the reference's
CMNode.cs:81 convention)."""
from __future__ import annotations


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _read_varint(buf: bytes, off: int):
    """``(value, offset after it)``, or ``(None, off)`` when ``buf`` ends
    first; raises ValueError on a varint longer than 10 bytes."""
    v = 0
    for i in range(10):
        if off >= len(buf):
            return None, off
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return v, off
    raise ValueError("malformed varint")


def frame(payload: bytes, field: int = 1) -> bytes:
    """Tagged Base128 length-prefix framing: tag ``field << 3 | 2``, the
    payload's length, the payload."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload
