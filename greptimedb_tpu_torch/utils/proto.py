"""Protobuf wire encoding, the ONE copy (decoding twin: the _pb_fields
walker in servers/protocols.py).  Shared by the OTLP span exporter
(utils/tracing.py), the Prometheus remote-read response encoder
(servers/protocols.py), and the protocol tests."""

from __future__ import annotations

import struct


def pb_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b7 = v & 0x7F
        v >>= 7
        out.append(b7 | (0x80 if v else 0))
        if not v:
            return bytes(out)


def pb_tag(field: int, wtype: int) -> bytes:
    return pb_varint((field << 3) | wtype)


def pb_len(field: int, payload: bytes) -> bytes:
    return pb_tag(field, 2) + pb_varint(len(payload)) + payload


def pb_vint_field(field: int, v: int) -> bytes:
    return pb_tag(field, 0) + pb_varint(v)


def pb_fixed64(field: int, v: int) -> bytes:
    return pb_tag(field, 1) + struct.pack("<Q", v)


def pb_double(field: int, v: float) -> bytes:
    return pb_tag(field, 1) + struct.pack("<d", v)
