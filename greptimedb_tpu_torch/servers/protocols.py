"""Wire-protocol parsing for the push entry points: the Loki push.

A host copy of the parts of the JAX package's ``servers/protocols.py``
that ``servers/ingest.py`` calls: the minimal protobuf wire walker and
``parse_loki_push`` (logproto.PushRequest, reference
``src/servers/src/http/loki.rs``).  Nothing here touches a device.
"""

from __future__ import annotations

from greptimedb_tpu_torch.errors import InvalidArguments


def _pb_fields(data: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int) from a message."""
    pos = 0
    n = len(data)
    while pos < n:
        key = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        field, wtype = key >> 3, key & 0x07
        if wtype == 0:  # varint
            v = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            yield field, wtype, v
        elif wtype == 1:  # 64-bit
            yield field, wtype, data[pos:pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            yield field, wtype, data[pos:pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            yield field, wtype, data[pos:pos + 4]
            pos += 4
        else:
            raise InvalidArguments(f"unsupported protobuf wire type {wtype}")


def _zigzag_or_signed(v: int) -> int:
    """Interpret a varint as a signed int64 (two's complement)."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


# ---------------------------------------------------------------------------
# Loki protobuf push (snappy logproto.PushRequest)
# ---------------------------------------------------------------------------

def _parse_loki_labels(s: str) -> dict[str, str]:
    """`{job="api", env="prod"}` → dict (Loki's label-set string form)."""
    out: dict[str, str] = {}
    s = s.strip()
    if s.startswith("{"):
        s = s[1:]
    if s.endswith("}"):
        s = s[:-1]
    i, n = 0, len(s)
    while i < n:
        while i < n and s[i] in ", \t":
            i += 1
        j = i
        while j < n and s[j] not in "=":
            j += 1
        name = s[i:j].strip()
        i = j + 1
        if i < n and s[i] == '"':
            i += 1
            val = []
            while i < n and s[i] != '"':
                if s[i] == "\\" and i + 1 < n:
                    i += 1
                val.append(s[i])
                i += 1
            i += 1  # closing quote
            if name:
                out[name] = "".join(val)
        else:  # unquoted (not produced by real clients; be lenient)
            j = i
            while j < n and s[j] not in ",}":
                j += 1
            if name:
                out[name] = s[i:j].strip()
            i = j
    return out


def parse_loki_push(body: bytes) -> list[tuple[dict, str, int]]:
    """logproto.PushRequest → [(labels, line, ts_ms)].

    PushRequest{ streams=1: StreamAdapter{ labels=1 (label-set string),
    entries=2: EntryAdapter{ timestamp=1 (Timestamp{seconds=1,nanos=2}),
    line=2 } } } — the snappy layer is the caller's concern.
    """
    rows: list[tuple[dict, str, int]] = []
    for field, _wt, stream_bytes in _pb_fields(body):
        if field != 1:
            continue
        labels: dict[str, str] = {}
        entries: list[tuple[int, str]] = []
        for f2, _wt2, v2 in _pb_fields(stream_bytes):
            if f2 == 1:  # labels string
                labels = _parse_loki_labels(v2.decode("utf-8", "replace"))
            elif f2 == 2:  # EntryAdapter
                secs = nanos = 0
                line = ""
                for f3, _wt3, v3 in _pb_fields(v2):
                    if f3 == 1:  # Timestamp
                        for f4, _wt4, v4 in _pb_fields(v3):
                            if f4 == 1:
                                secs = _zigzag_or_signed(v4)
                            elif f4 == 2:
                                nanos = _zigzag_or_signed(v4)
                    elif f3 == 2:
                        line = v3.decode("utf-8", "replace")
                entries.append((secs * 1000 + nanos // 1_000_000, line))
        for ts_ms, line in entries:
            rows.append((labels, line, ts_ms))
    return rows
