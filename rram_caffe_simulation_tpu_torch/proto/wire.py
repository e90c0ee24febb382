"""A decoder for protobuf's binary wire format, without protobuf.

Enough for the records the slice reads: `Datum` (one LMDB value) and
`BlobProto` (a mean file such as examples/cifar10/mean.binaryproto).
Packed and unpacked repeated fields both decode; fields the schema does
not declare are skipped, as protobuf skips unknown fields.
"""
from __future__ import annotations

import struct

import numpy as np

from .message import Message, coerce
from .schema import MESSAGES


def _varint(buf: bytes, pos: int):
    out, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _signed(kind: str, v: int) -> int:
    if kind in ("int32", "int64", "enum") and v >= 1 << 63:
        return v - (1 << 64)
    return v


_PACKED = {"float": "<f4", "double": "<f8"}


def decode(buf: bytes, type_name: str) -> Message:
    """Decode serialized bytes as a message of schema type
    `type_name`."""
    mtype = MESSAGES[type_name]
    msg = Message(type_name)
    values = msg._values
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            raw, pos = _varint(buf, pos)
        elif wt == 1:
            raw, pos = buf[pos:pos + 8], pos + 8
        elif wt == 2:
            n, pos = _varint(buf, pos)
            raw, pos = buf[pos:pos + n], pos + n
        elif wt == 5:
            raw, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"{type_name}: unsupported wire type {wt}")
        f = mtype.by_number.get(num)
        if f is None:
            continue
        if f.kind == "message":
            vals = [decode(raw, f.type_name)]
        elif f.kind == "string":
            vals = [raw.decode("utf-8")]
        elif f.kind == "bytes":
            vals = [bytes(raw)]
        elif wt == 2:                                  # packed numbers
            if f.kind in _PACKED:
                vals = np.frombuffer(raw, _PACKED[f.kind]).tolist()
            else:
                vals, p = [], 0
                while p < len(raw):
                    v, p = _varint(raw, p)
                    vals.append(coerce(f.kind, _signed(f.kind, v)))
        elif wt == 5:
            vals = [struct.unpack("<f", raw)[0]]
        elif wt == 1:
            vals = [struct.unpack("<d", raw)[0]]
        else:
            vals = [coerce(f.kind, _signed(f.kind, raw))]
        if f.repeated:
            values.setdefault(f.name, []).extend(vals)
        else:
            values[f.name] = vals[-1]
    return msg


def decode_datum(buf: bytes) -> Message:
    return decode(buf, "Datum")


def decode_blob_proto(buf: bytes) -> Message:
    return decode(buf, "BlobProto")
