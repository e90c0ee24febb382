"""Protobuf's binary wire format, without protobuf.

`decode` reads the records the port loads: `Datum` (one LMDB value),
`BlobProto` (a mean file such as examples/cifar10/mean.binaryproto) and
a `NetParameter` with blobs (a `.caffemodel`). Packed and unpacked
repeated fields both decode; fields the schema does not declare are
skipped, as protobuf skips unknown fields.

`encode` is its inverse over the schema, the counterpart of protobuf's
`SerializeToString`: the set fields in field-number order, repeated
numbers packed where the schema says `[packed = true]`, so a message
the schema covers gives protobuf's bytes. A field the schema does not
declare (kept raw by the text reader) cannot be written and raises.
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


def _put_varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1                  # negatives as 64-bit two's complement
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _put_key(out: bytearray, num: int, wt: int) -> None:
    _put_varint(out, (num << 3) | wt)


_FIXED = {"float": (5, "<f4"), "double": (1, "<f8")}


def _put_value(out: bytearray, f, v) -> None:
    if f.kind in _FIXED:
        wt, dtype = _FIXED[f.kind]
        _put_key(out, f.number, wt)
        out += np.asarray(v, dtype).tobytes()
        return
    if f.kind in ("message", "string", "bytes"):
        raw = (encode(v) if f.kind == "message"
               else v.encode("utf-8") if f.kind == "string" else bytes(v))
        _put_key(out, f.number, 2)
        _put_varint(out, len(raw))
        out += raw
        return
    _put_key(out, f.number, 0)
    _put_varint(out, int(v))


def encode(msg: Message) -> bytes:
    """Serialize `msg` (the inverse of `decode`)."""
    mtype = msg._type
    if mtype is None:
        raise ValueError("a message of no schema type cannot be encoded")
    values = msg.set_fields()
    unknown = [k for k in values if k not in mtype.fields]
    if unknown:
        raise ValueError(f"{mtype.name}: fields {unknown} are not in the "
                         "port's schema and cannot be encoded")
    out = bytearray()
    for f in sorted((mtype.fields[k] for k in values),
                    key=lambda f: f.number):
        v = values[f.name]
        if not f.repeated:
            _put_value(out, f, v)
        elif f.packed:
            if f.kind in _FIXED:
                raw = np.asarray(v, _FIXED[f.kind][1]).tobytes()
            else:
                run = bytearray()
                for x in v:
                    _put_varint(run, int(x))
                raw = bytes(run)
            _put_key(out, f.number, 2)
            _put_varint(out, len(raw))
            out += raw
        else:
            for x in v:
                _put_value(out, f, x)
    return bytes(out)


def decode_datum(buf: bytes) -> Message:
    return decode(buf, "Datum")


def decode_blob_proto(buf: bytes) -> Message:
    return decode(buf, "BlobProto")
