"""A reader and a writer for protobuf's text format (`.prototxt`),
without protobuf.

The reader accepts what Caffe's prototxts use: `name: value` and
`name { ... }` (or `name: { ... }`, `< ... >`), `[a, b]` lists, `#`
comments, quoted strings with C escapes, adjacent string concatenation,
enum labels, `inf`/`nan`, and optional `,`/`;` separators. Fields the
schema (schema.py) declares are typed and defaulted; others are kept raw
so a prototxt with fields this package never reads still loads.

The writer, `to_text`, is the counterpart of protobuf's
`text_format.MessageToString` with its defaults: the set fields in
field-number order, one `name: value` line each (a repeated field one
line an element), nested messages as `name {` ... `}` indented by two
spaces, enum labels, strings C-escaped (non-ASCII characters kept, as
protobuf's `as_utf8` default keeps them; `bytes` escaped byte by byte),
`float` fields in the shortest form that reads back to the same float32
and `double` fields as Python's `str`.
"""
from __future__ import annotations

import codecs
import math
import re
import struct
from typing import List

from .message import Message, coerce
from .schema import enum_table

_TOKEN = re.compile(r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<str>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')
  | (?P<word>[-+]?(?:0[xX][0-9a-fA-F]+
                    |(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?[fF]?
                    |[A-Za-z_][\w.]*))
  | (?P<punct>[{}<>\[\]:,;])
""", re.VERBOSE)


class ParseError(ValueError):
    pass


def tokenize(text: str) -> List[tuple]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            line = text.count("\n", 0, pos) + 1
            raise ParseError(f"line {line}: unexpected {text[pos:pos + 20]!r}")
        pos = m.end()
        if m.lastgroup != "ws":
            out.append((m.lastgroup, m.group(m.lastgroup)))
    return out


def _unquote(tok: str) -> bytes:
    return codecs.escape_decode(tok[1:-1].encode("utf-8"))[0]


def _number(tok: str):
    low = tok.lower().lstrip("+-")
    neg = tok.startswith("-")
    if low in ("inf", "infinity"):
        return float("-inf") if neg else float("inf")
    if low == "nan":
        return float("nan")
    if low.startswith("0x"):
        return int(tok, 16)
    if re.fullmatch(r"[-+]?\d+", tok):
        return int(tok)
    return float(tok.rstrip("fF"))


class _Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def take(self, expect=None):
        kind, tok = self.peek()
        if tok is None or (expect is not None and tok != expect):
            raise ParseError(f"expected {expect!r}, got {tok!r}")
        self.i += 1
        return kind, tok

    def message_body(self, msg: Message, close=None):
        while True:
            kind, tok = self.peek()
            if tok is None:
                if close is not None:
                    raise ParseError(f"missing {close!r}")
                return
            if tok == close:
                self.take()
                return
            if kind != "word":
                raise ParseError(f"expected a field name, got {tok!r}")
            self.take()
            self.field(msg, tok)
            if self.peek()[1] in (",", ";"):
                self.take()

    def field(self, msg: Message, name: str):
        f = msg._field(name)
        if self.peek()[1] == ":":
            self.take()
        if self.peek()[1] == "[":
            self.take()
            while self.peek()[1] != "]":
                self.value(msg, name, f)
                if self.peek()[1] == ",":
                    self.take()
            self.take("]")
        else:
            self.value(msg, name, f)

    def value(self, msg: Message, name: str, f):
        _, tok = self.peek()
        if tok in ("{", "<"):
            self.take()
            child = Message(f.type_name if f is not None else "")
            self.message_body(child, "}" if tok == "{" else ">")
            _store(msg, name, f, child)
            return
        kind, tok = self.take()
        if kind == "str":
            raw = _unquote(tok)
            while self.peek()[0] == "str":          # "a" "b" -> "ab"
                raw += _unquote(self.take()[1])
            val = raw if f is not None and f.kind == "bytes" \
                else raw.decode("utf-8")
        elif kind == "word":
            val = _word(msg, f, tok)
        else:
            raise ParseError(f"field {name!r}: unexpected {tok!r}")
        _store(msg, name, f, val)


def _word(msg: Message, f, tok: str):
    if f is not None and f.kind == "enum":
        table = enum_table(msg.type_name, f.type_name) or {}
        if tok in table:
            return table[tok]
        return int(tok)
    if f is not None and f.kind == "bool" or tok in ("true", "false",
                                                     "True", "False"):
        if tok in ("true", "True", "t", "1"):
            return True
        if tok in ("false", "False", "f", "0"):
            return False
        raise ParseError(f"bad bool {tok!r}")
    if f is None and re.fullmatch(r"[A-Za-z_]\w*", tok) and \
            tok.lower() not in ("inf", "infinity", "nan"):
        return tok                                   # raw enum label
    return _number(tok)


def _store(msg: Message, name: str, f, val):
    values = msg._values
    if f is not None:
        if f.kind != "message" and not isinstance(val, Message):
            val = coerce(f.kind, val)
        if f.repeated:
            values.setdefault(name, []).append(val)
        elif name in values:
            raise ParseError(f"{msg.type_name}: field {name!r} set twice")
        else:
            values[name] = val
        return
    # a field the schema does not declare: a second occurrence makes
    # it a list
    if name in values:
        prev = values[name]
        values[name] = (prev if isinstance(prev, list) else [prev]) + [val]
    else:
        values[name] = val


def parse(text: str, type_name: str) -> Message:
    """Parse prototxt `text` as a message of schema type `type_name`."""
    msg = Message(type_name)
    _Parser(text).message_body(msg)
    return msg


# ---------------------------------------------------------------------------
# the writer

# protobuf's text_encoding.CEscape: a `string` field's characters below
# 128 (MessageToString's as_utf8 default keeps the others), a `bytes`
# field's every byte
_STR_ESCAPES = {i: "\\%03o" % i for i in range(128) if not 32 <= i < 127}
_STR_ESCAPES.update({9: r"\t", 10: r"\n", 13: r"\r", 34: r'\"', 39: r"\'",
                     92: r"\\"})
_BYTE_ESCAPES = {i: _STR_ESCAPES.get(i, chr(i)) if i < 128 else "\\%03o" % i
                 for i in range(256)}


def _f32(v: float) -> float:
    return struct.unpack("<f", struct.pack("<f", v))[0]


def shortest_float(v: float) -> str:
    """A float32 value as protobuf prints it (type_checkers
    .ToShortestFloat): the fewest significant digits, from 6 up, whose
    value rounds back to the same float32, then Python's `str`."""
    if math.isnan(v):
        return str(v)
    precision = 6
    rounded = float(f"{v:.{precision}g}")
    while _f32(rounded) != v:
        precision += 1
        rounded = float(f"{v:.{precision}g}")
    return str(rounded)


def _scalar_text(msg: Message, f, v) -> str:
    if f.kind == "enum":
        table = enum_table(msg.type_name, f.type_name) or {}
        names = {num: label for label, num in table.items()}
        return names.get(int(v), str(int(v)))
    if f.kind == "string":
        return '"' + v.translate(_STR_ESCAPES) + '"'
    if f.kind == "bytes":
        return '"' + "".join(_BYTE_ESCAPES[c] for c in bytes(v)) + '"'
    v = coerce(f.kind, v)
    if f.kind == "bool":
        return "true" if v else "false"
    if f.kind == "float":
        return shortest_float(v)
    return str(v)


def _write(msg: Message, indent: int, out: list) -> None:
    mtype = msg._type
    if mtype is None:
        raise ValueError("a message of no schema type cannot be written")
    values = msg.set_fields()
    unknown = [k for k in values if k not in mtype.fields]
    if unknown:
        raise ValueError(f"{mtype.name}: fields {unknown} are not in the "
                         "port's schema and cannot be written")
    pad = " " * indent
    for f in sorted((mtype.fields[k] for k in values),
                    key=lambda f: f.number):
        v = values[f.name]
        for item in (v if f.repeated else [v]):
            if f.kind == "message":
                out.append(f"{pad}{f.name} {{\n")
                _write(item, indent + 2, out)
                out.append(f"{pad}}}\n")
            else:
                out.append(f"{pad}{f.name}: {_scalar_text(msg, f, item)}\n")


def to_text(msg: Message) -> str:
    """`msg` in text format, line for line what protobuf's
    `text_format.MessageToString` gives for the same message. A field
    the schema does not declare (kept raw by the reader) cannot be
    written and raises."""
    out: list = []
    _write(msg, 0, out)
    return "".join(out)
