"""Message objects with protobuf's read semantics, without protobuf.

A `Message` answers attribute reads the way a generated proto2 class
does: a set field returns its value, an unset scalar its default (the
schema's, else the kind's zero), an unset message field an empty child
whose own fields read as defaults, a repeated field a list. Assigning
to a field of such a child marks the child and its parents as set, so
`sp.failure_pattern.mean = 1e8` works as it does on a generated class.
`float` fields are rounded to float32 on the way in, as protobuf stores
them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .schema import MESSAGES

_ZERO = {"double": 0.0, "float": 0.0, "int32": 0, "int64": 0, "uint32": 0,
         "uint64": 0, "bool": False, "string": "", "bytes": b"", "enum": 0}


def coerce(kind: str, value):
    """A scalar as protobuf's Python API returns it."""
    if kind == "float":
        return float(np.float32(value))
    if kind == "double":
        return float(value)
    if kind == "bool":
        return bool(value)
    if kind in ("int32", "int64", "uint32", "uint64", "enum"):
        return int(value)
    return value


class Message:
    """One message instance of schema type `type_name` ("" =
    schema-less: a message the schema does not declare, kept raw)."""

    __slots__ = ("_type", "_values", "_parent")

    def __init__(self, type_name: str = ""):
        object.__setattr__(self, "_type", MESSAGES.get(type_name))
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_parent", None)

    @property
    def type_name(self) -> str:
        return self._type.name if self._type else ""

    def _field(self, name: str):
        return self._type.fields.get(name) if self._type else None

    def _mark_set(self):
        """Attach this message, and each unset parent it was read
        through, at its own level (`sp.a.b.x = 1` sets `b` in `a` and
        `a` in `sp`)."""
        child, p = self, self._parent
        while p is not None:
            parent, name = p
            parent._values.setdefault(name, child)
            child, p = parent, parent._parent

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        values = self._values
        if name in values:
            return values[name]
        f = self._field(name)
        if f is None:
            raise AttributeError(
                f"{self.type_name or 'message'} has no field {name!r}")
        if f.repeated:
            values[name] = []
            return values[name]
        if f.kind == "message":
            child = Message(f.type_name)
            object.__setattr__(child, "_parent", (self, name))
            return child
        return f.default if f.default is not None else _ZERO[f.kind]

    def __setattr__(self, name: str, value):
        f = self._field(name)
        if f is not None and not f.repeated and f.kind != "message":
            value = coerce(f.kind, value)
        self._values[name] = value
        self._mark_set()

    def HasField(self, name: str) -> bool:
        return name in self._values and not isinstance(self._values[name],
                                                       list)

    def ClearField(self, name: str) -> None:
        self._values.pop(name, None)

    def set_fields(self) -> Dict[str, Any]:
        """The fields present in this message (non-empty repeated
        fields included), in insertion order."""
        return {k: v for k, v in self._values.items()
                if not (isinstance(v, list) and not v)}

    def __eq__(self, other):
        """Same type and the same set fields, as protobuf compares."""
        if not isinstance(other, Message):
            return NotImplemented
        return (self.type_name == other.type_name
                and self.set_fields() == other.set_fields())

    __hash__ = None

    def copy(self) -> "Message":
        out = Message(self.type_name)
        for k, v in self._values.items():
            if isinstance(v, Message):
                v = v.copy()
            elif isinstance(v, list):
                v = [x.copy() if isinstance(x, Message) else x for x in v]
            out._values[k] = v
        return out

    def __repr__(self):
        return f"<{self.type_name or 'Message'} {self.set_fields()!r}>"
