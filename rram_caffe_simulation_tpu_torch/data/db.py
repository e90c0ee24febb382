"""Datum databases (counterpart of the reference package's data/db.py;
reference util/db.{hpp,cpp}, db_lmdb.cpp, db_leveldb.cpp): LMDB and
LevelDB through the pure-Python readers in lmdb_py and leveldb_py,
chosen by the files on disk, and the Datum <-> array conversions.

The reference decodes no encoded Datum (its datum_to_array reads `data`
as raw pixels); the port refuses one by name instead of misreading it.
"""
from __future__ import annotations

import os

import numpy as np

from .. import proto
from . import leveldb_py, lmdb_py


def datum_to_array(datum: proto.Message):
    """(C, H, W) uint8 (or float32) pixels and the label of a Datum."""
    shape = (datum.channels, datum.height, datum.width)
    if datum.encoded:
        raise NotImplementedError("encoded (JPEG/PNG) Datum records are "
                                  "not supported by the port")
    if datum.data:
        arr = np.frombuffer(datum.data, dtype=np.uint8).reshape(shape)
    else:
        arr = np.asarray(datum.float_data, dtype=np.float32).reshape(shape)
    return arr, datum.label


def array_to_datum(arr: np.ndarray, label: int = 0) -> proto.Message:
    """A (C, H, W) array as a Datum (the reference's data/db.py
    array_to_datum): uint8 pixels as `data`, any other dtype as float32
    `float_data`; `proto.encode` serializes it."""
    d = proto.Message("Datum")
    d.channels, d.height, d.width = (int(v) for v in arr.shape)
    d.label = int(label)
    if arr.dtype == np.uint8:
        d.data = arr.tobytes()
    else:
        d.float_data.extend(np.asarray(arr, np.float32).reshape(-1).tolist())
    return d


class LMDB:
    """The DB surface (db.hpp:13-46) over an LMDB environment."""

    def __init__(self, source: str):
        self.env = lmdb_py.Environment(source)

    def cursor(self) -> lmdb_py.Cursor:
        return lmdb_py.Cursor(self.env)

    def __len__(self):
        return len(self.env)

    def close(self):
        self.env.close()


class LevelDBCursor:
    """A sequential cursor over a leveldb_py.Database that wraps around
    at the end, with the surface of lmdb_py.Cursor (db_leveldb.hpp
    SeekToFirst/Next/valid)."""

    def __init__(self, db: leveldb_py.Database):
        self._db = db
        self.seek_to_first()

    def seek_to_first(self):
        self._it = self._db.items()
        self._cur = next(self._it, None)

    def valid(self) -> bool:
        return self._cur is not None

    def next(self):
        self._cur = next(self._it, None)
        if self._cur is None:
            self.seek_to_first()

    def key(self) -> bytes:
        return self._cur[0]

    def value(self) -> bytes:
        return self._cur[1]

    def next_value(self) -> bytes:
        v = self.value()
        self.next()
        return v


class LevelDB:
    """The DB surface over a LevelDB directory (db_leveldb.cpp)."""

    def __init__(self, source: str):
        self.env = leveldb_py.Database(source)

    def cursor(self) -> LevelDBCursor:
        return LevelDBCursor(self.env)

    def __len__(self):
        return len(self.env)

    def close(self):
        self.env.close()


def open_db(source: str, backend=None):
    """GetDB (db.hpp:48) by the files on disk: an LMDB `data.mdb` or a
    LevelDB `CURRENT`. The `backend` enum is advisory: a prototxt that
    says LEVELDB (Caffe's default) but names an LMDB still loads, and
    the other way round."""
    mdb = source if os.path.isfile(source) else os.path.join(source,
                                                             "data.mdb")
    if os.path.exists(mdb):
        return LMDB(source)
    if os.path.exists(os.path.join(source, "CURRENT")):
        return LevelDB(source)
    raise FileNotFoundError(
        f"Datum DB source {source!r} is neither LMDB nor LevelDB; create "
        "one with the shipped dataset converters")


def infer_datum_shape(source: str, backend=None) -> tuple:
    """(C, H, W) of the first record (DataLayer setup,
    data_layer.cpp DataLayerSetUp)."""
    db = open_db(source, backend)
    try:
        arr, _ = datum_to_array(proto.decode_datum(db.cursor().value()))
        return arr.shape
    finally:
        db.close()
