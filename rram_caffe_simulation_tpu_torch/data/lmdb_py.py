"""Pure-Python LMDB reader: a read-only environment and a wrap-around
cursor (a reader-only copy of the reference package's data/lmdb_py.py;
the port never writes LMDBs).

Implements the on-disk format of LMDB 0.9 (magic 0xBEEFC0DE, data
version 1): 4096-byte pages, meta pages 0/1, a B+tree of branch/leaf
pages, overflow pages for large values.
- page header (16B): pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
- node header (8B):  lo u16 | hi u16 | flags u16 | ksize u16
  leaf:   datasize = lo | hi<<16; F_BIGDATA(0x01) -> data is overflow pgno u64
  branch: child pgno = lo | hi<<16 | flags<<32
- meta (at offset 16 of pages 0/1): magic u32 | version u32 | address u64 |
  mapsize u64 | free_db[48] | main_db[48] | last_pg u64 | txnid u64
- db record (48B): pad u32 | flags u16 | depth u16 | branch u64 | leaf u64 |
  overflow u64 | entries u64 | root u64
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Optional, Tuple

PAGE = 4096
MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_META = 0x08
F_BIGDATA = 0x01

_PGHDR = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<HHHH")         # lo, hi, flags, ksize
_META = struct.Struct("<IIQQ")            # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")          # pad,flags,depth,branch,leaf,ovf,entries,root
_INVALID = 0xFFFFFFFFFFFFFFFF


class LmdbError(RuntimeError):
    pass


class Environment:
    """Read-only LMDB environment over data.mdb (subdir=True layout like the
    reference's MDB_NOSUBDIR-less default, or a direct file path)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        m0 = self._read_meta(0)
        m1 = self._read_meta(1)
        self.meta = m0 if m0[0] >= m1[0] else m1
        self.txnid, self.main_root, self.entries, self.depth = self.meta[:4]

    def _read_meta(self, pgno: int):
        off = pgno * PAGE
        _, _, flags, _, _ = _PGHDR.unpack_from(self._mm, off)
        if not flags & P_META:
            raise LmdbError(f"page {pgno} is not a meta page")
        magic, version, _, _ = _META.unpack_from(self._mm, off + 16)
        if magic != MAGIC:
            raise LmdbError(f"bad LMDB magic {magic:#x}")
        if version != VERSION:
            raise LmdbError(f"unsupported LMDB data version {version}")
        main_off = off + 16 + _META.size + _DB.size
        (_, _, depth, _, _, _, entries, root) = _DB.unpack_from(
            self._mm, main_off)
        last_pg, txnid = struct.unpack_from(
            "<QQ", self._mm, main_off + _DB.size)
        return (txnid, root, entries, depth, last_pg)

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        off = pgno * PAGE
        _, _, flags, lower, upper = _PGHDR.unpack_from(self._mm, off)
        return off, flags, lower, upper

    def _nodes(self, pgno: int):
        off, flags, lower, upper = self._page(pgno)
        n = (lower - 16) // 2
        ptrs = struct.unpack_from(f"<{n}H", self._mm, off + 16)
        return off, flags, ptrs

    def _leaf_value(self, page_off: int, ptr: int) -> Tuple[bytes, bytes]:
        lo, hi, nflags, ksize = _NODEHDR.unpack_from(self._mm,
                                                     page_off + ptr)
        key_off = page_off + ptr + 8
        key = bytes(self._mm[key_off:key_off + ksize])
        datasize = lo | (hi << 16)
        if nflags & F_BIGDATA:
            (ovf_pgno,) = struct.unpack_from("<Q", self._mm,
                                             key_off + ksize)
            data_off = ovf_pgno * PAGE + 16
            data = bytes(self._mm[data_off:data_off + datasize])
        else:
            data = bytes(self._mm[key_off + ksize:
                                  key_off + ksize + datasize])
        return key, data

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order iteration over (key, value) of the main DB."""
        if self.main_root == _INVALID:
            return
        stack = [(self.main_root, 0)]
        while stack:
            pgno, idx = stack.pop()
            off, flags, ptrs = self._nodes(pgno)
            if flags & P_LEAF:
                for ptr in ptrs:
                    yield self._leaf_value(off, ptr)
            elif flags & P_BRANCH:
                if idx < len(ptrs):
                    stack.append((pgno, idx + 1))
                    lo, hi, nflags, ksize = _NODEHDR.unpack_from(
                        self._mm, off + ptrs[idx])
                    child = lo | (hi << 16) | (nflags << 32)
                    stack.append((child, 0))
            else:
                raise LmdbError(f"unexpected page flags {flags:#x}")

    def get(self, key: bytes) -> Optional[bytes]:
        """Point lookup by binary-searching the tree."""
        if self.main_root == _INVALID:
            return None
        pgno = self.main_root
        while True:
            off, flags, ptrs = self._nodes(pgno)
            if flags & P_LEAF:
                for ptr in ptrs:
                    k, v = self._leaf_value(off, ptr)
                    if k == key:
                        return v
                return None
            # branch: last child whose key <= target (first key is empty)
            child = None
            for ptr in ptrs:
                lo, hi, nflags, ksize = _NODEHDR.unpack_from(self._mm,
                                                             off + ptr)
                k = bytes(self._mm[off + ptr + 8: off + ptr + 8 + ksize])
                if ksize and k > key:
                    break
                child = lo | (hi << 16) | (nflags << 32)
            if child is None:
                return None
            pgno = child

    def __len__(self):
        return self.entries

    def close(self):
        self._mm.close()
        self._f.close()


class Cursor:
    """Sequential cursor with wrap-around, matching the reference
    LMDBCursor semantics (db_lmdb.hpp: SeekToFirst/Next/valid)."""

    def __init__(self, env: Environment):
        self.env = env
        self._it = env.items()
        self._cur = None
        self.seek_to_first()

    def seek_to_first(self):
        self._it = self.env.items()
        self._cur = next(self._it, None)

    def valid(self) -> bool:
        return self._cur is not None

    def next(self):
        self._cur = next(self._it, None)
        if self._cur is None:          # wrap like DataReader
            self.seek_to_first()

    def key(self) -> bytes:
        return self._cur[0]

    def value(self) -> bytes:
        return self._cur[1]

    def next_value(self) -> bytes:
        """Return current value then advance (wrapping)."""
        v = self.value()
        self.next()
        return v
