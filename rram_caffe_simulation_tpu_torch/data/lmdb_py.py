"""Pure-Python LMDB: a read-only environment, a wrap-around cursor and a
bulk writer (a copy of the reference package's data/lmdb_py.py).

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
- overflow page: the header with the page count (u32) over lower/upper,
  then the value
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

PAGE = 4096
MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
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


# ---------------------------------------------------------------------------
# Bulk writer: one transaction, keys written in sorted order, the B+tree
# built bottom-up. The reader above (and liblmdb) accepts the file: meta
# txnid 1, an empty free DB.

_MAX_NODE = (PAGE - 16 - 2) // 2 - 8   # a conservative in-page node size


class BulkWriter:
    """Collects (key, value) pairs with `put` and writes the LMDB at
    `close` (or on leaving a `with` block without an error): `path` is
    a directory holding data.mdb, or with subdir=False the file itself."""

    def __init__(self, path: str, subdir: bool = True):
        if subdir:
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "data.mdb")
        self.path = path
        self.pages: List[bytes] = [b"", b""]   # meta pages, filled at close
        self.items: List[Tuple[bytes, bytes]] = []
        self.n_overflow = 0

    def put(self, key: bytes, value: bytes):
        self.items.append((bytes(key), bytes(value)))

    def _alloc(self) -> int:
        self.pages.append(b"")
        return len(self.pages) - 1

    @staticmethod
    def _make_page(flags: int, nodes: List[bytes], pgno: int) -> bytes:
        body = bytearray(PAGE)
        lower = 16 + 2 * len(nodes)
        upper = PAGE - sum(len(n) for n in nodes)
        _PGHDR.pack_into(body, 0, pgno, 0, flags, lower, upper)
        off, ptrs = PAGE, []
        for n in nodes:
            off -= len(n)
            ptrs.append(off)
            body[off:off + len(n)] = n
        struct.pack_into(f"<{len(ptrs)}H", body, 16, *ptrs)
        return bytes(body)

    def _overflow(self, data: bytes) -> int:
        n_pages = (16 + len(data) + PAGE - 1) // PAGE
        first = len(self.pages)
        raw = bytearray(n_pages * PAGE)
        _PGHDR.pack_into(raw, 0, first, 0, P_OVERFLOW, 0, 0)
        struct.pack_into("<I", raw, 12, n_pages)
        raw[16:16 + len(data)] = data
        self.pages.extend(bytes(raw[i * PAGE:(i + 1) * PAGE])
                          for i in range(n_pages))
        self.n_overflow += n_pages
        return first

    def _leaf_node(self, key: bytes, value: bytes) -> bytes:
        if 8 + len(key) + len(value) > _MAX_NODE:
            ovf = self._overflow(value)
            return _NODEHDR.pack(len(value) & 0xFFFF, len(value) >> 16,
                                 F_BIGDATA, len(key)) + key + struct.pack(
                                     "<Q", ovf)
        return _NODEHDR.pack(len(value) & 0xFFFF, len(value) >> 16, 0,
                             len(key)) + key + value

    @staticmethod
    def _branch_node(key: bytes, child: int) -> bytes:
        return _NODEHDR.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                             (child >> 32) & 0xFFFF, len(key)) + key

    def _pages(self, flags: int, entries, node_of) -> list:
        """Pack entries into pages of `flags`, a node each from
        node_of(entry, first_on_page) (a branch page's first node carries
        an empty key), built in entry order (a leaf's overflow pages
        come before its page); returns [(first key, pgno)] of the
        pages."""
        out, nodes, first, space = [], [], None, PAGE - 16

        def flush():
            nonlocal nodes, first, space
            if nodes:
                pgno = self._alloc()
                self.pages[pgno] = self._make_page(flags, nodes, pgno)
                out.append((first, pgno))
            nodes, first, space = [], None, PAGE - 16
        for entry in entries:
            node = node_of(entry, not nodes)
            if nodes and len(node) + 2 > space:
                flush()
                if flags == P_BRANCH:
                    node = node_of(entry, True)
            if first is None:
                first = entry[0]
            nodes.append(node)
            space -= len(node) + 2
        flush()
        return out

    def close(self):
        items = sorted(self.items, key=lambda kv: kv[0])
        if len({k for k, _ in items}) != len(items):
            raise LmdbError("duplicate keys in bulk write")
        level = self._pages(P_LEAF, items,
                            lambda kv, first: self._leaf_node(*kv))
        n_leaf, n_branch, depth = len(level), 0, 1
        while len(level) > 1:
            level = self._pages(P_BRANCH, level, lambda e, first:
                                self._branch_node(b"" if first else e[0],
                                                  e[1]))
            n_branch += len(level)
            depth += 1
        root = level[0][1] if level else _INVALID
        if root == _INVALID:
            depth = 0
        last_pg = len(self.pages) - 1
        for mp in (0, 1):
            body = bytearray(PAGE)
            _PGHDR.pack_into(body, 0, mp, 0, P_META, 0, 0)
            _META.pack_into(body, 16, MAGIC, VERSION, 0,
                            max(len(self.pages) * PAGE, 1 << 20))
            free_off = 16 + _META.size
            _DB.pack_into(body, free_off, 0, 0, 0, 0, 0, 0, 0, _INVALID)
            main_off = free_off + _DB.size
            _DB.pack_into(body, main_off, 0, 0, depth, n_branch, n_leaf,
                          self.n_overflow, len(items), root)
            struct.pack_into("<QQ", body, main_off + _DB.size, last_pg, 1)
            self.pages[mp] = bytes(body)
        with open(self.path, "wb") as f:
            for p in self.pages:
                f.write(p)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not exc[0]:
            self.close()
