"""Pure-Python LevelDB: a read-only database and a bulk writer (a copy of
the reference package's data/leveldb_py.py; Caffe's DataParameter
backend defaults to LEVELDB, db_leveldb.cpp).

Implements the LevelDB 1.x on-disk format (doc/table_format.md,
doc/log_format.md, doc/impl.md of google/leveldb):

- read path: CURRENT -> MANIFEST (VersionEdit records in log framing) ->
  live SSTables per level + the recovery .log (memtable), merged into one
  ordered key/value iteration, the newest sequence winning and
  deletions suppressed; snappy-compressed blocks inflate through the
  pure-Python decompressor below.
- write path: a fresh database whose entries live entirely in the
  recovery log (LevelDB replays the log into its memtable on open), with
  a MANIFEST, CURRENT and masked-CRC32C framing.
"""
from __future__ import annotations

import os
import struct

# ---------------------------------------------------------------------------
# varints

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        if n < 0x80:
            out.append(n)
            return bytes(out)
        out.append((n & 0x7F) | 0x80)
        n >>= 7


def _length_prefixed(b: bytes) -> bytes:
    return _write_varint(len(b)) + b


# ---------------------------------------------------------------------------
# snappy (decompress only — this module never writes compressed blocks)

def snappy_uncompress(src: bytes) -> bytes:
    total, pos = _read_varint(src, 0)
    out = bytearray()
    n = len(src)
    while pos < n:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                     # literal
            length = tag >> 2
            if length >= 60:              # length stored in next 1-4 bytes
                extra = length - 59
                length = int.from_bytes(src[pos:pos + extra], "little")
                pos += extra
            length += 1
            out += src[pos:pos + length]
            pos += length
            continue
        if kind == 1:                     # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif kind == 2:                   # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[pos:pos + 2], "little")
            pos += 2
        else:                             # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
        # overlapping copy semantics: byte-at-a-time when ranges overlap
        start = len(out) - offset
        for i in range(length):
            out.append(out[start + i])
    if len(out) != total:
        raise ValueError(
            f"snappy: inflated {len(out)} bytes, header says {total}")
    return bytes(out)


# ---------------------------------------------------------------------------
# masked CRC32C (leveldb frames every log record and block with this)

_CRC_TABLE = []


def _crc32c_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    table = _crc32c_table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# log framing (doc/log_format.md): 32 KiB blocks of
# [crc u32][length u16][type u8][payload]; type 1=FULL 2=FIRST 3=MIDDLE 4=LAST

_LOG_BLOCK = 32768
_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4


def read_log_records(path: str):
    """Yield complete records from a leveldb-framed log file."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    partial = bytearray()
    while pos + 7 <= len(data):
        block_left = _LOG_BLOCK - (pos % _LOG_BLOCK)
        if block_left < 7:                # trailer: zero-padded, skip
            pos += block_left
            continue
        _crc, length, rtype = struct.unpack_from("<IHB", data, pos)
        pos += 7
        if rtype == 0 and length == 0:    # preallocated zeroes = end
            break
        payload = data[pos:pos + length]
        pos += length
        if rtype == _FULL:
            yield bytes(payload)
        elif rtype == _FIRST:
            partial = bytearray(payload)
        elif rtype == _MIDDLE:
            partial += payload
        elif rtype == _LAST:
            partial += payload
            yield bytes(partial)
            partial = bytearray()
        else:
            raise ValueError(f"bad log record type {rtype} @ {pos}")


class LogWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._block_off = 0

    def append(self, record: bytes) -> None:
        pos = 0
        first = True
        while True:
            left = _LOG_BLOCK - self._block_off
            if left < 7:
                self._f.write(b"\x00" * left)
                self._block_off = 0
                left = _LOG_BLOCK
            avail = left - 7
            frag = record[pos:pos + avail]
            end = pos + len(frag) == len(record)
            rtype = (_FULL if first and end else
                     _FIRST if first else _LAST if end else _MIDDLE)
            header = struct.pack(
                "<IHB", masked_crc(bytes([rtype]) + frag), len(frag), rtype)
            self._f.write(header + frag)
            self._block_off = (self._block_off + 7 + len(frag)) % _LOG_BLOCK
            pos += len(frag)
            first = False
            if end:
                return

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# internal keys: user_key + 8 bytes of (sequence << 8 | value_type)

_TYPE_DELETION, _TYPE_VALUE = 0, 1


def _split_internal_key(ikey: bytes) -> tuple[bytes, int, int]:
    tail = int.from_bytes(ikey[-8:], "little")
    return ikey[:-8], tail >> 8, tail & 0xFF


# ---------------------------------------------------------------------------
# SSTable (doc/table_format.md)

def _read_block(data: bytes, offset: int, size: int) -> bytes:
    raw = data[offset:offset + size]
    compression = data[offset + size]
    if compression == 0:
        return raw
    if compression == 1:
        return snappy_uncompress(raw)
    raise ValueError(f"unsupported block compression {compression}")


def _block_entries(block: bytes):
    """Yield (key, value) from one block (prefix-compressed entries)."""
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    limit = len(block) - 4 * (n_restarts + 1)
    pos = 0
    key = b""
    while pos < limit:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + value_len]
        pos += value_len


_TABLE_MAGIC = 0xDB4775248B80FB57


def read_sstable(path: str):
    """Yield (user_key, sequence, type, value) in key order from an .ldb
    or .sst file."""
    with open(path, "rb") as f:
        data = f.read()
    footer = data[-48:]
    magic = struct.unpack_from("<Q", footer, 40)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad sstable magic {magic:#x}")
    pos = 0
    _meta_off, pos = _read_varint(footer, pos)
    _meta_size, pos = _read_varint(footer, pos)
    index_off, pos = _read_varint(footer, pos)
    index_size, pos = _read_varint(footer, pos)
    index = _read_block(data, index_off, index_size)
    for _last_key, handle in _block_entries(index):
        hpos = 0
        off, hpos = _read_varint(handle, hpos)
        size, hpos = _read_varint(handle, hpos)
        for ikey, value in _block_entries(_read_block(data, off, size)):
            user_key, seq, vtype = _split_internal_key(ikey)
            yield user_key, seq, vtype, value


# ---------------------------------------------------------------------------
# MANIFEST (VersionEdit records)

_EDIT_COMPARATOR = 1
_EDIT_LOG_NUMBER = 2
_EDIT_NEXT_FILE = 3
_EDIT_LAST_SEQ = 4
_EDIT_COMPACT_PTR = 5
_EDIT_DELETED_FILE = 6
_EDIT_NEW_FILE = 7
_EDIT_PREV_LOG = 9


def _parse_version_edit(rec: bytes) -> dict:
    out = {"new_files": [], "deleted_files": []}
    pos = 0
    while pos < len(rec):
        tag, pos = _read_varint(rec, pos)
        if tag == _EDIT_COMPARATOR:
            ln, pos = _read_varint(rec, pos)
            out["comparator"] = rec[pos:pos + ln]
            pos += ln
        elif tag in (_EDIT_LOG_NUMBER, _EDIT_NEXT_FILE, _EDIT_LAST_SEQ,
                     _EDIT_PREV_LOG):
            val, pos = _read_varint(rec, pos)
            out[{_EDIT_LOG_NUMBER: "log_number", _EDIT_NEXT_FILE: "next_file",
                 _EDIT_LAST_SEQ: "last_seq",
                 _EDIT_PREV_LOG: "prev_log"}[tag]] = val
        elif tag == _EDIT_COMPACT_PTR:
            _lvl, pos = _read_varint(rec, pos)
            ln, pos = _read_varint(rec, pos)
            pos += ln
        elif tag == _EDIT_DELETED_FILE:
            lvl, pos = _read_varint(rec, pos)
            num, pos = _read_varint(rec, pos)
            out["deleted_files"].append((lvl, num))
        elif tag == _EDIT_NEW_FILE:
            lvl, pos = _read_varint(rec, pos)
            num, pos = _read_varint(rec, pos)
            _size, pos = _read_varint(rec, pos)
            for _ in range(2):            # smallest, largest internal keys
                ln, pos = _read_varint(rec, pos)
                pos += ln
            out["new_files"].append((lvl, num))
        else:
            raise ValueError(f"unknown VersionEdit tag {tag}")
    return out


# ---------------------------------------------------------------------------
# WriteBatch payloads in the recovery log

def _parse_write_batch(rec: bytes):
    """Yield (user_key, seq, type, value) from one WriteBatch record."""
    seq = int.from_bytes(rec[:8], "little")
    count = struct.unpack_from("<I", rec, 8)[0]
    pos = 12
    for i in range(count):
        vtype = rec[pos]
        pos += 1
        ln, pos = _read_varint(rec, pos)
        key = rec[pos:pos + ln]
        pos += ln
        if vtype == _TYPE_VALUE:
            ln, pos = _read_varint(rec, pos)
            value = rec[pos:pos + ln]
            pos += ln
        else:
            value = b""
        yield key, seq + i, vtype, value


def _encode_write_batch(seq: int, puts) -> bytes:
    out = bytearray(seq.to_bytes(8, "little"))
    out += struct.pack("<I", len(puts))
    for key, value in puts:
        out.append(_TYPE_VALUE)
        out += _length_prefixed(key)
        out += _length_prefixed(value)
    return bytes(out)


# ---------------------------------------------------------------------------
# database

class Database:
    """Read-only ordered view over a LevelDB directory."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "CURRENT")) as f:
            manifest = f.read().strip()
        self._files: list[tuple[int, int]] = []   # (level, number)
        self._log_number = 0
        live: dict[tuple[int, int], bool] = {}
        for rec in read_log_records(os.path.join(path, manifest)):
            edit = _parse_version_edit(rec)
            for lf in edit["new_files"]:
                live[lf] = True
            for df in edit["deleted_files"]:
                live.pop(df, None)
            if "log_number" in edit:
                self._log_number = edit["log_number"]
        self._files = sorted(live)
        self._len: int | None = None

    def _table_path(self, num: int) -> str:
        for ext in (".ldb", ".sst"):
            p = os.path.join(self.path, f"{num:06d}{ext}")
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"sstable {num:06d} missing from {self.path}")

    def _sources(self):
        """One iterator per source, NEWEST first (memtable log, then
        level-0 tables newest-first, then deeper levels)."""
        sources = []
        log_path = os.path.join(self.path, f"{self._log_number:06d}.log")
        if os.path.exists(log_path) and os.path.getsize(log_path) > 0:
            entries = []
            for rec in read_log_records(log_path):
                entries.extend(_parse_write_batch(rec))
            entries.sort(key=lambda e: (e[0], ~e[1]))
            sources.append(entries)
        level0 = sorted((n for l, n in self._files if l == 0), reverse=True)
        for num in level0:
            sources.append(read_sstable(self._table_path(num)))
        deeper = sorted((l, n) for l, n in self._files if l > 0)
        if deeper:
            def deep_iter():
                for _l, num in deeper:
                    yield from read_sstable(self._table_path(num))
            sources.append(deep_iter())
        return sources

    def items(self):
        """Merged (key, value) iteration in key order, newest sequence
        wins, deletions suppressed."""
        import heapq
        sources = [iter(s) for s in self._sources()]
        heap = []
        for prio, it in enumerate(sources):
            for entry in it:
                # (key, -seq) ordering makes the newest version pop first
                heapq.heappush(heap, (entry[0], -entry[1], prio, entry))
                break
        last_key = None
        while heap:
            key, _negseq, prio, entry = heapq.heappop(heap)
            for nxt in sources[prio]:
                heapq.heappush(heap, (nxt[0], -nxt[1], prio, nxt))
                break
            if key == last_key:
                continue                   # shadowed by a newer sequence
            last_key = key
            if entry[2] == _TYPE_VALUE:
                yield key, entry[3]

    def __len__(self):
        if self._len is None:
            self._len = sum(1 for _ in self.items())
        return self._len

    def close(self):
        pass


class BulkWriter:
    """Create a fresh LevelDB directory with all entries in the recovery
    log (real LevelDB replays it into the memtable on open). Mirrors the
    lmdb_py.BulkWriter surface used by the dataset converters."""

    def __init__(self, path: str, batch_size: int = 256):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self._batch: list[tuple[bytes, bytes]] = []
        self._batch_size = batch_size
        self._seq = 0
        self._log = LogWriter(os.path.join(path, "000003.log"))

    def put(self, key: bytes, value: bytes) -> None:
        self._batch.append((bytes(key), bytes(value)))
        if len(self._batch) >= self._batch_size:
            self._flush()

    def _flush(self):
        if not self._batch:
            return
        self._log.append(_encode_write_batch(self._seq + 1, self._batch))
        self._seq += len(self._batch)
        self._batch.clear()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        if exc_type is None:
            self.close()
        return False

    def close(self):
        self._flush()
        self._log.close()
        edit = bytearray()
        edit += _write_varint(_EDIT_COMPARATOR)
        edit += _length_prefixed(b"leveldb.BytewiseComparator")
        edit += _write_varint(_EDIT_LOG_NUMBER) + _write_varint(3)
        edit += _write_varint(_EDIT_NEXT_FILE) + _write_varint(4)
        edit += _write_varint(_EDIT_LAST_SEQ) + _write_varint(self._seq)
        mw = LogWriter(os.path.join(self.path, "MANIFEST-000002"))
        mw.append(bytes(edit))
        mw.close()
        with open(os.path.join(self.path, "CURRENT"), "w") as f:
            f.write("MANIFEST-000002\n")
