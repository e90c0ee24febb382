"""Pure-Python image codecs: PNG (the five filters, palette, 16-bit and
low bit depths, Adam7), BMP, and PPM/PGM (ASCII and binary, comments,
CR/CRLF headers), with no imaging dependency (a copy of the reference
package's data/imagecodec.py; the reference ingests images through
OpenCV, util/io.cpp:73-100 ReadImageToCVMat). JPEG goes through PIL
where PIL imports (`data/image.py`).

Decoders return (H, W, C) uint8 arrays in RGB order (C in {1, 3, 4});
16-bit samples are downshifted to 8.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIG = b"\x89PNG\r\n\x1a\n"

# Adam7: per-pass (x_start, y_start, x_step, y_step)
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter_scalar(raw: bytes, width: int, height: int, channels: int,
                     bit_depth: int) -> np.ndarray:
    """Reference per-pixel unfilter (the original implementation) —
    kept as the golden oracle for the vectorized `_unfilter`'s parity
    tests; every filter decision is spelled out byte by byte."""
    bpp = max(1, channels * bit_depth // 8)
    rowbytes = (width * channels * bit_depth + 7) // 8
    out = np.empty((height, rowbytes), np.uint8)
    stride = rowbytes + 1
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(height):
        ftype = raw[y * stride]
        line = np.frombuffer(raw, np.uint8, rowbytes, y * stride + 1)
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:        # Sub
            cur = line.copy()
            for x in range(bpp, rowbytes):
                cur[x] = (int(cur[x]) + int(cur[x - bpp])) & 0xFF
        elif ftype == 2:        # Up
            cur = line + prev
        elif ftype == 3:        # Average
            cur = line.copy()
            for x in range(rowbytes):
                left = int(cur[x - bpp]) if x >= bpp else 0
                cur[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) \
                    & 0xFF
        elif ftype == 4:        # Paeth
            cur = line.copy()
            for x in range(rowbytes):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                if pa <= pb and pa <= pc:
                    pred = a
                elif pb <= pc:
                    pred = b
                else:
                    pred = c
                cur[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _sub_row(line: np.ndarray, bpp: int) -> np.ndarray:
    """Undo filter 1 (Sub) for one scanline. The recurrence
    cur[x] = line[x] + cur[x-bpp] is a prefix sum per byte lane
    (mod 256 — addition wraps, so a uint8 accumulate IS the modular
    sum), fully vectorized."""
    if bpp == 1:
        return np.add.accumulate(line, dtype=np.uint8)
    n = line.size
    pad = (-n) % bpp
    if pad:
        line = np.concatenate([line, np.zeros(pad, np.uint8)])
    return np.add.accumulate(line.reshape(-1, bpp), axis=0,
                             dtype=np.uint8).reshape(-1)[:n]


def _avg_row(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo filter 3 (Average). The floor-division predictor makes the
    left-neighbor chain non-linear (no prefix-sum form), so the scan
    stays sequential — but on Python ints over lists, which drops the
    per-byte ndarray indexing that dominated the original loop."""
    l = line.tolist()
    p = prev.tolist()
    out = l[:]
    n = len(out)
    for x in range(min(bpp, n)):
        out[x] = (l[x] + (p[x] >> 1)) & 0xFF
    for x in range(bpp, n):
        out[x] = (l[x] + ((out[x - bpp] + p[x]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _paeth_row(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo filter 4 (Paeth); same sequential-scan-on-ints treatment as
    `_avg_row` (the predictor select depends on the just-computed left
    byte). For x < bpp the predictor reduces to the up byte."""
    l = line.tolist()
    p = prev.tolist()
    out = l[:]
    n = len(out)
    # pa = |p - a| = |b - c| depends only on the previous row — hoist
    # it (and b - 2c) out of the sequential scan as numpy vectors
    pi = prev.astype(np.int16)
    pa_v = np.abs(pi[bpp:] - pi[:-bpp]).tolist() if n > bpp else []
    bc2_v = (pi[bpp:] - 2 * pi[:-bpp]).tolist() if n > bpp else []
    for x in range(min(bpp, n)):
        out[x] = (l[x] + p[x]) & 0xFF
    for x in range(bpp, n):
        a = out[x - bpp]
        c = p[x - bpp]
        pa = pa_v[x - bpp]
        pb = a - c if a >= c else c - a          # |p - b|, p = a + b - c
        pc = a + bc2_v[x - bpp]
        if pc < 0:
            pc = -pc                             # |p - c|
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = p[x]
        else:
            pred = c
        out[x] = (l[x] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: bytes, width: int, height: int, channels: int,
              bit_depth: int) -> np.ndarray:
    """Undo PNG scanline filters; returns (height, rowbytes) uint8.

    Vectorized per scanline (vs `_unfilter_scalar`'s per-pixel Python
    loops): None/Up rows are whole-row numpy ops and Sub rows a
    per-lane modular prefix sum (~150x). Average/Paeth carry an
    inherent sequential dependency through the just-decoded left
    neighbor; their scan runs on native ints with the
    previous-row-only predictor terms hoisted to numpy (~3x).
    `_unfilter_scalar` is the per-byte oracle it is held to."""
    bpp = max(1, channels * bit_depth // 8)
    rowbytes = (width * channels * bit_depth + 7) // 8
    stride = rowbytes + 1
    buf = np.frombuffer(raw, np.uint8, stride * height) \
        .reshape(height, stride)
    ftypes = buf[:, 0]
    if (ftypes > 4).any():
        first_bad = int(ftypes[int((ftypes > 4).argmax())])
        raise ValueError(f"PNG: unknown filter type {first_bad}")
    lines = buf[:, 1:]
    out = np.empty((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    y = 0
    while y < height:
        f = ftypes[y]
        line = lines[y]
        if f == 0:
            out[y] = line
        elif f == 1:              # Sub
            out[y] = _sub_row(line, bpp)
        elif f == 2:              # Up (uint8 add wraps mod 256)
            np.add(line, prev, out=out[y])
        elif f == 3:              # Average
            out[y] = _avg_row(line, prev, bpp)
        else:                     # Paeth
            out[y] = _paeth_row(line, prev, bpp)
        y += 1
        prev = out[y - 1]
    return out


def _expand_samples(rows: np.ndarray, width: int, channels: int,
                    bit_depth: int) -> np.ndarray:
    """(H, rowbytes) -> (H, W, C) uint8 samples."""
    h = rows.shape[0]
    if bit_depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if bit_depth == 16:
        return rows.reshape(h, -1)[:, :width * channels * 2] \
            .reshape(h, width * channels, 2)[:, :, 0] \
            .reshape(h, width, channels)   # high byte
    # 1/2/4-bit (gray or palette, single channel); value scaling for
    # gray happens in decode_png — palette indices stay raw
    bits = np.unpackbits(rows, axis=1)
    vals = bits.reshape(h, -1, bit_depth)
    weights = (1 << np.arange(bit_depth - 1, -1, -1)).astype(np.uint8)
    samples = (vals * weights).sum(axis=2).astype(np.uint8)
    return samples[:, :width * channels].reshape(h, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    if not data.startswith(PNG_SIG):
        raise ValueError("not a PNG (bad signature)")
    pos = 8
    ihdr = None
    idat = []
    plte = None
    trns = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"PLTE":
            plte = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG: missing IHDR or IDAT")
    width, height, bit_depth, color_type, comp, filt, interlace = ihdr
    if comp != 0 or filt != 0:
        raise ValueError("PNG: unsupported compression/filter method")
    channels = _PNG_CHANNELS.get(color_type)
    if channels is None:
        raise ValueError(f"PNG: bad color type {color_type}")
    raw = zlib.decompress(b"".join(idat))

    def pass_image(raw_part, w, h):
        rows = _unfilter(raw_part, w, h, channels, bit_depth)
        return _expand_samples(rows, w, channels, bit_depth)

    if interlace == 0:
        img = pass_image(raw, width, height)
    elif interlace == 1:
        img = np.zeros((height, width, channels), np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            w = (width - x0 + dx - 1) // dx
            h = (height - y0 + dy - 1) // dy
            if w == 0 or h == 0:
                continue
            rowbytes = (w * channels * bit_depth + 7) // 8
            nbytes = (rowbytes + 1) * h
            img[y0::dy, x0::dx] = pass_image(raw[off:off + nbytes], w, h)
            off += nbytes
    else:
        raise ValueError(f"PNG: bad interlace method {interlace}")

    if color_type == 3:                       # palette
        if plte is None:
            raise ValueError("PNG: palette image without PLTE")
        idx = img[:, :, 0]
        rgb = plte[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = trns
            return np.dstack([rgb, alpha[idx]])
        return rgb
    if color_type == 0 and bit_depth < 8:     # scale 1/2/4-bit gray
        img = (img.astype(np.uint16) * 255
               // ((1 << bit_depth) - 1)).astype(np.uint8)
    return img


def encode_png(arr: np.ndarray) -> bytes:
    """Minimal PNG writer (filter 0, 8-bit); arr is (H,W), (H,W,1),
    (H,W,3) or (H,W,4) uint8."""
    arr = np.asarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(ctype, payload):
        body = ctype + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def decode_bmp(data: bytes) -> np.ndarray:
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    (pix_off,) = struct.unpack("<I", data[10:14])
    (hdr_size,) = struct.unpack("<I", data[14:18])
    if hdr_size < 40:
        raise ValueError("BMP: pre-BITMAPINFOHEADER formats unsupported")
    width, height = struct.unpack("<ii", data[18:26])
    (bpp,) = struct.unpack("<H", data[28:30])
    (compression,) = struct.unpack("<I", data[30:34])
    if compression not in (0, 3):
        raise ValueError(f"BMP: compression {compression} unsupported")
    top_down = height < 0
    height = abs(height)
    if bpp == 8:
        (used,) = struct.unpack("<I", data[46:50])
        n_pal = used or 256
        pal_off = 14 + hdr_size
        pal = np.frombuffer(data, np.uint8,
                            n_pal * 4, pal_off).reshape(-1, 4)
        pal_rgb = pal[:, [2, 1, 0]]           # stored BGRX
        stride = (width + 3) & ~3
        rows = np.frombuffer(data, np.uint8, stride * height, pix_off) \
            .reshape(height, stride)[:, :width]
        img = pal_rgb[rows]
    elif bpp in (24, 32):
        nb = bpp // 8
        stride = (width * nb + 3) & ~3
        rows = np.frombuffer(data, np.uint8, stride * height, pix_off) \
            .reshape(height, stride)[:, :width * nb] \
            .reshape(height, width, nb)
        img = rows[:, :, [2, 1, 0]]           # BGR(A) -> RGB
        if nb == 4:
            img = np.dstack([img, rows[:, :, 3]])
    else:
        raise ValueError(f"BMP: {bpp}-bit unsupported")
    return img if top_down else img[::-1].copy()


def _pnm_tokens(data: bytes):
    pos = 0
    while True:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if pos < len(data) and data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        yield data[start:pos], pos


def decode_ppm(data: bytes) -> np.ndarray:
    magic = data[:2]
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError("not a PGM/PPM (P2/P3/P5/P6)")
    channels = 3 if magic in (b"P3", b"P6") else 1
    toks = _pnm_tokens(data[2:])
    vals = []
    end = 0
    for tok, pos in toks:
        vals.append(int(tok))
        end = pos
        if len(vals) == 3:
            break
    width, height, maxval = vals
    n = width * height * channels
    if magic in (b"P5", b"P6"):
        # exactly one whitespace char terminates the header, but writers
        # on Windows emit \r\n — treat that pair as the single terminator
        # UNLESS the payload length says the \n is really the first pixel
        # byte (lone-\r terminator + pixel value 0x0A). With trailing
        # slack after the raster the two readings are indistinguishable;
        # the CRLF reading wins (lone-\r headers are vanishingly rare)
        body_off = 2 + end + 1
        nbytes = n * (2 if maxval > 255 else 1)
        if data[2 + end:2 + end + 2] == b"\r\n" \
                and len(data) - body_off != nbytes:
            if len(data) - (body_off + 1) != nbytes:
                # neither reading is an exact fit: trailing slack makes
                # "CRLF terminator" vs "lone-\r + first pixel 0x0A"
                # indistinguishable — say so instead of silently shifting
                import warnings
                warnings.warn(
                    "PNM header ends in \\r\\n with trailing bytes after "
                    "the raster; assuming CRLF terminator (a lone-\\r "
                    "header whose first pixel is 0x0A would decode "
                    "shifted by one byte)", stacklevel=2)
            body_off += 1
        if maxval > 255:
            img = np.frombuffer(data, ">u2", n, body_off)
            img = (img >> 8).astype(np.uint8)
        else:
            img = np.frombuffer(data, np.uint8, n, body_off)
    else:
        # keep tokenizing so body-side comments are skipped like header ones
        body = []
        for tok, _ in toks:
            if not tok:
                break
            body.append(int(tok))
            if len(body) == n:
                break
        img = np.array(body[:n], np.uint32)
        if maxval != 255:
            img = img * 255 // maxval
        img = img.astype(np.uint8)
    return img.reshape(height, width, channels)


def decode(data: bytes) -> np.ndarray:
    """Sniff the magic bytes and decode. Returns (H, W, C) uint8 RGB
    (C in {1,3,4})."""
    if data.startswith(PNG_SIG):
        return decode_png(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:1] == b"P" and data[1:2] in b"2356":
        return decode_ppm(data)
    raise ValueError("unrecognized image format (PNG/BMP/PPM supported "
                     "natively; JPEG needs PIL)")


def resize_bilinear(arr: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Half-pixel-center bilinear resize (OpenCV INTER_LINEAR
    convention), (H,W,C) uint8 -> (new_h,new_w,C) uint8."""
    h, w = arr.shape[:2]
    if (h, w) == (new_h, new_w):
        return arr
    ys = (np.arange(new_h) + 0.5) * h / new_h - 0.5
    xs = (np.arange(new_w) + 0.5) * w / new_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = arr[y0][:, x0].astype(np.float32)
    b = arr[y0][:, x1].astype(np.float32)
    c = arr[y1][:, x0].astype(np.float32)
    d = arr[y1][:, x1].astype(np.float32)
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    out = top * (1 - wy) + bot * wy
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
