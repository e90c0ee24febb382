"""The port's image codecs and image loader (data/imagecodec.py,
data/image.py) against the reference package's, on the same files.

- Decoding: PNG written by PIL (its adaptive per-row filters; gray,
  RGB, RGBA, palette with and without tRNS, 16-bit and 1-bit gray),
  by `encode_png`, and by hand (each of the five filters alone, random
  filters per row, Adam7 at 8 and 16 bits); BMP (24-bit, 8-bit palette);
  PPM/PGM (binary P5/P6 from PIL, ASCII P2/P3 with comments, CRLF and
  lone-CR headers, 16-bit maxval): the port's arrays equal the
  reference's, and PIL's pixels where PIL wrote the file.
- `encode_png` writes the reference's bytes; `resize_bilinear` and
  `load_image` (colour, gray, resize) give the reference's arrays bit for
  bit. JPEG goes through PIL where it imports, and is refused with the
  reference's ValueError where it does not.

Tolerance: none; every comparison is exact.
"""
import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from rram_caffe_simulation_tpu.data import image as jimage
from rram_caffe_simulation_tpu.data import imagecodec as jic
from rram_caffe_simulation_tpu_torch.data import image as timage
from rram_caffe_simulation_tpu_torch.data import imagecodec as tic


def rand(h, w, c, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c),
                                               dtype=np.uint8)


def pil_bytes(img, fmt="PNG"):
    buf = io.BytesIO()
    img.save(buf, fmt)
    return buf.getvalue()


def chunk(ctype, payload):
    body = ctype + payload
    return (struct.pack(">I", len(payload)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def hand_png(arr, bit_depth=8, color_type=2, filters=None, adam7=False,
             seed=0):
    """A PNG of `arr` (H, W, C; uint8 or uint16 samples) whose rows carry
    the filter type `filters` (an int, or None: random per row) over
    bytes chosen so that the unfiltered rows are the image's."""
    rng = np.random.RandomState(seed)
    h, w, c = arr.shape
    be = arr.astype(">u2") if bit_depth == 16 else arr.astype(np.uint8)
    bpp = max(1, c * bit_depth // 8)

    def encode_rows(sub):
        rows = [np.frombuffer(r.tobytes(), np.uint8) for r in sub]
        out = bytearray()
        prev = np.zeros(len(rows[0]), np.uint8)
        for row in rows:
            f = int(rng.randint(5)) if filters is None else filters
            out.append(f)
            cur = row.astype(np.int64)
            p = prev.astype(np.int64)
            enc = np.empty_like(cur)
            for x in range(len(cur)):
                a = cur[x - bpp] if x >= bpp else 0
                b = p[x]
                cc = p[x - bpp] if x >= bpp else 0
                pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1}.get(f)
                if f == 4:
                    pp = a + b - cc
                    pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - cc)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else cc)
                enc[x] = (cur[x] - pred) & 0xFF
            out += enc.astype(np.uint8).tobytes()
            prev = row
        return bytes(out)
    if adam7:
        raw = b"".join(encode_rows(be[y0::dy, x0::dx])
                       for x0, y0, dx, dy in tic._ADAM7
                       if be[y0::dy, x0::dx].size)
    else:
        raw = encode_rows(be)
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0,
                       int(adam7))
    return (tic.PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def png_cases():
    """(bytes, the pixels expected, or None: the reference's alone)."""
    out = {}
    for mode, c in (("L", 1), ("RGB", 3), ("RGBA", 4)):
        arr = rand(33, 21, c, seed=c)
        out[f"pil_{mode}"] = (pil_bytes(Image.fromarray(arr.squeeze(-1)
                                                        if c == 1 else arr,
                                                        mode)), arr)
    q = Image.fromarray(rand(16, 16, 3, seed=4), "RGB").quantize(colors=17)
    out["pil_palette"] = (pil_bytes(q), np.asarray(q.convert("RGB")))
    qt = q.copy()
    qt.info["transparency"] = bytes(range(0, 170, 10))
    out["pil_palette_trns"] = (pil_bytes(qt), None)
    arr16 = np.random.RandomState(5).randint(0, 65536, (9, 11),
                                             dtype=np.uint16)
    out["pil_16bit_gray"] = (pil_bytes(Image.fromarray(arr16)),
                             (arr16 >> 8).astype(np.uint8)[:, :, None])
    bits = (np.arange(64).reshape(8, 8) % 2).astype(np.uint8)
    out["pil_1bit"] = (pil_bytes(Image.fromarray(bits * 255).convert("1")),
                       (bits * 255)[:, :, None])
    for c in (1, 3, 4):
        arr = rand(13, 7, c, seed=10 + c)
        out[f"encode_png_{c}"] = (tic.encode_png(arr), arr)
    arr = rand(9, 10, 3, seed=6)
    for f in range(5):
        out[f"filter_{f}"] = (hand_png(arr, filters=f, seed=f), arr)
    out["filters_mixed"] = (hand_png(rand(12, 9, 4, 7), color_type=6,
                                     seed=9), rand(12, 9, 4, 7))
    out["adam7"] = (hand_png(arr, adam7=True, seed=3), arr)
    a16 = np.random.RandomState(8).randint(0, 65536, (9, 10, 3),
                                           dtype=np.uint16)
    out["adam7_16bit"] = (hand_png(a16, 16, adam7=True, seed=4),
                          (a16 >> 8).astype(np.uint8))
    return out


def other_cases():
    out = {}
    arr = rand(15, 9, 3, seed=7)
    out["bmp_rgb"] = (pil_bytes(Image.fromarray(arr, "RGB"), "BMP"), arr)
    p = Image.fromarray(rand(10, 13, 3, seed=8), "RGB").quantize(colors=9)
    out["bmp_palette"] = (pil_bytes(p, "BMP"), np.asarray(p.convert("RGB")))
    out["ppm_p6"] = (pil_bytes(Image.fromarray(arr, "RGB"), "PPM"), arr)
    g = rand(7, 12, 1, seed=9)
    out["pgm_p5"] = (pil_bytes(Image.fromarray(g[:, :, 0], "L"), "PPM"), g)
    out["pgm_p2_comments"] = (
        b"P2\n# a comment\n3 2\n# another\n15\n0 5 10\n15 # mid\n 1 2\n",
        (np.array([[0, 5, 10], [15, 1, 2]]) * 255 // 15)
        .astype(np.uint8)[:, :, None])
    out["ppm_p3"] = (b"P3 2 1 255 1 2 3 250 251 252",
                     np.array([[[1, 2, 3], [250, 251, 252]]], np.uint8))
    px = bytes([10, 0x0A, 30, 40])
    out["pgm_crlf"] = (b"P5\r\n2 2\r\n255\r\n" + px,
                       np.frombuffer(px, np.uint8).reshape(2, 2, 1))
    out["pgm_lone_cr"] = (b"P5 2 2 255\r" + px,
                          np.frombuffer(px, np.uint8).reshape(2, 2, 1))
    v16 = np.array([[0, 65535], [256, 4096]], ">u2")
    out["pgm_16bit"] = (b"P5 2 2 65535\n" + v16.tobytes(),
                        (v16 >> 8).astype(np.uint8)[:, :, None])
    return out


CASES = {**png_cases(), **other_cases()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_the_reference(name):
    data, expect = CASES[name]
    got = tic.decode(data)
    want = jic.decode(data)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if expect is not None:
        np.testing.assert_array_equal(got[..., :expect.shape[-1]], expect)


def test_unfilter_matches_its_scalar_oracle():
    rng = np.random.RandomState(7)
    for w, h, ch, bd in [(13, 9, 3, 8), (7, 5, 1, 8), (9, 11, 3, 16),
                         (10, 6, 2, 8), (3, 3, 1, 1), (8, 2, 1, 4)]:
        rowbytes = (w * ch * bd + 7) // 8
        raw = b"".join(bytes([rng.randint(5)]) + rng.bytes(rowbytes)
                       for _ in range(h))
        np.testing.assert_array_equal(tic._unfilter(raw, w, h, ch, bd),
                                      jic._unfilter_scalar(raw, w, h, ch, bd))
    with pytest.raises(ValueError, match="unknown filter type 9"):
        tic._unfilter(bytes([9]) + bytes(3), 1, 1, 3, 8)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_encode_png_writes_the_references_bytes(c):
    arr = rand(17, 11, c, seed=20 + c)
    assert tic.encode_png(arr) == jic.encode_png(arr)


@pytest.mark.parametrize("shape", [(5, 7, 3, 13, 4), (40, 30, 1, 17, 50),
                                   (256, 300, 3, 256, 256), (9, 9, 3, 9, 9)])
def test_resize_bilinear_matches_the_reference(shape):
    h, w, c, nh, nw = shape
    arr = rand(h, w, c, seed=h)
    np.testing.assert_array_equal(tic.resize_bilinear(arr, nh, nw),
                                  jic.resize_bilinear(arr, nh, nw))


@pytest.mark.parametrize("fmt", ["png", "bmp", "ppm"])
@pytest.mark.parametrize("color,new_hw", [(True, (0, 0)), (False, (0, 0)),
                                          (True, (20, 17)),
                                          (False, (31, 8))])
def test_load_image_matches_the_reference(tmp_path, fmt, color, new_hw):
    arr = rand(23, 29, 3, seed=11)
    path = str(tmp_path / f"x.{fmt}")
    if fmt == "png":
        open(path, "wb").write(tic.encode_png(arr))
    else:
        Image.fromarray(arr, "RGB").save(path, fmt.upper())
    got = timage.load_image(path, color, *new_hw)
    want = jimage.load_image(path, color, *new_hw)
    assert got.dtype == np.uint8 and got.shape[0] == (3 if color else 1)
    np.testing.assert_array_equal(got, want)


def test_jpeg_through_pil_and_refused_without_it(tmp_path, monkeypatch):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(rand(12, 16, 3, seed=2), "RGB").save(path, "JPEG")
    np.testing.assert_array_equal(timage.load_image(path),
                                  jimage.load_image(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    errors = []
    for mod in (timage, jimage):
        with pytest.raises(ValueError) as e:
            mod.load_image(path)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "PIL is not installed" in errors[0]
    png = str(tmp_path / "x.png")              # no PIL needed for PNG
    open(png, "wb").write(tic.encode_png(rand(4, 5, 3)))
    np.testing.assert_array_equal(timage.load_image(png),
                                  jimage.load_image(png))


def test_infer_image_shape_from_the_first_entry(tmp_path):
    from rram_caffe_simulation_tpu_torch import proto
    open(tmp_path / "a.png", "wb").write(tic.encode_png(rand(9, 14, 3)))
    (tmp_path / "list.txt").write_text("a.png 3\n")
    ip = proto.Message("ImageDataParameter")
    ip.source = str(tmp_path / "list.txt")
    ip.root_folder = str(tmp_path) + "/"
    assert timage.infer_image_shape(ip) == (3, 9, 14)
    ip.new_height, ip.new_width, ip.is_color = 5, 6, False
    assert timage.infer_image_shape(ip) == (1, 5, 6)
