"""The port's window crop and WindowData feed (data/windows.py,
data/feed.py `_window_feed`) against the reference package's, on
stand-in files written from a seed with numpy.

- `plan_window_crop` gives the reference's plan on random boxes inside
  and beyond the image, warp and square, with and without context_pad.
- `extract_window` equals the reference's PIL path (float "F" images,
  BILINEAR) bit for bit on 32 random shapes, up- and downscaling, with
  mirror; the port runs with PIL made unimportable.
- `parse_window_file` reads what the reference reads, and
  `write_window_file` writes a file both read alike.
- The WindowData feed: 3 pulls give the reference's batches bit for bit
  (mean_file, mean_value or none; mirror; cache_images; square; the
  scale of transform_param or of window_data_param), with PIL hidden
  from the port.

Tolerance: none; every comparison is exact.
"""
import sys

import numpy as np
import pytest
from google.protobuf import text_format

import rram_caffe_simulation_tpu.ops  # noqa: F401  (registers the layers)
from rram_caffe_simulation_tpu.core.registry import create_layer as jcreate
from rram_caffe_simulation_tpu.data import feed as jfeed
from rram_caffe_simulation_tpu.data import windows as jwin
from rram_caffe_simulation_tpu.proto import pb
import rram_caffe_simulation_tpu_torch.ops  # noqa: F401
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core.registry import \
    create_layer as tcreate
from rram_caffe_simulation_tpu_torch.data import feed as tfeed
from rram_caffe_simulation_tpu_torch.data import windows as twin
from rram_caffe_simulation_tpu_torch.data.imagecodec import encode_png
from rram_caffe_simulation_tpu_torch.utils.io import (array_to_blob,
                                                      write_proto_binary)


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# stand-in files (the other data-source tests import these)

def write_images(folder, n, hw_range, seed, prefix="img"):
    """n PNGs of random sizes in hw_range (rows, cols bounds) and random
    pixels; returns their paths and (c, h, w)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h = int(rng.randint(*hw_range[0]))
        w = int(rng.randint(*hw_range[1]))
        arr = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        path = f"{folder}/{prefix}{i:03d}.png"
        with open(path, "wb") as f:
            f.write(encode_png(arr))
        out.append((path, (3, h, w)))
    return out


def write_windows(path, images, per_image, seed, fg_share=0.5):
    """A window file over `images`: `per_image` boxes each, inside the
    image, overlaps drawn so that about `fg_share` are foreground (>=
    0.5) and the rest background (< 0.5), labels 1..20."""
    rng = np.random.RandomState(seed)
    windows = []
    for i, (_, (_, h, w)) in enumerate(images):
        for _ in range(per_image):
            x1, x2 = sorted(rng.randint(0, w, 2))
            y1, y2 = sorted(rng.randint(0, h, 2))
            fg = rng.rand() < fg_share
            overlap = 0.5 + 0.5 * rng.rand() if fg else 0.49 * rng.rand()
            windows.append(twin.WindowRecord(
                i, int(rng.randint(1, 21)), float(np.float32(overlap)),
                (int(x1), int(y1), int(x2), int(y2))))
    twin.write_window_file(str(path), images, windows)
    return str(path)


def write_mean(path, shape=(1, 3, 256, 256), seed=0):
    """A mean .binaryproto of random values around 110."""
    mean = (110 + 20 * np.random.RandomState(seed).randn(*shape)) \
        .astype(np.float32)
    write_proto_binary(str(path), array_to_blob(mean))
    return str(path)


def layer_pair(text, phase=0):
    """The layer `text` (LayerParameter text) built in both packages."""
    lp = pb.LayerParameter()
    text_format.Parse(text, lp)
    j = jcreate(lp, phase)
    j.setup([])
    t = tcreate(tproto.parse(text, "LayerParameter"), phase)
    t.setup([])
    return j, t


@pytest.fixture(scope="module")
def window_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("windows")
    images = write_images(tmp, 5, ((40, 90), (50, 120)), seed=1)
    return {"tmp": tmp, "source": write_windows(tmp / "windows.txt", images,
                                                6, seed=2),
            "mean": write_mean(tmp / "mean.binaryproto",
                               (1, 3, 40, 40), seed=3)}


# ---------------------------------------------------------------------------
# the crop

def random_box(rng, h, w, beyond):
    """(x1, y1, x2, y2) inclusive; with `beyond` possibly outside the
    image on any side."""
    lo_x, hi_x = (-w // 2, w + w // 2) if beyond else (0, w)
    lo_y, hi_y = (-h // 2, h + h // 2) if beyond else (0, h)
    x1, x2 = sorted(rng.randint(lo_x, hi_x, 2))
    y1, y2 = sorted(rng.randint(lo_y, hi_y, 2))
    # keep at least one source pixel inside the image
    x1, y1 = min(x1, w - 1), min(y1, h - 1)
    x2, y2 = max(x2, 0), max(y2, 0)
    return int(x1), int(y1), int(x2), int(y2)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("pad", [0, 3, 16])
@pytest.mark.parametrize("beyond", [False, True])
def test_plan_window_crop_matches_the_reference(square, pad, beyond):
    rng = np.random.RandomState(pad * 7 + square * 3 + beyond)
    for _ in range(60):
        h, w = (int(v) for v in rng.randint(8, 400, 2))
        out = int(rng.choice([40, 100, 227]))
        box = random_box(rng, h, w, beyond)
        got = twin.plan_window_crop(box, (h, w), out, pad, square)
        want = jwin.plan_window_crop(box, (h, w), out, pad, square)
        assert (got.src_y, got.src_x, got.dst_y, got.dst_x) == \
            (want.src_y, want.src_x, want.dst_y, want.dst_x), (box, h, w)


@pytest.mark.parametrize("seed", range(32))
def test_extract_window_is_pils_bit_for_bit(monkeypatch, seed):
    """The reference's crop (PIL's F-mode BILINEAR resize) against the
    port's numpy twin, PIL hidden from the port: sizes 20-300 up and
    down."""
    rng = np.random.RandomState(100 + seed)
    h, w = (int(v) for v in rng.randint(20, 300, 2))
    img = (rng.rand(3, h, w) * 255).astype(np.float32)
    if seed % 2:
        img = np.round(img)                    # decoded pixels are integers
    out = int(rng.randint(20, 300))
    box = random_box(rng, h, w, beyond=bool(seed % 3 == 0))
    pad, square, mirror = int(rng.randint(0, out // 4)), bool(seed % 4 == 1), \
        bool(seed % 5 < 2)
    want = jwin.extract_window(img, box, out, pad, square, mirror)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = twin.extract_window(img, box, out, pad, square, mirror)
    assert got[0].dtype == np.float32 and got[0].shape == (3, out, out)
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1], want[1])


def test_parse_and_write_window_file(window_files, tmp_path):
    root = str(window_files["tmp"]) + "/"
    images, windows = twin.parse_window_file(window_files["source"])
    want = jwin.parse_window_file(window_files["source"])
    assert images == want[0]
    assert [(w.image_index, w.label, w.overlap, w.box) for w in windows] \
        == [(w.image_index, w.label, w.overlap, w.box) for w in want[1]]
    rel = [(p[len(root):], chw) for p, chw in images]
    twin.write_window_file(str(tmp_path / "w.txt"), rel, windows)
    again = jwin.parse_window_file(str(tmp_path / "w.txt"), root)
    assert again[0] == images
    assert [w.box for w in again[1]] == [w.box for w in windows]


# ---------------------------------------------------------------------------
# the feed

def window_layer_text(files, batch=8, crop=32, transform="", param=""):
    return (f'name: "wd" type: "WindowData" top: "data" top: "label" '
            f"transform_param {{ crop_size: {crop} {transform} }} "
            f'window_data_param {{ source: "{files["source"]}" '
            f"batch_size: {batch} fg_threshold: 0.5 bg_threshold: 0.5 "
            f'fg_fraction: 0.25 context_pad: 4 {param} }}')


WINDOW_FEEDS = {
    "mean_file_mirror": ('mirror: true mean_file: "{mean}"', ""),
    "mean_value_scale": ("mean_value: 104 mean_value: 117 mean_value: 123 "
                         "scale: 0.5", "scale: 2.0"),
    "none_param_scale": ("", 'scale: 0.25 crop_mode: "square"'),
    "cache_images": ('mirror: true mean_file: "{mean}"',
                     "cache_images: true"),
}


@pytest.mark.parametrize("case", sorted(WINDOW_FEEDS))
def test_window_feed_gives_the_references_batches(monkeypatch, window_files,
                                                  case):
    transform, param = WINDOW_FEEDS[case]
    text = window_layer_text(window_files,
                             transform=transform.format(
                                 mean=window_files["mean"]), param=param)
    jlayer, tlayer = layer_pair(text)
    assert tlayer.top_shapes == [tuple(s) for s in jlayer.top_shapes] == \
        [(8, 3, 32, 32), (8,)]
    jf = jfeed.FEED_BUILDERS["WindowData"](jlayer)
    wants = [jf() for _ in range(3)]
    monkeypatch.setitem(sys.modules, "PIL", None)
    tf = tfeed.FEED_BUILDERS["WindowData"](tlayer)
    for want in wants:
        got = tf()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(bits(got[k]), bits(want[k]))
    assert (got["label"][:6] == 0).all() and (got["label"][6:] > 0).all()


def test_window_data_requires_a_crop(window_files):
    text = window_layer_text(window_files, crop=0)
    with pytest.raises(ValueError, match="requires crop_size"):
        tcreate(tproto.parse(text, "LayerParameter"), 0).setup([])
