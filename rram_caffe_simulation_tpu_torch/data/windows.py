"""R-CNN window crops: context-padded warp and square crops (counterpart
of the reference package's data/windows.py; geometry of reference
window_data_layer.cpp load_batch, :300-430).

A crop is described by a CropPlan (source box and destination placement)
computed in one pass, then executed by a bilinear resize and a paste.
The resize is a numpy twin of PIL's BILINEAR resize of float ("F")
images, which the reference calls: the same coefficients and the same
order of operations, so the crops equal the reference's bit for bit
without PIL.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CropPlan:
    """Where to read in the source image and where to paste in the output
    canvas. All boxes are [lo, hi) half-open numpy-style bounds."""
    src_y: tuple      # rows of the source image to crop
    src_x: tuple
    dst_y: tuple      # rows of the out_size canvas receiving the resize
    dst_x: tuple

    @property
    def dst_hw(self):
        return (self.dst_y[1] - self.dst_y[0], self.dst_x[1] - self.dst_x[0])


def plan_window_crop(box, image_hw, out_size: int, context_pad: int = 0,
                     square: bool = False) -> CropPlan:
    """The crop and paste plan of one window.

    `box` = (x1, y1, x2, y2) inclusive pixel coordinates; `image_hw` the
    source image size. With context_pad > 0 the box is grown so that after
    warping to out_size x out_size the original box occupies the central
    (out_size - 2*context_pad)^2 region; `square` first grows the box to
    the tightest square. The region outside the image stays unwritten
    (zero-padded by the caller), the paste offset scaled accordingly.
    """
    x1, y1, x2, y2 = (float(v) for v in box)
    im_h, im_w = image_hw
    if context_pad > 0 or square:
        grow = out_size / float(out_size - 2 * context_pad)
        half_w = (x2 - x1 + 1) / 2.0
        half_h = (y2 - y1 + 1) / 2.0
        cx, cy = x1 + half_w, y1 + half_h
        if square:
            half_w = half_h = max(half_w, half_h)
        x1 = round(cx - half_w * grow)
        x2 = round(cx + half_w * grow)
        y1 = round(cy - half_h * grow)
        y2 = round(cy + half_h * grow)

    # extent of the (possibly grown) box beyond the image, per edge
    over_l, over_t = max(0, -int(x1)), max(0, -int(y1))
    over_r, over_b = max(0, int(x2) - im_w + 1), max(0, int(y2) - im_h + 1)
    full_w, full_h = int(x2 - x1 + 1), int(y2 - y1 + 1)
    sx1, sy1 = int(x1) + over_l, int(y1) + over_t
    sx2, sy2 = int(x2) - over_r, int(y2) - over_b

    # resize scale of the *unclipped* box onto the canvas
    scale_x = out_size / float(full_w)
    scale_y = out_size / float(full_h)
    dst_x1 = int(round(over_l * scale_x))
    dst_y1 = int(round(over_t * scale_y))
    dst_w = int(round((sx2 - sx1 + 1) * scale_x))
    dst_h = int(round((sy2 - sy1 + 1) * scale_y))
    # rounding may spill past the canvas edge; trim like the reference does
    dst_w = min(dst_w, out_size - dst_x1)
    dst_h = min(dst_h, out_size - dst_y1)
    return CropPlan(src_y=(sy1, sy2 + 1), src_x=(sx1, sx2 + 1),
                    dst_y=(dst_y1, dst_y1 + dst_h),
                    dst_x=(dst_x1, dst_x1 + dst_w))


def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs (libImaging/Resample.c) for the bilinear
    (triangle) filter over the box [0, in_size): per output pixel, the
    first input pixel `xmin`, the taps' weights (out_size, ksize) in
    float64, zero past each pixel's own tap count."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):
        live = x < xmax
        w = np.abs(((x + xmin) - center + 0.5) * ss)
        w = np.where(w < 1.0, 1.0 - w, 0.0)
        w = np.where(live, w, 0.0)
        k[:, x] = w
        ww = ww + w                     # tap by tap, in C's order
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    return xmin, k


def _resample_rows(img: np.ndarray, out_size: int) -> np.ndarray:
    """One pass of PIL's 32-bit float resample along axis 0 of a float32
    array: per output row, its taps summed in order in float64, the sum
    stored as float32 (ImagingResampleHorizontal_32bpc and
    ImagingResampleVertical_32bpc; the axis a pass runs along is moved to
    the front, so each tap gathers whole rows)."""
    in_size = img.shape[0]
    xmin, k = _bilinear_coeffs(in_size, out_size)
    src = img.astype(np.float64)
    acc = np.zeros((out_size,) + img.shape[1:], np.float64)
    extra = (1,) * (img.ndim - 1)
    for x in range(k.shape[1]):
        # a tap past the pixel's count has weight 0 (any in-range index)
        idx = np.minimum(xmin + x, in_size - 1)
        acc += src[idx] * k[:, x].reshape((-1,) + extra)
    return acc.astype(np.float32)


def _resize_chw(patch: np.ndarray, hw) -> np.ndarray:
    """Bilinear resize of a C x H x W patch to `hw`, float32: PIL's
    Image.resize((w, h), BILINEAR) of each channel as an "F" image, the
    horizontal pass first (ImagingResampleInner), each pass only where
    its size changes."""
    h, w = hw
    out = patch.astype(np.float32)
    if out.shape[2] != w:
        out = _resample_rows(np.ascontiguousarray(out.transpose(2, 0, 1)),
                             w).transpose(1, 2, 0)
    if out.shape[1] != h:
        out = _resample_rows(np.ascontiguousarray(out.transpose(1, 0, 2)),
                             h).transpose(1, 0, 2)
    return out


def extract_window(img_chw: np.ndarray, box, out_size: int,
                   context_pad: int = 0, square: bool = False,
                   mirror: bool = False):
    """Crop `box` out of a (C, H, W) image (uint8 or float) into an
    out_size x out_size canvas.

    Returns (canvas, mask): canvas is (C, out_size, out_size) float32 with
    the warped patch pasted and zeros elsewhere; mask is (out_size,
    out_size) bool marking patch pixels, so the caller can mean-subtract
    only where image data exists (the reference leaves padding at exact
    0, window_data_layer.cpp:404-425). `mirror` flips canvas and mask
    together, padding included, after the paste."""
    c, im_h, im_w = img_chw.shape
    plan = plan_window_crop(box, (im_h, im_w), out_size, context_pad, square)
    patch = img_chw[:, plan.src_y[0]:plan.src_y[1],
                    plan.src_x[0]:plan.src_x[1]]
    canvas = np.zeros((c, out_size, out_size), np.float32)
    mask = np.zeros((out_size, out_size), bool)
    canvas[:, plan.dst_y[0]:plan.dst_y[1], plan.dst_x[0]:plan.dst_x[1]] = \
        _resize_chw(patch, plan.dst_hw)
    mask[plan.dst_y[0]:plan.dst_y[1], plan.dst_x[0]:plan.dst_x[1]] = True
    if mirror:
        canvas = canvas[:, :, ::-1]
        mask = mask[:, ::-1]
    return canvas, mask


@dataclasses.dataclass
class WindowRecord:
    image_index: int
    label: int
    overlap: float
    box: tuple  # (x1, y1, x2, y2) inclusive


def parse_window_file(source: str, root_folder: str = ""):
    """Parse the R-CNN window list format (window_data_layer.cpp:90-160):

        # <image_index>
        <image_path>
        <channels> <height> <width>
        <num_windows>
        <label> <overlap> <x1> <y1> <x2> <y2>   (x num_windows)

    Returns (images, windows): images = [(path, (c, h, w))], windows =
    [WindowRecord]. Tokenized with free whitespace, like the C++ `>>`.
    """
    with open(source) as f:
        toks = f.read().split()
    images, windows = [], []
    i = 0
    while i < len(toks):
        if toks[i] != "#":
            raise ValueError(f"window file {source}: expected '#', got "
                             f"{toks[i]!r}")
        image_index = int(toks[i + 1])
        path = root_folder + toks[i + 2]
        chw = tuple(int(t) for t in toks[i + 3:i + 6])
        n_windows = int(toks[i + 6])
        i += 7
        if image_index != len(images):
            raise ValueError(f"non-sequential image index {image_index}")
        images.append((path, chw))
        for _ in range(n_windows):
            label, overlap = int(toks[i]), float(toks[i + 1])
            box = tuple(int(t) for t in toks[i + 2:i + 6])
            windows.append(WindowRecord(image_index, label, overlap, box))
            i += 6
    return images, windows


def write_window_file(path: str, images, windows) -> None:
    """The window list format `parse_window_file` reads: `images` =
    [(path, (c, h, w))], `windows` = [WindowRecord], grouped by image."""
    with open(path, "w") as f:
        for i, (img_path, chw) in enumerate(images):
            own = [w for w in windows if w.image_index == i]
            f.write(f"# {i}\n{img_path}\n{chw[0]}\n{chw[1]}\n{chw[2]}\n"
                    f"{len(own)}\n")
            for w in own:
                f.write(f"{w.label} {w.overlap:.6f} "
                        f"{' '.join(str(int(v)) for v in w.box)}\n")
