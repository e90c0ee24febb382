"""Image files for ImageData (counterpart of the reference package's
data/image.py; reference image_data_layer.cpp and util/io.cpp
ReadImageToDatum, which decode through OpenCV). PNG, BMP and PPM/PGM
decode through `data/imagecodec.py`; JPEG and other formats through PIL,
only where PIL imports."""
from __future__ import annotations

import io

import numpy as np

from . import imagecodec

# ITU-R BT.601 luma, what OpenCV's cvtColor BGR2GRAY (and PIL 'L') use
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def _decode_any(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return imagecodec.decode(data)
    except ValueError:
        pass
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: not a PNG/BMP/PPM (decoded natively) and PIL is "
            "not installed for other formats (JPEG)") from None
    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if img.mode not in ("L", "RGB", "RGBA")
                      else img.mode)
    arr = np.asarray(img, dtype=np.uint8)
    return arr[:, :, None] if arr.ndim == 2 else arr


def load_image(path: str, color: bool = True, new_height: int = 0,
               new_width: int = 0) -> np.ndarray:
    """An image file as a (C, H, W) uint8 array, channels in BGR order
    (Caffe's and OpenCV's); gray through BT.601 luma when not `color`;
    resized bilinearly when both `new_height` and `new_width` are set."""
    arr = _decode_any(path)                   # (H, W, C) RGB or gray
    if arr.shape[2] == 4:
        arr = arr[:, :, :3]                   # drop alpha (cv::imread)
    if color and arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    elif not color and arr.shape[2] == 3:
        arr = np.rint(arr.astype(np.float32) @ _LUMA) \
            .astype(np.uint8)[:, :, None]
    if new_height > 0 and new_width > 0:
        arr = imagecodec.resize_bilinear(arr, new_height, new_width)
    if color:
        return arr[:, :, ::-1].transpose(2, 0, 1)   # RGB -> BGR, CHW
    return arr.transpose(2, 0, 1)


def infer_image_shape(image_data_param) -> tuple:
    """(C, H, W) of the list's first image, as the layer loads it
    (ImageDataLayer::DataLayerSetUp)."""
    ip = image_data_param
    with open(ip.source) as f:
        first = f.readline().split()[0]
    path = (ip.root_folder or "") + first
    arr = load_image(path, ip.is_color, ip.new_height, ip.new_width)
    return arr.shape
