"""DataTransformer: mean subtraction, crop, mirror, scale (counterpart of
the reference package's data/transformer.py; reference
data_transformer.cpp:19-150). Per pixel: (value - mean) * scale; crop is
random in TRAIN and centred in TEST; mirror is a random horizontal flip
in TRAIN only. Host-side numpy, as the feed runs on the host."""
from __future__ import annotations

import numpy as np

from .. import proto
from ..utils.io import read_blob_from_file


class DataTransformer:
    def __init__(self, transform_param, phase: int, seed: int = 0):
        self.tp = transform_param
        self.phase = phase
        self.rng = np.random.RandomState(seed)
        self.mean = None
        if transform_param.HasField("mean_file"):
            self.mean = read_blob_from_file(
                transform_param.mean_file).astype(np.float32)
            if self.mean.ndim == 4:
                self.mean = self.mean[0]
        elif transform_param.mean_value:
            self.mean = np.asarray(list(transform_param.mean_value),
                                   np.float32).reshape(-1, 1, 1)

    def transform(self, arr: np.ndarray) -> np.ndarray:
        """arr: (C, H, W) uint8 or float. Returns float32 (C, h, w)."""
        tp = self.tp
        out = arr.astype(np.float32)
        if self.mean is not None:
            # a mean file is full-size and indexed at the pre-crop
            # position (data_transformer.cpp:58)
            out = out - self.mean
        crop = tp.crop_size
        if crop:
            _, h, w = out.shape
            if self.phase == proto.TRAIN:
                h_off = self.rng.randint(h - crop + 1)
                w_off = self.rng.randint(w - crop + 1)
            else:
                h_off = (h - crop) // 2
                w_off = (w - crop) // 2
            out = out[:, h_off:h_off + crop, w_off:w_off + crop]
        if tp.mirror and self.phase == proto.TRAIN and self.rng.randint(2):
            out = out[:, :, ::-1]
        if tp.scale != 1.0:
            out = out * np.float32(tp.scale)
        return np.ascontiguousarray(out)
