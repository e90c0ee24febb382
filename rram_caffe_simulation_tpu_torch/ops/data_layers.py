"""Data-source layers (counterpart of the reference package's
ops/data_layers.py): they declare their tops' static shapes; batches
come from the host feed (data/feed.py) through Net.apply's batch dict.
HDF5Output is no data source: its forward writes its two bottoms to a
file on the host.

DummyData is no data source: its tops are filled inside apply
(reference dummy_data_layer.cpp). A constant filler fills from
PRNGKey(0) and is shared by every config lane; a random filler draws top
i from fold_in(rng, (crc32(name) + i) & 0x7FFFFFFF), each lane from its
own key."""
from __future__ import annotations

import os
import zlib

import numpy as np

from .. import proto
from ..core import prng
from ..core.fillers import make_filler
from ..core.registry import Layer, register_layer
from ..data.db import infer_datum_shape
from ..data.image import infer_image_shape
from ..utils.io import require_h5py
from .common import lanes_major


class DataSourceLayer(Layer):
    is_data_source = True

    def setup(self, bottom_shapes):
        self.top_shapes = self.output_shapes()
        return self.top_shapes

    def output_shapes(self):
        raise NotImplementedError

    def apply(self, params, bottoms, ctx):
        raise RuntimeError(
            f"{self.type_name} tops must be fed via the batch dict")


@register_layer("Input")
class InputLayer(DataSourceLayer):
    def output_shapes(self):
        shapes = [tuple(int(d) for d in s.dim)
                  for s in self.lp.input_param.shape]
        n_top = len(self.lp.top)
        if len(shapes) == 1 and n_top > 1:
            shapes = shapes * n_top
        if len(shapes) != n_top:
            raise ValueError(f"Input {self.name!r} needs one shape per top")
        return shapes


def _image_shapes(layer, n: int, chw: tuple) -> list:
    """(n, C, H, W) of an image top, H = W = crop_size when cropping,
    and (n,) of a label top when there is one."""
    c, h, w = chw
    crop = layer.lp.transform_param.crop_size
    if crop > 0:
        h = w = crop
    shapes = [(n, c, h, w)]
    if len(layer.lp.top) > 1:
        shapes.append((n,))
    return shapes


@register_layer("Data")
class DataLayer(DataSourceLayer):
    """LMDB or LevelDB Datum stream (reference data_layer.cpp); shapes
    come from the first record and transform_param."""

    def output_shapes(self):
        dp = self.lp.data_param
        return _image_shapes(self, dp.batch_size,
                             infer_datum_shape(dp.source, dp.backend))


@register_layer("ImageData")
class ImageDataLayer(DataSourceLayer):
    """File-list image stream (reference image_data_layer.cpp); shapes
    come from the list's first image and transform_param."""

    def output_shapes(self):
        ip = self.lp.image_data_param
        return _image_shapes(self, ip.batch_size, infer_image_shape(ip))


@register_layer("HDF5Data")
class HDF5DataLayer(DataSourceLayer):
    """HDF5 dataset stream; tops are datasets of the same names
    (reference hdf5_data_layer.cpp); shapes from the first listed file."""

    def output_shapes(self):
        h5py = require_h5py(f"HDF5Data layer {self.name!r}")
        hp = self.lp.hdf5_data_param
        with open(hp.source) as f:
            first = f.readline().strip()
        with h5py.File(first, "r") as h5:
            return [(hp.batch_size,) + tuple(h5[top].shape[1:])
                    for top in self.lp.top]


@register_layer("MemoryData")
class MemoryDataLayer(DataSourceLayer):
    """Arrays fed from the API through `set_input_arrays` (reference
    memory_data_layer.cpp)."""

    def output_shapes(self):
        mp = self.lp.memory_data_param
        n = mp.batch_size
        return [(n, mp.channels, mp.height, mp.width), (n,)]


@register_layer("WindowData")
class WindowDataLayer(DataSourceLayer):
    """R-CNN window crops (reference window_data_layer.cpp)."""

    def output_shapes(self):
        wp = self.lp.window_data_param
        crop = self.lp.transform_param.crop_size or wp.crop_size
        if crop <= 0:
            raise ValueError(f"WindowData {self.name!r} requires crop_size")
        return [(wp.batch_size, 3, crop, crop), (wp.batch_size,)]


@register_layer("HDF5Output")
class HDF5OutputLayer(Layer):
    """Writes its two bottoms to `hdf5_output_param.file_name` in the
    forward, on the host (reference hdf5_output_layer.cpp:30-74); no
    gradient flows through it.

    The reference package's documented deviation, kept: each forward
    APPENDS its rows to the `data` and `label` datasets (the reference
    layer re-saves only the latest batch), and the file is truncated
    when the layer is built."""

    def setup(self, bottom_shapes):
        self.file_name = self.lp.hdf5_output_param.file_name
        if self.file_name and os.path.exists(self.file_name):
            os.remove(self.file_name)
        self.top_shapes = []
        return []

    def _save(self, data: np.ndarray, label: np.ndarray) -> None:
        h5py = require_h5py(f"HDF5Output layer {self.name!r}")
        with h5py.File(self.file_name, "a") as f:
            for name, arr in (("data", data), ("label", label)):
                if name in f:
                    ds = f[name]
                    n0 = ds.shape[0]
                    ds.resize(n0 + arr.shape[0], axis=0)
                    ds[n0:] = arr
                else:
                    f.create_dataset(name, data=arr,
                                     maxshape=(None,) + arr.shape[1:])

    def apply(self, params, bottoms, ctx):
        self._save(*(b.detach().cpu().numpy() for b in bottoms[:2]))
        return []


@register_layer("DummyData")
class DummyDataLayer(Layer):
    lane_rule = "own"

    def setup(self, bottom_shapes):
        dp = self.lp.dummy_data_param
        n_top = len(self.lp.top)
        if dp.shape:
            shapes = [tuple(int(d) for d in s.dim) for s in dp.shape]
        else:
            shapes = [(dp.num[i], dp.channels[i], dp.height[i], dp.width[i])
                      for i in range(len(dp.num))]
        if len(shapes) == 1 and n_top > 1:
            shapes = shapes * n_top
        fillers = list(dp.data_filler) or [proto.Message("FillerParameter")]
        if len(fillers) == 1 and n_top > 1:
            fillers = fillers * n_top
        if len(shapes) < n_top or len(fillers) < n_top:
            raise ValueError(f"DummyData {self.name!r}: {n_top} tops, "
                             f"{len(shapes)} shapes, {len(fillers)} fillers")
        self.fillers = [make_filler(f) for f in fillers]
        self.filler_types = [f.type for f in fillers]
        self.top_shapes = shapes[:n_top]
        return self.top_shapes

    def draws_tops(self):
        return tuple(t != "constant" for t in self.filler_types)

    def apply(self, params, bottoms, ctx):
        tops = []
        for i, (fill, shape) in enumerate(zip(self.fillers,
                                              self.top_shapes)):
            if self.filler_types[i] == "constant":
                tops.append(fill(prng.PRNGKey(0), shape, ctx.device))
                continue
            if ctx.rng is None:
                raise ValueError(f"DummyData {self.name!r}: a random "
                                 "filler needs a forward key (Net.apply's "
                                 "rng)")
            key = prng.fold_in(
                ctx.rng, (zlib.crc32(self.name.encode()) + i) & 0x7FFFFFFF)
            v = fill(key, shape, ctx.device)
            if ctx.lanes:
                if v.dim() == len(shape):       # a filler that draws nothing
                    v = v.expand((ctx.lanes,) + tuple(shape))
                v = lanes_major(v, shape)
            tops.append(v)
        return tops
