"""Data-source layers (counterpart of the reference package's
ops/data_layers.py): they declare their tops' static shapes; batches
come from the host feed (data/feed.py) through Net.apply's batch dict.

DummyData is no data source: its tops are filled inside apply
(reference dummy_data_layer.cpp). A constant filler fills from
PRNGKey(0) and is shared by every config lane; a random filler draws top
i from fold_in(rng, (crc32(name) + i) & 0x7FFFFFFF), each lane from its
own key."""
from __future__ import annotations

import zlib

from .. import proto
from ..core import prng
from ..core.fillers import make_filler
from ..core.registry import Layer, register_layer
from ..data.feed import infer_datum_shape
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


@register_layer("Data")
class DataLayer(DataSourceLayer):
    """LMDB-backed Datum stream (reference data_layer.cpp); shapes come
    from the first record and transform_param."""

    def output_shapes(self):
        dp = self.lp.data_param
        c, h, w = infer_datum_shape(dp.source)
        crop = self.lp.transform_param.crop_size
        if crop > 0:
            h = w = crop
        shapes = [(dp.batch_size, c, h, w)]
        if len(self.lp.top) > 1:
            shapes.append((dp.batch_size,))
        return shapes


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
