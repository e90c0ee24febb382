"""Data-source layers (counterpart of the reference package's
ops/data_layers.py): they declare their tops' static shapes; batches
come from the host feed (data/feed.py) through Net.apply's batch dict."""
from __future__ import annotations

from ..core.registry import Layer, register_layer
from ..data.feed import infer_datum_shape


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
