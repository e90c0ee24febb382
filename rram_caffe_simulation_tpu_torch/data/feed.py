"""Host-side batch feeds for data-source layers (counterpart of the
reference package's data/feed.py, its sequential Python Data path):
a wrap-around LMDB cursor, Datum decode and the DataTransformer, one
numpy batch dict per call. The solver moves each batch to its device.

`materialize_data_source` decodes a whole LMDB once instead (the
sweep's device-resident dataset): batch t is then records
(t*B + arange(B)) % N, the host cursor's wrap-around order."""
from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

from .. import proto
from .lmdb_py import Cursor, Environment
from .transformer import DataTransformer

Feed = Callable[[], Dict[str, np.ndarray]]


def datum_to_array(datum: proto.Message):
    """(C, H, W) uint8 (or float32) pixels and the label of a Datum."""
    shape = (datum.channels, datum.height, datum.width)
    if datum.encoded:
        raise NotImplementedError("encoded (JPEG/PNG) Datum records are "
                                  "not supported by the port")
    if datum.data:
        arr = np.frombuffer(datum.data, dtype=np.uint8).reshape(shape)
    else:
        arr = np.asarray(datum.float_data, dtype=np.float32).reshape(shape)
    return arr, datum.label


def array_to_datum(arr: np.ndarray, label: int = 0) -> proto.Message:
    """A (C, H, W) array as a Datum (the reference's data/db.py
    array_to_datum): uint8 pixels as `data`, any other dtype as float32
    `float_data`; `proto.encode` serializes it."""
    d = proto.Message("Datum")
    d.channels, d.height, d.width = (int(v) for v in arr.shape)
    d.label = int(label)
    if arr.dtype == np.uint8:
        d.data = arr.tobytes()
    else:
        d.float_data.extend(np.asarray(arr, np.float32).reshape(-1).tolist())
    return d


def open_lmdb(source: str) -> Environment:
    mdb = source if os.path.isfile(source) else os.path.join(source,
                                                             "data.mdb")
    if not os.path.exists(mdb):
        raise FileNotFoundError(
            f"Data source {source!r} is not an LMDB (the port reads LMDB "
            "only)")
    return Environment(source)


def infer_datum_shape(source: str) -> tuple:
    """(C, H, W) of the first record (DataLayer setup,
    data_layer.cpp DataLayerSetUp)."""
    env = open_lmdb(source)
    try:
        arr, _ = datum_to_array(proto.decode_datum(Cursor(env).value()))
        return arr.shape
    finally:
        env.close()


def data_feed(layer) -> Feed:
    """The sequential feed of one Data layer: `batch_size` records per
    call from a wrap-around cursor, transformed, labels as float32."""
    dp = layer.lp.data_param
    cursor = Cursor(open_lmdb(dp.source))
    transformer = DataTransformer(layer.lp.transform_param,
                                  phase=layer.phase)
    tops = list(layer.lp.top)

    def feed() -> Dict[str, np.ndarray]:
        datas, labels = [], []
        for _ in range(dp.batch_size):
            arr, label = datum_to_array(
                proto.decode_datum(cursor.next_value()))
            datas.append(transformer.transform(arr))
            labels.append(label)
        out = {tops[0]: np.stack(datas)}
        if len(tops) > 1:
            out[tops[1]] = np.asarray(labels, np.float32)
        return out
    return feed


def build_feed(net) -> Feed:
    """One callable feeding every data-source layer of `net`; a layer
    with no automatic source (Input) raises at first pull."""
    subs = []
    for layer in net.layers:
        if not layer.is_data_source:
            continue
        if layer.type_name == "Data":
            subs.append(data_feed(layer))
        else:
            def missing(layer=layer):
                raise NotImplementedError(
                    f"no automatic feed for layer {layer.name!r} "
                    f"({layer.type_name}); pass train_feed to Solver")
            subs.append(missing)

    def feed() -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        for f in subs:
            batch.update(f())
        return batch
    return feed


def can_materialize(layer) -> bool:
    """Whether a layer's source decodes deterministically into whole-DB
    arrays: a Data layer without random per-pull transforms (TRAIN-phase
    random crop, mirror)."""
    if layer.type_name != "Data":
        return False
    tp = layer.lp.transform_param
    return not (tp.mirror or (tp.crop_size and layer.phase == proto.TRAIN))


MATERIALIZE_MAX_BYTES = 1 << 31     # a dataset larger stays on the host


def materialize_data_source(layer):
    """The whole DB of a Data layer, decoded and transformed in cursor
    order: {top: (N, ...) array}, labels as float32; None when the layer
    cannot be materialized exactly or the data exceed
    MATERIALIZE_MAX_BYTES."""
    if not can_materialize(layer):
        return None
    dp = layer.lp.data_param
    tops = list(layer.lp.top)
    env = open_lmdb(dp.source)
    try:
        cursor = Cursor(env)
        transformer = DataTransformer(layer.lp.transform_param,
                                      phase=layer.phase)
        datas, labels, total = [], [], 0
        for _ in range(len(env)):          # the cursor wraps; count
            arr, label = datum_to_array(
                proto.decode_datum(cursor.next_value()))
            arr = transformer.transform(arr)
            total += arr.nbytes
            if total > MATERIALIZE_MAX_BYTES:
                return None
            datas.append(arr)
            labels.append(label)
    finally:
        env.close()
    out = {tops[0]: np.stack(datas)}
    if len(tops) > 1:
        out[tops[1]] = np.asarray(labels, np.float32)
    return out
