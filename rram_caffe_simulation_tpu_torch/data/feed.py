"""Host-side batch feeds for data-source layers (counterpart of the
reference package's data/feed.py): one callable per net, each call one
batch dict {top: array}, pulled from every data-source layer's own feed.

- Data: a wrap-around cursor over an LMDB or a LevelDB (data/db.py),
  Datum decode and the DataTransformer;
- ImageData: a `path label` list, images decoded on a thread pool, the
  transform in entry order, a reshuffle at each epoch with `shuffle`;
- WindowData: R-CNN windows, background then foreground, each cropped
  by data/windows.py and normalized where image pixels lie;
- HDF5Data: the listed files' rows in order, round robin;
- MemoryData: arrays set through the layer's `set_input_arrays`.

`build_feed(net, prefetch=True)` runs each Data, ImageData, HDF5Data and
WindowData feed on a producer thread of its own (`PrefetchingFeed`), as
the reference does (base_data_layer.cpp:76-120 prefetch).

`materialize_data_source` decodes a whole DB once instead (the sweep's
device-resident dataset): batch t is then records (t*B + arange(B)) % N,
the host cursor's wrap-around order."""
from __future__ import annotations

import os
import queue
import threading
import weakref
import zlib
from typing import Callable, Dict

import numpy as np
import torch

from .. import proto
from .db import array_to_datum, datum_to_array, open_db  # noqa: F401
from .transformer import DataTransformer

Feed = Callable[[], Dict[str, np.ndarray]]


def batch_to(batch: dict, device) -> Dict[str, torch.Tensor]:
    """A batch dict of host arrays or tensors as tensors on `device`."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the prefetching feed

_STOP_POLL_S = 0.1      # how often a blocked producer looks for its owner


class PrefetchingFeed:
    """`feed` run ahead on a daemon producer thread into a queue of
    `depth` batches (base_data_layer.hpp:71 PREFETCH_COUNT). The thread
    starts at the first pull, so a feed nobody pulls starts none.

    With a `device` each batch arrives as tensors there: on the card the
    producer copies it from pinned memory on a CUDA stream of its own and
    records an event, and the pull makes the caller's stream wait on
    that event before it hands the batch over (and marks the tensors as
    used on the caller's stream, so their memory is not reused before
    the caller is done). Without one it arrives as the host arrays.

    A producer error is sticky: the pull that reaches it raises it, and
    so does every later pull. The producer ends when the feed is closed
    or no longer referenced."""

    def __init__(self, feed: Feed, depth: int = 3, device=None):
        self._feed = feed
        self._depth = max(int(depth), 1)
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = None
        self._error = None

    @staticmethod
    def _produce(owner, feed, device, q, stop):
        cuda = device is not None and device.type == "cuda"
        stream = torch.cuda.Stream(device) if cuda else None

        def put(item) -> bool:
            while not stop.is_set() and owner() is not None:
                try:
                    q.put(item, timeout=_STOP_POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        try:
            while True:
                batch, event = feed(), None
                if cuda:
                    with torch.cuda.stream(stream):
                        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                                 .pin_memory().to(device, non_blocking=True)
                                 for k, v in batch.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                elif device is not None:
                    batch = batch_to(batch, device)
                if not put((batch, event)):
                    return
        except BaseException as e:     # surfaces at the consumer's pull
            put(_ProducerDied(e))

    def __call__(self) -> dict:
        if self._error is not None:
            raise self._error
        if self._stop.is_set():
            raise RuntimeError("pull from a closed PrefetchingFeed")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._produce, name="feed-prefetch", daemon=True,
                args=(weakref.ref(self), self._feed, self._device, self._q,
                      self._stop))
            self._thread.start()
        item = self._q.get()
        if isinstance(item, _ProducerDied):
            self._error = item.error
            raise self._error
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the producer and drop the batches it made."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        while not self._q.empty():
            self._q.get_nowait()


class _ProducerDied:
    def __init__(self, error: BaseException):
        self.error = error


# the layer types whose feeds do I/O and prefetch; MemoryData does not
# (its arrays arrive through set_input_arrays after construction)
_PREFETCHABLE = {"Data", "ImageData", "HDF5Data", "WindowData"}


def _feed_rng(layer) -> np.random.RandomState:
    """The layer's own host RNG (the reference seeds each prefetch thread
    from the global RNG, base_data_layer.cpp:60)."""
    return np.random.RandomState(
        (zlib.crc32(layer.name.encode()) ^ 0x5EED) & 0x7FFFFFFF)


def build_feed(net, prefetch: bool = True, device=None) -> Feed:
    """One callable feeding every data-source layer of `net`; a layer
    with no automatic source (Input) raises at first pull. With
    `prefetch` each I/O source runs ahead on its own thread
    (`PrefetchingFeed`, of depth `data_param.prefetch` for Data, 3 for
    the others), its batches as tensors on `device` when one is given.
    The callable's `close()` stops the producers."""
    subs, prefetchers = [], []
    for layer in net.layers:
        if not layer.is_data_source:
            continue
        builder = FEED_BUILDERS.get(layer.type_name)
        if builder is None:
            def missing(layer=layer):
                raise NotImplementedError(
                    f"no automatic feed for layer {layer.name!r} "
                    f"({layer.type_name}); pass train_feed to Solver or "
                    "use MemoryData's set_input_arrays")
            subs.append(missing)
            continue
        f = builder(layer)
        if prefetch and layer.type_name in _PREFETCHABLE:
            depth = (layer.lp.data_param.prefetch
                     if layer.type_name == "Data" else 3)
            f = PrefetchingFeed(f, depth=depth, device=device)
            prefetchers.append(f)
        subs.append(f)

    def feed() -> dict:
        batch: dict = {}
        for f in subs:
            batch.update(f())
        return batch

    def close() -> None:
        for p in prefetchers:
            p.close()
    feed.close = close
    return feed


# ---------------------------------------------------------------------------
# Data (LMDB / LevelDB)

def data_feed(layer) -> Feed:
    """The sequential feed of one Data layer: `batch_size` records per
    call from a wrap-around cursor, transformed, labels as float32."""
    dp = layer.lp.data_param
    cursor = open_db(dp.source, dp.backend).cursor()
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
    db = open_db(dp.source, dp.backend)
    try:
        cursor = db.cursor()
        transformer = DataTransformer(layer.lp.transform_param,
                                      phase=layer.phase)
        datas, labels, total = [], [], 0
        for _ in range(len(db)):           # the cursor wraps; count
            arr, label = datum_to_array(
                proto.decode_datum(cursor.next_value()))
            arr = transformer.transform(arr)
            total += arr.nbytes
            if total > MATERIALIZE_MAX_BYTES:
                return None
            datas.append(arr)
            labels.append(label)
    finally:
        db.close()
    out = {tops[0]: np.stack(datas)}
    if len(tops) > 1:
        out[tops[1]] = np.asarray(labels, np.float32)
    return out


# ---------------------------------------------------------------------------
# HDF5Data, MemoryData

def _hdf5_feed(layer) -> Feed:
    """HDF5Data (hdf5_data_layer.cpp): the source lists .h5 paths; rows
    are read in order, the files round robin; with `shuffle` the file
    order is shuffled at the start and again at each wrap."""
    from ..utils.io import require_h5py
    h5py = require_h5py(f"HDF5Data layer {layer.name!r}")
    hp = layer.lp.hdf5_data_param
    with open(hp.source) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    tops = list(layer.lp.top)
    state = {"file": 0, "row": 0, "data": None}
    rng = _feed_rng(layer)
    if hp.shuffle:
        rng.shuffle(files)

    def load(idx):
        with h5py.File(files[idx], "r") as h5:
            state["data"] = {t: np.asarray(h5[t]) for t in tops}
        state["row"] = 0

    def feed():
        if state["data"] is None:
            load(state["file"])
        out = {t: [] for t in tops}
        need = hp.batch_size
        while need > 0:
            data = state["data"]
            n = next(iter(data.values())).shape[0]
            take = min(need, n - state["row"])
            for t in tops:
                out[t].append(data[t][state["row"]:state["row"] + take])
            state["row"] += take
            need -= take
            if state["row"] >= n:
                state["file"] = (state["file"] + 1) % len(files)
                if state["file"] == 0 and hp.shuffle:
                    # the reference re-permutes its file order on wrap
                    # (hdf5_data_layer.cpp:172-180)
                    rng.shuffle(files)
                load(state["file"])
        return {t: np.concatenate(v, axis=0) for t, v in out.items()}
    return feed


def _memory_feed(layer) -> Feed:
    """MemoryData (memory_data_layer.cpp): arrays set through
    `layer.set_input_arrays(data, labels)`, served in batch-size chunks
    that wrap around."""
    state = {"pos": 0}

    def set_input_arrays(data, labels):
        layer._memory_data = (np.asarray(data, np.float32),
                              np.asarray(labels, np.float32))
        state["pos"] = 0
    layer.set_input_arrays = set_input_arrays

    n = layer.lp.memory_data_param.batch_size
    tops = list(layer.lp.top)

    def feed():
        if not hasattr(layer, "_memory_data"):
            raise RuntimeError(
                f"MemoryData layer {layer.name!r}: call set_input_arrays "
                "before stepping")
        data, labels = layer._memory_data
        total = data.shape[0]
        idx = [(state["pos"] + i) % total for i in range(n)]
        state["pos"] = (state["pos"] + n) % total
        return {tops[0]: data[idx], tops[1]: labels[idx]}
    return feed


# ---------------------------------------------------------------------------
# ImageData, WindowData

_DECODE_POOL = None


def _decode_pool():
    """The shared thread pool a batch's image files decode on (zlib
    inflate and numpy release the GIL); the transform stays on the
    calling thread."""
    global _DECODE_POOL
    if _DECODE_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _DECODE_POOL = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="img-decode")
    return _DECODE_POOL


def _image_feed(layer) -> Feed:
    """ImageData (image_data_layer.cpp): the source lists `path label`
    lines. A batch's files decode concurrently on the decode pool; the
    DataTransformer runs in entry order (its random crop and mirror
    draws depend on the order)."""
    from .image import load_image
    ip = layer.lp.image_data_param
    with open(ip.source) as f:
        # any-whitespace split, like the reference's `infile >> name >> label`
        entries = [ln.rsplit(None, 1) for ln in f if ln.strip()]
    rng = _feed_rng(layer)
    if ip.shuffle:
        rng.shuffle(entries)
    transformer = DataTransformer(layer.lp.transform_param,
                                  phase=layer.phase)
    tops = list(layer.lp.top)
    state = {"pos": int(ip.rand_skip)}

    def feed():
        paths, labels = [], []
        for _ in range(ip.batch_size):
            if state["pos"] >= len(entries):
                state["pos"] = 0
                if ip.shuffle:
                    # ShuffleImages each epoch (image_data_layer.cpp:140)
                    rng.shuffle(entries)
            path, label = entries[state["pos"]]
            state["pos"] += 1
            paths.append(ip.root_folder + path)
            labels.append(float(label))
        arrs = list(_decode_pool().map(
            lambda p: load_image(p, ip.is_color, ip.new_height,
                                 ip.new_width), paths))
        datas = [transformer.transform(a) for a in arrs]
        return {tops[0]: np.stack(datas),
                tops[1]: np.asarray(labels, np.float32)}
    return feed


def _window_feed(layer) -> Feed:
    """WindowData (window_data_layer.cpp load_batch): per batch,
    `fg_fraction` of the windows drawn from the foreground (overlap >=
    fg_threshold), the rest from the background (overlap < bg_threshold,
    label 0), background first; each window cropped with its context
    padding in warp or square mode, mirrored at random with `mirror`,
    and mean-subtracted and scaled only where image pixels lie (the
    padding stays exact 0)."""
    from ..utils.io import read_blob_from_file
    from .image import load_image
    from .windows import extract_window, parse_window_file
    wp = layer.lp.window_data_param
    tp = layer.lp.transform_param
    images, windows = parse_window_file(wp.source, wp.root_folder)
    fg = [w for w in windows if w.overlap >= wp.fg_threshold]
    bg = [w for w in windows if w.overlap < wp.bg_threshold]
    if not fg or not bg:
        raise ValueError(
            f"window file {wp.source}: need both foreground and background "
            f"windows (got {len(fg)} fg / {len(bg)} bg)")
    crop = int(tp.crop_size or wp.crop_size)
    mean_values = mean_patch = None
    if tp.mean_file or wp.mean_file:
        mean = read_blob_from_file(tp.mean_file or wp.mean_file)[0]
        off = (mean.shape[-1] - crop) // 2
        mean_patch = mean[:, off:off + crop, off:off + crop]
    elif tp.mean_value:
        mean_values = np.asarray(tp.mean_value, np.float32).reshape(-1, 1, 1)
    scale = tp.scale if tp.HasField("scale") else wp.scale
    square = wp.crop_mode == "square"
    n_fg = int(wp.batch_size * wp.fg_fraction)
    counts = {True: n_fg, False: wp.batch_size - n_fg}
    rng = _feed_rng(layer)
    tops = list(layer.lp.top)
    cache: dict = {}

    def get_image(idx):
        # uint8 pixels: the crop converts its own patch to float32, the
        # values the reference's whole-image conversion gives
        img = cache.get(idx)
        if img is None:
            img = load_image(images[idx][0])
            if wp.cache_images:
                cache[idx] = img
        return img

    def feed():
        datas = np.zeros((wp.batch_size, 3, crop, crop), np.float32)
        labels = np.zeros((wp.batch_size,), np.float32)
        item = 0
        for is_fg in (False, True):   # background first, as the reference
            pool = fg if is_fg else bg
            for _ in range(counts[is_fg]):
                w = pool[rng.randint(len(pool))]
                mirror = bool(tp.mirror) and rng.randint(2) == 1
                canvas, mask = extract_window(
                    get_image(w.image_index), w.box, crop,
                    context_pad=wp.context_pad, square=square, mirror=mirror)
                if mean_patch is not None:
                    canvas = np.where(mask, (canvas - mean_patch) * scale, 0)
                elif mean_values is not None:
                    canvas = np.where(mask, (canvas - mean_values) * scale, 0)
                else:
                    canvas = canvas * scale
                datas[item] = canvas
                labels[item] = w.label if is_fg else 0
                item += 1
        return {tops[0]: datas, tops[1]: labels}
    return feed


FEED_BUILDERS = {
    "Data": data_feed,
    "HDF5Data": _hdf5_feed,
    "MemoryData": _memory_feed,
    "ImageData": _image_feed,
    "WindowData": _window_feed,
}
