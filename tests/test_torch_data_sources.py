"""The port's data sources against the reference package's, on files
written from a seed with numpy: ImageData, LevelDB and the Data layer
over it, HDF5Data and HDF5Output, MemoryData, and the prefetching feed
with its wiring into the Solver and the sweep.

- ImageData: 4 pulls give the reference's batches bit for bit: shuffle
  across a wrap, rand_skip, root_folder, new_height/new_width, mean_file
  against mean_value against none, crop and mirror in TRAIN, the centre
  crop in TEST, gray images.
- LevelDB both ways: the port reads a DB the reference's BulkWriter
  wrote, the reference reads the port's, and the two writers' files are
  byte-identical; a hand-built SSTable (snappy-compressed data block,
  a deletion and a newer write in the log) reads alike in both. A
  LEVELDB Data layer feeds the reference's batches, its Solver steps, and
  the sweep materializes it as the reference does.
- HDF5Data (shuffled file order, rows across files and wraps) and
  HDF5Output (rows appended, the file truncated at construction) match
  the reference; without h5py both are refused by name.
- MemoryData serves the reference's chunks, and refuses a pull before
  set_input_arrays as the reference does.
- PrefetchingFeed gives the raw feed's batches in order, its producer's
  error is sticky, a closed or dropped feed stops its thread; the
  Solver's default feed prefetches (no thread until the first pull), the
  sweep's stays raw and gives the reference's batches; stack_batches
  stacks device tensors as it stacks host arrays.

Tolerance: none; every comparison is exact.
"""
import gc
import os
import struct
import sys
import threading

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax

from rram_caffe_simulation_tpu.data import feed as jfeed
from rram_caffe_simulation_tpu.data import leveldb_py as jldb
from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core.registry import \
    create_layer as tcreate
from rram_caffe_simulation_tpu_torch.data import db as tdb
from rram_caffe_simulation_tpu_torch.data import feed as tfeed
from rram_caffe_simulation_tpu_torch.data import leveldb_py as tldb
from rram_caffe_simulation_tpu_torch.data.feed import array_to_datum
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver.solver import stack_batches

from test_torch_windows import bits, layer_pair, write_images, write_mean


@pytest.fixture(autouse=True)
def no_x64():
    with jax.enable_x64(False):
        yield


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(bits(g), bits(want[k]))


def prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "feed-prefetch"]


# ---------------------------------------------------------------------------
# ImageData

@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("images")
    images = write_images(tmp, 7, ((20, 50), (24, 60)), seed=5)
    rng = np.random.RandomState(6)
    (tmp / "list.txt").write_text("".join(
        f"{os.path.basename(p)} {rng.randint(20)}\n" for p, _ in images))
    return {"root": str(tmp) + "/", "list": str(tmp / "list.txt"),
            "mean": write_mean(tmp / "mean.binaryproto", (1, 3, 32, 32), 7)}


IMAGE_FEEDS = {   # transform_param, image_data_param, phase
    "shuffle_wrap": ("", "shuffle: true", 0),
    "rand_skip": ("", "rand_skip: 2", 0),
    "mean_file_crop_mirror": ('mirror: true crop_size: 28 mean_file: '
                              '"{mean}"', "shuffle: true", 0),
    "mean_value_scale_gray": ("mean_value: 100 scale: 0.5", "is_color: false",
                              0),
    "test_centre_crop": ('crop_size: 24 mean_file: "{mean}"', "", 1),
}


def image_layer_text(files, transform="", param=""):
    return (f'name: "data" type: "ImageData" top: "data" top: "label" '
            f"transform_param {{ {transform.format(mean=files['mean'])} }} "
            f'image_data_param {{ source: "{files["list"]}" batch_size: 3 '
            f'root_folder: "{files["root"]}" new_height: 32 new_width: 32 '
            f"{param} }}")


@pytest.mark.parametrize("case", sorted(IMAGE_FEEDS))
def test_image_feed_gives_the_references_batches(image_files, case):
    transform, param, phase = IMAGE_FEEDS[case]
    jlayer, tlayer = layer_pair(image_layer_text(image_files, transform,
                                                 param), phase)
    assert tlayer.top_shapes == [tuple(s) for s in jlayer.top_shapes]
    jf = jfeed.FEED_BUILDERS["ImageData"](jlayer)
    tf = tfeed.FEED_BUILDERS["ImageData"](tlayer)
    for _ in range(4):                 # 12 entries drawn from 7: wraps
        assert_batches_equal(tf(), jf())


def test_image_data_net_prefetches_the_references_batches(image_files):
    """build_feed over a net with an ImageData layer: its prefetching feed
    (tensors on the CPU) gives the reference's raw feed's batches."""
    text = ("layer { %s }" % image_layer_text(
        image_files, 'mirror: true crop_size: 28 mean_file: "{mean}"',
        "shuffle: true"))
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    jf = jfeed.build_feed(JNet(jmsg, pb.TRAIN), prefetch=False)
    tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                device="cpu")
    tf = tfeed.build_feed(tnet, device="cpu")
    for _ in range(4):
        got = tf()
        assert all(isinstance(v, torch.Tensor) for v in got.values())
        assert_batches_equal(got, jf())
    tf.close()


# ---------------------------------------------------------------------------
# LevelDB

def datum_records(n, shape=(1, 4, 4), seed=0):
    rng = np.random.RandomState(seed)
    return [(f"{i:08d}".encode(), tproto.encode(array_to_datum(
        rng.randint(0, 256, shape, dtype=np.uint8), int(rng.randint(10)))))
        for i in range(n)]


def test_leveldb_both_ways_and_byte_identical(tmp_path):
    recs = datum_records(300, (3, 8, 8))        # several log blocks
    for name, mod in (("ref", jldb), ("port", tldb)):
        with mod.BulkWriter(str(tmp_path / name), batch_size=64) as w:
            for k, v in recs:
                w.put(k, v)
    files = sorted(os.listdir(tmp_path / "ref"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "000003.log", "CURRENT", "MANIFEST-000002"]
    for f in files:
        assert (tmp_path / "ref" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f
    assert list(tldb.Database(str(tmp_path / "ref")).items()) == recs
    assert list(jldb.Database(str(tmp_path / "port")).items()) == recs
    db = tdb.open_db(str(tmp_path / "port"), 1)   # says LMDB: files win
    assert isinstance(db, tdb.LevelDB) and len(db) == 300
    cur = db.cursor()
    assert [cur.next_value() for _ in range(302)][-2:] == \
        [recs[0][1], recs[1][1]]                 # wraps around


def snappy_literal_and_copy(data: bytes) -> bytes:
    """A snappy stream of `data`: its first 8 bytes as a literal, the rest
    as 1-byte-offset copies of 4..11 bytes where `data` repeats its
    opening, else literals."""
    out = bytearray(tldb._write_varint(len(data)))
    out += bytes([(8 - 1) << 2]) + data[:8]
    pos = 8
    while pos < len(data):
        n = min(11, len(data) - pos)
        if n >= 4 and data[pos:pos + n] == data[pos - 8:pos - 8 + n]:
            out += bytes([((n - 4) << 2) | 1, 8])   # offset 8, length n
        else:
            n = min(60, len(data) - pos)
            out += bytes([(n - 1) << 2]) + data[pos:pos + n]
        pos += n
    return bytes(out)


def hand_sstable(entries, compress):
    """An SSTable of (user_key, seq, type, value) entries in one data
    block, restart every entry."""
    block = bytearray()
    restarts = []
    for key, seq, vtype, value in entries:
        restarts.append(len(block))
        ikey = key + ((seq << 8) | vtype).to_bytes(8, "little")
        block += (tldb._write_varint(0) + tldb._write_varint(len(ikey))
                  + tldb._write_varint(len(value)) + ikey + value)
    block += b"".join(struct.pack("<I", r) for r in restarts)
    block += struct.pack("<I", len(restarts))
    raw = snappy_literal_and_copy(bytes(block)) if compress else bytes(block)
    data = bytearray(raw + bytes([int(compress)]) + b"\0" * 4)
    handle = tldb._write_varint(0) + tldb._write_varint(len(raw))
    last = entries[-1][0] + b"\xff" * 8
    index = (tldb._write_varint(0) + tldb._write_varint(len(last))
             + tldb._write_varint(len(handle)) + last + handle
             + struct.pack("<II", 0, 1))
    index_off = len(data)
    data += index + b"\0" * 5
    footer = (tldb._write_varint(0) + tldb._write_varint(0)
              + tldb._write_varint(index_off) + tldb._write_varint(len(index)))
    footer = footer.ljust(40, b"\0") + struct.pack("<Q", tldb._TABLE_MAGIC)
    return bytes(data + footer)


@pytest.mark.parametrize("compress", [False, True])
def test_leveldb_sstable_log_and_deletions(tmp_path, compress):
    """Level-0 table 000005.ldb under a log with a newer write and a
    deletion: the newest sequence wins, deletions are suppressed, in both
    packages."""
    path = tmp_path / "db"
    path.mkdir()
    rep = b"abcdefgh" * 6
    table = [(b"k%02d" % i, i + 1, 1, rep + bytes([i])) for i in range(12)]
    (path / "000005.ldb").write_bytes(hand_sstable(table, compress))
    edit = (tldb._write_varint(1) + tldb._length_prefixed(
        b"leveldb.BytewiseComparator") + tldb._write_varint(2)
        + tldb._write_varint(6) + tldb._write_varint(7)
        + tldb._write_varint(0) + tldb._write_varint(5)
        + tldb._write_varint(100) + tldb._length_prefixed(b"k00" + bytes(8))
        + tldb._length_prefixed(b"k11" + bytes(8)))
    mw = tldb.LogWriter(str(path / "MANIFEST-000004"))
    mw.append(edit)
    mw.close()
    (path / "CURRENT").write_text("MANIFEST-000004\n")
    batch = bytearray((100).to_bytes(8, "little") + struct.pack("<I", 2))
    batch += b"\x01" + tldb._length_prefixed(b"k03") + \
        tldb._length_prefixed(b"newer")
    batch += b"\x00" + tldb._length_prefixed(b"k07")
    lw = tldb.LogWriter(str(path / "000006.log"))
    lw.append(bytes(batch))
    lw.close()
    got = list(tldb.Database(str(path)).items())
    assert got == list(jldb.Database(str(path)).items())
    want = {k: v for k, _, _, v in table}
    want[b"k03"] = b"newer"
    del want[b"k07"]
    assert got == sorted(want.items())
    assert tldb.crc32c(b"123456789") == jldb.crc32c(b"123456789") == \
        0xE3069283


def data_layer_text(source, batch=4, transform="", backend="LEVELDB"):
    return (f'name: "data" type: "Data" top: "data" top: "label" '
            f"transform_param {{ {transform} }} "
            f'data_param {{ source: "{source}" batch_size: {batch} '
            f"backend: {backend} }}")


@pytest.fixture(scope="module")
def leveldb_source(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("leveldb") / "db")
    with tldb.BulkWriter(path) as w:
        for k, v in datum_records(10, (1, 6, 6), seed=3):
            w.put(k, v)
    return path


def test_leveldb_data_layer_feeds_and_trains(leveldb_source):
    layer = data_layer_text(leveldb_source, 4, "scale: 0.00390625")
    jlayer, tlayer = layer_pair(layer)
    assert tlayer.top_shapes == [tuple(s) for s in jlayer.top_shapes] == \
        [(4, 1, 6, 6), (4,)]
    jf = jfeed._python_data_feed(jlayer)
    tf = tfeed.data_feed(tlayer)
    for _ in range(4):                          # 16 of 10 records: wraps
        assert_batches_equal(tf(), jf())
    net = (f"layer {{ {layer} }} layer {{ name: 'ip' type: 'InnerProduct' "
           "bottom: 'data' top: 'ip' inner_product_param { num_output: 10 "
           "weight_filler { type: 'xavier' } } } layer { name: 'loss' "
           "type: 'SoftmaxWithLoss' bottom: 'ip' bottom: 'label' top: 'loss' }")
    sp = tproto.parse(f"net_param {{ {net} }} base_lr: 0.1 lr_policy: "
                      "'fixed' display: 0 random_seed: 1 failure_pattern { "
                      "type: 'gaussian' mean: 1e8 std: 1e6 }",
                      "SolverParameter")
    ts = TSolver(sp, device="cpu")
    ts.step(3)
    assert np.isfinite(float(ts.last_loss))
    jf = jfeed._python_data_feed(jlayer)
    r = TSweep(ts, 2, device="cpu")             # materialized, as an LMDB
    assert r._dataset is not None and r._feed is None
    want = jfeed.materialize_data_source(jlayer)
    assert_batches_equal({k: v.cpu() for k, v in r._dataset.items()}, want)
    assert_batches_equal(r._batch(1), {k: v[4:8] for k, v in want.items()})
    r.close()


# ---------------------------------------------------------------------------
# HDF5Data, HDF5Output

@pytest.fixture(scope="module")
def hdf5_files(tmp_path_factory):
    import h5py
    tmp = tmp_path_factory.mktemp("hdf5")
    rng = np.random.RandomState(9)
    names = []
    for i, n in enumerate((5, 3, 4)):
        name = str(tmp / f"part{i}.h5")
        with h5py.File(name, "w") as f:
            f["data"] = rng.randn(n, 2, 3, 3).astype(np.float32)
            f["label"] = rng.randint(0, 5, n).astype(np.float32)
        names.append(name)
    (tmp / "list.txt").write_text("\n".join(names) + "\n")
    return str(tmp / "list.txt")


@pytest.mark.parametrize("shuffle", [False, True])
def test_hdf5_data_matches_the_reference(hdf5_files, shuffle):
    text = (f'name: "h5" type: "HDF5Data" top: "data" top: "label" '
            f'hdf5_data_param {{ source: "{hdf5_files}" batch_size: 5 '
            f"shuffle: {str(shuffle).lower()} }}")
    jlayer, tlayer = layer_pair(text)
    assert tlayer.top_shapes == [tuple(s) for s in jlayer.top_shapes] == \
        [(5, 2, 3, 3), (5,)]
    jf = jfeed.FEED_BUILDERS["HDF5Data"](jlayer)
    tf = tfeed.FEED_BUILDERS["HDF5Data"](tlayer)
    for _ in range(6):                       # 30 rows of 12: wraps twice
        assert_batches_equal(tf(), jf())


def sink_net_text(path):
    return ('layer { name: "in" type: "Input" top: "data" top: "label" '
            "input_param { shape { dim: 3 dim: 4 } shape { dim: 3 } } } "
            'layer { name: "out" type: "HDF5Output" bottom: "data" '
            f'bottom: "label" hdf5_output_param {{ file_name: "{path}" }} }}')


def test_hdf5_output_appends_as_the_reference(tmp_path):
    import h5py
    rng = np.random.RandomState(2)
    batches = [{"data": rng.randn(3, 4).astype(np.float32),
                "label": rng.randn(3).astype(np.float32)} for _ in range(2)]
    out = {}
    for name in ("ref", "port"):
        path = str(tmp_path / f"{name}.h5")
        with open(path, "w") as f:
            f.write("stale")                  # truncated at construction
        text = sink_net_text(path)
        if name == "ref":
            jmsg = pb.NetParameter()
            text_format.Parse(text, jmsg)
            net = JNet(jmsg, pb.TEST)
            assert not os.path.exists(path)
            for b in batches:
                net.apply({}, b)
        else:
            net = TNet(tproto.parse(text, "NetParameter"), tproto.TEST,
                       device="cpu")
            assert not os.path.exists(path)
            for b in batches:
                blobs, _ = net.apply({}, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        with h5py.File(path, "r") as f:
            out[name] = {k: np.asarray(f[k]) for k in f}
    assert_batches_equal(out["port"], out["ref"])
    assert out["port"]["data"].shape == (6, 4)


def test_hdf5_layers_refused_without_h5py(monkeypatch, hdf5_files, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    text = (f'name: "h5" type: "HDF5Data" top: "data" top: "label" '
            f'hdf5_data_param {{ source: "{hdf5_files}" batch_size: 5 }}')
    layer = tcreate(tproto.parse(text, "LayerParameter"), 0)
    with pytest.raises(NotImplementedError, match="HDF5Data layer 'h5'.*h5py"):
        layer.setup([])
    net = TNet(tproto.parse(sink_net_text(tmp_path / "x.h5"),
                            "NetParameter"), tproto.TEST, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="HDF5Output layer 'out'.*h5py"):
        net.apply({}, {"data": torch.zeros(3, 4), "label": torch.zeros(3)})


# ---------------------------------------------------------------------------
# MemoryData

MEMORY_NET = ('layer { name: "mem" type: "MemoryData" top: "data" '
              'top: "label" memory_data_param { batch_size: 4 channels: 2 '
              "height: 3 width: 3 } } layer { name: 'ip' type: "
              "'InnerProduct' bottom: 'data' top: 'ip' inner_product_param "
              "{ num_output: 5 weight_filler { type: 'xavier' } } } layer { "
              "name: 'loss' type: 'SoftmaxWithLoss' bottom: 'ip' bottom: "
              "'label' top: 'loss' }")


def test_memory_data_matches_the_reference():
    text = MEMORY_NET.split(" layer { name: 'ip'")[0][len("layer { "):-2]
    jlayer, tlayer = layer_pair(text)
    assert tlayer.top_shapes == [tuple(s) for s in jlayer.top_shapes]
    jf = jfeed.FEED_BUILDERS["MemoryData"](jlayer)
    tf = tfeed.FEED_BUILDERS["MemoryData"](tlayer)
    errors = []
    for f in (tf, jf):
        with pytest.raises(RuntimeError) as e:
            f()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "set_input_arrays" in errors[0]
    rng = np.random.RandomState(4)
    data = rng.randn(10, 2, 3, 3)
    labels = rng.randint(0, 5, 10)
    for layer in (jlayer, tlayer):
        layer.set_input_arrays(data, labels)
    for _ in range(4):
        assert_batches_equal(tf(), jf())
    sp = tproto.parse(f"net_param {{ {MEMORY_NET} }} base_lr: 0.1 "
                      "lr_policy: 'fixed' display: 0 random_seed: 1",
                      "SolverParameter")
    ts = TSolver(sp, device="cpu")
    ts.net.layer_by_name["mem"].set_input_arrays(data, labels)
    ts.step(3)
    assert np.isfinite(float(ts.last_loss))


# ---------------------------------------------------------------------------
# the prefetching feed and its wiring

def counting_feed(fail_at=None):
    calls = {"n": 0}

    def feed():
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise ValueError(f"bad record {calls['n']}")
        return {"x": np.full((2, 3), calls["n"], np.float32),
                "y": np.arange(2, dtype=np.float32) + calls["n"]}
    return feed


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetching_feed_keeps_the_raw_order(device):
    raw, pf = counting_feed(), tfeed.PrefetchingFeed(counting_feed(), 2,
                                                     device)
    for _ in range(7):
        got = pf()
        assert all(isinstance(v, torch.Tensor) == (device is not None)
                   for v in got.values())
        assert_batches_equal(got, raw())
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf()


def test_prefetching_feed_error_is_sticky():
    pf = tfeed.PrefetchingFeed(counting_feed(fail_at=3), depth=4)
    assert float(pf()["x"][0, 0]) == 1 and float(pf()["x"][0, 0]) == 2
    for _ in range(3):                    # every later pull, no hang
        with pytest.raises(ValueError, match="bad record 3"):
            pf()


def test_prefetching_feed_starts_late_and_ends_when_dropped():
    before = len(prefetch_threads())
    pf = tfeed.PrefetchingFeed(counting_feed(), depth=2)
    assert len(prefetch_threads()) == before
    pf()
    thread = pf._thread
    assert thread.is_alive()
    del pf
    gc.collect()
    thread.join(timeout=5)
    assert not thread.is_alive()


def mirrored_solver_text(source):
    """A TRAIN mirror makes the Data layer unmaterializable, so a sweep
    over this net feeds from the host."""
    layer = data_layer_text(source, 4, "mirror: true")
    net = (f"layer {{ {layer} }} layer {{ name: 'ip' type: 'InnerProduct' "
           "bottom: 'data' top: 'ip' inner_product_param { num_output: 10 "
           "weight_filler { type: 'xavier' } } } layer { name: 'loss' "
           "type: 'SoftmaxWithLoss' bottom: 'ip' bottom: 'label' top: 'loss' }")
    text = (f"net_param {{ {net} }} base_lr: 0.1 lr_policy: 'fixed' "
            "display: 0 random_seed: 1 failure_pattern { type: 'gaussian' "
            "mean: 1e8 std: 1e6 }")
    return layer, tproto.parse(text, "SolverParameter")


@pytest.mark.parametrize("prefetch", [False, True])
def test_solver_feeds_raw_unless_asked_to_prefetch(leveldb_source, prefetch):
    """The Solver's default feed is raw (host arrays, no thread); with
    `prefetch` it runs on a producer thread started at the first pull,
    its batches tensors on the Solver's device, and `close()` stops it.
    Either way the batches are the reference's, bit for bit."""
    layer, sp = mirrored_solver_text(leveldb_source)
    before = len(prefetch_threads())
    ts = TSolver(sp, device="cpu", prefetch=prefetch)
    assert not ts.custom_train_feed and len(prefetch_threads()) == before
    jlayer, _ = layer_pair(layer)
    jf = jfeed._python_data_feed(jlayer)
    for _ in range(3):
        got = ts.train_feed()
        assert all(isinstance(v, torch.Tensor) == prefetch
                   for v in got.values())
        assert_batches_equal(got, jf())
    assert len(prefetch_threads()) == before + prefetch
    ts.step(2)
    assert np.isfinite(float(ts.last_loss))
    ts.close()
    assert len(prefetch_threads()) == before


def test_the_sweep_feeds_from_its_own_raw_feed_or_the_one_given(
        leveldb_source):
    """Without a feed the runner builds a raw one of its own, whose
    batches are the reference's from the first record, whatever the
    Solver's feed has pulled; a feed given to the runner, or given to or
    assigned on the Solver before the runner is built, is the one it
    pulls; a swap on the Solver after that is refused at the next batch."""
    layer, sp = mirrored_solver_text(leveldb_source)
    ts = TSolver(sp, device="cpu")
    ts.train_feed()
    r = TSweep(ts, 2, device="cpu")
    assert r._dataset is None
    jlayer, _ = layer_pair(layer)
    jf = jfeed._python_data_feed(jlayer)
    for it in range(3):
        assert_batches_equal(r._batch(it), jf())
    r.close()
    for given in ("runner", "solver"):
        feed = counting_feed()
        if given == "solver":
            ts.train_feed = feed
        r = TSweep(ts, 2, device="cpu",
                   feed=feed if given == "runner" else None)
        want = counting_feed()
        for it in range(2):
            assert_batches_equal(r._batch(it), want())
        r.close()
    r = TSweep(ts, 2, device="cpu")
    ts.train_feed = counting_feed()
    with pytest.raises(RuntimeError, match="replaced after this SweepRunner"):
        r._batch(0)
    r.close()


def test_stack_batches_takes_tensors_as_arrays():
    for iter_size in (1, 3):
        host = stack_batches(counting_feed(), iter_size, "cpu")
        feed = counting_feed()
        dev = stack_batches(lambda: {k: torch.from_numpy(v) for k, v in
                                     feed().items()}, iter_size, "cpu")
        assert_batches_equal(dev, {k: v.numpy() for k, v in host.items()})
        assert host["x"].shape == ((2, 3) if iter_size == 1
                                   else (iter_size, 2, 3))
