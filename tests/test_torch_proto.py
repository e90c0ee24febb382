"""The port's protobuf-free readers against google.protobuf: the text
reader on the CIFAR-10-quick prototxts (every field the port's schema
declares, defaults included), and the wire decoders on LMDB Datum
records and the CIFAR mean BlobProto."""
import os

import numpy as np
import pytest
from google.protobuf import text_format

from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.data import feed as tfeed
from rram_caffe_simulation_tpu_torch.data.lmdb_py import Cursor, Environment
from rram_caffe_simulation_tpu_torch.proto.schema import MESSAGES
from rram_caffe_simulation_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTOTXTS = [
    ("models/cifar10_quick/cifar10_quick_lmdb_solver.prototxt",
     "SolverParameter"),
    ("models/cifar10_quick/cifar10_quick_lmdb_train_test.prototxt",
     "NetParameter"),
    ("models/cifar10_quick/cifar10_quick_train_test.prototxt",
     "NetParameter"),
]


def assert_same(ref, mine, path="msg"):
    """Every field of `mine`'s schema type reads as protobuf reads it
    (presence, value, default); every field protobuf has set is present
    in `mine`, declared or not."""
    schema = MESSAGES[mine.type_name]
    for fd in ref.DESCRIPTOR.fields:
        name = fd.name
        where = f"{path}.{name}"
        if name not in schema.fields:
            if fd.is_repeated:
                present = len(getattr(ref, name)) > 0
            else:
                present = ref.HasField(name)
            assert (name in mine.set_fields()) == present, where
            continue
        ref_v, my_v = getattr(ref, name), getattr(mine, name)
        if fd.is_repeated:
            assert len(ref_v) == len(my_v), where
            for i, (a, b) in enumerate(zip(ref_v, my_v)):
                if fd.type == fd.TYPE_MESSAGE:
                    assert_same(a, b, f"{where}[{i}]")
                else:
                    assert a == b, f"{where}[{i}]: {a!r} != {b!r}"
            continue
        assert ref.HasField(name) == mine.HasField(name), where
        if fd.type == fd.TYPE_MESSAGE:
            assert_same(ref_v, my_v, where)
        else:
            assert ref_v == my_v, f"{where}: {ref_v!r} != {my_v!r}"


@pytest.mark.parametrize("path,type_name", PROTOTXTS)
def test_text_reader_matches_protobuf(path, type_name):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    ref = getattr(pb, type_name)()
    text_format.Parse(text, ref)
    assert_same(ref, tproto.parse(text, type_name))


def test_text_reader_syntax_corners():
    text = r'''
    # comment
    net_param < name: "a\"b\tc" "d" layer { name: 'x' type: "Input"
      top: "data" input_param { shape { dim: [2, 3] } } } >
    test_iter: [1, 2] test_interval: 0x10 base_lr: 1e-3 momentum: .9;
    delta: inf, weight_decay: -4.5e-1 lr_policy: "step" stepvalue: 5
    stepvalue: -7 random_seed: -1234567890123
    train_state: { phase: 0 stage: "s1" }
    failure_pattern { type: "gaussian" mean: 1e8 std: 3e7
                      failure_prob { neg: 1 zero: 2 pos: 3 } }
    rram_forward { sigma: 0.05 adc_bits: 4 }
    snapshot_format: HDF5 solver_mode: CPU
    '''
    ref = pb.SolverParameter()
    text_format.Parse(text, ref)
    mine = tproto.parse(text, "SolverParameter")
    assert_same(ref, mine)
    assert mine.snapshot_format == tproto.HDF5 == 0  # a declared enum
    assert mine.solver_mode == "CPU"              # undeclared: kept raw


def test_message_assignment_marks_parents():
    sp = tproto.Message("SolverParameter")
    assert not sp.HasField("failure_pattern")
    assert sp.failure_pattern.mean == 10000.0     # the schema default
    sp.failure_pattern.mean = 1e8
    sp.failure_pattern.failure_prob.neg = 3
    assert sp.HasField("failure_pattern")
    assert sp.failure_pattern.HasField("failure_prob")
    assert sp.failure_pattern.mean == 1e8 and sp.failure_pattern.std == 100
    sp.base_lr = 0.001
    assert sp.base_lr == float(np.float32(0.001))  # floats are float32


def test_datum_decoder_matches_protobuf():
    env = Environment(os.path.join(REPO, "examples/cifar10/cifar10_train_lmdb"))
    try:
        cur = Cursor(env)
        for _ in range(5):
            raw = cur.next_value()
            ref = pb.Datum()
            ref.ParseFromString(raw)
            assert_same(ref, tproto.decode_datum(raw))
    finally:
        env.close()
    # float payload, a negative label (10-byte varint), the encoded flag
    ref = pb.Datum(channels=1, height=2, width=3, label=-5, encoded=True)
    ref.float_data.extend([0.5, -1.25, 3.0, 1e-30, -0.0, 7.0])
    mine = tproto.decode_datum(ref.SerializeToString())
    assert_same(ref, mine)
    arr = np.asarray(mine.float_data, np.float32)
    np.testing.assert_array_equal(arr, np.asarray(ref.float_data,
                                                  np.float32))


def test_blob_decoder_matches_protobuf():
    path = os.path.join(REPO, "examples/cifar10/mean.binaryproto")
    with open(path, "rb") as f:
        raw = f.read()
    ref = pb.BlobProto()
    ref.ParseFromString(raw)
    mine = tproto.decode_blob_proto(raw)
    assert_same(ref, mine)
    from rram_caffe_simulation_tpu.utils.io import blob_to_array
    np.testing.assert_array_equal(tio.read_blob_from_file(path),
                                  blob_to_array(ref))
    ref2 = pb.BlobProto()
    ref2.shape.dim.extend([2, 3])
    ref2.double_data.extend([1.0, 2.5, -3.0, 4.0, 1e300, -0.0])
    b2 = tproto.decode_blob_proto(ref2.SerializeToString())
    assert_same(ref2, b2)
    assert tio.blob_to_array(b2).dtype == np.float64


def test_data_feed_matches_reference_feed(monkeypatch):
    """The port's LMDB feed (cursor + Datum decode + mean file) yields
    the reference's Python feed batches bit for bit, wrap included."""
    from rram_caffe_simulation_tpu.data import feed as jfeed
    from rram_caffe_simulation_tpu.net import Net as JNet
    from rram_caffe_simulation_tpu.utils.io import read_net_param
    from rram_caffe_simulation_tpu_torch.net import Net as TNet
    monkeypatch.chdir(REPO)
    path = "models/cifar10_quick/cifar10_quick_lmdb_train_test.prototxt"
    jnet = JNet(read_net_param(path), pb.TRAIN)
    tnet = TNet(tio.read_net_param(path), tproto.TRAIN, device="cpu")
    jf = jfeed._python_data_feed(jnet.layers[0])
    tf = tfeed.build_feed(tnet)
    assert tnet.data_source_tops == jnet.data_source_tops
    for _ in range(3):                       # 300 > 200 records: wraps
        a, b = jf(), tf()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the writer: wire.encode, binary files, the .caffemodel path of the net

STRATEGY_SOLVER = (
    'net: "models/x.prototxt" test_iter: 3 test_iter: 4 test_interval: 50 '
    'test_compute_loss: true base_lr: 0.01 random_seed: -7 '
    'test_state { stage: "val" level: 2 } '
    'failure_pattern { type: "gaussian" mean: 300 std: 50 } '
    'failure_strategy { type: "threshold" threshold: 0.0025 } '
    'failure_strategy { type: "genetic" threshold: 0.5 start: 3 period: 5 '
    'prune_order_file: "order.txt" switch_time: 50 prune_net_file: '
    '"prune.prototxt" prune_model_file: "prune.caffemodel" '
    'track_identity: true }')


def test_schema_parses_the_nine_strategy_fields():
    ref = pb.SolverParameter()
    text_format.Parse(STRATEGY_SOLVER, ref)
    mine = tproto.parse(STRATEGY_SOLVER, "SolverParameter")
    assert_same(ref, mine)
    g = mine.failure_strategy[1]
    assert (g.type, g.start, g.period, g.prune_order_file, g.switch_time,
            g.prune_net_file, g.prune_model_file, g.track_identity) == (
        "genetic", 3, 5, "order.txt", 50, "prune.prototxt",
        "prune.caffemodel", True)
    assert g.threshold == float(np.float32(0.5))
    t = mine.failure_strategy[0]          # defaults of the unset fields
    assert (t.switch_time, t.period, t.track_identity) == (100, 100, False)


def blobs_net(seed=0):
    """The CIFAR-10-quick train/test net in both packages, with blobs
    added by each package's array_to_blob (f32, and one f64 blob)."""
    from rram_caffe_simulation_tpu.utils.io import array_to_blob
    with open(os.path.join(REPO, PROTOTXTS[1][0])) as f:
        text = f.read()
    ref = pb.NetParameter()
    text_format.Parse(text, ref)
    mine = tproto.parse(text, "NetParameter")
    rng = np.random.RandomState(seed)
    for i, (rl, ml) in enumerate(zip(ref.layer, mine.layer)):
        for shape in ((3, 5), (4,)) if i % 2 else ((2, 1, 3, 3),):
            arr = rng.randn(*shape).astype(np.float64 if i == 3
                                           else np.float32)
            array_to_blob(arr, rl.blobs.add())
            ml.blobs.append(tio.array_to_blob(arr))
    return ref, mine


@pytest.mark.parametrize("kind", ["net_with_blobs", "strategy_solver"])
def test_encode_equals_protobuf_and_decodes_back(kind):
    if kind == "net_with_blobs":
        ref, mine = blobs_net()
    else:
        ref = pb.SolverParameter()
        text_format.Parse(STRATEGY_SOLVER, ref)
        mine = tproto.parse(STRATEGY_SOLVER, "SolverParameter")
    raw = tproto.encode(mine)
    assert raw == ref.SerializeToString()
    back = tproto.decode(raw, mine.type_name)
    assert back == mine
    assert_same(ref, back)


def test_encode_refuses_fields_the_schema_lacks():
    sp = tproto.parse('base_lr: 0.1 solver_mode: CPU', "SolverParameter")
    with pytest.raises(ValueError, match=r"\['solver_mode'\] are not in "
                                         r"the port's schema"):
        tproto.encode(sp)


def test_caffemodel_round_trip_and_copy_trained_from(monkeypatch, tmp_path):
    """A .caffemodel the reference writes (to_proto) loads into the port
    by name as the reference loads it (copy_trained_from, exact), and
    the port's to_proto writes the reference's bytes; a net built from
    the file takes its blobs as init."""
    import jax
    from rram_caffe_simulation_tpu.net import Net as JNet
    from rram_caffe_simulation_tpu.utils.io import (read_net_param,
                                                    write_proto_binary)
    from rram_caffe_simulation_tpu_torch import convert
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.net import Net as TNet
    monkeypatch.chdir(REPO)
    path = PROTOTXTS[1][0]
    jnet = JNet(read_net_param(path), pb.TRAIN)
    tnet = TNet(tio.read_net_param(path), tproto.TRAIN, device="cpu")
    jparams = jnet.init(jax.random.PRNGKey(4))
    model = str(tmp_path / "w.caffemodel")
    write_proto_binary(model, jnet.to_proto(jparams))
    mine = tnet.copy_trained_from(tnet.init(prng.PRNGKey(0)), model)
    ref = jnet.copy_trained_from(jnet.init(jax.random.PRNGKey(5)), model)
    for ln, vals in ref.items():
        for a, b in zip(vals, mine[ln]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with open(model, "rb") as f:
        assert tproto.encode(tnet.to_proto(mine)) == f.read()
    out = str(tmp_path / "port.caffemodel")
    tio.write_proto_binary(out, tnet.to_proto(mine))
    assert tio.read_proto_binary(out, "NetParameter") == \
        tio.read_net_param(model)
    from_file = TNet(tio.read_net_param(out), tproto.TRAIN, device="cpu")
    init = from_file.init(prng.PRNGKey(9))
    for ln, vals in convert.params_to_jax(mine).items():
        for a, b in zip(vals, init[ln]):
            np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("suffix", [".caffemodel", ".prototxt"])
def test_legacy_v1_nets_raise_binary_and_text(tmp_path, suffix):
    """A V1 net (`layers`, field 2) needs the reference's upgrade pass:
    the port refuses it from a binary model as from a prototxt, rather
    than reading a net with no layers."""
    ref = pb.NetParameter()
    ref.name = "v1"
    v1 = ref.layers.add()
    v1.name, v1.type = "ip1", v1.INNER_PRODUCT
    v1.blobs.add().data.extend([1.0, 2.0])
    path = tmp_path / f"v1{suffix}"
    if suffix == ".caffemodel":
        path.write_bytes(ref.SerializeToString())
        assert tproto.decode(path.read_bytes(),
                             "NetParameter").layers == \
            [ref.layers[0].SerializeToString()]
    else:
        path.write_text(text_format.MessageToString(ref))
    with pytest.raises(NotImplementedError,
                       match=r"legacy V1 `layers` nets are not supported"):
        tio.read_net_param(str(path))
