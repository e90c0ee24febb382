"""The port's test nets (Solver.test / test_all, the test_interval hook
and InitTestNets' sourcing and count checks) against the reference
package's, on the narrowed CIFAR-10-quick of test_torch_solver.py with
a TEST Data layer over the in-repo test LMDB and an Accuracy layer.

Tolerances: the test loss within 1e-4 relative (the packages sum
convolutions and products in other orders), accuracy within 1/batch
(one image may flip), and the printed lines identical up to their
values."""
import re

import numpy as np
import pytest
from google.protobuf import text_format

from rram_caffe_simulation_tpu.data import feed as jfeed
from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_solver import NET, REPO

BATCH = 8
TRAIN_DATA_END = "batch_size: 8 backend: LMDB } }\n"
TEST_DATA = (
    'layer { name: "cifar" type: "Data" top: "data" top: "label" include { '
    'phase: TEST } transform_param { mean_file: '
    '"examples/cifar10/mean.binaryproto" } data_param { source: '
    f'"examples/cifar10/cifar10_test_lmdb" batch_size: {BATCH} backend: '
    'LMDB } }\n')
ACCURACY = ('layer { name: "accuracy" type: "Accuracy" bottom: "ip2" '
            'bottom: "label" top: "accuracy" include { phase: TEST } }\n')
assert NET.count(TRAIN_DATA_END) == 1
TT_NET = NET.replace(TRAIN_DATA_END, TRAIN_DATA_END + TEST_DATA) + ACCURACY

BASE = ('base_lr: 0.01 momentum: 0.9 weight_decay: 0.004 lr_policy: "fixed" '
        'display: 0 max_iter: 100 random_seed: 3')
FAULTS = ' failure_pattern { type: "gaussian" mean: 250 std: 120 }'
CASES = {
    "plain": "",
    "adc": FAULTS + " rram_forward { adc_bits: 8 }",
    "tiled": (' failure_pattern { type: "gaussian" mean: 250 std: 120 '
              'conv_also: true } rram_forward { adc_bits: 8 tiles: '
              '"cells=32x32" }'),
}
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def solver_text(extra="", test="test_iter: 3 test_compute_loss: true"):
    return f"net_param {{ {TT_NET} }} {test} {BASE}{extra}"


def reference_solver(text):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    train = JNet(sp.net_param, pb.TRAIN)
    test = JNet(sp.net_param, pb.TEST)
    return JSolver(sp, train_feed=jfeed._python_data_feed(train.layers[0]),
                   test_feeds=[jfeed._python_data_feed(test.layers[0])])


def outputs(text: str) -> dict:
    """{label: [values]} of the test lines, in print order."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"\s*Test net output #\d+: (\w+) = (\S+)", line)
        if m:
            out.setdefault(m.group(1), []).append(float(m.group(2)))
        elif line.startswith("Test loss:"):
            out.setdefault("Test loss", []).append(float(line.split()[-1]))
    return out


def shape(text: str) -> list:
    return [NUMBER.sub("#", line) for line in text.splitlines()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_test_all_matches_reference(monkeypatch, capsys, case):
    """Both packages test the reference's params (at init and after two
    of the reference's train steps): test_iter 3 batches of 8 from
    cifar10_test_lmdb, sigma 0, through adc_bits and the tiles as the
    case configures them."""
    monkeypatch.chdir(REPO)
    text = solver_text(CASES[case])
    js = reference_solver(text)
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 conv_im2col="implicit" if case == "tiled" else None)
    if case == "tiled":
        assert set(ts._tiles_ctx()) >= {"ip1"}
    assert len(ts.test_nets) == len(js.test_nets) == 1
    assert ts.test_nets[0].output_names == js.test_nets[0].output_names
    for _ in range(2):
        ts.params = convert.params_from_jax(
            {k: [np.asarray(a) for a in v] for k, v in js.params.items()})
        ts.iter = js.iter
        capsys.readouterr()
        ref_scores = js.test_all()
        ref_out = capsys.readouterr().out
        scores = ts.test_all()
        out = capsys.readouterr().out
        assert shape(out) == shape(ref_out)
        assert len(shape(out)) == 4         # header, loss, two outputs
        mine, ref = outputs(out), outputs(ref_out)
        assert mine.keys() == ref.keys() == {"Test loss", "loss",
                                             "accuracy"}
        for k in ("Test loss", "loss"):
            assert mine[k] == pytest.approx(ref[k], rel=1e-4)
        assert abs(mine["accuracy"][0] - ref["accuracy"][0]) <= 1 / BATCH
        assert scores[0]["loss"] == pytest.approx(ref_scores[0]["loss"],
                                                  rel=1e-4)
        js.step(2)


def test_test_interval_runs_the_test_nets_as_the_reference(monkeypatch,
                                                            capsys):
    """test_interval 2 with test_initialization: Solver.step(5) tests
    at iterations 0, 2 and 4, and the lines match the reference's."""
    monkeypatch.chdir(REPO)
    text = solver_text(test="test_iter: 1 test_interval: 2")
    js = reference_solver(text)
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    ts.params = convert.params_from_jax(
        {k: [np.asarray(a) for a in v] for k, v in js.params.items()})
    capsys.readouterr()
    js.step(5)
    ref_out = capsys.readouterr().out
    ts.step(5)
    out = capsys.readouterr().out
    heads = [ln for ln in out.splitlines() if "Testing net" in ln]
    assert heads == [f"Iteration {i}, Testing net (#0)" for i in (0, 2, 4)]
    assert shape(out) == shape(ref_out)
    for k, v in outputs(out).items():
        ref = outputs(ref_out)[k]
        if k == "accuracy":
            assert np.max(np.abs(np.subtract(v, ref))) <= 1 / BATCH
        else:
            assert v == pytest.approx(ref, rel=1e-4)


def test_test_initialization_false_skips_iteration_zero(monkeypatch,
                                                        capsys):
    monkeypatch.chdir(REPO)
    text = solver_text(test="test_iter: 1 test_interval: 2 "
                            "test_initialization: false")
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    capsys.readouterr()
    ts.step(3)
    assert [ln for ln in capsys.readouterr().out.splitlines()
            if "Testing net" in ln] == ["Iteration 2, Testing net (#0)"]


TEST_NET_PARAM = f"test_net_param {{ {TT_NET} }}"


@pytest.mark.parametrize("sources,count,match", [
    # the train net fills every test_iter entry left
    (f"net_param {{ {TT_NET} }} test_iter: 1 test_iter: 2", 2, None),
    (f"net_param {{ {TT_NET} }} {TEST_NET_PARAM} test_iter: 1 test_iter: 1",
     2, None),
    (f"net_param {{ {TT_NET} }} {TEST_NET_PARAM} test_iter: 1 test_state {{ "
     'stage: "a" } test_state { stage: "b" }', 0,
     r"test_state must have one entry per test net \(2 != 1\)"),
    (f"net_param {{ {TT_NET} }} {TEST_NET_PARAM} {TEST_NET_PARAM} "
     "test_iter: 1", 0,
     r"test_iter has 1 entries but 2 test nets could be sourced"),
    # train_net_param is not shared with the test nets
    (f"train_net_param {{ {TT_NET} }} test_iter: 1", 0,
     r"test_iter has 1 entries but 0 test nets could be sourced"),
], ids=["train_net_fills", "param_then_fill", "test_state_count",
        "too_many_sources", "train_net_param_alone"])
def test_test_net_sources_and_counts_match_reference(monkeypatch, sources,
                                                     count, match):
    monkeypatch.chdir(REPO)
    text = f"{sources} {BASE}"
    if match:
        with pytest.raises(ValueError, match=match):
            JSolver(_parsed(text))
        with pytest.raises(ValueError, match=match):
            TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
        return
    js = JSolver(_parsed(text))
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu")
    assert len(ts.test_nets) == len(js.test_nets) == count
    assert len(ts.test_feeds) == count


def _parsed(text):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return sp
