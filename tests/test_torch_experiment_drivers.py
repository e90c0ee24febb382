"""The fork's experiment harness in the port
(rram_caffe_simulation_tpu_torch/examples/gaussian_failure/
run_gaussian_exp.py, run_different_mean.py, run_sweeps.py, prune_order.py,
`parallel.sweep.sequential_sweep` and `proto.to_text`) against the
reference's drivers (examples/gaussian_failure/), on the CPU.

The inputs: the resume guard's 24-record 1x8x8 LMDB
(tests/test_torch_group_prefetch.py `build_db`) under a two-InnerProduct
net (ip1 8 outputs, ip2 4: the remapping and genetic strategies need a
hidden FC pair), as a solver template with display 2, snapshot 4, a test
net (test_iter 2, test_interval 3) and max_iter 6, lifetimes set by the
drivers (N(300, 60): cells die within a few writes); CIFAR-10-quick's
net for prune_order. Every driver module's `HERE` is patched to a
temporary directory and each run has a working directory of its own, so
nothing is written into the checkout. Reference runs have x64 off.

- `build_solver_param` over the flag combinations, on the real VGG11-BN
  template: the port's message encodes to the reference's bytes and
  `to_text` equals `MessageToString`; `to_text` of the repo's solver
  templates and nets equals protobuf's.
- Both runners' `main` with `--cpu` (one config, with strategies, and
  `--sweep-means`): the same snapshot directories, snapshot files and
  solver files (text equal), the same log head; logged losses within
  1e-4 relative, broken fractions equal (the sweep's printed ones; the
  single runs' final `.faultstate` bytes).
- `sequential_sweep` against the reference's for the prob, threshold,
  mean + seed and other-field keys with the test net's scores, and with
  the genetic strategy: configs and broken equal, loss and scores within
  1e-4 relative.
- `run_sweeps` tables (prob with --eval, threshold) against the
  reference's; its mean and std grids handed to the runner with the
  reference's arguments.
- prune_order's output file byte-equal to the reference's, from a
  `.caffemodel` and (the port) from the same weights as `.caffemodel.h5`.
- Refusals: `--compute-dtype bfloat16` by name; every new entry point
  without `--cpu` (or `device="cpu"`) and without a card, before it
  writes anything.
"""
import contextlib
import importlib.util
import io
import os
import re
import sys

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax

from rram_caffe_simulation_tpu.parallel.sweep import \
    sequential_sweep as jsequential
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
    prune_order as tprune
from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
    run_different_mean as tmean
from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
    run_gaussian_exp as texp
from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
    run_sweeps as tsweeps
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.parallel import \
    sequential_sweep as tsequential
from rram_caffe_simulation_tpu_torch.utils.io import (write_net_hdf5,
                                                      write_proto_binary)

from test_torch_group_prefetch import build_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = os.path.join(REPO, "examples", "gaussian_failure")
REL = 1e-4
HIDDEN = 8                       # ip1's outputs


def reference(name):
    """The reference's driver `name` as a module of its own (sys.path
    restored after its import-time insertions)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(DRIVERS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def ref():
    return {n: reference(n) for n in ("run_gaussian_exp", "run_sweeps",
                                      "prune_order")}


def net_text(db):
    return f"""
  name: "harness"
  layer {{ name: "data" type: "Data" top: "data" top: "label"
    data_param {{ source: "{db}" batch_size: 8 }}
    transform_param {{ scale: 0.00390625 }} }}
  layer {{ name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
    inner_product_param {{ num_output: {HIDDEN}
      weight_filler {{ type: "xavier" }} }} }}
  layer {{ name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }}
  layer {{ name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
    inner_product_param {{ num_output: 4
      weight_filler {{ type: "xavier" }} }} }}
  layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip2"
    bottom: "label" top: "loss" }}
"""


def template_text(db, extra=""):
    return f"""
base_lr: 0.05
lr_policy: "fixed"
momentum: 0.9
type: "SGD"
max_iter: 6
display: 2
snapshot: 4
test_iter: 2
test_interval: 3
random_seed: 3
snapshot_prefix: "fail/"
net_param {{ {net_text(db)} }}
failure_pattern {{ type: "gaussian" mean: 5000000 std: 1000000 }}
{extra}"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("harness")
    db = build_db(root / "db")
    template = root / "template.prototxt"
    template.write_text(template_text(db))
    order = root / "order.txt"
    order.write_text(" ".join(str(i) for i in
                              np.random.RandomState(5).permutation(HIDDEN))
                     + "\n")
    return {"root": root, "db": db, "template": str(template),
            "order": str(order)}


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's draws are many small torch ops: beside other test
    processes, torch's intra-op threads fight them for the cores and a
    draw takes tens of times longer than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def quiet(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


# ---------------------------------------------------------------------------
# the text writer and build_solver_param

FLAG_CASES = [
    [],
    ["-t", "0.05", "--max-iter", "7"],
    ["-r", "order.txt"],
    ["-r", "dir/order.txt,50"],
    ["-r", "order.txt,50,10", "--prob", "10"],
    ["-g", "prune.prototxt,prune.caffemodel"],
    ["-g", "a/prune.prototxt,b/prune.caffemodel,7"],
    ["-g", "prune.prototxt,prune.caffemodel,7,8"],
    ["-g", "prune.prototxt,prune.caffemodel,7,8,9", "--prob", "0"],
    ["--hw-sigma", "0.05", "--conv-also"],
    ["-t", "0.001", "-r", "o.txt,5,5", "-g", "p.prototxt,p.caffemodel,3,4,5",
     "--prob", "49", "--hw-sigma", "0.1", "--conv-also", "--max-iter", "11"],
]


@pytest.mark.parametrize("flags", FLAG_CASES,
                         ids=lambda f: " ".join(f) or "plain")
@pytest.mark.parametrize("point", [("1e8", "3e7", "0"),
                                   ("4000", "1200.5", "3")])
def test_build_solver_param_matches_the_reference(ref, point, flags):
    argv = [*point, *flags]
    mine = texp.build_solver_param(texp.parse_args(argv))
    theirs = ref["run_gaussian_exp"].build_solver_param(
        ref["run_gaussian_exp"].parse_args(argv))
    assert tproto.encode(mine) == theirs.SerializeToString()
    assert tproto.to_text(mine) == text_format.MessageToString(theirs)


TEXT_FILES = [
    "models/cifar10_vgg11/cifar10_vgg11_template.prototxt",
    "models/cifar10_vgg11/cifar10_vgg11_fc1024_bn_scale_msra_fc_also"
    ".prototxt",
    "models/cifar10_quick/cifar10_quick_lmdb_solver.prototxt",
    "models/cifar10_quick/cifar10_quick_lmdb_train_test.prototxt",
]


@pytest.mark.parametrize("path", TEXT_FILES)
def test_to_text_equals_message_to_string(path):
    text = open(os.path.join(REPO, path)).read()
    kind = "SolverParameter" if "solver" in path or "template" in path \
        else "NetParameter"
    theirs = getattr(pb, kind)()
    text_format.Parse(text, theirs)
    mine = tproto.parse(text, kind)
    assert tproto.to_text(mine) == text_format.MessageToString(theirs)
    # the text reads back to the same message
    assert tproto.encode(tproto.parse(tproto.to_text(mine), kind)) == \
        theirs.SerializeToString()


@pytest.mark.parametrize("case", ["prob", "sigma", "deep"])
def test_unset_nested_messages_attach_at_their_own_level(case):
    """Setting a field through two or more unset message fields
    (`sp.failure_pattern.failure_prob.neg = 5` on a solver without a
    failure_pattern) sets each at its own level, as protobuf does; the
    port used to hang the innermost message at the outermost field."""
    mine, theirs = tproto.Message("SolverParameter"), pb.SolverParameter()
    for sp in (mine, theirs):
        if case == "prob":
            fp = sp.failure_pattern.failure_prob
            fp.neg = fp.pos = 5
        elif case == "sigma":
            sp.rram_forward.sigma = 0.25
            sp.failure_pattern.failure_prob.zero = 3
        else:
            sp.train_state.level = 2
            sp.net_param.state.level = 4
    assert tproto.encode(mine) == theirs.SerializeToString()
    assert tproto.to_text(mine) == text_format.MessageToString(theirs)


# ---------------------------------------------------------------------------
# the runner, both packages

LOSS_LINE = re.compile(r"^(?:config (\d+) \(mean=(\S+)\): )?Iteration (\d+), "
                       r"loss = (\S+?)(?:, broken = (\S+))?$")


def log_lines(path):
    with open(path) as f:
        text = f.read()
    rows = []
    for ln in text.splitlines():
        m = LOSS_LINE.match(ln)
        if m:
            cfg, mean, it, loss, broken = m.groups()
            rows.append((cfg, mean, int(it), float(loss), broken))
    return text, rows


def run_both(ref_mod, tmp_path, monkeypatch, argv, port_main=None):
    """Each package's runner in a working directory of its own, its
    module's HERE there too; returns {package: directory}."""
    dirs = {}
    for name, mod, main, extra in (
            ("port", texp, port_main or texp.main, ["--cpu"]),
            ("reference", ref_mod, ref_mod.main, ["--cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setattr(mod, "HERE", str(d))
        monkeypatch.chdir(d)
        assert main([*argv, *extra]) == 0
        dirs[name] = d
    return dirs


def tree(d):
    return {str(p.relative_to(d)) for p in d.rglob("*")}


@pytest.mark.parametrize("case", ["one", "strategies", "sweep"])
def test_runner_matches_the_reference(ref, inputs, tmp_path, monkeypatch,
                                      case):
    argv = ["300", "60", "0", "-y", "--template", inputs["template"]]
    if case == "strategies":
        argv += ["-t", "0.001", "-r", inputs["order"] + ",2,1"]
    if case == "sweep":
        argv += ["--sweep-means", "300,600,100000000.0", "--tag", "_ms"]
    dirs = run_both(ref["run_gaussian_exp"], tmp_path, monkeypatch, argv)
    port, theirs = dirs["port"], dirs["reference"]
    assert tree(port) == tree(theirs)
    (snap,) = [p.name for p in port.iterdir() if p.name.startswith("snap")]
    (solver,) = os.listdir(port / "solvers")
    assert (port / "solvers" / solver).read_text() == \
        (theirs / "solvers" / solver).read_text()
    mine, rows = log_lines(port / snap / "log")
    want, want_rows = log_lines(theirs / snap / "log")
    # the log opens with the solver's text
    head = (port / "solvers" / solver).read_text()
    assert mine.startswith(head) and want.startswith(head)
    assert len(rows) == len(want_rows) > 0
    for a, b in zip(rows, want_rows):
        assert a[:3] == b[:3] and a[4] == b[4]
        assert a[3] == pytest.approx(b[3], rel=REL)
    if case == "sweep":
        assert [r[4] for r in rows[-3:]] != ["0.0000"] * 3
        return
    last = max(int(p.name.split("_iter_")[1].split(".")[0])
               for p in (port / snap).glob("*.faultstate"))
    assert last == 6
    fault = f"_iter_{last}.faultstate"
    assert (port / snap / fault).read_bytes() == \
        (theirs / snap / fault).read_bytes()


def test_different_mean_calls_the_runner(inputs, tmp_path, monkeypatch):
    """run_different_mean hands its grid to run_gaussian_exp's main
    through the package import: the mean sweep's directory, its solver
    file and one line a config and display."""
    monkeypatch.setattr(texp, "HERE", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    seen = []
    real = texp.main

    def spy(argv):
        seen.append(argv)
        return real([*argv, "--template", inputs["template"]])

    monkeypatch.setattr(tmean, "run", spy)
    assert quiet(tmean.main, ["300", "600", "--std", "60", "--max-iter",
                              "4", "--cpu"])[0] == 0
    assert seen == [["300.0", "60.0", "0", "-y", "--tag", "_meansweep",
                     "--sweep-means", "300.0,600.0", "--max-iter", "4",
                     "--cpu"]]
    snap = tmp_path / "snapshot_300.0_60.0_meansweep"
    assert os.listdir(tmp_path / "solvers") == [
        "solver_300.0_60.0_meansweep.prototxt"]
    _, rows = log_lines(snap / "log")
    assert [(r[0], r[2]) for r in rows] == [
        ("0", 2), ("1", 2), ("0", 4), ("1", 4)]


# ---------------------------------------------------------------------------
# sequential_sweep

def parse_both(text):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return tproto.parse(text, "SolverParameter"), sp


def prune_files(root, db):
    """A prune net (the harness net) and a `.caffemodel` of it whose FC
    weights have their smaller half zeroed."""
    net_file = root / "prune.prototxt"
    net_file.write_text(net_text(db))
    net = TNet(tproto.parse(net_text(db), "NetParameter"), tproto.TRAIN,
               device="cpu")
    params = net.init(prng.PRNGKey(1))
    for ln in ("ip1", "ip2"):
        w = params[ln][0].abs()
        params[ln][0] = torch.where(w < w.median(), torch.zeros_like(w), w)
    model = root / "prune.caffemodel"
    write_proto_binary(str(model), net.to_proto(params))
    return str(net_file), str(model)


def records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["config"] == w["config"]
        assert np.float32(g["broken"]) == np.float32(w["broken"])
        assert g["loss"] == pytest.approx(w["loss"], rel=REL)
        assert set(g.get("scores", {})) == set(w.get("scores", {}))
        for k, v in w.get("scores", {}).items():
            assert g["scores"][k] == pytest.approx(v, rel=REL)


@pytest.mark.parametrize("case", ["keys", "genetic"])
def test_sequential_sweep_matches_the_reference(inputs, tmp_path, case):
    text = template_text(inputs["db"]).replace(
        'failure_pattern { type: "gaussian" mean: 5000000 std: 1000000 }',
        'failure_pattern { type: "gaussian" mean: 300 std: 60 }')
    text = text.replace("display: 2", "display: 0").replace("snapshot: 4",
                                                           "snapshot: 0")
    if case == "keys":
        configs = [{"prob": 5}, {"threshold": 0.001},
                   {"mean": 400.0, "seed": 9}, {"base_lr": 0.02}]
        eval_iters = 1
    else:
        net_file, model = prune_files(tmp_path, inputs["db"])
        text += (f'failure_strategy {{ type: "genetic" start: 1 period: 2 '
                 f'switch_time: 50 prune_net_file: "{net_file}" '
                 f'prune_model_file: "{model}" }}')
        configs = [{"mean": 300.0}, {"mean": 500.0, "seed": 4}]
        eval_iters = 0
    mine, theirs = parse_both(text)
    before = tproto.encode(mine)
    got, _ = quiet(tsequential, mine, configs, 4, eval_iters=eval_iters,
                   device="cpu")
    want, _ = quiet(jsequential, theirs, configs, 4, eval_iters=eval_iters)
    assert tproto.encode(mine) == before      # copied, never aliased
    records_equal(got, want)
    assert any(r["broken"] > 0 for r in got)
    if case == "keys":
        assert set(got[0]["scores"]) == {"loss"}


@pytest.mark.parametrize("kind, values, flags", [
    ("prob", "2,5", ["--eval"]),
    ("threshold", "0.001,1e9", []),
])
def test_run_sweeps_tables_match_the_reference(ref, inputs, monkeypatch,
                                               kind, values, flags):
    argv = [kind, "300", "60", "--values", values, "--max-iter", "4",
            "--template", inputs["template"], *flags]
    tables = {}
    for name, main, extra in (("port", tsweeps.main, ["--cpu"]),
                              ("reference", ref["run_sweeps"].main, [])):
        monkeypatch.chdir(inputs["root"])
        code, out = quiet(main, [*argv, *extra])
        assert code == 0
        lines = out.splitlines()
        tables[name] = lines[next(i for i, ln in enumerate(lines)
                                  if ln.lstrip().startswith(kind)):]
    mine, want = tables["port"], tables["reference"]
    assert mine[0] == want[0] and len(mine) == len(want) == 3
    for a, b in zip(mine[1:], want[1:]):
        a, b = a.split(), b.split()
        assert a[0] == b[0] and a[2] == b[2]          # value, broken
        assert float(a[1]) == pytest.approx(float(b[1]), rel=REL, abs=1e-4)
        assert [s.split("=")[0] for s in a[3:]] == \
            [s.split("=")[0] for s in b[3:]]
        for x, y in zip(a[3:], b[3:]):
            assert float(x.split("=")[1]) == pytest.approx(
                float(y.split("=")[1]), rel=REL, abs=1e-4)
    if kind == "threshold":
        assert mine[2].split()[2] == "0.0000"         # nothing written
    else:
        assert all(float(r.split()[2]) > 0 for r in mine[1:])


@pytest.mark.parametrize("kind", ["mean", "std"])
def test_run_sweeps_hands_grids_to_the_runner_as_the_reference(
        ref, inputs, monkeypatch, kind):
    """The mean and std grids go to each package's runner (`--sweep-means`,
    `--sweep-stds`) with the same arguments (the runners themselves are
    compared above)."""
    seen = {}

    def recorder(name):
        def run(argv):
            seen[name] = argv
            return 0
        return run
    monkeypatch.setattr(tsweeps, "run", recorder("port"))
    fake = type(sys)("run_gaussian_exp")
    fake.main = recorder("reference")
    monkeypatch.setitem(sys.modules, "run_gaussian_exp", fake)
    argv = [kind, "300", "60", "--values", "300,600,1e8", "--max-iter", "4",
            "--template", inputs["template"]]
    assert tsweeps.main([*argv, "--cpu"]) == 0
    assert ref["run_sweeps"].main(argv) == 0
    assert seen["port"] == [*seen["reference"], "--cpu"]
    assert f"_{kind}sweep" in seen["port"]


# ---------------------------------------------------------------------------
# prune_order

@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    """CIFAR-10-quick's net with absolute Data sources, and a
    `.caffemodel` (and the same weights as `.caffemodel.h5`) of a seeded
    init."""
    root = tmp_path_factory.mktemp("quick")
    text = open(os.path.join(
        REPO, "models/cifar10_quick/cifar10_quick_lmdb_train_test.prototxt"
    )).read().replace('"examples/', f'"{REPO}/examples/')
    proto_file = root / "quick.prototxt"
    proto_file.write_text(text)
    net = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
               device="cpu")
    model = net.to_proto(net.init(prng.PRNGKey(5)))
    write_proto_binary(str(root / "quick.caffemodel"), model)
    write_net_hdf5(model, str(root / "quick.caffemodel.h5"))
    return root


@pytest.mark.parametrize("ratio", ["0.0", "0.6", "0.95"])
def test_prune_order_bytes_equal_the_reference(ref, quick, ratio):
    proto_file = str(quick / "quick.prototxt")
    out = {}
    for name, main, model, extra in (
            ("reference", ref["prune_order"].main, "quick.caffemodel", []),
            ("port", tprune.main, "quick.caffemodel", ["--cpu"]),
            ("port_h5", tprune.main, "quick.caffemodel.h5", ["--cpu"])):
        path = quick / f"{name}_{ratio}.txt"
        code, printed = quiet(main, [proto_file, str(quick / model), ratio,
                                     str(path), *extra])
        assert code == 0
        assert printed.startswith(f"proto: {proto_file}; model: ")
        out[name] = path.read_bytes()
    assert out["port"] == out["reference"] == out["port_h5"]
    (line,) = out["port"].decode().splitlines()      # ip1/ip2: one pair
    assert sorted(int(x) for x in line.split()) == list(range(64))


# ---------------------------------------------------------------------------
# refusals

def test_compute_dtype_other_than_float32_raises(inputs, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(texp, "HERE", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=r"compute-dtype "
                                                  r"bfloat16.*§A 5"):
        texp.main(["300", "60", "0", "-y", "--cpu", "--template",
                   inputs["template"], "--compute-dtype", "bfloat16"])
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tmean.main(["300", "--compute-dtype", "bfloat16", "--cpu"])
    assert os.listdir(tmp_path) == []
    assert texp.parse_args(["1", "2", "0", "--compute-dtype",
                            "float32"]).compute_dtype in texp.COMPUTE_DTYPES


def no_card_cases(inputs, quick):
    sp = tproto.parse(template_text(inputs["db"]), "SolverParameter")
    t = inputs["template"]
    return {
        "run_gaussian_exp": lambda: texp.main(["300", "60", "0", "-y",
                                               "--template", t]),
        "run_gaussian_exp sweep": lambda: texp.main(
            ["300", "60", "0", "-y", "--template", t, "--sweep-means",
             "300,600"]),
        "run_different_mean": lambda: tmean.main(["300", "600"]),
        "run_sweeps prob": lambda: tsweeps.main(
            ["prob", "300", "60", "--values", "2", "--template", t]),
        "run_sweeps mean": lambda: tsweeps.main(
            ["mean", "300", "60", "--values", "300", "--template", t]),
        "prune_order": lambda: tprune.main(
            [str(quick / "quick.prototxt"), str(quick / "quick.caffemodel"),
             "0.5", str(quick / "never.txt")]),
        "sequential_sweep": lambda: tsequential(sp, [{"mean": 300}], 1),
    }


@pytest.mark.parametrize("entry", [
    "run_gaussian_exp", "run_gaussian_exp sweep", "run_different_mean",
    "run_sweeps prob", "run_sweeps mean", "prune_order",
    "sequential_sweep"])
def test_entry_points_raise_without_a_card(inputs, quick, tmp_path,
                                           monkeypatch, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    monkeypatch.setattr(texp, "HERE", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quiet(no_card_cases(inputs, quick)[entry])
    assert os.listdir(tmp_path) == []
    assert not (quick / "never.txt").exists()
