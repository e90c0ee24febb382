"""One seed, two packages: a port Solver and a reference Solver built
from the same prototxt and `random_seed`, with nothing carried across
(no convert.py), draw the same numbers.

Held bit for bit (tolerance 0; core/prng.py's normal is bit-exact on
the CPU, tests/test_torch_prng.py): the params of CIFAR-10-quick (the
main path's prototxt, gaussian and constant fillers), the f32 fault
state (stuck values and lifetimes), the packed banks (no life_q byte
differs, so no cell needs the allowance for a differing lifetime), the
tiled draw of a narrowed CIFAR-10-quick under a small TileSpec with
conv_also, draw_state_rows over 4 configs with mean/std grids and a row
slice, the sweep's draw, the crossbar seeds the port's step hands its
reads over 3 steps, and a host-noise bias read at sigma 0.05.

Also pinned here, the step's repairs: `snapshot: 2` writes its files at
iteration 2 and not before (raises there under HDF5), and a displayed
step prints the reference's `Train
net output` lines (names and structure exact, values within 1e-5
relative: the two packages sum the product in other orders).
"""
import os
import re
import sys

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import engine as jengine
from rram_caffe_simulation_tpu.fault import hw_aware as jhw
from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu.fault.mapping import TileSpec as JTileSpec
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu.utils import io as jio
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.fault import hw_aware as thw
from rram_caffe_simulation_tpu_torch.fault.mapping import TileSpec
from rram_caffe_simulation_tpu_torch.ops import common as tcommon
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver import solver as tsolver
from rram_caffe_simulation_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = "models/cifar10_quick/cifar10_quick_lmdb_solver.prototxt"
SEED = 7
FAULT = {"type": "gaussian", "mean": 300.0, "std": 50.0}


def host(a) -> np.ndarray:
    return np.array(a, copy=True)


def with_fault(sp, **extra):
    sp.random_seed = SEED
    for k, v in {**FAULT, **extra}.items():
        setattr(sp.failure_pattern, k, v)
    return sp


@pytest.fixture(scope="module")
def main_pair():
    """(reference solver, port f32 solver, port packed solver) of the
    main path's prototxt, seed 7, N(300, 50) lifetimes."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with jax.enable_x64(False):
            js = JSolver(with_fault(jio.read_solver_param(MAIN)))
        tp = with_fault(tio.read_solver_param(MAIN))
        ts = TSolver(tp, device="cpu")
        tsp = TSolver(tp, device="cpu", fault_format="packed")
    finally:
        os.chdir(cwd)
    return js, ts, tsp


def test_solver_draws_the_reference_params(main_pair):
    js, ts, _ = main_pair
    assert set(js.params) == set(ts.params)
    for ln, vals in js.params.items():
        for i, a in enumerate(vals):
            got = ts.params[ln][i]
            assert got.dtype == torch.float32
            assert got.numpy().tobytes() == host(a).tobytes(), (ln, i)
    np.testing.assert_array_equal(ts._key, host(js._key))


def test_solver_draws_the_reference_fault_state(main_pair):
    js, ts, _ = main_pair
    for group in ("lifetimes", "stuck"):
        assert list(js.fault_state[group]) == list(ts.fault_state[group])
        for k, v in js.fault_state[group].items():
            assert ts.fault_state[group][k].numpy().tobytes() == \
                host(v).tobytes(), (group, k)


def test_packed_banks_equal_the_reference_pack(main_pair):
    """The port's packed solver against the reference's pack of its own
    draw: a differing life_q byte is allowed only on a cell whose f32
    lifetime differs, and there is none."""
    js, ts, tsp = main_pair
    ref_state = {g: {k: host(v) for k, v in leaves.items()}
                 for g, leaves in js.fault_state.items()}
    spec = jpacked.make_pack_spec(ref_state, 100.0,
                                  pattern=js.param.failure_pattern)
    assert spec == tsp.pack_spec
    ref_packed = jpacked.pack_state(ref_state, spec)
    life_differs = 0
    for k, q in ref_packed["life_q"].items():
        differ = tsp.fault_state["life_q"][k].numpy() != host(q)
        same_life = (ts.fault_state["lifetimes"][k].numpy()
                     == ref_state["lifetimes"][k])
        assert not (differ & same_life).any(), k
        life_differs += int(differ.sum())
        assert tsp.fault_state["stuck_bits"][k].numpy().tobytes() == \
            host(ref_packed["stuck_bits"][k]).tobytes()
    print(f"life_q bytes that differ (cells whose lifetime differs): "
          f"{life_differs}")
    assert life_differs == 0


def test_crossbar_seeds_follow_the_reference_chain(main_pair, monkeypatch):
    """The seeds the port's step passes its crossbar reads over 3 steps
    against the reference's: fault key i reads with randint(fold_in(
    fold_in(fold_in(key, it), 0x4A7), i), (), 0, 2^31 - 1)."""
    js, ts, _ = main_pair
    tp = with_fault(tio.read_solver_param(os.path.join(REPO, MAIN)))
    tp.test_interval = 0
    tp.display = 0
    batch = {"data": np.zeros((100, 3, 32, 32), np.float32),
             "label": np.zeros((100,), np.float32)}
    s = TSolver(tp, device="cpu", dtype_policy="ternary",
                train_feed=lambda: batch)
    seen = []
    real = tcommon.crossbar_matmul

    def spy(x, w, broken, stuck, seed, *rest):
        seen.append(seed)
        return real(x, w, broken, stuck, seed, *rest)
    monkeypatch.setattr(tcommon, "crossbar_matmul", spy)
    s.step(3)
    keys = s._fault_keys
    with jax.enable_x64(False):
        want = []
        for it in range(3):
            base = jax.random.fold_in(jax.random.fold_in(js._key, it),
                                      0x4A7)
            for i, k in enumerate(keys):
                if k in s._crossbar_keys:
                    want.append(int(jax.random.randint(
                        jax.random.fold_in(base, i), (), 0,
                        jnp.iinfo(jnp.int32).max)))
    assert len(seen) == 6 and seen == want


def test_host_noise_bias_read(main_pair):
    """A bias is read through perturb_weight with its own noise key;
    at sigma 0.05 the port's read equals the reference's jitted one."""
    js, ts, _ = main_pair
    k = "ip1/1"
    i = ts._fault_keys.index(k)
    rng = prng.fold_in(ts._key, 5)
    nk = tsolver.noise_keys(rng, i + 1)[i]
    b = torch.from_numpy(np.linspace(-0.3, 0.3, 64, dtype=np.float32))
    broken = ts.fault_state["lifetimes"][k] <= 250
    stuck = ts.fault_state["stuck"][k]
    got = thw.perturb_weight(b, broken, stuck, nk, 0.05)
    with jax.enable_x64(False):
        jnk = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(js._key, 5), 0x4A7), i)
        np.testing.assert_array_equal(nk, host(jnk))
        want = host(jax.jit(jhw.perturb_weight, static_argnums=4)(
            jnp.asarray(b.numpy()), jnp.asarray(broken.numpy()),
            jnp.asarray(stuck.numpy()), jnk, 0.05))
    assert broken.any() and not broken.all()
    assert got.detach().numpy().tobytes() == want.tobytes()


def test_draw_state_rows_and_the_sweep_draw(main_pair):
    """4 configs on mean/std grids, rows [1, 3) drawn alone equal the
    full draw's rows, both the reference's; the port's SweepRunner
    draws the reference runner's state (fold_in(key, 0xFA117))."""
    js, ts, _ = main_pair
    flat = ts._flat(ts.params)
    shapes = {k: tuple(flat[k].shape) for k in ts._fault_keys}
    pattern = ts.param.failure_pattern
    means = np.array([250.0, 300.0, 400.0, 1000.0], np.float32)
    stds = np.array([30.0, 50.0, 120.0, 300.0], np.float32)
    key = prng.fold_in(ts._key, 0xFA117)
    full = tengine.draw_state_rows(key, shapes, pattern, 4, means, stds)
    part = tengine.draw_state_rows(key, shapes, pattern, 4, means, stds,
                                   rows=(1, 3))
    with jax.enable_x64(False):
        jkey = jax.random.fold_in(js._key, 0xFA117)
        want = jengine.draw_state_rows(jkey, {k: tuple(v) for k, v in
                                              shapes.items()},
                                       js.param.failure_pattern, 4,
                                       means, stds)
        want = {g: {k: host(v) for k, v in leaves.items()}
                for g, leaves in want.items()}
    for g in ("lifetimes", "stuck"):
        for k in shapes:
            assert full[g][k].numpy().tobytes() == want[g][k].tobytes()
            assert torch.equal(part[g][k], full[g][k][1:3])
    r = SweepRunner(ts, 4, means=means, stds=stds, device="cpu")
    for g in ("lifetimes", "stuck"):
        for k in shapes:
            assert r.fault_states[g][k].numpy().tobytes() == \
                want[g][k].tobytes()
    np.testing.assert_array_equal(
        r.lane_keys(3), np.stack([prng.fold_in(prng.fold_in(ts._key, 3), c)
                                  for c in range(4)]))


# ---------------------------------------------------------------------------
# the tiled draw, on a narrowed CIFAR-10-quick

def narrow_solver_text(tiles="cells=16x8", extra=""):
    from test_torch_solver import NET
    return (f'net_param {{ {NET} }} base_lr: 0.01 lr_policy: "fixed" '
            f'random_seed: {SEED} failure_pattern {{ type: "gaussian" '
            'mean: 300 std: 50 conv_also: true } rram_forward { tiles: '
            f'"{tiles}" }} {extra}')


def test_tiled_draw_with_conv_also_equals_the_reference(monkeypatch):
    monkeypatch.chdir(REPO)
    text = narrow_solver_text()
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        js = JSolver(sp, train_feed=lambda: {})
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 train_feed=lambda: {})
    spec = TileSpec.parse("cells=16x8")
    flat = ts._flat(ts.params)
    tiled = [k for k in ts._fault_keys
             if len(flat[k].shape) >= 2 and spec.n_tiles(
                 tuple(flat[k].shape)) > 1]
    assert {k.split("/")[0] for k in tiled} >= {"conv1", "conv2", "ip1"}
    assert JTileSpec.parse("cells=16x8").canonical() == spec.canonical()
    for g in ("lifetimes", "stuck"):
        assert list(js.fault_state[g]) == list(ts.fault_state[g])
        for k, v in js.fault_state[g].items():
            assert ts.fault_state[g][k].numpy().tobytes() == \
                host(v).tobytes(), (g, k)


# ---------------------------------------------------------------------------
# the step's repairs: snapshot and the display lines

TINY_NET = (
    'name: "tiny" layer { name: "in" type: "Input" top: "data" top: '
    '"label" input_param { shape { dim: 8 dim: 12 } shape { dim: 8 } } } '
    'layer { name: "fc1" type: "InnerProduct" bottom: "data" top: "fc1" '
    'inner_product_param { num_output: 6 weight_filler { type: "gaussian" '
    'std: 0.3 } bias_filler { type: "constant" value: 0.1 } } } '
    'layer { name: "fc2" type: "InnerProduct" bottom: "fc1" top: "fc2" '
    'inner_product_param { num_output: 3 weight_filler { type: "xavier" '
    '} } } layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2" '
    'bottom: "label" top: "loss" } layer { name: "acc" type: "Accuracy" '
    'bottom: "fc2" bottom: "label" top: "acc" }')


def tiny_solver(extra):
    return (f'net_param {{ {TINY_NET} }} base_lr: 0.05 lr_policy: "fixed" '
            f'random_seed: {SEED} {extra}')


def tiny_batch():
    rng = np.random.RandomState(0)
    return {"data": rng.randn(8, 12).astype(np.float32),
            "label": rng.randint(0, 3, 8).astype(np.float32)}


def test_snapshot_raises_at_the_snapshot_iteration(tmp_path, monkeypatch):
    """`snapshot: 2` writes the three snapshot files at iteration 2 and
    not before; under snapshot_format HDF5 without h5py (an import that
    fails) it raises there instead, naming HDF5 and h5py."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    batch = tiny_batch()
    fault = 'failure_pattern { type: "gaussian" mean: 300 std: 50 }'
    prefix = tmp_path / "snap"
    s = TSolver(tproto.parse(tiny_solver(
        f'snapshot: 2 snapshot_prefix: "{prefix}" {fault}'),
        "SolverParameter"), device="cpu", train_feed=lambda: batch)
    s.step(1)
    assert s.iter == 1 and not os.listdir(tmp_path)
    s.step(1)
    assert s.iter == 2
    assert sorted(os.listdir(tmp_path)) == [
        "snap_iter_2.caffemodel", "snap_iter_2.faultstate",
        "snap_iter_2.solverstate"]
    h5 = TSolver(tproto.parse(tiny_solver(
        f'snapshot: 2 snapshot_format: HDF5 snapshot_prefix: "{prefix}5"'),
        "SolverParameter"), device="cpu", train_feed=lambda: batch)
    h5.step(1)
    with pytest.raises(NotImplementedError,
                       match=r"snapshot at iteration 2.*HDF5.*h5py"):
        h5.step(1)
    assert h5.iter == 2 and len(os.listdir(tmp_path)) == 3
    # snapshot: 0 trains on
    s0 = TSolver(tproto.parse(tiny_solver(""), "SolverParameter"),
                 device="cpu", train_feed=lambda: batch)
    s0.step(3)
    assert s0.iter == 3


def _lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Iteration", "    Train net output"))]


def test_display_prints_the_reference_train_output_lines(capsys):
    """One displayed step in both packages from the same seed and batch:
    the lr, loss and `Train net output #j: name = v` lines (with the
    loss weight's ` (* w = w*v loss)`) match, numbers within 1e-5
    relative."""
    batch = tiny_batch()
    text = tiny_solver("display: 1")
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        js = JSolver(sp, train_feed=lambda: batch)
        capsys.readouterr()
        js.step(1)
        want = _lines(capsys.readouterr().out)
    ts = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                 train_feed=lambda: batch)
    capsys.readouterr()
    ts.step(1)
    got = _lines(capsys.readouterr().out)
    assert any("Train net output #0: loss" in ln and "(* 1 = " in ln
               for ln in want)
    assert any("Train net output #1: acc" in ln for ln in want)
    assert len(got) == len(want) == 4
    num = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
    for g, w in zip(got, want):
        assert num.sub("#", g) == num.sub("#", w), (g, w)
        for a, b in zip(num.findall(g), num.findall(w)):
            assert float(a) == pytest.approx(float(b), rel=1e-5), (g, w)


def test_rram_tpu_seed_pins_an_unseeded_solver(monkeypatch):
    """random_seed < 0 takes RRAM_TPU_SEED (masked to 31 bits), as the
    reference does, before the wall clock."""
    batch = tiny_batch()
    monkeypatch.setenv("RRAM_TPU_SEED", str(SEED + 2 ** 31))
    text = f'net_param {{ {TINY_NET} }} base_lr: 0.05 lr_policy: "fixed"'
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                train_feed=lambda: batch)
    seeded = TSolver(tproto.parse(tiny_solver(""), "SolverParameter"),
                     device="cpu", train_feed=lambda: batch)
    assert s.seed == SEED
    np.testing.assert_array_equal(s._key, seeded._key)
    assert torch.equal(s.params["fc1"][0], seeded.params["fc1"][0])
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    with jax.enable_x64(False):
        js = JSolver(sp, train_feed=lambda: batch)
    assert js.seed == SEED
    np.testing.assert_array_equal(s._key, host(js._key))
