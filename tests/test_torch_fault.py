"""The port's fault engine, packed banks and the plain version of kernel
B1 against the reference package, bit for bit: the same numpy inputs
go through both. The reference's fused epilogue runs its Pallas kernel
in interpret mode, as its own tests run it on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import engine as jengine
from rram_caffe_simulation_tpu.fault import fused as jfused
from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.fault import fused as tfused
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked

SHAPES = [(6, 10), (3, 7), (13,), (2, 3, 9), (64, 1024), (10, 64)]
MODES = ("write", "always", "never")


def bits(a) -> np.ndarray:
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits(a, b):
    x, y = bits(a), bits(b)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


def leaf(shape, seed, life_range=(-3, 4), dtype=np.int32):
    """(data, upd, life_q, stuck) with exact-zero, tiny (around the
    1e-20 write gate) and regular updates, counters near zero."""
    rng = np.random.RandomState(seed)
    data = rng.randn(*shape).astype(np.float32)
    upd = (rng.randn(*shape) * 1e-3).astype(np.float32)
    sel = rng.rand(*shape)
    upd[sel < 0.2] = 0.0
    upd[(sel >= 0.2) & (sel < 0.25)] = 1e-20
    upd[(sel >= 0.25) & (sel < 0.3)] = -9.99e-21
    lq = rng.randint(*life_range, size=shape).astype(dtype)
    stuck = rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
    return data, upd, lq, stuck


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_unpack_bank_bytes(shape):
    rng = np.random.RandomState(len(shape))
    stuck = rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
    life = (rng.randn(*shape) * 400 + 150).astype(np.float32)
    for dt in ("int16", "int32"):
        assert_bits(tpacked.pack_lifetimes(torch.from_numpy(life), 100.0, dt),
                    jpacked.pack_lifetimes(life, 100.0, dt))
    bank = tpacked.pack_stuck(torch.from_numpy(stuck))
    assert_bits(bank, jpacked.pack_stuck(stuck))
    assert_bits(tpacked.unpack_stuck(torch.from_numpy(bank), shape[-1]),
                jpacked.unpack_stuck(jnp.asarray(bank), shape[-1]))
    q = jpacked.pack_lifetimes(life, 100.0, "int32")
    assert_bits(tpacked.unpack_lifetimes(torch.from_numpy(q), 100.0),
                jpacked.unpack_lifetimes(jnp.asarray(q), 100.0))


@pytest.mark.parametrize("mean,std", [(300.0, 50.0), (1e8, 3e7),
                                      (1e6, 1e3), (150.0, 10.0)])
def test_choose_life_dtype(mean, std):
    assert tpacked.choose_life_dtype([mean], [std], 100.0) == \
        jpacked.choose_life_dtype([mean], [std], 100.0)


def _state(shapes, seed):
    rng = np.random.RandomState(seed)
    life = {f"l{i}/0": (rng.randn(*s) * 150 + 50).astype(np.float32)
            for i, s in enumerate(shapes)}
    stuck = {k: rng.choice([-1.0, 0.0, 1.0], size=v.shape).astype(np.float32)
             for k, v in life.items()}
    return {"lifetimes": life, "stuck": stuck}


def test_fail_f32_engine():
    shapes = SHAPES[:4]
    state = _state(shapes, 0)
    rng = np.random.RandomState(1)
    data = {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in state["lifetimes"].items()}
    diffs = {k: leaf(v.shape, i)[1]
             for i, (k, v) in enumerate(state["lifetimes"].items())}
    jp, js = jengine.fail({k: jnp.asarray(v) for k, v in data.items()},
                          jax.tree.map(jnp.asarray, state),
                          {k: jnp.asarray(v) for k, v in diffs.items()})
    tp, ts = tengine.fail({k: torch.from_numpy(v) for k, v in data.items()},
                          convert.fault_state_from_jax(state),
                          {k: torch.from_numpy(v) for k, v in diffs.items()})
    for k in data:
        assert_bits(tp[k], jp[k])
        assert_bits(ts["lifetimes"][k], js["lifetimes"][k])
    assert tengine.broken_fraction(ts) == pytest.approx(
        float(jengine.broken_fraction(js)), abs=0)


def test_fault_counters():
    prev = _state(SHAPES[:4], 5)["lifetimes"]
    new = {k: v - np.float32(100) for k, v in prev.items()}
    jt, jp = jengine.fault_counters(
        {k: jnp.asarray(v) for k, v in prev.items()},
        {k: jnp.asarray(v) for k, v in new.items()})
    tt, tp = tengine.fault_counters(
        {k: torch.from_numpy(v) for k, v in prev.items()},
        {k: torch.from_numpy(v) for k, v in new.items()})
    for got, ref in [(tt, jt)] + [(tp[k], jp[k]) for k in jp]:
        assert sorted(got) == sorted(ref)
        for name in ref:
            assert float(got[name]) == pytest.approx(float(ref[name]),
                                                     rel=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_fail_packed(mode, dtype):
    spec = {"decrement": 100.0, "life_dtype": np.dtype(dtype).name,
            "last_dim": {}}
    jstate, tstate = {"life_q": {}, "stuck_bits": {}}, None
    data, diffs = {}, {}
    for i, shape in enumerate(SHAPES):
        d, u, lq, stuck = leaf(shape, 10 + i, dtype=dtype)
        k = f"l{i}/0"
        data[k], diffs[k] = d, u
        jstate["life_q"][k] = lq
        jstate["stuck_bits"][k] = jpacked.pack_stuck(stuck)
        spec["last_dim"][k] = shape[-1]
    tstate = convert.fault_state_from_jax(jstate)
    jp, js = jpacked.fail_packed(
        {k: jnp.asarray(v) for k, v in data.items()},
        jax.tree.map(jnp.asarray, jstate),
        {k: jnp.asarray(v) for k, v in diffs.items()}, spec, mode=mode)
    tp, ts = tpacked.fail_packed(
        {k: torch.from_numpy(v) for k, v in data.items()}, tstate,
        {k: torch.from_numpy(v) for k, v in diffs.items()}, spec, mode=mode)
    for k in data:
        assert_bits(tp[k], jp[k])
        assert_bits(ts["life_q"][k], js["life_q"][k])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("shape", [(6, 10), (13,), (10, 64), (3, 7)])
def test_plain_b1_matches_reference_fused_kernel(shape, dtype, mode):
    """fused_update_fail_plain (and the wrapper, which takes it on CPU
    tensors) against the reference's Pallas epilogue in interpret mode,
    single leaf and config-batched (C = 3 leading lanes)."""
    d, u, lq, stuck = leaf(shape, 7, dtype=dtype)
    bank = jpacked.pack_stuck(stuck)
    jd, jl = jfused.fused_update_fail(jnp.asarray(d), jnp.asarray(u),
                                      jnp.asarray(lq), jnp.asarray(bank),
                                      mode=mode)
    args = [torch.from_numpy(a) for a in (d, u, lq, bank)]
    for fn in (tfused.fused_update_fail_plain, tfused.fused_update_fail):
        td, tl = fn(*args, mode=mode)
        assert_bits(td, jd)
        assert_bits(tl, jl)
    lanes = [leaf(shape, 20 + c, dtype=dtype) for c in range(3)]
    D, U, L = (np.stack([ln[i] for ln in lanes]) for i in range(3))
    B = np.stack([jpacked.pack_stuck(ln[3]) for ln in lanes])
    jd, jl = jax.vmap(lambda *a: jfused.fused_update_fail(*a, mode=mode))(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(L), jnp.asarray(B))
    td, tl = tfused.fused_update_fail(*[torch.from_numpy(a)
                                        for a in (D, U, L, B)], mode=mode)
    assert_bits(td, jd)
    assert_bits(tl, jl)


def test_b1_wrapper_checks():
    d, u, lq, stuck = leaf((4, 8), 0)
    args = [torch.from_numpy(a) for a in (d, u, lq)]
    bank = torch.from_numpy(tpacked.pack_stuck(stuck))
    with pytest.raises(ValueError, match="mode"):
        tfused.fused_update_fail(*args, bank, mode="sometimes")
    with pytest.raises(TypeError, match="int16 or int32"):
        tfused.fused_update_fail(args[0], args[1], args[2].long(), bank)
    with pytest.raises(ValueError, match="stuck_bits shape"):
        tfused.fused_update_fail(*args, bank[:, :1])


def test_init_fault_state_statistics():
    pattern = tproto.parse("mean: 1000 std: 200", "FailurePatternParameter")
    gen = torch.Generator().manual_seed(0)
    st = tengine.init_fault_state(gen, {"a/0": (200, 300), "a/1": (300,)},
                                  pattern)
    life, stuck = st["lifetimes"]["a/0"], st["stuck"]["a/0"]
    assert life.dtype == torch.float32 and stuck.shape == (200, 300)
    assert abs(float(life.mean()) - 1000) < 5
    assert abs(float(life.std()) - 200) < 5
    frac = [float((stuck == v).float().mean()) for v in (-1.0, 0.0, 1.0)]
    np.testing.assert_allclose(frac, [0.25, 0.5, 0.25], atol=0.01)
    gen2 = torch.Generator().manual_seed(0)
    st2 = tengine.init_fault_state(gen2, {"a/0": (200, 300),
                                          "a/1": (300,)}, pattern)
    assert torch.equal(st2["lifetimes"]["a/0"], life)


def test_state_arrays_and_convert_round_trip():
    state = _state(SHAPES[:3], 3)
    spec = jpacked.make_pack_spec(state, 100.0, means=[50.0], stds=[150.0])
    jpk = jpacked.pack_state(state, spec)
    tpk = tpacked.pack_state(convert.fault_state_from_jax(state),
                             tpacked.make_pack_spec(
                                 convert.fault_state_from_jax(state), 100.0,
                                 means=[50.0], stds=[150.0]))
    for g in ("life_q", "stuck_bits"):
        for k in jpk[g]:
            assert_bits(tpk[g][k], jpk[g][k])
    arrays = tengine.state_to_arrays(tpk)
    assert list(arrays) == list(jengine.state_to_arrays(
        jax.tree.map(jnp.asarray, jpk)))
    back = tengine.state_from_arrays(arrays)
    for g in back:
        for k in back[g]:
            assert torch.equal(back[g][k], tpk[g][k])
    again = convert.fault_state_to_jax(convert.fault_state_from_jax(jpk))
    for g in jpk:
        for k in jpk[g]:
            assert_bits(again[g][k], jpk[g][k])
