"""The port's tiled crossbar path (fault/mapping.py, the tiled reads of
fault/hw_aware.py, the tiled InnerProduct and Convolution, Solver and
SweepRunner with a tile spec and conv_also) against the reference
package's.

Tolerances:

- exact (bytes) where the reference is exact: tile geometry, address
  plans, patch rows, tiled draws' layout, fault transitions, bank bytes;
- exact on dyadic inputs: x and w are small multiples of 2^-4 (and the
  quantization grid a power of two), so every partial sum is exact in
  f32 in any order and the per-tile ADC sees the same bits in both
  packages. Against the reference's jitted code (its Pallas kernels in
  interpret mode) that holds where the ADC's level count is 1 or off:
  XLA rewrites the step max/levels, a division by a constant, as
  max * fl(1/levels), one ulp off IEEE division for levels 3 or 127,
  and the level a value rounds to can move with it. The port divides,
  as the reference's eager functions do, and equals those bit for bit
  at every ADC width;
- otherwise (random f32, host noise) each element within the f32
  summation bound of every K-tile it sums plus one ADC step (LSB) of
  each, an LSB flip allowed on at most 2% of the elements: the ADC turns
  a one-ulp difference at a rounding boundary into a whole level;
- gradients and losses of whole steps within 1e-4 relative (the two
  packages sum convolutions and products in other orders).

Kernel B3's plain read (the implicit conv read) against the reference's
kernel, and its wrapper on every layout, are held in
tests/test_torch_tiles_b3.py, with the same tolerances."""
import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import engine as jengine
from rram_caffe_simulation_tpu.fault import hw_aware as jhw
from rram_caffe_simulation_tpu.fault import mapping as jmap
from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.solver import Solver as JSolver
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.core.registry import LayerContext
from rram_caffe_simulation_tpu_torch.fault import engine as tengine
from rram_caffe_simulation_tpu_torch.fault import hw_aware as thw
from rram_caffe_simulation_tpu_torch.fault import mapping as tmap
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_crossbar import LAYOUTS, host_eps, laid_out, operands, t

U = 2.0 ** -24

# ---------------------------------------------------------------------------
# the mapping: specs, views, plans, patch rows

SPECS = ["1x1", "2x4", "cells=8x2", "cells=128x128", " CELLS=7x3 ", "3x1"]
SHAPES = [(64, 1024), (10, 64), (3, 2, 3, 3), (32, 32, 5, 5), (5,),
          (2, 27)]


@pytest.mark.parametrize("spec", SPECS)
def test_tilespec_matches_reference(spec):
    a, b = tmap.TileSpec.parse(spec), jmap.TileSpec.parse(spec)
    assert a.canonical() == b.canonical() == tmap.canonical(spec)
    assert a.is_default == b.is_default
    assert a == tmap.TileSpec.parse(a.canonical()) and hash(a) == hash(
        tmap.TileSpec.parse(a.canonical()))
    for shape in SHAPES:
        assert a.grid(shape) == b.grid(shape), shape
        if len(shape) >= 2:
            assert a.tile_dims(shape) == b.tile_dims(shape)
            assert a.bounds(shape) == b.bounds(shape)
            assert list(a.tile_slices(shape)) == list(b.tile_slices(shape))
            assert a.n_tiles(shape) == b.n_tiles(shape)


@pytest.mark.parametrize("bad", ["0x2", "cells=4", "4x", "grid=2x2",
                                 "4097x1"])
def test_bad_tilespecs_raise(bad):
    with pytest.raises(ValueError):
        tmap.TileSpec.parse(bad)
    with pytest.raises(ValueError):
        jmap.TileSpec.parse(bad)


def test_tile_cap_and_default_constants():
    assert tmap.DEFAULT_TILES == jmap.DEFAULT_TILES
    assert tmap.MAX_TILES_PER_LAYER == jmap.MAX_TILES_PER_LAYER
    assert tmap.split_bounds(10, 4) == jmap.split_bounds(10, 4)
    with pytest.raises(ValueError, match="cap"):
        tmap.TileSpec.parse("cells=1x1").grid((100, 100))


def test_im2col_view_bijection_matches_reference():
    rng = np.random.RandomState(0)
    shape = (4, 3, 3, 5)
    w = rng.randn(2, *shape).astype(np.float32)    # a leading lane axis
    assert tmap.im2col_shape(shape) == jmap.im2col_shape(shape) == (45, 4)
    assert tmap.crossbar_view_shape((10, 6)) == (10, 6)
    with pytest.raises(ValueError, match="2-D"):
        tmap.im2col_shape((10, 6))
    want = np.asarray(jmap.to_im2col(jnp.asarray(w), param_ndim=4))
    for arr in (w, torch.from_numpy(w)):           # numpy and tensors
        v = tmap.to_im2col(arr, param_ndim=4)
        assert np.asarray(v).tobytes() == want.tobytes()
        back = tmap.from_im2col(v, shape)
        assert np.asarray(back).tobytes() == w.tobytes()
    assert tmap.to_im2col(w[0]).shape == (45, 4)


GEOMS = [  # x shape, kernel, stride, pad, dilation
    ((2, 3, 7, 7), (3, 3), (2, 2), (1, 1), (1, 1)),
    ((1, 2, 6, 8), (3, 2), (1, 2), (0, 1), (1, 1)),
    ((2, 2, 9, 9), (3, 3), (2, 1), (2, 2), (2, 2)),
    ((3, 4, 8, 8), (5, 5), (1, 1), (2, 2), (1, 1)),
]


@pytest.mark.parametrize("x_shape,kernel,stride,pad,dil", GEOMS)
def test_index_plan_and_patch_rows_match_reference(x_shape, kernel, stride,
                                                    pad, dil):
    geom = tmap.conv_geom(kernel, stride, pad, dil)
    assert geom == jmap.conv_geom(kernel, stride, pad, dil)
    got, want = tmap.im2col_index_plan(x_shape, geom), \
        jmap.im2col_index_plan(x_shape, geom)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert got[2:] == want[2:]
    x = np.random.RandomState(1).randn(*x_shape).astype(np.float32)
    rows = tmap.conv_patch_rows(torch.from_numpy(x), geom).numpy()
    ref = np.asarray(jmap.conv_patch_rows(jnp.asarray(x), geom))
    assert rows.shape == ref.shape and rows.tobytes() == ref.tobytes()
    flat = tmap.pad_activation_flat(torch.from_numpy(x), geom).numpy()
    assert flat.tobytes() == np.asarray(
        jmap.pad_activation_flat(jnp.asarray(x), geom)).tobytes()
    rb, co = got[0].astype(np.int64), got[1].astype(np.int64)
    assert np.array_equal(flat[rb[:, None] + co[None, :]], rows)
    # a lane axis rides through
    x2 = torch.from_numpy(np.stack([x, 2 * x]))
    r2 = tmap.conv_patch_rows(x2, geom)
    assert torch.equal(r2[0], torch.from_numpy(rows))
    assert torch.equal(r2[1], torch.from_numpy(2 * rows))


def test_conv_geom_refuses_other_ranks():
    with pytest.raises(ValueError, match="2-D"):
        tmap.conv_geom((3,), (1,), (0,), (1,))
    with pytest.raises(ValueError, match="empty output"):
        tmap.im2col_index_plan((1, 1, 2, 2), (5, 5, 1, 1, 0, 0, 1, 1))


# ---------------------------------------------------------------------------
# tiled draws

PATTERN = 'type: "gaussian" mean: 400 std: 100'


def test_tiled_draw_single_tile_is_the_untiled_draw():
    pattern = tproto.parse(PATTERN, "FailurePattern")
    shapes = {"conv1/0": (4, 3, 3, 3), "conv1/1": (4,), "ip/0": (5, 7)}
    base = tengine.init_fault_state(prng.PRNGKey(3), shapes, pattern)
    for spec in (None, "1x1", "cells=1024x1024"):
        ts = None if spec is None else tmap.TileSpec.parse(spec)
        got = tengine.init_fault_state(prng.PRNGKey(3), shapes, pattern,
                                       tiles=ts)
        for g in base:
            for k in base[g]:
                assert got[g][k].numpy().tobytes() == \
                    base[g][k].numpy().tobytes()
    lanes = tengine.stack_fault_states(prng.PRNGKey(4), shapes, pattern, 2)
    lanes11 = tengine.stack_fault_states(prng.PRNGKey(4), shapes, pattern, 2,
                                         tiles=tmap.TileSpec.parse("1x1"))
    for g in lanes:
        for k in lanes[g]:
            assert torch.equal(lanes[g][k], lanes11[g][k])


def test_tiled_draw_tiles_are_independent():
    pattern = tproto.parse(PATTERN, "FailurePattern")
    ts = tmap.TileSpec.parse("cells=40x3")     # view (243, 9) -> 7x3 tiles
    shape = (9, 3, 9, 9)
    st = tengine.init_fault_state(prng.PRNGKey(5),
                                  {"c/0": shape, "c/1": (9,)}, pattern,
                                  tiles=ts)
    life = st["lifetimes"]["c/0"]
    assert life.shape == shape and st["stuck"]["c/0"].shape == shape
    again = tengine.init_fault_state(prng.PRNGKey(5),
                                     {"c/0": shape, "c/1": (9,)}, pattern,
                                     tiles=ts)
    assert torch.equal(again["lifetimes"]["c/0"], life)
    view = tmap.to_im2col(life)
    blocks = [view[r0:r1, c0:c1].flatten()
              for _, (r0, r1, c0, c1) in ts.tile_slices(shape)]
    assert len(blocks) == 21
    # tile t's cells are drawn from fold_in(k_life, t), tile-major: block
    # 0 is normal(fold_in(k_life, 0)) of its shape (mean + std * z)
    k_life = prng.split(prng.PRNGKey(5), 3)[1]
    for t_ in (0, 20):
        z_t = prng.normal(prng.fold_in(k_life, t_),
                          blocks[t_].reshape(-1, 3).shape)
        assert torch.equal(blocks[t_], (z_t * 100.0 + 400.0).flatten())
    # independent draws: no two tiles share values; correlation ~ 0
    z = [(b - 400.0) / 100.0 for b in blocks]
    r = float(torch.corrcoef(torch.stack([z[0][:27], z[1][:27]]))[0, 1])
    assert abs(r) < 0.6
    assert len({b.numpy().tobytes() for b in blocks}) == 21
    allz = torch.cat(z)
    assert abs(float(allz.mean())) < 0.1 and abs(float(allz.std()) - 1) < 0.1


# ---------------------------------------------------------------------------
# the tiled reads: plain versions against the reference's kernels

def dyadic(rng, shape, lim=16):
    """Multiples of 2^-4 in [-lim/16, lim/16]."""
    return (rng.randint(-lim, lim + 1, size=shape) / 16.0).astype(
        np.float32)


def weights(rng, C, K, N, dyad):
    """w with max |w| = 0.75 in every lane on dyadic inputs (so the grid
    step max/levels is a power of two at q_bits 2 and 3), broken, stuck."""
    if dyad:
        w = dyadic(rng, (C, K, N), 12)
        w[:, 0, 0] = 0.75
    else:
        w = (rng.randn(C, K, N) * 0.3).astype(np.float32)
    broken = (rng.rand(C, K, N) < 0.15).astype(np.float32)
    stuck = rng.choice([-1.0, 0.0, 1.0], size=(C, K, N)).astype(np.float32)
    return w, broken, stuck


def tiled_bound(y, y_ref, x_abs, w_abs, levels_bound, tiles):
    """|y - y_ref| per element within the f32 summation bound of each
    K-tile plus one ADC step of each (`levels_bound` = per-(lane, kt,
    jt) step), and the share of elements past the summation bound alone
    (LSB flips) at most 2%."""
    bk, bn, _ = tiles
    K, N = w_abs.shape[-2:]
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    sum_b = np.zeros_like(y)
    lsb = np.zeros_like(y)
    for kt, k0 in enumerate(range(0, K, bk)):
        k1 = min(k0 + bk, K)
        part = np.matmul(x_abs[..., k0:k1], w_abs[..., k0:k1, :])
        sum_b += (k1 - k0) * U * part * 2 + U * np.abs(y)
        for jt, n0 in enumerate(range(0, N, bn)):
            lsb[..., n0:n0 + bn] += levels_bound[..., kt, jt, None, None] \
                if levels_bound.ndim == 3 else levels_bound[kt, jt]
    err = np.abs(y - y_ref)
    assert (err <= sum_b + lsb + 1e-30).all(), float((err - sum_b - lsb)
                                                     .max())
    assert (err > sum_b).mean() <= 0.02


def adc_steps(x, w_eff, tiles):
    """(..., gk, gn) ADC steps max|partial| / levels of each tile."""
    bk, bn, adc = tiles
    lv = thw.q_levels(adc)
    K, N = w_eff.shape[-2:]
    out = np.zeros(w_eff.shape[:-2] + (-(-K // bk), -(-N // bn)))
    for kt, k0 in enumerate(range(0, K, bk)):
        for jt, n0 in enumerate(range(0, N, bn)):
            p = np.matmul(x[..., k0:k0 + bk], w_eff[..., k0:k0 + bk,
                                                    n0:n0 + bn])
            out[..., kt, jt] = (np.abs(p).max(axis=(-2, -1)) / lv
                                if lv else 0.0)
    return out


def plain_weff(w, broken, stuck, seeds, sigma, q_bits, eps):
    return thw._lane_w_eff(t(w), t(broken), t(stuck), t(seeds), sigma,
                           q_bits, None if eps is None else t(eps)).numpy()


@pytest.mark.parametrize("adc", [0, 3, 8])
@pytest.mark.parametrize("bk,bn", [(8, 4), (7, 3)])
def test_tiled_matmul_dyadic_bit_exact(adc, bk, bn):
    rng = np.random.RandomState(adc + bk)
    x = dyadic(rng, (13, 40))
    w = dyadic(rng, (40, 10), 12)
    got = thw.tiled_crossbar_matmul(t(x), t(w), bk, bn, adc).numpy()
    want = np.asarray(jhw.tiled_crossbar_matmul(jnp.asarray(x),
                                                jnp.asarray(w), bk, bn, adc))
    assert got.tobytes() == want.tobytes()
    # the lazy-operand spelling and a lane axis give the same bytes
    slabs = thw.tiled_crossbar_matmul_slabs(
        lambda k0, k1: t(x[:, k0:k1]), t(w), bk, bn, adc).numpy()
    assert slabs.tobytes() == got.tobytes()
    lanes = thw.tiled_crossbar_matmul(t(x), t(np.stack([w, w])), bk, bn,
                                      adc).numpy()
    assert lanes[1].tobytes() == got.tobytes()


# the weight grid and the ADC together: (q_bits, adc) = (0, 0) and (3, 3)
@pytest.mark.parametrize("q_bits,adc", [(0, 0), (3, 3)])
@pytest.mark.parametrize("sigma", [0.0, 0.05])
@pytest.mark.parametrize("lanes", ["single", "shared", "per_lane"])
def test_b2t_plain_matches_reference_kernel(q_bits, sigma, lanes, adc):
    """crossbar_forward_plain(tiles=) against the reference's
    `_pallas_forward[_batched](tiles=)` in interpret mode, host noise
    for sigma > 0: bit-exact on dyadic inputs at sigma 0 with the ADC
    off, within the stated bound otherwise."""
    C = 1 if lanes == "single" else 3
    M, K, N = 12, 37, 10
    tiles = (8, 3, adc)
    rng = np.random.RandomState(7 + q_bits + C)
    dyad = sigma == 0.0
    exact = dyad and not adc
    x = dyadic(rng, (C, M, K)) if dyad else rng.randn(C, M, K).astype(
        np.float32)
    xin = x if lanes == "per_lane" else x[0]
    w, broken, stuck = weights(rng, C, K, N, dyad)
    seeds = np.arange(11, 11 + C, dtype=np.int32)
    if lanes == "single":
        y_ref = np.asarray(jhw._pallas_forward(
            jnp.asarray(xin), jnp.asarray(w[0]), jnp.asarray(broken[0]),
            jnp.asarray(stuck[0]), int(seeds[0]), sigma, q_bits,
            tiles))[None]
    else:
        y_ref = np.asarray(jhw._pallas_forward_batched(
            jnp.asarray(xin), jnp.asarray(w), jnp.asarray(broken),
            jnp.asarray(stuck), jnp.asarray(seeds), sigma, q_bits, tiles))
    eps = (np.stack([host_eps(int(s), K, N, tiles[0], tiles[1])
                     for s in seeds]) if sigma else None)
    args = (t(xin), t(w), t(broken), t(stuck), t(seeds), sigma, q_bits)
    y = thw.crossbar_forward_plain(*args, eps=None if eps is None
                                   else t(eps), tiles=tiles).numpy()
    # the wrapper takes the plain version on CPU tensors
    assert thw.crossbar_forward(*args, eps=None if eps is None else t(eps),
                                tiles=tiles).numpy().tobytes() == y.tobytes()
    if exact:
        assert y.tobytes() == y_ref.tobytes()
    else:
        w_eff = plain_weff(w, broken, stuck, seeds, sigma, q_bits, eps)
        xb = np.broadcast_to(xin, (C, M, K))
        tiled_bound(y, y_ref, np.abs(xb), np.abs(w_eff),
                    adc_steps(xb, w_eff, tiles), tiles)


# the weight grid and the ADC together: (q_bits, adc) = (0, 0) and (3, 3)
def test_reference_crossbar_matmul_pure_spelling():
    """The pure spelling (quantize_ste, perturb_weight, the tiled
    product) equals the kernels' plain version at sigma 0, dyadic."""
    rng = np.random.RandomState(9)
    x = dyadic(rng, (6, 20))
    w, broken, stuck = weights(rng, 1, 20, 7, True)
    got = thw.reference_crossbar_matmul(
        t(x), t(w[0]), t(broken[0]) > 0, t(stuck[0]), None, 0.0, 2,
        (6, 4, 3))
    plain = thw.crossbar_forward_plain(t(x), t(w), t(broken), t(stuck),
                                       t(np.array([1], np.int32)), 0.0, 2,
                                       tiles=(6, 4, 3))[0]
    want = jhw.reference_crossbar_matmul(
        jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(broken[0] > 0),
        jnp.asarray(stuck[0]), jax.random.PRNGKey(0), 0.0, 2, (6, 4, 3))
    assert got.numpy().tobytes() == plain.numpy().tobytes() \
        == np.asarray(want).tobytes()


# ---------------------------------------------------------------------------
# B2t's wrapper on every storage layout it takes, and its plan

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("lanes", ["single", "shared", "per_lane"])
def test_b2t_layouts_equal_dense_and_reference(layout, lanes):
    """crossbar_forward_plain(tiles=) and the wrapper on each layout B2t
    reads in place (dense f32, broken bool, Caffe's stored layout turned
    by view with x folded, unaligned rows, mixed with broken uint8): the
    dense f32 call's bits; within the tiled bound of the reference's
    `_pallas_forward[_batched](tiles=)` in interpret mode, host noise."""
    C = 1 if lanes == "single" else 3
    M, K, N = 12, 37, 10
    tiles = (8, 3, 3)
    sigma, q_bits = 0.05, 3
    rng = np.random.RandomState(80 + C)
    x, xs, w, broken, stuck, seeds = operands(rng, C, M, K, N)
    xin = xs if lanes == "per_lane" else x
    eps = np.stack([host_eps(int(s), K, N, tiles[0], tiles[1])
                    for s in seeds])
    dense = laid_out("dense", xin, w, broken, stuck, eps)
    y0 = thw.crossbar_forward_plain(*dense[:4], t(seeds), sigma, q_bits,
                                    eps=dense[4], tiles=tiles)
    lx, lw, lb, ls, le = laid_out(layout, xin, w, broken, stuck, eps)
    for fwd in (thw.crossbar_forward_plain, thw.crossbar_forward):
        assert torch.equal(fwd(lx, lw, lb, ls, t(seeds), sigma, q_bits,
                               eps=le, tiles=tiles), y0)
    bf = broken.astype(np.float32)
    if lanes == "single":
        y_ref = np.asarray(jhw._pallas_forward(
            jnp.asarray(xin), jnp.asarray(w[0]), jnp.asarray(bf[0]),
            jnp.asarray(stuck[0]), int(seeds[0]), sigma, q_bits,
            tiles))[None]
    else:
        y_ref = np.asarray(jhw._pallas_forward_batched(
            jnp.asarray(xin), jnp.asarray(w), jnp.asarray(bf),
            jnp.asarray(stuck), jnp.asarray(seeds), sigma, q_bits, tiles))
    w_eff = plain_weff(w, bf, stuck, seeds, sigma, q_bits, eps)
    xb = np.broadcast_to(xin, (C, M, K))
    tiled_bound(y0.numpy(), y_ref, np.abs(xb), np.abs(w_eff),
                adc_steps(xb, w_eff, tiles), tiles)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("x_batched", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_b2t_matmul_lanes_layouts_forward_and_grads(layout, x_batched,
                                                    use_kernel):
    """`crossbar_matmul_lanes(tiles=)` on each layout: y, dx and dw carry
    the bits of the call on dense f32 copies."""
    C, M, K, N = 3, 10, 24, 12
    tiles = (7, 5, 3)
    rng = np.random.RandomState(90)
    x, xs, w, broken, stuck, seeds = operands(rng, C, M, K, N)
    xin = xs if x_batched else x
    g = t(rng.randn(C, M, N).astype(np.float32))
    outs = []
    for lay in ("dense", layout):
        lx, lw, lb, ls, _ = laid_out(lay, xin, w, broken, stuck, w)
        lx = lx.detach().requires_grad_()
        lw = lw.detach().requires_grad_()
        y = thw.crossbar_matmul_lanes(lx, lw, lb, ls, t(seeds), 0.0, 2,
                                      use_kernel, tiles)
        dx, dw = torch.autograd.grad(y, (lx, lw), g)
        outs.append((y.detach(), dx, dw))
    for a, b in zip(*outs):
        assert a.shape == b.shape
        assert torch.equal(a, b)
    assert (outs[1][2][t(broken)] == 0).all()


B2T_SHAPES = [  # C, M, K, N, bk, bn
    (1, 100, 1024, 64, 128, 64), (64, 100, 1024, 64, 128, 64),
    (512, 100, 1024, 64, 128, 64), (1, 1, 1000, 64, 128, 64),
    (4, 128, 1000, 10, 96, 64), (1, 100, 256, 130, 128, 64),
    (4, 100, 300, 64, 128, 32), (1, 100, 64, 10, 128, 64),
    (1, 129, 1024, 64, 128, 64), (4, 37, 50, 11, 7, 3),
    (2, 96, 96, 96, 7, 5), (2, 96, 96, 96, 32, 32), (2, 96, 96, 96, 96, 32),
    (3, 300, 5000, 200, 128, 128), (1, 113, 70, 200, 16, 64)]


@pytest.mark.parametrize("C,M,K,N,bk,bn", B2T_SHAPES)
def test_b2t_plan_is_valid(C, M, K, N, bk, bn):
    bm = thw.b2t_plan(C, M, K, N, bk)
    assert bm in (32, 112, 128)
    assert thw.b2t_plan(C, M, K, N, bk) == bm           # the shape alone
    gk, cols = -(-K // bk), -(-N // thw.B2_BN)
    if bm == 32:
        # 32-row tiles only where the larger ones leave the card short of
        # blocks
        assert C * gk * -(-M // 128) * cols < thw.B2_FILL
    else:
        assert -(-M // bm) == -(-M // 128)  # 112 rows cost no extra tile
        assert C * gk * -(-M // bm) * cols >= thw.B2_FILL
    assert gk * bk >= K > (gk - 1) * bk     # no empty K-tile


def test_b2t_plan_path_shapes():
    # ip1 of the tiled slice: 4 x 8 blocks of 32 rows; of the tiled
    # sweep's 64 lanes and the sweep's 512: 112 rows, one row block a lane
    # and K-tile
    assert thw.b2t_plan(1, 100, 1024, 64, 128) == 32
    assert thw.b2t_plan(64, 100, 1024, 64, 128) == 112
    assert thw.b2t_plan(512, 100, 1024, 64, 128) == 112
    assert thw.b2t_plan(1, 100, 64, 10, 128) == 32
    assert thw.b2t_plan(1, 129, 1024, 64, 128) == 32


# ---------------------------------------------------------------------------
# the layer's three operand modes; the implicit backward

def conv_layer(num_output=4, group=1, in_shape=(3, 2, 7, 7), pad=1,
               stride=2, kernel=3, dilation=1):
    from rram_caffe_simulation_tpu_torch.ops.vision import ConvolutionLayer
    lp = tproto.parse(
        f'name: "c" type: "Convolution" bottom: "x" top: "y" '
        f'convolution_param {{ num_output: {num_output} group: {group} '
        f'kernel_size: {kernel} stride: {stride} pad: {pad} '
        f'dilation: {dilation} }}', "LayerParameter")
    layer = ConvolutionLayer(lp, tproto.TRAIN)
    layer.setup([in_shape])
    return layer


@pytest.mark.parametrize("pad,stride,dil", [(1, 2, 1), (0, 1, 1), (2, 3, 2)])
@pytest.mark.parametrize("read", ["crossbar", "crossbar_plain", "stored"])
def test_conv_operand_modes_byte_identical(pad, stride, dil, read):
    """premat, tilewise and implicit give the same bytes, forward and
    backward (dx, dw), on the crossbar read through the kernel wrappers
    (which take the plain versions here) and on the plain read by name.
    With no crossbar read armed (the stored weights through the tiles,
    autograd's backward through each mode's own gathers) the forward
    bytes are equal and dx, dw agree within f32 reordering (1e-5)."""
    layer = conv_layer(pad=pad, stride=stride, dilation=dil)
    rng = np.random.RandomState(pad + stride)
    x0 = rng.randn(3, 2, 7, 7).astype(np.float32)
    w0 = rng.randn(4, 2, 3, 3).astype(np.float32)
    b0 = rng.randn(4).astype(np.float32)
    broken = torch.from_numpy(rng.rand(4, 2, 3, 3) < 0.2)
    stuck = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], (4, 2, 3, 3))
                             .astype(np.float32))
    g = torch.from_numpy(rng.randn(*layer.top_shapes[0]).astype(np.float32))
    cb = None if read == "stored" else {
        "c": (broken, stuck, 3, 0.0, 2, read == "crossbar")}
    outs = {}
    # tilewise is a plain-path mode: the kernel route refuses it (the
    # solver resolves it to premat there)
    modes = ("premat", "implicit") if read == "crossbar" else (
        "premat", "tilewise", "implicit")
    for mode in modes:
        x, w, b = (torch.from_numpy(a).requires_grad_() for a in (x0, w0,
                                                                  b0))
        ctx = LayerContext(phase=tproto.TRAIN, adc_bits=4, crossbar=cb,
                           tiles={"c": (7, 2)}, conv_im2col=mode)
        (y,) = layer.apply([w, b], [x], ctx)
        dx, dw = torch.autograd.grad(y, (x, w), g)
        outs[mode] = [a.detach().numpy() for a in (y, dx, dw)]
    if read == "crossbar":
        ctx = LayerContext(phase=tproto.TRAIN, adc_bits=4, crossbar=cb,
                           tiles={"c": (7, 2)}, conv_im2col="tilewise")
        with pytest.raises(ValueError, match="plain-path"):
            layer.apply([w, b], [x], ctx)
    for mode in modes[1:]:
        for i, (a, b) in enumerate(zip(outs[mode], outs["premat"])):
            if read == "stored" and i:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            else:
                assert a.tobytes() == b.tobytes(), (mode, i)


def test_conv_operand_mode_env_fallback_and_bogus(monkeypatch):
    """The solver resolves the mode: its argument, else RRAM_CONV_IM2COL,
    else premat; an unknown value raises naming the variable. The layer
    reads only ctx.conv_im2col (None = premat), never the environment."""
    feed = cycling(conv_batches(1))
    text = conv_solver_text()
    monkeypatch.delenv("RRAM_CONV_IM2COL", raising=False)
    assert port_solver(text, feed)._step_fn.conv_im2col_resolved == "premat"
    monkeypatch.setenv("RRAM_CONV_IM2COL", "implicit")
    s = port_solver(text, feed)
    assert s._step_fn.conv_im2col_requested == "implicit"
    assert s._step_fn.conv_im2col_resolved == "implicit"
    assert port_solver(text, feed, conv_im2col="premat") \
        ._step_fn.conv_im2col_resolved == "premat"
    layer = conv_layer()
    x = torch.randn(3, 2, 7, 7)
    w, b = torch.randn(4, 2, 3, 3), torch.zeros(4)
    monkeypatch.setenv("RRAM_CONV_IM2COL", "bogus")
    (pre,) = layer.apply([w, b], [x], LayerContext(
        phase=tproto.TRAIN, adc_bits=3, tiles={"c": (7, 2)}))
    (imp,) = layer.apply([w, b], [x], LayerContext(
        phase=tproto.TRAIN, adc_bits=3, tiles={"c": (7, 2)},
        conv_im2col="implicit"))
    assert torch.equal(pre, imp)
    with pytest.raises(ValueError, match="RRAM_CONV_IM2COL"):
        port_solver(text, feed)


def test_conv_tiled_layer_matches_reference_layer():
    """The port's tiled conv layer (no crossbar read: the stored weight
    through the tiles) against the reference's, dyadic inputs: equal
    bytes."""
    from rram_caffe_simulation_tpu.core.registry import \
        LayerContext as JContext
    from rram_caffe_simulation_tpu.ops.vision import ConvolutionLayer as JConv
    lp = pb.LayerParameter(name="c", type="Convolution")
    lp.bottom.append("x")
    lp.top.append("y")
    cp = lp.convolution_param
    cp.num_output, cp.group = 4, 1
    cp.kernel_size.append(3)
    cp.stride.append(2)
    cp.pad.append(1)
    jl = JConv(lp, pb.TRAIN)
    jl.setup([(3, 2, 7, 7)])
    rng = np.random.RandomState(4)
    x, w, b = dyadic(rng, (3, 2, 7, 7)), dyadic(rng, (4, 2, 3, 3)), \
        dyadic(rng, (4,))
    (want,), _ = jl.apply([jnp.asarray(w), jnp.asarray(b)], [jnp.asarray(x)],
                          JContext(phase=pb.TRAIN, adc_bits=3,
                                   tiles={"c": (7, 2)},
                                   conv_im2col="implicit"))
    (got,) = conv_layer().apply([t(w), t(b)], [t(x)], LayerContext(
        phase=tproto.TRAIN, adc_bits=3, tiles={"c": (7, 2)},
        conv_im2col="implicit"))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("sigma,q_bits", [(0.0, 0), (0.1, 3)])
def test_implicit_backward_against_reference(sigma, q_bits):
    """dx and dw of the port's crossbar_conv_matmul against jax.grad of
    the reference's, sum(y^2) as the loss; host noise fed to neither
    (sigma enters only the forward, which the two packages draw
    differently, so the noise case compares each side's backward to its
    own forward's cotangent g = 2y)."""
    rng = np.random.RandomState(5)
    geom = tmap.conv_geom((3, 3), (2, 2), (1, 1), (1, 1))
    x = rng.randn(2, 2, 6, 6).astype(np.float32)
    w = rng.randn(18, 4).astype(np.float32)
    broken = rng.rand(18, 4) < 0.2
    stuck = np.where(rng.rand(18, 4) < 0.5, 1.0, -1.0).astype(np.float32)
    tiles = (8, 3, 3)
    g = rng.randn(18, 4).astype(np.float32)     # cotangent of y (M, N)

    def ref(xa, wa):
        y = jhw.crossbar_conv_matmul(xa, wa, jnp.asarray(broken),
                                     jnp.asarray(stuck), jnp.uint32(7),
                                     sigma, q_bits, tiles, geom)
        return y
    _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(g))
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    y = thw.crossbar_conv_matmul(xt, wt, t(broken), t(stuck), 7, sigma,
                                 q_bits, tiles, geom)
    assert y.shape == (18, 4)
    dx, dw = torch.autograd.grad(y, (xt, wt), t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), rtol=1e-4,
                               atol=1e-5)
    assert (dw.numpy()[broken] == 0).all()
    # and byte-equal to the premat path's backward in the port
    xp, wp = t(x).requires_grad_(), t(w).requires_grad_()
    yp = thw.crossbar_matmul(tmap.conv_patch_rows(xp, geom), wp, t(broken),
                             t(stuck), 7, sigma, q_bits, tiles=tiles)
    dxp, dwp = torch.autograd.grad(yp, (xp, wp), t(g))
    assert dxp.numpy().tobytes() == dx.numpy().tobytes()
    assert dwp.numpy().tobytes() == dw.numpy().tobytes()


def test_laned_conv_and_ip_equal_single_lanes():
    """A laned tiled conv + InnerProduct read ((N, C*ch, H, W) bottoms,
    one launch for every lane) equals each lane read alone."""
    from rram_caffe_simulation_tpu_torch.ops.common import InnerProductLayer
    C = 3
    layer = conv_layer()
    rng = np.random.RandomState(8)
    xs = rng.randn(C, 3, 2, 7, 7).astype(np.float32)
    ws = rng.randn(C, 4, 2, 3, 3).astype(np.float32)
    bs = rng.randn(C, 4).astype(np.float32)
    broken = torch.from_numpy(rng.rand(C, 4, 2, 3, 3) < 0.2)
    stuck = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], (C, 4, 2, 3, 3))
                             .astype(np.float32))
    seeds = torch.arange(C, dtype=torch.int32)
    laned_x = torch.from_numpy(xs).transpose(0, 1).reshape(3, C * 2, 7, 7)
    for mode in ("premat", "implicit"):
        ctx = LayerContext(phase=tproto.TRAIN, adc_bits=3, tiles={"c": (7, 2)},
                           conv_im2col=mode, lanes=C, laned=(True,),
                           crossbar={"c": (broken, stuck, seeds, 0.0, 2,
                                           True)})
        (y,) = layer.apply([t(ws), t(bs)], [laned_x], ctx)
        for c in range(C):
            one = LayerContext(phase=tproto.TRAIN, adc_bits=3,
                               tiles={"c": (7, 2)}, conv_im2col=mode,
                               crossbar={"c": (broken[c], stuck[c], c, 0.0,
                                               2, True)})
            (yc,) = layer.apply([t(ws[c]), t(bs[c])], [t(xs[c])], one)
            torch.testing.assert_close(y[:, 4 * c:4 * c + 4], yc, rtol=0,
                                       atol=1e-6)
    lp = tproto.parse('name: "ip" type: "InnerProduct" bottom: "x" '
                      'top: "y" inner_product_param { num_output: 5 }',
                      "LayerParameter")
    ip = InnerProductLayer(lp, tproto.TRAIN)
    ip.setup([(6, 11)])
    xi = rng.randn(C, 6, 11).astype(np.float32)
    wi = rng.randn(C, 5, 11).astype(np.float32)
    bi = np.zeros((C, 5), np.float32)
    bri = torch.from_numpy(rng.rand(C, 5, 11) < 0.2)
    sti = torch.ones(C, 5, 11)
    ctx = LayerContext(phase=tproto.TRAIN, adc_bits=3, tiles={"ip": (2, 4)},
                       lanes=C, laned=(True,),
                       crossbar={"ip": (bri, sti, seeds, 0.0, 2, True)})
    (y,) = ip.apply([t(wi), t(bi)], [t(xi).transpose(0, 1).reshape(6, -1)],
                    ctx)
    for c in range(C):
        one = LayerContext(phase=tproto.TRAIN, adc_bits=3,
                           tiles={"ip": (2, 4)},
                           crossbar={"ip": (bri[c], sti[c], c, 0.0, 2,
                                            True)})
        (yc,) = ip.apply([t(wi[c]), t(bi[c])], [t(xi[c])], one)
        torch.testing.assert_close(y[:, 5 * c:5 * c + 5], yc, rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Solver and SweepRunner against the reference

CONV_TILE_NET = """
name: "ConvTileNet"
layer { name: "data" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 4 dim: 2 dim: 8 dim: 8 } shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 3 kernel_size: 3 stride: 2
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" value: 0.05 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "fc1" type: "InnerProduct" bottom: "conv1" top: "fc1"
  inner_product_param { num_output: 2
    weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc1" bottom: "label"
  top: "loss" }
"""


def conv_solver_text(mean=250.0, std=30.0, adc_bits=3, tiles="cells=8x2",
                     net=CONV_TILE_NET):
    """The reference's test_conv_tiles.py net with SoftmaxWithLoss in
    place of EuclideanLoss (the port has no EuclideanLoss yet): conv1
    (3, 2, 3, 3) -> im2col view (18, 3) -> a 3x2 grid of (8, 2) tiles;
    fc1 (2, 27) -> 1x14 tiles of (2, 2)."""
    rf = f"rram_forward {{ adc_bits: {adc_bits} tiles: \"{tiles}\" }}" \
        if (adc_bits or tiles) else ""
    return (f'net_param {{ {net} }} base_lr: 0.05 momentum: 0.9 '
            f'lr_policy: "fixed" display: 0 max_iter: 100 random_seed: 9 '
            f'failure_pattern {{ type: "gaussian" mean: {mean} std: {std} '
            f'conv_also: true }} {rf}')


def conv_batches(n, seed=4):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(4, 2, 8, 8).astype(np.float32),
             "label": rng.randint(0, 2, 4).astype(np.float32)}
            for _ in range(n)]


def cycling(bs):
    state = {"i": 0}

    def feed():
        b = bs[state["i"] % len(bs)]
        state["i"] += 1
        return b
    return feed


def ref_solver(text, feed):
    sp = pb.SolverParameter()
    text_format.Parse(text, sp)
    return JSolver(sp, train_feed=feed)


def port_solver(text, feed, **kw):
    return TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                   train_feed=feed, **kw)


def test_tiled_solver_matches_reference():
    """cells=8x2, adc_bits 3, ternary, sigma 0, packed banks, lifetimes
    N(600, 250): the
    reference on its "jax" engine, the port on "cuda" (the wrappers'
    plain versions here) with the implicit conv operand and the fused
    epilogue, from the reference's tiled draw carried over. Losses
    within 1e-4 relative, packed banks equal byte for byte, every
    step."""
    bs = conv_batches(4)
    text = conv_solver_text(mean=600.0, std=250.0)
    js = ref_solver(text, cycling(bs))
    assert js.tile_spec.canonical() == "cells=8x2"
    spec = jpacked.make_pack_spec(js.fault_state, 100.0,
                                  pattern=js.param.failure_pattern)
    jstate = jpacked.pack_state(
        {g: {k: np.asarray(v) for k, v in grp.items()}
         for g, grp in js.fault_state.items()}, spec)
    jstep = jax.jit(js.make_train_step(hw_engine="jax",
                                       dtype_policy="ternary",
                                       fault_format="packed",
                                       pack_spec=spec))
    ts = port_solver(text, cycling(bs), hw_engine="cuda",
                     dtype_policy="ternary", fault_format="packed",
                     fused_epilogue=True, conv_im2col="implicit")
    assert ts._fault_keys == list(js._fault_keys)
    assert ts._tiles_ctx() == {"conv1": (8, 2), "fc1": (2, 2)}
    assert ts._tiles_ctx() == js._tiles_ctx()
    assert ts._step_fn.conv_im2col_resolved == "implicit"
    assert ts.pack_spec == spec
    ts.params = convert.params_from_jax(
        {k: [np.asarray(a) for a in v] for k, v in js.params.items()})
    ts.fault_state = convert.fault_state_from_jax(jstate)
    params, hist, state = js.params, js.history, jax.tree.map(jnp.asarray,
                                                              jstate)
    for it in range(4):
        batch = {k: jnp.asarray(v) for k, v in js.train_feed().items()}
        params, hist, state, loss, _, _ = jstep(
            params, hist, state, batch, jnp.int32(it),
            jax.random.fold_in(js._key, it), False)
        ts.step(1)
        assert float(ts.last_loss) == pytest.approx(float(loss), rel=1e-4)
        for g in ("life_q", "stuck_bits"):
            for k in state[g]:
                assert ts.fault_state[g][k].numpy().tobytes() == \
                    np.asarray(state[g][k]).tobytes(), (it, g, k)
    assert 0.05 < ts.broken_fraction() < 1.0


def test_tiled_sweep_matches_reference():
    """3 lanes of the tiled sweep (implicit operand, packed banks, fused
    epilogue) against the reference SweepRunner (engine "jax", premat),
    the reference's tiled draw loaded with sweep_state_from_jax: banks
    identical per lane and losses within 1e-4 after every chunk."""
    bs = conv_batches(6, seed=5)
    text = conv_solver_text(adc_bits=0)
    means, stds = [250.0, 400.0, 300.0], [30.0, 150.0, 90.0]
    ref = JSweep(ref_solver(text, cycling(bs)), 3, means=means, stds=stds,
                 engine="jax", packed_state=True, dtype_policy="ternary")
    port = TSweep(port_solver(text, cycling(bs)), 3, means=means, stds=stds,
                  engine="cuda", packed_state=True, dtype_policy="ternary",
                  device="cpu", conv_im2col="implicit")
    assert port.conv_im2col_resolved == "implicit"
    assert port.fused_epilogue_resolved
    assert port._pack_spec == ref._pack_spec
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)
    convert.sweep_state_from_jax(port, np_tree(ref.params),
                                 np_tree(ref.history),
                                 np_tree(ref.fault_states))
    assert port.fault_states["life_q"]["conv1/0"].shape == (3, 3, 2, 3, 3)
    for _ in range(2):
        got = port.step(2, chunk=2)[0]
        want = np.asarray(ref.step(2, chunk=2)[0])
        np.testing.assert_allclose(got, want, rtol=1e-4)
        rb = np_tree(ref.fault_states)
        for g in ("life_q", "stuck_bits"):
            for k, v in port.fault_states[g].items():
                assert v.numpy().tobytes() == rb[g][k].tobytes(), (g, k)
    frac = port.broken_fractions()
    assert (frac > 0.02).all() and (frac < 1.0).any()


def test_sweep_lane_equals_tiled_solver_and_modes_agree():
    """Lane i of the tiled sweep equals a single-config tiled Solver from
    lane i's state; premat and implicit sweeps train byte-identically;
    the implicit operand's bytes estimate is smaller by exactly the
    patch-operand difference."""
    bs = conv_batches(4, seed=6)
    text = conv_solver_text()
    mk = lambda mode: TSweep(port_solver(text, cycling(bs)), 2,
                             engine="cuda", packed_state=True,
                             dtype_policy="ternary", device="cpu",
                             conv_im2col=mode)
    pre, imp = mk("premat"), mk("implicit")
    imp.params, imp.history = pre.params, pre.history
    imp.fault_states = {g: {k: v.clone() for k, v in grp.items()}
                        for g, grp in pre.fault_states.items()}
    solvers = []
    for i in range(2):
        s = port_solver(text, cycling(bs), hw_engine="cuda",
                        dtype_policy="ternary", fault_format="packed",
                        conv_im2col="implicit")
        s.params, s.history, s.fault_state = pre.lane_state(i)
        solvers.append(s)
    for _ in range(3):
        lp, li = pre.step(1)[0], imp.step(1)[0]
        assert lp.tobytes() == li.tobytes()
        for i, s in enumerate(solvers):
            s.step(1)
            assert float(s.last_loss) == pytest.approx(float(li[i]),
                                                       rel=1e-5)
            for k, lq in s.fault_state["life_q"].items():
                assert torch.equal(lq, imp.fault_states["life_q"][k][i])
        for k, v in pre.fault_states["life_q"].items():
            assert torch.equal(v, imp.fault_states["life_q"][k])
    assert 0 < imp.conv_patch_bytes_est() < pre.conv_patch_bytes_est()
    assert (pre.bytes_per_step_est() - imp.bytes_per_step_est()
            == pre.conv_patch_bytes_est() - imp.conv_patch_bytes_est())
    # premat: 2 lanes * M (4*3*3) * K 18 * 4 bytes; implicit: the input
    assert pre.conv_patch_bytes_est() == 2 * 36 * 18 * 4
    assert imp.conv_patch_bytes_est() == 2 * 4 * 2 * 8 * 8 * 4


def test_tiled_step_resolution_and_tilewise():
    bs = conv_batches(1)
    text = conv_solver_text()
    s = port_solver(text, cycling(bs), hw_engine="cuda",
                    dtype_policy="ternary", conv_im2col="tilewise")
    assert s._step_fn.conv_im2col_requested == "tilewise"
    assert s._step_fn.conv_im2col_resolved == "premat"
    assert "tilewise" in s._step_fn.conv_im2col_reason
    plain = s.make_train_step(hw_engine="torch", dtype_policy="ternary")
    assert plain.conv_im2col_resolved == "tilewise"
    imp = s.make_train_step(hw_engine="cuda", dtype_policy="ternary",
                            conv_im2col="implicit")
    assert imp.conv_im2col_resolved == "implicit"
    assert "backward" in imp.conv_im2col_reason
    # a net with no tiled conv: the mode is inert, and says so
    fc_only = port_solver(conv_solver_text(tiles="cells=64x64"),
                          cycling(bs), conv_im2col="implicit")
    assert fc_only._tiles_ctx() is None
    assert fc_only._step_fn.conv_im2col_resolved is None
    assert "inert" in fc_only._step_fn.conv_im2col_reason


def test_tile_spec_precedence_and_untiled_identity():
    """Constructor > proto rram_forward.tiles; a spec whose grids are all
    1x1 trains byte-identically to no spec."""
    bs = conv_batches(3, seed=7)
    text = conv_solver_text(tiles="cells=8x2")
    s = port_solver(text, cycling(bs), tile_spec="2x2")
    assert s.tile_spec.canonical() == "2x2"
    runs = []
    for spec in ("1x1", "cells=1024x1024"):
        r = port_solver(text, cycling(bs), tile_spec=spec,
                        dtype_policy="ternary")
        assert r._tiles_ctx() is None
        r.step(3)
        runs.append((float(r.last_loss), {
            k: v.numpy().tobytes() for k, v in r._flat(r.params).items()},
            r.fault_state["lifetimes"]["conv1/0"].numpy().tobytes()))
    assert runs[0] == runs[1]


GROUPED = CONV_TILE_NET.replace(
    'convolution_param { num_output: 3 kernel_size: 3',
    'convolution_param { num_output: 4 group: 2 kernel_size: 3')


@pytest.mark.parametrize("case,match,exc", [
    ("grouped", "conv1.*group", ValueError),
    ("deconvolution", "Deconvolution", KeyError),
    ("no_engine", "no fault engine", ValueError),
    ("bad_mode", "conv_im2col", ValueError),
    ("bad_spec", "tile spec", ValueError),
])
def test_tiled_refusals(case, match, exc):
    """A grouped conv is refused by name under a non-default spec (the
    port has no Deconvolution layer yet: such a net is refused as not
    ported); a spec without a fault engine, an unknown conv operand mode
    and a bad spec raise."""
    feed = cycling(conv_batches(1))
    text = conv_solver_text()
    kw = {}
    if case == "grouped":
        text = conv_solver_text(net=GROUPED)
    elif case == "deconvolution":
        text = text.replace('type: "Convolution"', 'type: "Deconvolution"')
    elif case == "no_engine":
        text = text.replace('failure_pattern { type: "gaussian"',
                            'failure_pattern { type: "none"').replace(
            "adc_bits: 3 ", "")
    elif case == "bad_mode":
        kw = {"conv_im2col": "bogus"}
    elif case == "bad_spec":
        kw = {"tile_spec": "cells=9"}
    with pytest.raises(exc, match=match):
        port_solver(text, feed, **kw)
    if case == "grouped":     # untiled, the grouped layer trains
        port_solver(text, feed, tile_spec="1x1").step(1)


def test_sweep_refuses_a_bad_conv_mode():
    s = port_solver(conv_solver_text(), cycling(conv_batches(1)))
    with pytest.raises(ValueError, match="conv_im2col"):
        TSweep(s, 2, device="cpu", dtype_policy="ternary",
               conv_im2col="bogus")


# ---------------------------------------------------------------------------
# convert: 4-D conv leaves need no new format

def test_convert_carries_conv_fault_leaves():
    """A reference fault state with 4-D conv leaves (tiled draw), f32
    and packed, loads through fault_state_from_jax dtype for dtype; the
    port's pack_state of the same f32 state gives the same bank bytes."""
    shapes = {"conv1/0": (3, 2, 3, 3), "conv1/1": (3,), "fc1/0": (2, 27)}
    sp = pb.SolverParameter()
    text_format.Parse('failure_pattern { type: "gaussian" mean: 250 '
                      'std: 30 }', sp)
    ref = jengine.init_fault_state(jax.random.PRNGKey(2), shapes,
                                   sp.failure_pattern,
                                   tiles=jmap.TileSpec.parse("cells=8x2"))
    ref = {g: {k: np.asarray(v) for k, v in grp.items()}
           for g, grp in ref.items()}
    spec = jpacked.make_pack_spec(ref, 100.0, pattern=sp.failure_pattern)
    ref_packed = jpacked.pack_state(ref, spec)
    f32 = convert.fault_state_from_jax(ref)
    packed = convert.fault_state_from_jax(ref_packed)
    for g in ref:
        for k in ref[g]:
            assert f32[g][k].numpy().tobytes() == ref[g][k].tobytes()
    tspec = tpacked.make_pack_spec(f32, 100.0, pattern=tproto.parse(
        'mean: 250 std: 30', "FailurePattern"))
    assert tspec == spec
    ours = tpacked.pack_state(f32, tspec)
    for g in ("life_q", "stuck_bits"):
        for k in ref_packed[g]:
            assert packed[g][k].dtype == ours[g][k].dtype
            assert packed[g][k].numpy().tobytes() == \
                np.asarray(ref_packed[g][k]).tobytes() == \
                ours[g][k].numpy().tobytes()
    assert convert.fault_state_to_jax(packed)["life_q"]["conv1/0"].shape \
        == (3, 2, 3, 3)
