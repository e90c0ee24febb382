"""Kernel B3's plain version (fault/hw_aware.py
`crossbar_conv_forward_plain`, the tiled read of a convolution with its
operand gathered implicitly) against the reference package's
`_pallas_forward_implicit[_batched]` in interpret mode, its wrapper
`crossbar_conv_matmul_lanes` on every layout the Convolution layer hands
over (forward, dx, dw against the dense call; dyadic inputs against the
reference's eager read), and `b3_plan`. The tolerances are those of
tests/test_torch_tiles.py, whose helpers these tests share."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import hw_aware as jhw
from rram_caffe_simulation_tpu.fault import mapping as jmap
from rram_caffe_simulation_tpu_torch.fault import hw_aware as thw
from rram_caffe_simulation_tpu_torch.fault import mapping as tmap

from test_torch_crossbar import host_eps, t
from test_torch_tiles import (adc_steps, dyadic, plain_weff, tiled_bound,
                              weights)


@pytest.mark.parametrize("q_bits,adc", [(0, 0), (3, 3)])
@pytest.mark.parametrize("sigma", [0.0, 0.05])
@pytest.mark.parametrize("lanes", ["single", "shared", "per_lane"])
def test_b3_plain_matches_reference_implicit_kernel(q_bits, sigma, lanes,
                                                   adc):
    """crossbar_conv_forward_plain against the reference's
    `_pallas_forward_implicit[_batched]` in interpret mode, on a strided,
    padded, dilated geometry with ragged tiles; exact as in the B2t
    case."""
    C = 1 if lanes == "single" else 3
    geom = (3, 3, 2, 1, 1, 2, 1, 2)
    xs = (2, 3, 7, 8)
    K, N = 27, 5
    tiles = (7, 2, adc)
    rng = np.random.RandomState(3 + q_bits + C)
    dyad = sigma == 0.0
    exact = dyad and not adc
    x = dyadic(rng, (C,) + xs) if dyad else rng.randn(C, *xs).astype(
        np.float32)
    xin = x if lanes == "per_lane" else x[0]
    w, broken, stuck = weights(rng, C, K, N, dyad)
    seeds = np.arange(5, 5 + C, dtype=np.int32)
    if lanes == "single":
        y_ref = np.asarray(jhw._pallas_forward_implicit(
            jnp.asarray(xin), jnp.asarray(w[0]), jnp.asarray(broken[0]),
            jnp.asarray(stuck[0]), int(seeds[0]), sigma, q_bits, tiles,
            geom))[None]
    else:
        y_ref = np.asarray(jhw._pallas_forward_implicit_batched(
            jnp.asarray(xin), jnp.asarray(w), jnp.asarray(broken),
            jnp.asarray(stuck), jnp.asarray(seeds), sigma, q_bits, tiles,
            geom))
    eps = (np.stack([host_eps(int(s), K, N, tiles[0], tiles[1])
                     for s in seeds]) if sigma else None)
    args = (t(xin), t(w), t(broken), t(stuck), t(seeds), sigma, q_bits,
            tiles, geom)
    y = thw.crossbar_conv_forward_plain(
        *args, eps=None if eps is None else t(eps)).numpy()
    assert thw.crossbar_conv_forward(
        *args, eps=None if eps is None else t(eps)).numpy().tobytes() \
        == y.tobytes()
    if exact:
        assert y.tobytes() == y_ref.tobytes()
    else:
        rows = tmap.conv_patch_rows(t(xin), geom).numpy()
        rows = np.broadcast_to(rows, (C,) + rows.shape[-2:])
        w_eff = plain_weff(w, broken, stuck, seeds, sigma, q_bits, eps)
        tiled_bound(y, y_ref, np.abs(rows), np.abs(w_eff),
                    adc_steps(rows, w_eff, tiles), tiles)


# ---------------------------------------------------------------------------
# B3's wrapper on every layout ops/vision.py hands over, and its plan

B3_LAYOUTS = ("dense", "broken_bool", "broken_uint8", "stored", "laned")
B3_GEOM = (3, 3, 2, 1, 1, 2, 1, 2)       # strided, padded, dilated
B3_X = (2, 3, 7, 8)                      # one lane's (N, ch, H, W)


def conv_laid_out(layout, x, w, broken, stuck):
    """The same conv operand values as torch views in one layout: dense
    f32 (broken 0/1 as f32); broken bool or uint8; w, stuck and broken as
    the `to_im2col` view of Caffe's stored (C, C_out, ch, kh, kw) weight;
    a per-lane x as the (C, N, ch, H, W) view of the laned (N, C*ch, H, W)
    activation, broken uint8 (x shared: as dense)."""
    def stored(a):
        C, K, N = a.shape
        return tmap.to_im2col(t(np.swapaxes(a, 1, 2)).reshape(
            C, N, B3_X[1], B3_GEOM[0], B3_GEOM[1]), 4)

    if layout == "dense":
        return t(x), t(w), t(broken.astype(np.float32)), t(stuck)
    if layout == "broken_bool":
        return t(x), t(w), t(broken), t(stuck)
    if layout == "broken_uint8":
        return t(x), t(w), t(broken.astype(np.uint8)), t(stuck)
    if layout == "stored":
        return t(x), stored(w), stored(broken), stored(stuck)
    lx = t(x)
    if x.ndim == 5:
        C, n = x.shape[:2]
        lx = t(np.swapaxes(x, 0, 1).reshape(n, C * x.shape[2], *x.shape[3:])
               ).reshape(n, C, *x.shape[2:]).transpose(0, 1)
    return lx, t(w), t(broken.astype(np.uint8)), t(stuck)


def conv_operands(rng, C, dyad):
    K, N = B3_X[1] * B3_GEOM[0] * B3_GEOM[1], 5
    x = dyadic(rng, (C,) + B3_X) if dyad else rng.randn(
        C, *B3_X).astype(np.float32)
    w, broken, stuck = weights(rng, C, K, N, dyad)
    return x, w, broken > 0, stuck, np.arange(5, 5 + C, dtype=np.int32)


@pytest.mark.parametrize("layout", B3_LAYOUTS)
@pytest.mark.parametrize("x_batched", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_b3_matmul_lanes_layouts_forward_and_grads(layout, x_batched,
                                                   use_kernel):
    """`crossbar_conv_matmul_lanes` on each layout the Convolution layer
    hands over: y, dx and dw carry the bits of the call on dense f32
    copies."""
    C, tiles = 3, (7, 2, 3)
    rng = np.random.RandomState(95)
    x, w, broken, stuck, seeds = conv_operands(rng, C, False)
    xin = x if x_batched else x[0]
    g = t(rng.randn(C, 64, 5).astype(np.float32))
    outs = []
    for lay in ("dense", layout):
        lx, lw, lb, ls = conv_laid_out(lay, xin, w, broken, stuck)
        lx = lx.detach().requires_grad_()
        lw = lw.detach().requires_grad_()
        y = thw.crossbar_conv_matmul_lanes(lx, lw, lb, ls, t(seeds), 0.0, 2,
                                           tiles, B3_GEOM, use_kernel)
        dx, dw = torch.autograd.grad(y, (lx, lw), g)
        outs.append((y.detach(), dx, dw))
    for a, b in zip(*outs):
        assert a.shape == b.shape
        assert torch.equal(a, b)
    assert (outs[1][2][t(broken)] == 0).all()


@pytest.mark.parametrize("layout", B3_LAYOUTS)
@pytest.mark.parametrize("lanes", ["single", "shared", "per_lane"])
@pytest.mark.parametrize("adc", [3, 8])
def test_b3_layouts_equal_reference(layout, lanes, adc):
    """`crossbar_conv_matmul_lanes` on each layout, dyadic inputs at ADC
    3 and 8 bits: bit for bit the reference's eager read (its patch rows,
    `_w_eff`, `tiled_crossbar_matmul`), and within the tiled bound of its
    `_pallas_forward_implicit[_batched]` in interpret mode, whose jitted
    ADC step max * fl(1/levels) can move a level (module docstring)."""
    C = 1 if lanes == "single" else 3
    tiles = (7, 2, adc)
    rng = np.random.RandomState(60 + adc + C)
    x, w, broken, stuck, seeds = conv_operands(rng, C, True)
    xin = x if lanes == "per_lane" else x[0]
    lx, lw, lb, ls = conv_laid_out(layout, xin, w, broken, stuck)
    with torch.no_grad():
        y = thw.crossbar_conv_matmul_lanes(lx, lw, lb, ls, t(seeds), 0.0, 2,
                                           tiles, B3_GEOM).numpy()
    bf = broken.astype(np.float32)
    eager = []
    for c in range(C):
        rows = jmap.conv_patch_rows(jnp.asarray(x[c] if lanes == "per_lane"
                                                else xin), B3_GEOM)
        wc = jnp.asarray(w[c])
        w_eff = jhw._w_eff(wc, jnp.asarray(bf[c]), jnp.asarray(stuck[c]),
                           0.0, None, thw.q_levels(2),
                           jnp.max(jnp.abs(wc)))
        eager.append(np.asarray(jhw.tiled_crossbar_matmul(
            rows, w_eff, tiles[0], tiles[1], adc)))
    assert y.tobytes() == np.stack(eager).tobytes()
    if lanes == "single":
        y_ref = np.asarray(jhw._pallas_forward_implicit(
            jnp.asarray(xin), jnp.asarray(w[0]), jnp.asarray(bf[0]),
            jnp.asarray(stuck[0]), int(seeds[0]), 0.0, 2, tiles,
            B3_GEOM))[None]
    else:
        y_ref = np.asarray(jhw._pallas_forward_implicit_batched(
            jnp.asarray(xin), jnp.asarray(w), jnp.asarray(bf),
            jnp.asarray(stuck), jnp.asarray(seeds), 0.0, 2, tiles, B3_GEOM))
    rows = tmap.conv_patch_rows(t(xin), B3_GEOM).numpy()
    rows = np.broadcast_to(rows, (C,) + rows.shape[-2:])
    w_eff = plain_weff(w, bf, stuck, seeds, 0.0, 2, None)
    tiled_bound(y, y_ref, np.abs(rows), np.abs(w_eff),
                adc_steps(rows, w_eff, tiles), tiles)


B3_SHAPES = [  # C, M, K, N, bk
    (1, 25600, 800, 32, 128), (64, 25600, 800, 32, 128),
    (1, 6400, 800, 64, 128), (64, 6400, 800, 64, 128),
    (1, 64, 27, 5, 7), (4, 64, 27, 5, 7), (3, 6400, 75, 96, 16),
    (2, 100, 300, 33, 128), (1, 3000, 600, 128, 256),
    (512, 1024, 2304, 384, 128), (1, 1, 1, 1, 1), (4, 900, 150, 20, 64)]


@pytest.mark.parametrize("C,M,K,N,bk", B3_SHAPES)
def test_b3_plan_is_valid(C, M, K, N, bk):
    bn = thw.b3_plan(N)
    assert bn in (32, 64) and thw.B3_ROWS[bn] * bn == 8192  # 8 columns a
    # thread either way; the column tile pads N less, 64 on a tie
    assert -(-N // bn) * bn <= -(-N // (96 - bn)) * (96 - bn)
    if bn == 32:
        assert -(-N // 32) * 32 < -(-N // 64) * 64
    assert -(-M // thw.B3_ROWS[bn]) <= 65535            # the grid's rows
    assert C * -(-K // bk) < 2 ** 31


def test_b3_plan_path_shapes():
    # conv2 (N = 32) on 256 x 32 tiles, conv3 (N = 64) on 128 x 64 ones
    assert thw.b3_plan(32) == 32 and thw.B3_ROWS[32] == 256
    assert thw.b3_plan(64) == 64 and thw.B3_ROWS[64] == 128
    assert [thw.b3_plan(n) for n in (1, 5, 33, 65, 96, 97, 128)] == \
        [32, 32, 64, 32, 32, 64, 64]
