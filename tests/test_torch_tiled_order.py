"""The plain tiled crossbar read in the kernels' k order
(rram_caffe_simulation_tpu_torch/fault/hw_aware.py `ordered_tile_partials`):
each K-tile's partial product summed as kernels B2t and B3 sum it
(csrc/crossbar.cu: 32-deep stages, two chains of correctly rounded
float32 fused multiply-adds, group 0 over the first 16 k of each stage and
group 1 over the last, then group 0's + group 1's), held here to a
pure-Python model built from exact fractions and round-to-nearest-even
to float32. On the card the plain read uses it, so kernel and plain
agree bit for bit (chip_smoke.py phase 9, phase 20 (a)); on the CPU the
plain read keeps torch.matmul, the order held against the reference.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest
import torch

from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
from rram_caffe_simulation_tpu_torch.fault.mapping import (conv_geom,
                                                           conv_patch_rows)

F32_MAX = Fraction(float(np.finfo(np.float32).max))


def f32_round(q: Fraction) -> Fraction:
    """q rounded to the nearest float32, ties to even (subnormals
    included), as an exact fraction."""
    if q == 0:
        return Fraction(0)
    sign, a = (1, q) if q > 0 else (-1, -q)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    if Fraction(2) ** (e + 1) <= a:
        e += 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(a, ulp)
    if rem * 2 > ulp or (rem * 2 == ulp and n % 2):
        n += 1
    r = n * ulp
    assert r <= F32_MAX
    return sign * r


def model_partials(x: np.ndarray, w: np.ndarray, bk: int) -> np.ndarray:
    """(gk, M, N) float32 partials of x (M, K) @ w (K, N) per K-tile of
    bk in the kernels' order, exactly: position j of a tile (j = k - the
    tile's first k) feeds group (j % 32) // 16, each group's fmaf chain
    runs j ascending, then group 0's + group 1's."""
    M, K = x.shape
    N = w.shape[1]
    xf = [[Fraction(float(v)) for v in row] for row in x]
    wf = [[Fraction(float(v)) for v in row] for row in w]
    gk = -(-K // bk)
    out = np.zeros((gk, M, N), np.float32)
    for kt in range(gk):
        ks = range(kt * bk, min(kt * bk + bk, K))
        for m in range(M):
            for n in range(N):
                acc = [Fraction(0), Fraction(0)]
                for j, k in enumerate(ks):
                    g = (j % 32) // 16
                    acc[g] = f32_round(acc[g] + xf[m][k] * wf[k][n])
                out[kt, m, n] = float(f32_round(acc[0] + acc[1]))
    return out


def ordered(x, w, bk):
    return hw.ordered_tile_partials(torch.from_numpy(x),
                                    torch.from_numpy(w), bk).numpy()


def same_bits(a, b) -> bool:
    """Equal values (a -0 from zero padding equals +0)."""
    return a.shape == b.shape and bool(np.array_equal(a, b))


@pytest.mark.parametrize("M,K,N,bk", [
    (3, 70, 4, 32),     # stages of 32, a short last tile
    (2, 50, 3, 7),      # tiles below one group: group 1 all padding
    (2, 100, 3, 96),    # 96-deep tiles, a last tile of 4
    (1, 130, 2, 128),   # a 128-deep tile, then 2
    (4, 40, 5, 20),     # 20-deep tiles: 16 + 4 a stage
    (2, 64, 3, 128),    # one tile shorter than bk
])
def test_ordered_partials_equal_the_kernel_order_model(M, K, N, bk):
    rng = np.random.default_rng(M * 1000 + K + bk)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    assert same_bits(ordered(x, w, bk), model_partials(x, w, bk))


def test_order_is_not_matmuls_on_random_inputs():
    """The model is a real constraint: on random inputs some partial of
    the kernels' order differs from an ascending float32 sum."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 6)).astype(np.float32)
    got = ordered(x, w, 64)[0]
    serial = np.zeros((4, 6), np.float32)
    for k in range(64):
        serial = (serial + x[:, k:k + 1] * w[k:k + 1]).astype(np.float32)
    assert not np.array_equal(got, serial)


def test_ordered_partials_over_lanes_and_row_chunks(monkeypatch):
    """Lanes (x per lane, x shared) and chunks of rows give every lane's
    partials of the one-lane call."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 9, 45)).astype(np.float32)
    w = rng.standard_normal((3, 45, 5)).astype(np.float32)
    one = np.stack([ordered(x[c], w[c], 20) for c in range(3)])
    monkeypatch.setattr(hw, "ORDERED_ELEMS", 64)      # 1-row chunks
    assert same_bits(ordered(x, w, 20), one)
    shared = np.stack([ordered(x[0], w[c], 20) for c in range(3)])
    assert same_bits(ordered(x[0], w, 20), shared)
    assert same_bits(one[1], model_partials(x[1], w[1], 20))


def _f32(v) -> np.float32:
    return np.float32(v)


def test_midpoint_sums_round_correctly():
    """Crafted chains whose float64 sum lands exactly on a float32
    midpoint while the exact sum does not: one float64 add then a
    float32 rounding gives the wrong neighbour; the fma is right."""
    one_up = _f32(1 + 2.0 ** -23)                  # odd last bit
    tiny = _f32(2.0 ** -24 * (1 - 2.0 ** -23))
    # acc = 1 + 2^-23, then + (1 + 2^-23) * 2^-24 (1 - 2^-23): the exact
    # sum is 1 + 3 * 2^-24 - 2^-70, just below the midpoint
    x = np.array([[one_up, one_up], [-one_up, -one_up]], np.float32)
    w = np.array([[1.0], [tiny]], np.float32)
    # both k in group 0 (one chain): k 0 and k 1
    got = ordered(x, w, 32)
    want = model_partials(x, w, 32)
    assert same_bits(got, want)
    assert got[0, 0, 0] == one_up and got[0, 1, 0] == -one_up
    naive = np.float32(np.float64(one_up) + np.float64(one_up)
                       * np.float64(tiny))
    assert naive != one_up          # the float64 shortcut would be off
    # fma_f32 itself against prng.fma on the crafted and random values
    acc = torch.tensor([one_up, -one_up, 1.0, 3.0], dtype=torch.float32)
    a = torch.tensor([one_up, one_up, 2.0, -1.5], dtype=torch.float64)
    b = torch.tensor([tiny, -tiny, 0.25, 2.0], dtype=torch.float64)
    assert torch.equal(hw.fma_f32(acc, a, b), prng.fma(a, b, acc))
    g = torch.Generator().manual_seed(3)
    acc = torch.randn(100_000, generator=g)
    a = torch.randn(100_000, generator=g).double()
    b = (torch.randn(100_000, generator=g) * 1e-3).float().double()
    assert torch.equal(hw.fma_f32(acc, a, b), prng.fma(a, b, acc))


def test_subnormal_chains_round_correctly():
    """Products below float32's normal range: the exact fma path."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 40)) * 2.0 ** -70).astype(np.float32)
    w = (rng.standard_normal((40, 3)) * 2.0 ** -65).astype(np.float32)
    assert not hw._subnormal_free(torch.from_numpy(x))
    assert same_bits(ordered(x, w, 32), model_partials(x, w, 32))


@pytest.mark.parametrize("bk", [7, 32, 128])
def test_ordered_equals_matmul_on_dyadic_inputs(bk):
    """Where every sum is exact (multiples of 2^-4, small), any order
    gives the same partials: the twin equals torch.matmul's."""
    g = torch.Generator().manual_seed(bk)
    x = torch.randint(-16, 17, (2, 30, 300), generator=g).float() / 16
    w = torch.randint(-12, 13, (2, 300, 40), generator=g).float() / 16
    assert torch.equal(hw.ordered_tile_partials(x, w, bk),
                       hw.matmul_tile_partials(x, w, bk))


def test_ordered_gradient_is_the_matmul_forms():
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 7, 50, generator=g)
    w = torch.randn(2, 50, 6, generator=g)
    cot = torch.randn(2, 2, 7, 6, generator=g)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    hw.OrderedPartials.apply(xa, wa, 32).backward(cot)
    hw.matmul_tile_partials(xb, wb, 32).backward(cot)
    assert torch.equal(xa.grad, xb.grad) and torch.equal(wa.grad, wb.grad)
    # one operand alone
    wc = w.clone().requires_grad_()
    hw.OrderedPartials.apply(x, wc, 32).backward(cot)
    assert torch.equal(wc.grad, wb.grad)


def _tiled_from_partials(parts, bn, adc):
    """The tiled read from given (gk, M, N) partials: each tile's ADC,
    then the ascending sum over the K-tiles."""
    N = parts.shape[-1]
    cols = []
    for n0 in range(0, N, bn):
        acc = None
        for kt in range(parts.shape[0]):
            q = hw.adc_read(parts[kt, :, n0:n0 + bn], adc)
            acc = q if acc is None else acc + q
        cols.append(acc)
    return torch.cat(cols, -1)


def test_plain_tiled_read_follows_the_kernel_order_where_routed(
        monkeypatch):
    """The plain tiled read (fc and conv, every conv operand) built from
    the kernel-order partials where `kernel_order` asks for them (the
    kernels' plain versions on CUDA tensors), ADC included, also with
    its K-tiles taken one group at a time; torch.matmul's partials
    otherwise."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 70)).astype(np.float32)
    w = (rng.standard_normal((70, 5)) * 0.3).astype(np.float32)
    tiles = (32, 3, 4)
    cpu = hw.tiled_crossbar_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   *tiles)
    want_cpu = _tiled_from_partials(hw.matmul_tile_partials(
        torch.from_numpy(x), torch.from_numpy(w), 32), 3, 4)
    assert torch.equal(cpu, want_cpu)
    want = _tiled_from_partials(torch.from_numpy(model_partials(x, w, 32)),
                                3, 4)
    got = hw.tiled_crossbar_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   *tiles, kernel_order=True)
    assert torch.equal(got, want)
    # a conv read: every operand mode gives the patch rows' partials
    geom = conv_geom((3, 3), (1, 1), (1, 1), (1, 1))
    xc = torch.from_numpy(rng.standard_normal((2, 3, 5, 5)).astype(
        np.float32))
    wc = torch.from_numpy((rng.standard_normal((27, 4)) * 0.3).astype(
        np.float32))
    rows = conv_patch_rows(xc, geom)
    want_c = _tiled_from_partials(hw.ordered_tile_partials(rows, wc, 20),
                                  4, 3)
    for op in hw.CONV_OPERANDS:
        got = hw.tiled_crossbar_matmul_slabs(
            hw.conv_operand_slabs(xc, geom, op), wc, 20, 4, 3,
            kernel_order=True)
        assert torch.equal(got, want_c), op
    # an operand slab above ORDERED_ELEMS: one K-tile at a time, same bits
    monkeypatch.setattr(hw, "ORDERED_ELEMS", 1)
    got = hw.tiled_crossbar_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   *tiles, kernel_order=True)
    assert torch.equal(got, want)
