"""The plain version of kernel B4 (max-pool backward) against the
reference package's Pallas kernel in interpret mode, and the port's MAX
Pooling layer backward, under each RRAM_POOL_BWD choice, against the
reference layer's VJP.

Tolerance: B4's plain version adds a shared element's window cotangents
in the reference kernel's order (ascending window offset) and picks the
same first argmax, so it equals the reference kernel bit for bit. The
reference layer's own VJP (XLA's select_and_scatter) and autograd's
max-pool backward may add the up to 4 cotangents of an element that
wins several overlapping windows in another order: held to 4 f32
roundings of the sum of the addends' magnitudes."""
import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.ops import pool_backward as jpool
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.ops import pool_backward as tpool

# (H, W, kernel, stride, pads) as tests/test_pool_backward.py has them;
# the first row is CIFAR-10-quick's pool1
CASES = [
    (32, 32, (3, 3), (2, 2), ((0, 1), (0, 1))),
    (16, 16, (3, 3), (2, 2), ((0, 1), (0, 1))),
    (12, 12, (2, 2), (2, 2), ((0, 0), (0, 0))),
    (9, 11, (3, 2), (1, 2), ((1, 1), (0, 1))),
    (8, 8, (3, 3), (3, 3), ((0, 1), (0, 1))),
    (7, 7, (3, 3), (2, 2), ((1, 1), (1, 1))),
]


def out_hw(h, k, s, pads):
    return (h + pads[0] + pads[1] - k) // s + 1


def fpad(pads):
    (h_lo, h_hi), (w_lo, w_hi) = pads
    return (w_lo, w_hi, h_lo, h_hi)


def both(x, g, kernel, stride, pads):
    ref = np.asarray(jpool._pallas_bwd(jnp.asarray(g), jnp.asarray(x),
                                       kernel, stride, pads, interpret=True))
    got = tpool.max_pool_backward_plain(torch.from_numpy(x),
                                        torch.from_numpy(g), kernel, stride,
                                        fpad(pads))
    return ref, got.numpy()


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("H,W,kernel,stride,pads", CASES)
def test_plain_b4_equals_reference_kernel(H, W, kernel, stride, pads):
    rng = np.random.RandomState(H * W)
    x = rng.randn(6, 4, H, W).astype(np.float32)
    g = rng.randn(6, 4, out_hw(H, kernel[0], stride[0], pads[0]),
                  out_hw(W, kernel[1], stride[1], pads[1])).astype(np.float32)
    ref, got = both(x, g, kernel, stride, pads)
    np.testing.assert_array_equal(bits(got), bits(ref))
    # the wrapper takes the plain version on CPU tensors
    wrapped = tpool.max_pool_backward(torch.from_numpy(x), torch.from_numpy(g),
                                      kernel, stride, fpad(pads))
    np.testing.assert_array_equal(bits(wrapped.numpy()), bits(got))


def test_plain_b4_tie_goes_to_first_argmax():
    x = np.zeros((1, 1, 4, 4), np.float32)                # every window ties
    g = np.arange(1, 5, dtype=np.float32).reshape(1, 1, 2, 2)
    ref, got = both(x, g, (2, 2), (2, 2), ((0, 0), (0, 0)))
    np.testing.assert_array_equal(bits(got), bits(ref))
    expect = np.zeros((1, 1, 4, 4), np.float32)
    expect[0, 0, ::2, ::2] = [[1, 2], [3, 4]]
    np.testing.assert_array_equal(got, expect)


def test_plain_b4_constant_plane_overlapping_windows():
    """A constant plane under 3/2 windows: every window ties, its first
    element (the anchor) takes the cotangent."""
    x = np.full((2, 3, 7, 7), 0.5, np.float32)
    g = np.random.RandomState(1).randn(2, 3, 3, 3).astype(np.float32)
    ref, got = both(x, g, (3, 3), (2, 2), ((0, 0), (0, 0)))
    np.testing.assert_array_equal(bits(got), bits(ref))
    expect = np.zeros_like(x)
    expect[..., 0:5:2, 0:5:2] = g
    np.testing.assert_array_equal(got, expect)


def test_plain_b4_overlapping_windows_accumulate():
    rng = np.random.RandomState(3)
    x = -np.abs(rng.randn(1, 1, 6, 6)).astype(np.float32)
    x[0, 0, 2, 2] = 10.0                   # wins every window holding it
    g = rng.randn(1, 1, 4, 4).astype(np.float32)
    ref, got = both(x, g, (3, 3), (1, 1), ((0, 0), (0, 0)))
    np.testing.assert_array_equal(bits(got), bits(ref))
    assert got[0, 0, 2, 2] == pytest.approx(float(g[0, 0, :3, :3].sum()),
                                            rel=1e-5)


def test_b4_wrapper_checks():
    x = torch.zeros((2, 8, 8))
    with pytest.raises(TypeError, match="float32"):
        tpool.max_pool_backward(x.double(), torch.zeros((2, 4, 4)).double(),
                                (3, 3), (2, 2), (0, 1, 0, 1))
    with pytest.raises(ValueError, match="geometry gives"):
        tpool.max_pool_backward(x, torch.zeros((2, 3, 3)), (3, 3), (2, 2),
                                (0, 1, 0, 1))
    with pytest.raises(ValueError, match="do not pair"):
        tpool.max_pool_backward(x, torch.zeros((3, 4, 4)), (3, 3), (2, 2),
                                (0, 1, 0, 1))


POOL_NET = """
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 2 dim: 3 dim: %d dim: %d } } }
layer { name: "pool1" type: "Pooling" bottom: "data" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 pad: %d } }
"""


def reordering_bound(g_abs_sum):
    """|error| of an f32 sum of at most 4 addends taken in another
    order: 4 roundings of the sum of their magnitudes."""
    return 4 * 2.0 ** -24 * g_abs_sum + 1e-30


@pytest.mark.parametrize("engine", ["auto", "torch", "cuda"])
@pytest.mark.parametrize("hw,pad", [(32, 0), (7, 1)])
def test_pooling_layer_backward_matches_reference(monkeypatch, engine, hw,
                                                  pad):
    """Through the MAX Pooling layer of both packages: the forward top
    exactly, dx against the reference layer's VJP. "cuda" runs the
    wrapper, which takes the plain version on these CPU tensors."""
    monkeypatch.setenv("RRAM_POOL_BWD", engine)
    text = POOL_NET % (hw, hw, pad)
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    jnet = JNet(jmsg, pb.TRAIN)
    tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                device="cpu")
    rng = np.random.RandomState(hw + pad)
    x = rng.randn(2, 3, hw, hw).astype(np.float32)
    top = jnet.apply({}, {"data": jnp.asarray(x)})[0]["pool1"]
    G = rng.randn(*top.shape).astype(np.float32)

    def obj(a):
        return jnp.sum(jnet.apply({}, {"data": a})[0]["pool1"] * G)
    jdx = np.asarray(jax.grad(obj)(jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_()
    blobs, _ = tnet.apply({}, {"data": xt})
    np.testing.assert_array_equal(blobs["pool1"].detach().numpy(),
                                  np.asarray(top))
    (tdx,) = torch.autograd.grad((blobs["pool1"] * torch.from_numpy(G)).sum(),
                                 xt)
    tdx = tdx.numpy()
    # the positions that take a cotangent agree exactly; the values
    # within the reordering of at most 4 addends
    np.testing.assert_array_equal(tdx != 0, jdx != 0)
    err = np.abs(tdx.astype(np.float64) - jdx)
    gsum = tpool.max_pool_backward_plain(
        xt.detach(), torch.from_numpy(np.abs(G)), tnet.layers[1].kernel,
        tnet.layers[1].stride, tnet.layers[1].fpad).numpy()
    assert (err <= reordering_bound(gsum)).all()


def test_pool_engine_choice_is_checked(monkeypatch):
    monkeypatch.setenv("RRAM_POOL_BWD", "pallas")
    with pytest.raises(ValueError, match="RRAM_POOL_BWD"):
        tpool.max_pool(torch.zeros((1, 1, 4, 4)), (2, 2), (2, 2),
                       (0, 0, 0, 0))


# ---------------------------------------------------------------------------
# kernel B4's tiles (b4_plan), emulated on the CPU: the kernel's tile
# arithmetic with the plain version's arithmetic inside each tile

B4_BUDGETS = [tpool.B4_SMEM, 4096, 1024]
B4_GEOMETRIES = [c + (None,) for c in CASES] + [
    CASES[0][:5] + ("tie",), CASES[5][:5] + ("tie",),
    CASES[0][:5] + ("nan",), CASES[3][:5] + ("nan",)]


def b4_case_inputs(H, W, kernel, stride, pads, kind, seed=5):
    rng = np.random.RandomState(seed)
    ho = out_hw(H, kernel[0], stride[0], pads[0])
    wo = out_hw(W, kernel[1], stride[1], pads[1])
    if kind == "tie":
        x = np.full((2, 3, H, W), 0.75, np.float32)
    else:
        x = rng.randn(2, 3, H, W).astype(np.float32)
    if kind == "nan":         # lone NaNs, and windows with two or more
        x[rng.rand(*x.shape) < 0.05] = np.nan
        x[0, 0, :2, :2] = np.nan
    if kind == "spike":       # elements that win every window holding them
        x = -np.abs(x)
        x[rng.rand(*x.shape) < 0.05] = 10.0
    g = rng.randn(2, 3, ho, wo).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g)


def b4_tiles(H, W, Ho, Wo, kernel, stride, fp, plan, planes):
    """Every tile of kernel B4 under `plan`: (plane range, row band,
    column band), each band (lo, hi, o_lo, o_hi, x_lo, x_hi)."""
    (kh, kw), (sh, sw) = kernel, stride
    w_lo, _, h_lo, _ = fp
    rows = tpool.b4_bands(H, plan.rows, kh, sh, h_lo, Ho)
    cols = tpool.b4_bands(W, plan.cols, kw, sw, w_lo, Wo)
    for p0 in range(0, planes, plan.planes):
        for rb in rows:
            for cb in cols:
                yield (p0, min(planes, p0 + plan.planes)), rb, cb


def emulate_b4(x, g, kernel, stride, fp, plan):
    """dx tile by tile: the plain version over each tile's haloed x
    region and its windows' g, its band copied out."""
    H, W = x.shape[-2:]
    Ho, Wo = g.shape[-2:]
    (kh, kw), (sh, sw) = kernel, stride
    w_lo, _, h_lo, _ = fp
    xs, gs = x.reshape(-1, H, W), g.reshape(-1, Ho, Wo)
    dx = torch.full_like(xs, float("nan"))
    for (p0, p1), rb, cb in b4_tiles(H, W, Ho, Wo, kernel, stride, fp, plan,
                                     xs.shape[0]):
        (r0, r1, oh0, oh1, xr0, xr1), (c0, c1, ow0, ow1, xc0, xc1) = rb, cb
        band = torch.zeros((p1 - p0, r1 - r0, c1 - c0))
        if oh1 >= oh0 and ow1 >= ow0:
            top, left = xr0 - (oh0 * sh - h_lo), xc0 - (ow0 * sw - w_lo)
            sub = (left, (ow1 - ow0) * sw + kw - (xc1 - xc0) - left,
                   top, (oh1 - oh0) * sh + kh - (xr1 - xr0) - top)
            d = tpool.max_pool_backward_plain(
                xs[p0:p1, xr0:xr1, xc0:xc1], gs[p0:p1, oh0:oh1 + 1,
                                               ow0:ow1 + 1],
                kernel, stride, sub)
            a, b = max(r0, xr0), min(r1, xr1)
            c, e = max(c0, xc0), min(c1, xc1)
            if a < b and c < e:
                band[:, a - r0:b - r0, c - c0:e - c0] = \
                    d[:, a - xr0:b - xr0, c - xc0:e - xc0]
        dx[p0:p1, r0:r1, c0:c1] = band
    return dx.reshape(x.shape)


@pytest.mark.parametrize("budget", B4_BUDGETS)
@pytest.mark.parametrize("H,W,kernel,stride,pads,kind", B4_GEOMETRIES)
def test_b4_tiles_emulated_equal_plain(H, W, kernel, stride, pads, kind,
                                       budget):
    """Kernel B4's tiles, each through the plain version's arithmetic
    over its haloed x region, give the plain version's bits."""
    x, g = b4_case_inputs(H, W, kernel, stride, pads, kind)
    fp = fpad(pads)
    plan = tpool.b4_plan(H, W, *g.shape[-2:], kernel, stride, fp,
                         budget=budget)
    got = emulate_b4(x, g, kernel, stride, fp, plan)
    want = tpool.max_pool_backward_plain(x, g, kernel, stride, fp)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))


def _windows_holding(i, k, s, p, n_out):
    return [o for o in range(n_out) if o * s <= i + p < o * s + k]


@pytest.mark.parametrize("budget", B4_BUDGETS + [256])
@pytest.mark.parametrize("H,W,kernel,stride,pads", CASES + [
    (300, 300, (3, 3), (2, 2), ((0, 1), (0, 1))),
    (5, 40, (2, 3), (3, 2), ((1, 0), (2, 2)))])
def test_b4_plan_covers_each_element_once_within_halos(H, W, kernel, stride,
                                                       pads, budget):
    """Kernel B4's tiles cover every input element exactly once; every
    window holding an element of a band lies in the band's windows and
    reads only its x region; no band exceeds the plan's sizes, which
    take no more shared memory than a block has (and no more than the
    budget, unless even a band of one row of four takes more) and no more
    windows than the kernel's threads hold."""
    (kh, kw), (sh, sw) = kernel, stride
    fp = fpad(pads)
    Ho, Wo = (out_hw(H, kh, sh, pads[0]), out_hw(W, kw, sw, pads[1]))
    plan = tpool.b4_plan(H, W, Ho, Wo, kernel, stride, fp, budget=budget)
    assert plan.smem <= 232448          # a block's most on an H100
    assert plan.smem <= budget or (plan.rows, plan.cols) == (1, min(W, 4))
    assert plan.smem == tpool.b4_smem(W, plan.planes, plan.rows, plan.cols,
                                      plan.x_rows, plan.x_pitch,
                                      plan.win_rows, plan.g_pitch)
    assert plan.planes * plan.win_rows * plan.win_cols <= tpool.B4_WINDOWS
    if plan.planes > 1:
        assert (plan.rows, plan.cols) == (H, W)
    if plan.cols < W:
        assert plan.cols % 4 == 0
        assert plan.x_pitch % 4 == W % 4 and plan.g_pitch % 4 == Wo % 4
    else:
        assert (plan.x_pitch, plan.g_pitch) == (W, Wo)
    holding = [[_windows_holding(i, k, s, p, n_out) for i in range(n)]
               for n, k, s, p, n_out in ((H, kh, sh, fp[2], Ho),
                                         (W, kw, sw, fp[0], Wo))]
    seen = np.zeros((7, H, W), np.int64)
    for (p0, p1), rb, cb in b4_tiles(H, W, Ho, Wo, kernel, stride, fp, plan,
                                     7):
        seen[p0:p1, rb[0]:rb[1], cb[0]:cb[1]] += 1
        for (lo, hi, o_lo, o_hi, x_lo, x_hi), k, s, p, n, most, extent, \
                axis in ((rb, kh, sh, fp[2], H, plan.win_rows, plan.x_rows,
                          0),
                         (cb, kw, sw, fp[0], W, plan.win_cols, plan.x_pitch,
                          1)):
            assert o_hi - o_lo + 1 <= most and x_hi - x_lo <= extent
            for i in range(lo, hi):
                for o in holding[axis][i]:
                    assert o_lo <= o <= o_hi
                    assert x_lo <= max(0, o * s - p)
                    assert min(n, o * s - p + k) <= x_hi
    assert (seen == 1).all()


def emulate_b4_passes(x, g, kernel, stride, fp):
    """Kernel B4's arithmetic over whole planes: each window's first
    argmax (torch.argmax's rule), then its cotangent added at the argmax
    from 0 in f32, in pass (ki // sh) * ceil(kw / sw) + kj // sw, the
    passes ascending and the windows of a pass in reverse order (any
    order must do: no two windows of a pass meet at an element)."""
    (kh, kw), (sh, sw) = kernel, stride
    w_lo, _, h_lo, _ = fp
    H, W = x.shape[-2:]
    Ho, Wo = g.shape[-2:]
    xp = torch.nn.functional.pad(x, fp, value=float("-inf")).reshape(
        -1, H + fp[2] + fp[3], W + fp[0] + fp[1])
    gs = g.reshape(-1, Ho, Wo).numpy()
    dxp = np.zeros(xp.shape, np.float32)
    cols = -(-kw // sw)
    for p in range(xp.shape[0]):
        passes = {}
        for oh in range(Ho):
            for ow in range(Wo):
                win = xp[p, oh * sh:oh * sh + kh, ow * sw:ow * sw + kw]
                ki, kj = divmod(int(torch.argmax(win.reshape(-1))), kw)
                passes.setdefault((ki // sh) * cols + kj // sw, []).append(
                    (oh * sh + ki, ow * sw + kj, gs[p, oh, ow]))
        for q in sorted(passes):
            hits = [(r, c) for r, c, _ in passes[q]]
            assert len(set(hits)) == len(hits), "two windows of a pass meet"
            for r, c, v in reversed(passes[q]):
                dxp[p, r, c] = np.float32(dxp[p, r, c] + v)
    return dxp[:, h_lo:h_lo + H, w_lo:w_lo + W].reshape(x.shape)


@pytest.mark.parametrize("H,W,kernel,stride,pads,kind", [
    c + ("spike",) for c in CASES] + [
    (6, 6, (3, 3), (1, 1), ((0, 0), (0, 0)), "spike"),
    (9, 9, (2, 3), (1, 1), ((1, 0), (1, 1)), "spike"),
    CASES[0][:5] + ("nan",), CASES[5][:5] + ("tie",)])
def test_b4_pass_order_equals_plain(H, W, kernel, stride, pads, kind):
    """Kernel B4's passes: the cotangents of windows that share their
    argmax (a spike wins every window holding it: up to 9 at k3 s1) add
    in the plain version's order, so the bits equal it."""
    x, g = b4_case_inputs(H, W, kernel, stride, pads, kind)
    fp = fpad(pads)
    got = emulate_b4_passes(x, g, kernel, stride, fp)
    want = tpool.max_pool_backward_plain(x, g, kernel, stride, fp)
    np.testing.assert_array_equal(bits(got), bits(want.numpy()))
