"""The plain version of kernel B2 (the crossbar read) against the
reference package's Pallas kernels in interpret mode with the same host
noise, against its pure-JAX reference, and the straight-through VJP
against jax.vjp of crossbar_matmul.

Tolerance: the effective weights are computed with the same IEEE f32
operations in both packages (equal bit for bit); the product sums in
another order (XLA's dot vs torch.matmul), so |y - y_ref| is held to
the f32 summation bound K * 2^-24 * (|x| @ |w_eff|)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import hw_aware as jhw
from rram_caffe_simulation_tpu_torch.fault import hw_aware as thw

Q_BITS = (0, 2, 8)


def operands(rng, C, M, K, N):
    x = rng.randn(M, K).astype(np.float32)
    xs = rng.randn(C, M, K).astype(np.float32)
    w = (rng.randn(C, K, N) * 0.3).astype(np.float32)
    broken = rng.rand(C, K, N) < 0.15
    stuck = rng.choice([-1.0, 0.0, 1.0], size=(C, K, N)).astype(np.float32)
    seeds = np.arange(7, 7 + C, dtype=np.int32)
    return x, xs, w, broken, stuck, seeds


def host_eps(seed, K, N, bk=128, bn=128):
    """The reference's off-TPU noise: normal(PRNGKey(seed)) over the
    padded weight block, cut back to (K, N)."""
    Kp, Np = -(-K // bk) * bk, -(-N // bn) * bn
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (Kp, Np),
                                        jnp.float32))[:K, :N]


def assert_within_sum_bound(y, y_ref, x, w_eff):
    K = w_eff.shape[-2]
    bound = K * 2.0 ** -24 * np.matmul(np.abs(x), np.abs(w_eff)) + 1e-30
    err = np.abs(np.asarray(y, np.float64) - np.asarray(y_ref, np.float64))
    assert (err <= bound).all(), float((err - bound).max())


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("q_bits", Q_BITS)
@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_plain_b2_matches_reference_kernel_single(q_bits, sigma):
    rng = np.random.RandomState(q_bits + int(sigma * 100))
    x, _, w, broken, stuck, seeds = operands(rng, 1, 16, 40, 24)
    y_ref = jhw._pallas_forward(jnp.asarray(x), jnp.asarray(w[0]),
                                jnp.asarray(broken[0], jnp.float32),
                                jnp.asarray(stuck[0]), int(seeds[0]),
                                sigma, q_bits)
    eps = host_eps(int(seeds[0]), 40, 24)[None]
    args = (t(x), t(w), t(broken.astype(np.float32)), t(stuck), t(seeds),
            sigma, q_bits)
    y = thw.crossbar_forward_plain(*args, eps=t(eps))[0]
    w_eff = thw.effective_weight_plain(
        t(w), t(broken.astype(np.float32)), t(stuck), sigma, t(eps),
        thw.q_levels(q_bits), t(w).abs().amax(dim=(1, 2))).numpy()
    assert_within_sum_bound(y.numpy(), y_ref, x, w_eff[0])
    # the wrapper takes the plain version on CPU tensors
    torch.testing.assert_close(thw.crossbar_forward(*args, eps=t(eps))[0], y,
                               rtol=0, atol=0)


@pytest.mark.parametrize("q_bits", Q_BITS)
@pytest.mark.parametrize("x_batched", [False, True])
def test_plain_b2_matches_reference_kernel_batched(q_bits, x_batched):
    C, M, K, N = 3, 12, 72, 40
    rng = np.random.RandomState(10 + q_bits)
    x, xs, w, broken, stuck, seeds = operands(rng, C, M, K, N)
    xin = xs if x_batched else x
    sigma = 0.05
    y_ref = jhw._pallas_forward_batched(
        jnp.asarray(xin), jnp.asarray(w), jnp.asarray(broken, jnp.float32),
        jnp.asarray(stuck), jnp.asarray(seeds), sigma, q_bits)
    eps = np.stack([host_eps(int(s), K, N) for s in seeds])
    y = thw.crossbar_forward_plain(t(xin), t(w), t(broken.astype(np.float32)),
                                   t(stuck), t(seeds), sigma, q_bits,
                                   eps=t(eps))
    w_eff = thw.effective_weight_plain(
        t(w), t(broken.astype(np.float32)), t(stuck), sigma, t(eps),
        thw.q_levels(q_bits), t(w).abs().amax(dim=(1, 2))).numpy()
    assert y.shape == (C, M, N)
    assert_within_sum_bound(y.numpy(), y_ref, xin, w_eff)


@pytest.mark.parametrize("q_bits", Q_BITS)
def test_plain_b2_matches_pure_reference(q_bits):
    """sigma = 0: the pure-JAX reference (quantize_ste + perturb_weight
    + x @ w_eff) and the plain B2 give equal effective weights."""
    rng = np.random.RandomState(30 + q_bits)
    x, _, w, broken, stuck, seeds = operands(rng, 1, 10, 33, 17)
    y_ref = jhw.reference_crossbar_matmul(
        jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(broken[0]),
        jnp.asarray(stuck[0]), jax.random.PRNGKey(0), 0.0, q_bits)
    y = thw.crossbar_forward_plain(t(x), t(w), t(broken.astype(np.float32)),
                                   t(stuck), t(seeds), 0.0, q_bits)[0]
    wq = jhw.quantize_ste(jnp.asarray(w[0]), q_bits) if q_bits \
        else jnp.asarray(w[0])
    w_eff = np.asarray(jhw.perturb_weight(wq, jnp.asarray(broken[0]),
                                          jnp.asarray(stuck[0]),
                                          jax.random.PRNGKey(0), 0.0))
    w_eff_t = thw.effective_weight_plain(
        t(w), t(broken.astype(np.float32)), t(stuck), 0.0, None,
        thw.q_levels(q_bits), t(w).abs().amax(dim=(1, 2)))[0].numpy()
    np.testing.assert_array_equal(w_eff_t.view(np.uint32),
                                  w_eff.view(np.uint32))
    assert_within_sum_bound(y.numpy(), y_ref, x, w_eff)


@pytest.mark.parametrize("q_bits", Q_BITS)
def test_crossbar_vjp_matches_reference(q_bits):
    rng = np.random.RandomState(40 + q_bits)
    x, _, w, broken, stuck, _ = operands(rng, 1, 9, 20, 7)
    g = rng.randn(9, 7).astype(np.float32)
    b, s = jnp.asarray(broken[0]), jnp.asarray(stuck[0])
    _, vjp = jax.vjp(lambda a, ww: jhw.crossbar_matmul(a, ww, b, s, 3, 0.0,
                                                       q_bits),
                     jnp.asarray(x), jnp.asarray(w[0]))
    dx_ref, dw_ref = vjp(jnp.asarray(g))
    xt, wt = t(x).requires_grad_(), t(w[0]).requires_grad_()
    for use_kernel in (False, True):
        y = thw.crossbar_matmul(xt, wt, t(broken[0]), t(stuck[0]), 3, 0.0,
                                q_bits, use_kernel)
        dx, dw = torch.autograd.grad(y, (xt, wt), t(g))
        w_masked = np.where(broken[0], stuck[0],
                            np.asarray(jhw._quantize_tile(
                                jnp.asarray(w[0]),
                                jnp.max(jnp.abs(jnp.asarray(w[0]))),
                                jhw._q_levels(q_bits))) if q_bits else w[0])
        assert_within_sum_bound(dx.numpy(), dx_ref, g, w_masked.T)
        assert_within_sum_bound(dw.numpy(), dw_ref, x.T, g)
        assert (dw.numpy()[broken[0]] == 0).all()


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_ste_and_perturb_weight_bit_exact(bits):
    rng = np.random.RandomState(bits)
    v = (rng.randn(50) * 0.2).astype(np.float32)
    broken = rng.rand(50) < 0.3
    stuck = rng.choice([-1.0, 0.0, 1.0], size=50).astype(np.float32)
    q_ref = jhw.quantize_ste(jnp.asarray(v), bits)
    vt = t(v).requires_grad_()
    q = thw.quantize_ste(vt, bits)
    np.testing.assert_array_equal(q.detach().numpy().view(np.uint32),
                                  np.asarray(q_ref).view(np.uint32))
    (gq,) = torch.autograd.grad(q.sum(), vt)
    assert torch.equal(gq, torch.ones_like(gq))         # straight-through
    p_ref = jhw.perturb_weight(q_ref, jnp.asarray(broken),
                               jnp.asarray(stuck), jax.random.PRNGKey(0), 0.0)
    p = thw.perturb_weight(q, t(broken), t(stuck), None, 0.0)
    np.testing.assert_array_equal(p.detach().numpy().view(np.uint32),
                                  np.asarray(p_ref).view(np.uint32))


def test_philox_normal_moments_and_determinism():
    eps = thw.philox_normal([1, 2, 2 ** 31 - 1], 128, 256, "cpu")
    again = thw.philox_normal([1, 2, 2 ** 31 - 1], 128, 256, "cpu")
    assert torch.equal(eps, again)
    flat = eps.reshape(3, -1).double()
    assert (flat.mean(1).abs() < 0.03).all()
    assert ((flat.std(1) - 1).abs() < 0.03).all()
    r = torch.corrcoef(flat) - torch.eye(3, dtype=torch.float64)
    assert float(r.abs().max()) < 0.03
    # sigma > 0 with no host noise: the plain version draws the same
    # Philox noise the kernel draws
    w = torch.ones((1, 128, 256))
    zero = torch.zeros_like(w)
    y = thw.crossbar_forward_plain(torch.eye(128), w, zero, zero,
                                   torch.tensor([2]), 0.05, 0)
    torch.testing.assert_close((y[0] - 1) / 0.05, eps[1], rtol=0, atol=1e-5)


def test_b2_wrapper_checks():
    w = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="seeds"):
        thw.crossbar_forward(torch.zeros(5, 4), w, w, w, [1], 0.0)
    with pytest.raises(ValueError, match="x shape"):
        thw.crossbar_forward(torch.zeros(5, 3), w, w, w, [1, 2], 0.0)
    with pytest.raises(TypeError, match="float32"):
        thw.crossbar_forward(torch.zeros(5, 4, dtype=torch.float64), w, w,
                             w, [1, 2], 0.0)
    with pytest.raises(ValueError, match="bits >= 2"):
        thw.crossbar_forward(torch.zeros(5, 4), w, w, w, [1, 2], 0.0, 1)


# ---------------------------------------------------------------------------
# storage layouts: B2's wrapper reads its operands as they are stored

LAYOUTS = ("dense", "broken_bool", "stored", "unaligned", "mixed")


def laid_out(layout, x, w, broken, stuck, eps):
    """The same values as torch views in one storage layout: dense f32
    (broken 0/1 as f32); broken as bool; Caffe's stored (C, num_output,
    K) turned by view with a per-lane x as the (M, C, K) view of the
    folded activation; rows off the 16-byte grid; a mix of them."""
    def turned(a):
        return t(np.swapaxes(a, 1, 2)).transpose(1, 2)

    def folded(a):
        return t(np.swapaxes(a, 0, 1)).transpose(0, 1) if a.ndim == 3 else t(a)

    def padded(a):
        big = torch.zeros(a.shape[:-1] + (a.shape[-1] + 3,),
                          dtype=t(a).dtype)
        big[..., 1:-2] = t(a)
        return big[..., 1:-2]

    if layout == "dense":
        return t(x), t(w), t(broken.astype(np.float32)), t(stuck), t(eps)
    if layout == "broken_bool":
        return t(x), t(w), t(broken), t(stuck), t(eps)
    if layout == "stored":
        return (folded(x), turned(w), turned(broken), turned(stuck),
                turned(eps))
    if layout == "unaligned":
        return tuple(padded(a) for a in (x, w, broken, stuck, eps))
    return (t(x), turned(w), t(broken.astype(np.uint8)), t(stuck),
            turned(eps))


def test_laid_out_views_are_what_they_claim():
    rng = np.random.RandomState(0)
    _, xs, w, broken, stuck, _ = operands(rng, 2, 5, 8, 3)
    lx, lw, lb, ls, _ = laid_out("stored", xs, w, broken, stuck, w)
    assert lw.shape == (2, 8, 3) and lw.stride() == (24, 1, 8)
    assert lx.shape == (2, 5, 8) and lx.stride() == (8, 16, 1)
    assert lb.dtype == torch.bool and not lw.is_contiguous()
    assert laid_out("unaligned", xs, w, broken, stuck, w)[1].stride(1) == 6


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("q_bits", Q_BITS)
@pytest.mark.parametrize("x_batched", [False, True])
def test_b2_layouts_equal_dense_and_reference(layout, q_bits, x_batched):
    """Every layout the wrapper takes gives the dense f32 call's bits
    (forward and the scale the read used), and stays within the
    summation bound of the reference's batched kernel (interpret mode,
    host noise)."""
    C, M, K, N = 3, 12, 72, 40
    rng = np.random.RandomState(50 + q_bits)
    x, xs, w, broken, stuck, seeds = operands(rng, C, M, K, N)
    xin = xs if x_batched else x
    sigma = 0.05
    eps = np.stack([host_eps(int(s), K, N) for s in seeds])
    dense = laid_out("dense", xin, w, broken, stuck, eps)
    y0, scale0 = thw.crossbar_forward_scaled(*dense[:4], t(seeds), sigma,
                                             q_bits, eps=dense[4])
    lx, lw, lb, ls, le = laid_out(layout, xin, w, broken, stuck, eps)
    y, scale = thw.crossbar_forward_scaled(lx, lw, lb, ls, t(seeds), sigma,
                                           q_bits, eps=le)
    assert torch.equal(y, y0)
    assert torch.equal(thw.crossbar_forward(lx, lw, lb, ls, t(seeds), sigma,
                                            q_bits, eps=le), y0)
    if q_bits:
        assert torch.equal(scale, t(w).abs().amax(dim=(1, 2)))
        assert torch.equal(scale, scale0)
    else:
        assert scale is None and scale0 is None
    y_ref = jhw._pallas_forward_batched(
        jnp.asarray(xin), jnp.asarray(w), jnp.asarray(broken, jnp.float32),
        jnp.asarray(stuck), jnp.asarray(seeds), sigma, q_bits)
    w_eff = thw.effective_weight_plain(
        lw, lb, ls, sigma, le, thw.q_levels(q_bits),
        t(w).abs().amax(dim=(1, 2))).numpy()
    assert_within_sum_bound(y.numpy(), y_ref, xin, w_eff)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("q_bits", Q_BITS)
def test_b2_layouts_single_config_match_reference(layout, q_bits):
    """One config through `crossbar_matmul` on each layout (the
    InnerProduct layer hands over `.t()` views and a bool mask): equal
    to the dense call, within the bound of the reference's
    `_pallas_forward`."""
    rng = np.random.RandomState(60 + q_bits)
    x, _, w, broken, stuck, seeds = operands(rng, 1, 16, 40, 24)
    sigma = 0.05
    eps = host_eps(int(seeds[0]), 40, 24)[None]
    y_ref = jhw._pallas_forward(jnp.asarray(x), jnp.asarray(w[0]),
                                jnp.asarray(broken[0], jnp.float32),
                                jnp.asarray(stuck[0]), int(seeds[0]),
                                sigma, q_bits)
    dense = laid_out("dense", x, w, broken, stuck, eps)
    y0 = thw.crossbar_forward(*dense[:4], t(seeds), sigma, q_bits,
                              eps=dense[4])
    lx, lw, lb, ls, le = laid_out(layout, x, w, broken, stuck, eps)
    y = thw.crossbar_forward(lx, lw, lb, ls, t(seeds), sigma, q_bits, eps=le)
    assert torch.equal(y, y0)
    w_eff = thw.effective_weight_plain(
        lw, lb, ls, sigma, le, thw.q_levels(q_bits),
        t(w).abs().amax(dim=(1, 2))).numpy()
    assert_within_sum_bound(y[0].numpy(), y_ref, x, w_eff[0])
    # sigma = 0 through the autograd entry point, one lane
    y1 = thw.crossbar_matmul(lx, lw[0], lb[0], ls[0], int(seeds[0]), 0.0,
                             q_bits)
    y1d = thw.crossbar_matmul(dense[0], dense[1][0], dense[2][0],
                              dense[3][0], int(seeds[0]), 0.0, q_bits)
    assert torch.equal(y1, y1d)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("x_batched", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_crossbar_matmul_lanes_layouts_forward_and_grads(layout, x_batched,
                                                         use_kernel):
    """`crossbar_matmul_lanes` on each layout: y, dx and dw carry the
    bits of the call on dense f32 copies."""
    C, M, K, N = 3, 10, 24, 12
    rng = np.random.RandomState(70)
    x, xs, w, broken, stuck, seeds = operands(rng, C, M, K, N)
    xin = xs if x_batched else x
    g = t(rng.randn(C, M, N).astype(np.float32))
    outs = []
    for lay in ("dense", layout):
        lx, lw, lb, ls, _ = laid_out(lay, xin, w, broken, stuck, w)
        # leaves in the layout's own storage, as the solver's params are
        lx = lx.detach().requires_grad_()
        lw = lw.detach().requires_grad_()
        y = thw.crossbar_matmul_lanes(lx, lw, lb, ls, t(seeds), 0.0, 2,
                                      use_kernel)
        dx, dw = torch.autograd.grad(y, (lx, lw), g)
        outs.append((y.detach(), dx, dw))
    for a, b in zip(*outs):
        assert a.shape == b.shape
        assert torch.equal(a, b)
    assert (outs[1][2][t(broken)] == 0).all()


@pytest.mark.parametrize("C,M,K,N", [
    (512, 100, 1024, 64), (512, 100, 64, 10), (1, 100, 1024, 64),
    (1, 100, 64, 10), (4, 130, 257, 65), (64, 100, 64, 10), (1, 1, 7, 3),
    (3, 5, 0, 4), (2, 300, 5000, 200)])
def test_b2_plan_is_valid(C, M, K, N):
    bm, splits = thw.b2_plan(C, M, K, N)
    stages = -(-K // thw.B2_BK)
    assert bm in (128, 112, 32) and splits >= 1
    assert thw.b2_plan(C, M, K, N) == (bm, splits)      # shape alone
    if splits > 1:
        per = -(-stages // splits)
        assert bm == 32 and per * (splits - 1) < stages <= per * splits
    if C * -(-M // 128) * -(-N // thw.B2_BN) >= thw.B2_FILL:
        # enough 128-row tiles to fill the card: no split, and 112 rows
        # only where that costs no extra tile
        assert splits == 1 and bm in (128, 112)
        assert -(-M // bm) == -(-M // 128)
    else:
        # split-K stops about where the card is full
        blocks = C * -(-M // 32) * -(-N // thw.B2_BN)
        assert bm == 32 and blocks * (splits - 1) < thw.B2_FILL


def test_b2_plan_path_shapes():
    assert thw.b2_plan(512, 100, 1024, 64) == (112, 1)    # one tile a lane
    assert thw.b2_plan(1, 100, 1024, 64) == (32, 32)      # 128 blocks
    assert thw.b2_plan(1, 100, 64, 10) == (32, 2)


def test_b2_wrapper_checks_broken_dtype():
    w = torch.zeros((2, 4, 3))
    x = torch.zeros(5, 4)
    for ok in (torch.bool, torch.uint8, torch.float32):
        thw.crossbar_forward(x, w, w.to(ok), w, [1, 2], 0.0)
    with pytest.raises(TypeError, match="broken"):
        thw.crossbar_forward(x, w, w.to(torch.int32), w, [1, 2], 0.0)
