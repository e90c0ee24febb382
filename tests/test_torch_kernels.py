"""Kernels B1, B2 and B4 on the card against their plain PyTorch
versions.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels.py

B1 and B4 must equal their plain versions bit for bit. B2 is held to the f32
summation bound K * 2^-24 * (|x| @ |w_eff|): both compute w_eff with
the same IEEE operations and differ only in the order of the K-sum."""
import numpy as np
import pytest
import torch

from rram_caffe_simulation_tpu_torch.fault import fused as tfused
from rram_caffe_simulation_tpu_torch.fault import hw_aware as thw
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.ops import pool_backward as tpool

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from rram_caffe_simulation_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def b1_leaf(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    data = rng.randn(*shape).astype(np.float32)
    upd = (rng.randn(*shape) * 1e-3).astype(np.float32)
    sel = rng.rand(*shape)
    upd[sel < 0.2] = 0.0
    upd[(sel >= 0.2) & (sel < 0.25)] = 1e-20
    upd[(sel >= 0.25) & (sel < 0.3)] = -9.99e-21
    lq = rng.randint(-3, 4, size=shape).astype(dtype)
    bank = tpacked.pack_stuck(rng.choice([-1.0, 0.0, 1.0], size=shape))
    return data, upd, lq, bank


@pytest.mark.parametrize("mode", tfused.FUSED_MODES)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("shape", [(64, 1024), (64,), (10, 64), (10,),
                                   (4, 10, 64), (3, 7), (5, 13)])
def test_b1_kernel_equals_plain(cuda_device, shape, dtype, mode):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in b1_leaf(shape, 5, dtype)]
    kd, kl = tfused.fused_update_fail(*args, mode=mode)
    pd, pl = tfused.fused_update_fail_plain(*args, mode=mode)
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    assert torch.equal(kl, pl)


def within_sum_bound(y, y_ref, x, w_eff, slack=1.0):
    K = w_eff.shape[-2]
    bound = slack * K * 2.0 ** -24 * torch.matmul(x.abs(), w_eff.abs())
    return bool(((y - y_ref).abs() <= bound + 1e-30).all())


@pytest.mark.parametrize("q_bits", [0, 2, 8])
@pytest.mark.parametrize("C,M,K,N", [(1, 100, 1024, 64), (1, 100, 64, 10),
                                     (4, 33, 70, 19)])
def test_b2_kernel_matches_plain(cuda_device, q_bits, C, M, K, N):
    rng = np.random.RandomState(q_bits + C)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    x = t(rng.randn(M, K).astype(np.float32))
    xs = t(rng.randn(C, M, K).astype(np.float32))
    w = t((rng.randn(C, K, N) * 0.3).astype(np.float32))
    broken = t((rng.rand(C, K, N) < 0.15).astype(np.float32))
    stuck = t(rng.choice([-1.0, 0.0, 1.0], size=(C, K, N)).astype(np.float32))
    seeds = t(np.arange(7, 7 + C, dtype=np.int32))
    eps = t(rng.randn(C, K, N).astype(np.float32))
    levels = thw.q_levels(q_bits)
    for xin in (x, xs):
        for sigma, e in ((0.0, None), (0.05, eps), (0.05, None)):
            y = thw.crossbar_forward(xin, w, broken, stuck, seeds, sigma,
                                     q_bits, eps=e)
            yp = thw.crossbar_forward_plain(xin, w, broken, stuck, seeds,
                                            sigma, q_bits, eps=e)
            noise = e if e is not None else thw.philox_normal(seeds, K, N,
                                                              cuda_device)
            w_eff = thw.effective_weight_plain(
                w, broken, stuck, sigma, noise, levels,
                w.abs().amax(dim=(1, 2)))
            # in-kernel noise: libm's log/cos may differ by an ulp
            slack = 4.0 if (sigma and e is None) else 1.0
            assert within_sum_bound(y, yp, xin, w_eff, slack)


def test_b2_in_kernel_noise_statistics(cuda_device):
    K = N = 256
    x = torch.eye(K, device=cuda_device)
    w = torch.ones((3, K, N), device=cuda_device)
    zero = torch.zeros_like(w)
    seeds = torch.tensor([1, 2, 99], dtype=torch.int32, device=cuda_device)
    e1 = (thw.crossbar_forward(x, w, zero, zero, seeds, 0.05) - 1) / 0.05
    e2 = (thw.crossbar_forward(x, w, zero, zero, seeds, 0.05) - 1) / 0.05
    assert torch.equal(e1, e2)
    flat = e1.reshape(3, -1).double()
    assert bool((flat.mean(1).abs() < 0.02).all())
    assert bool(((flat.std(1) - 1).abs() < 0.02).all())
    r = torch.corrcoef(flat) - torch.eye(3, dtype=flat.dtype,
                                         device=flat.device)
    assert float(r.abs().max()) < 0.02


def test_b2_crossbar_matmul_autograd_on_card(cuda_device):
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    x = t(rng.randn(100, 64).astype(np.float32)).requires_grad_()
    w = t((rng.randn(64, 10) * 0.1).astype(np.float32)).requires_grad_()
    broken = t(rng.rand(64, 10) < 0.1)
    stuck = t(rng.choice([-1.0, 0.0, 1.0], size=(64, 10)).astype(np.float32))
    g = t(rng.randn(100, 10).astype(np.float32))
    grads = []
    for use_kernel in (True, False):
        y = thw.crossbar_matmul(x, w, broken, stuck, 3, 0.0, 2, use_kernel)
        grads.append(torch.autograd.grad(y, (x, w), g))
    for a, b in zip(*grads):
        assert torch.equal(a, b)        # the backward is the same code


@pytest.mark.parametrize("lead,hw,kernel,stride,fpad,const", [
    ((100, 32), (32, 32), (3, 3), (2, 2), (0, 1, 0, 1), None),   # pool1
    ((3, 5), (16, 16), (3, 3), (2, 2), (0, 1, 0, 1), None),
    ((4, 3), (7, 7), (3, 3), (2, 2), (1, 1, 1, 1), None),
    ((2, 3), (9, 11), (3, 2), (1, 2), (0, 1, 1, 1), None),
    ((2, 3), (12, 12), (2, 2), (2, 2), (0, 0, 0, 0), None),
    ((2, 3), (32, 32), (3, 3), (2, 2), (0, 1, 0, 1), 1.5),       # all tie
])
def test_b4_kernel_equals_plain(cuda_device, lead, hw, kernel, stride, fpad,
                                const):
    rng = np.random.RandomState(sum(hw))
    ho = (hw[0] + fpad[2] + fpad[3] - kernel[0]) // stride[0] + 1
    wo = (hw[1] + fpad[0] + fpad[1] - kernel[1]) // stride[1] + 1
    x = (np.full(lead + hw, const, np.float32) if const is not None
         else rng.randn(*lead, *hw).astype(np.float32))
    g = rng.randn(*lead, ho, wo).astype(np.float32)
    x, g = (torch.from_numpy(a).to(cuda_device) for a in (x, g))
    dk = tpool.max_pool_backward(x, g, kernel, stride, fpad)
    dp = tpool.max_pool_backward_plain(x, g, kernel, stride, fpad)
    assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
    # and through the layer's autograd.Function under RRAM_POOL_BWD=cuda
    launches = tpool.POOL_BWD_LIB.launches
    xr = x.clone().requires_grad_()
    y = tpool._MaxPool.apply(xr, kernel, stride, fpad, "cuda")
    (dx,) = torch.autograd.grad(y, xr, g)
    assert tpool.POOL_BWD_LIB.launches == launches + 1
    assert torch.equal(dx.view(torch.int32), dp.view(torch.int32))
