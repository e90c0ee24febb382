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
