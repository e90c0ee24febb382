"""Each ported layer against the reference package's, through a one-layer
net in both packages: the same params (carried with convert.py), the
same numpy inputs, the forward top and the gradients of sum(top * G)
with respect to the params and the input.

Tolerances: elementwise layers (ReLU, MAX pooling, the loss's masked
terms) match exactly; anything that sums (conv, AVE pooling,
InnerProduct, the softmax normalizer) is held to rtol 2e-5 / atol 1e-6
for f32 summation order (XLA vs ATen kernels)."""
import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.net import Net as TNet

RTOL, ATOL = 2e-5, 1e-6


def net_text(in_shape, layer, extra_inputs=(), extra_tops=()):
    dims = " ".join(f"dim: {d}" for d in in_shape)
    shapes = f"shape {{ {dims} }}" + "".join(
        " shape { " + " ".join(f"dim: {d}" for d in s) + " }"
        for s in extra_inputs)
    tops = 'top: "data"' + "".join(f' top: "{n}"' for n in extra_tops)
    return (f'name: "t" layer {{ name: "in" type: "Input" {tops} '
            f'input_param {{ {shapes} }} }}\n' + layer)


def run_both(text, inputs, seed=0, crossbar=None, adc_bits=0,
             grad_top=None):
    """(reference blobs, port blobs, reference grads, port grads);
    grads are of sum(top * G) for the layer's first top (`grad_top`),
    w.r.t. every param and the "data" input."""
    jp_msg = pb.NetParameter()
    text_format.Parse(text, jp_msg)
    jnet = JNet(jp_msg, pb.TRAIN)
    tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                device="cpu")
    tparams = tnet.init(prng.PRNGKey(seed))
    jparams = {k: [jnp.asarray(a) for a in v]
               for k, v in convert.params_to_jax(tparams).items()}
    jblobs, _ = jnet.apply(jparams, {k: jnp.asarray(v)
                                     for k, v in inputs.items()},
                           crossbar=crossbar and crossbar[0],
                           adc_bits=adc_bits)
    leaves = {k: [p.requires_grad_() for p in v] for k, v in tparams.items()}
    tin = {k: torch.from_numpy(v).requires_grad_(v.dtype == np.float32)
           for k, v in inputs.items()}
    tblobs, _ = tnet.apply(leaves, tin, crossbar=crossbar and crossbar[1],
                           adc_bits=adc_bits)
    if grad_top is None:
        return jblobs, tblobs, None, None
    G = np.asarray(np.random.RandomState(seed + 1).randn(
        *np.shape(jblobs[grad_top])), np.float32)

    def obj(p, x):
        b, _ = jnet.apply(p, {**{k: jnp.asarray(v) for k, v in
                                 inputs.items()}, "data": x},
                          crossbar=crossbar and crossbar[0],
                          adc_bits=adc_bits)
        return jnp.sum(b[grad_top] * G)
    jg = jax.grad(obj, argnums=(0, 1))(jparams, jnp.asarray(inputs["data"]))
    flat = [p for v in leaves.values() for p in v]
    tg = torch.autograd.grad((tblobs[grad_top] * torch.from_numpy(G)).sum(),
                             flat + [tin["data"]])
    jflat = [g for k in leaves for g in jg[0][k]] + [jg[1]]
    return jblobs, tblobs, jflat, list(tg)


def close(a, b, exact=False):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def check(text, inputs, top, exact=False, **kw):
    jb, tb, jg, tg = run_both(text, inputs, grad_top=top, **kw)
    close(jb[top], tb[top], exact)
    for a, b in zip(jg, tg):
        close(a, b, exact)


def x_in(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("conv", [
    "num_output: 4 kernel_size: 3 stride: 2 pad: 1",
    "num_output: 4 kernel_size: 5 pad: 2",
    "num_output: 4 kernel_h: 3 kernel_w: 2 stride_h: 1 stride_w: 2 group: 2",
    "num_output: 3 kernel_size: 3 bias_term: false dilation: 2",
])
def test_convolution(conv):
    layer = ('layer { name: "c" type: "Convolution" bottom: "data" top: "c" '
             f'convolution_param {{ {conv} weight_filler {{ type: "gaussian" '
             'std: 0.3 } bias_filler { type: "constant" value: 0.1 } } }')
    check(net_text((2, 4, 9, 9), layer), {"data": x_in((2, 4, 9, 9))}, "c")


@pytest.mark.parametrize("pool", ["MAX", "AVE"])
@pytest.mark.parametrize("geom,hw", [
    ("kernel_size: 3 stride: 2", 32),   # CIFAR-10-quick's pools: ragged
    ("kernel_size: 3 stride: 2", 8),    # ceil edge, clipped window
    ("kernel_size: 3 stride: 2 pad: 1", 8),   # pad + clipped divisor
    ("kernel_size: 2 stride: 2", 7),
    ("kernel_size: 3 stride: 1 pad: 1", 5),
])
def test_pooling_caffe_ceil_mode(pool, geom, hw):
    layer = ('layer { name: "p" type: "Pooling" bottom: "data" top: "p" '
             f'pooling_param {{ pool: {pool} {geom} }} }}')
    shape = (2, 3, hw, hw)
    jb, tb, jg, tg = run_both(net_text(shape, layer), {"data": x_in(shape)},
                              grad_top="p")
    close(jb["p"], tb["p"], exact=pool == "MAX")
    close(jg[-1], tg[-1], exact=pool == "MAX")


@pytest.mark.parametrize("slope", ["", "relu_param { negative_slope: 0.1 }"])
def test_relu(slope):
    layer = ('layer { name: "r" type: "ReLU" bottom: "data" top: "r" '
             f'{slope} }}')
    check(net_text((3, 5, 4), layer), {"data": x_in((3, 5, 4))}, "r",
          exact=True)


IP = ('layer {{ name: "fc" type: "InnerProduct" bottom: "data" top: "fc" '
      'inner_product_param {{ num_output: 6 {extra} weight_filler {{ '
      'type: "gaussian" std: 0.3 }} bias_filler {{ type: "constant" '
      'value: 0.2 }} }} }}')


@pytest.mark.parametrize("extra", ["", "transpose: true", "axis: 2"])
def test_inner_product(extra):
    check(net_text((4, 3, 2, 2), IP.format(extra=extra)),
          {"data": x_in((4, 3, 2, 2))}, "fc")


def test_inner_product_adc_branch():
    check(net_text((4, 12), IP.format(extra="")), {"data": x_in((4, 12))},
          "fc", adc_bits=4)


@pytest.mark.parametrize("q_bits", [0, 2, 8])
@pytest.mark.parametrize("transpose", [False, True])
def test_inner_product_crossbar_branch(q_bits, transpose):
    """The layer's crossbar read: broken/stuck in stored layout, read on
    the (K, N) view, through the reference's Pallas kernel (interpret)
    and the port's crossbar_matmul (plain forward on CPU)."""
    text = net_text((5, 12), IP.format(extra="transpose: true"
                                       if transpose else ""))
    shape = (12, 6) if transpose else (6, 12)
    rng = np.random.RandomState(q_bits)
    broken = rng.rand(*shape) < 0.2
    stuck = rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
    for use_kernel in (False, True):
        cb = ({"fc": (jnp.asarray(broken), jnp.asarray(stuck), 5, 0.0,
                      q_bits)},
              {"fc": (torch.from_numpy(broken), torch.from_numpy(stuck), 5,
                      0.0, q_bits, use_kernel)})
        jb, tb, jg, tg = run_both(text, {"data": x_in((5, 12))},
                                  crossbar=cb, grad_top="fc")
        close(jb["fc"], tb["fc"])
        for a, b in zip(jg, tg):
            close(a, b)


LOSS = ('layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "data" '
        'bottom: "label" top: "loss" {extra} }}')


@pytest.mark.parametrize("extra", [
    "", "loss_param { ignore_label: 2 }",
    "loss_param { ignore_label: 1 normalization: FULL }",
    "loss_param { normalization: BATCH_SIZE }",
    "loss_param { normalize: false }",
])
def test_softmax_with_loss(extra):
    labels = np.array([0, 2, 1, 3, 2, 0], np.float32)
    text = net_text((6, 4), LOSS.format(extra=extra), extra_inputs=[(6,)],
                    extra_tops=["label"])
    check(text, {"data": x_in((6, 4)) * 3, "label": labels}, "loss")


def test_softmax_with_loss_spatial():
    labels = np.random.RandomState(1).randint(0, 3, (2, 4, 5)).astype(
        np.float32)
    text = net_text((2, 3, 4, 5), LOSS.format(extra=""),
                    extra_inputs=[(2, 4, 5)], extra_tops=["label"])
    check(text, {"data": x_in((2, 3, 4, 5)), "label": labels}, "loss")


@pytest.mark.parametrize("extra", [
    "", "accuracy_param { top_k: 2 }",
    "accuracy_param { ignore_label: 1 }",
])
def test_accuracy(extra):
    text = net_text((8, 5), 'layer { name: "acc" type: "Accuracy" '
                    'bottom: "data" bottom: "label" top: "acc" top: "per" '
                    f'{extra} }}', extra_inputs=[(8,)], extra_tops=["label"])
    labels = np.array([0, 1, 2, 3, 4, 1, 1, 0], np.float32)
    jb, tb, _, _ = run_both(text, {"data": x_in((8, 5)), "label": labels})
    # the reference's per-class top is f64 under the tests' x64 mode
    for top in ("acc", "per"):
        close(np.asarray(jb[top], np.float32), tb[top])


FILTER_NET = '''name: "f"
layer { name: "a" type: "Input" top: "x" input_param { shape { dim: 1 } } }
layer { name: "b" type: "ReLU" bottom: "x" top: "b" include { phase: TRAIN } }
layer { name: "c" type: "ReLU" bottom: "x" top: "c" include { phase: TEST } }
layer { name: "d" type: "ReLU" bottom: "x" top: "d"
        include { stage: "s1" min_level: 1 } }
layer { name: "e" type: "ReLU" bottom: "x" top: "e" exclude { not_stage: "s2" }
        exclude { max_level: 0 phase: TEST } }
'''


@pytest.mark.parametrize("phase,stages,level", [
    (0, (), 0), (1, (), 0), (0, ("s1",), 1), (1, ("s1", "s2"), 2),
    (0, ("s2",), 0)])
def test_filter_net_matches_reference(phase, stages, level):
    ref = pb.NetParameter()
    text_format.Parse(FILTER_NET, ref)
    jnet = JNet(ref, phase, stages=stages, level=level)
    tnet = TNet(tproto.parse(FILTER_NET, "NetParameter"), phase,
                stages=stages, level=level, device="cpu")
    assert [l.name for l in tnet.layers] == [l.name for l in jnet.layers]
    assert tnet.output_names == jnet.output_names


@pytest.mark.parametrize("filler,check", [
    ('type: "constant" value: 0.25', lambda w: bool((w == 0.25).all())),
    ('type: "uniform" min: -2 max: 3',
     lambda w: -2 <= float(w.min()) and float(w.max()) <= 3
     and abs(float(w.mean()) - 0.5) < 0.05),
    ('type: "gaussian" mean: 1 std: 0.5',
     lambda w: abs(float(w.mean()) - 1) < 0.01
     and abs(float(w.std()) - 0.5) < 0.01),
    ('type: "gaussian" std: 1 sparse: 5',     # ~5 nonzeros per output
     lambda w: abs(float((w != 0).sum(1).float().mean()) - 5) < 0.5),
    ('type: "xavier"',                         # U(+-sqrt(3 / fan_in))
     lambda w: float(w.abs().max()) <= (3 / 300) ** 0.5
     and abs(float(w.std()) - (1 / 300) ** 0.5) < 0.003),
    ('type: "msra" variance_norm: FAN_OUT',    # N(0, 2 / fan_out)
     lambda w: abs(float(w.std()) - (2 / 200) ** 0.5) < 0.005),
])
def test_fillers(filler, check):
    from rram_caffe_simulation_tpu_torch.core.fillers import make_filler
    f = tproto.parse(filler, "FillerParameter")
    w = make_filler(f)(prng.PRNGKey(0), (200, 300))
    assert w.dtype == torch.float32 and w.shape == (200, 300)
    assert check(w)


# ---------------------------------------------------------------------------
# the layers of the in-repo CIFAR-10 "full" and siamese nets

def ulps(a, b) -> int:
    """The largest distance in float32 units in the last place."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # the two's-complement view of a negative float runs backwards
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max())


def wide_in(shape, seed=0):
    """Inputs over the neurons' whole range: saturation, the small-x
    branch and a few exact zeros."""
    x = x_in(shape, seed) * 6
    flat = x.reshape(-1)
    flat[:4] = (0.0, 1e-5, -3e-4, 95.0)
    return x


@pytest.mark.parametrize("kind", ["Sigmoid", "TanH"])
def test_neurons_match_bit_for_bit(kind):
    """Sigmoid and TanH are XLA's CPU float32 expressions (logistic as
    1 / (1 + exp(-x)), tanh as its rational approximation), forward and
    JAX's eager backward rule: bit for bit (0 ulps)."""
    layer = (f'layer {{ name: "n" type: "{kind}" bottom: "data" '
             'top: "n" }')
    check(net_text((4, 5, 6, 6), layer), {"data": wide_in((4, 5, 6, 6))},
          "n", exact=True)


LRN = ('layer {{ name: "lrn" type: "LRN" bottom: "data" top: "lrn" '
       'lrn_param {{ {p} }} }}')


@pytest.mark.parametrize("p", [
    # cifar10_full's norm1/norm2
    "local_size: 3 alpha: 5e-05 beta: 0.75 norm_region: WITHIN_CHANNEL",
    "local_size: 5 alpha: 0.5 beta: 0.6 k: 2 norm_region: WITHIN_CHANNEL",
    # AlexNet's
    "local_size: 5 alpha: 0.0001 beta: 0.75",
    "local_size: 3 alpha: 0.7 beta: 1.3 k: 0.5 norm_region: ACROSS_CHANNELS",
])
def test_lrn(p):
    """The window sums in the reference's order (shifted channel slices;
    the row-major box), so the scale is the reference's bit for bit; the
    power is float64's rounded once, within 1 ulp of XLA's CPU pow (the
    top too). Gradients within the summation tolerance."""
    shape = (3, 7, 6, 5)
    x = x_in(shape) * 4
    jb, tb, jg, tg = run_both(net_text(shape, LRN.format(p=p)), {"data": x},
                              grad_top="lrn")
    assert ulps(jb["lrn"], tb["lrn"]) <= 1
    close(jg[-1], tg[-1])


EXTRA = [(4, 3, 5, 2)]


@pytest.mark.parametrize("p", [
    "operation: PROD", "operation: SUM",
    "operation: SUM coeff: 0.3 coeff: -1.7", "operation: MAX",
])
def test_eltwise(p):
    """Elementwise, so bit for bit; MAX's tie (the inputs share some
    values) splits the gradient as jnp.maximum does."""
    x, y = x_in((4, 3, 5, 2)), x_in((4, 3, 5, 2), seed=1)
    y.reshape(-1)[:7] = x.reshape(-1)[:7]
    text = net_text((4, 3, 5, 2), 'layer { name: "e" type: "Eltwise" '
                    f'bottom: "data" bottom: "y" top: "e" eltwise_param {{ '
                    f'{p} }} }}', extra_inputs=EXTRA, extra_tops=["y"])
    check(text, {"data": x, "y": y}, "e", exact=True)


@pytest.mark.parametrize("layer,top", [
    ('type: "Slice" bottom: "data" top: "s0" top: "s1" top: "s2" '
     'slice_param { slice_point: 1 slice_point: 4 }', "s1"),
    ('type: "Slice" bottom: "data" top: "s0" top: "s1" '
     'slice_param { slice_dim: 2 }', "s1"),
    ('type: "Slice" bottom: "data" top: "s0" top: "s1" '
     'slice_param { axis: -1 slice_point: 3 }', "s0"),
    ('type: "Concat" bottom: "data" bottom: "y" top: "c"', "c"),
    ('type: "Concat" bottom: "y" bottom: "data" top: "c" '
     'concat_param { axis: 3 }', "c"),
    ('type: "Split" bottom: "data" top: "a" top: "b"', "b"),
    ('type: "Flatten" bottom: "data" top: "f"', "f"),
    ('type: "Flatten" bottom: "data" top: "f" '
     'flatten_param { axis: 2 end_axis: 3 }', "f"),
    ('type: "Reshape" bottom: "data" top: "r" '
     'reshape_param { shape { dim: 0 dim: -1 dim: 2 } }', "r"),
    ('type: "Reshape" bottom: "data" top: "r" reshape_param { shape { '
     'dim: 3 dim: 8 } axis: 2 num_axes: 2 }', "r"),
])
def test_structural_layers(layer, top):
    """Slice (slice points, slice_dim, a negative axis), Concat (axis 1,
    axis 3), Split, Flatten, Reshape: copies, bit for bit, with their
    gradients."""
    shape = (2, 6, 4, 6)
    text = net_text(shape, f'layer {{ name: "l" {layer} }}',
                    extra_inputs=[shape], extra_tops=["y"])
    check(text, {"data": x_in(shape), "y": x_in(shape, seed=3)}, top,
          exact=True)


@pytest.mark.parametrize("axis", [1, 2, -1])
def test_softmax(axis):
    layer = ('layer { name: "sm" type: "Softmax" bottom: "data" top: "sm" '
             f'softmax_param {{ axis: {axis} }} }}')
    check(net_text((3, 5, 4), layer), {"data": x_in((3, 5, 4)) * 3}, "sm")


def test_euclidean_loss():
    """b read in a's shape: (4, 6) against (4, 2, 3)."""
    text = net_text((4, 6), 'layer { name: "l" type: "EuclideanLoss" '
                    'bottom: "data" bottom: "y" top: "l" }',
                    extra_inputs=[(4, 2, 3)], extra_tops=["y"])
    check(text, {"data": x_in((4, 6)), "y": x_in((4, 2, 3), seed=1)}, "l")


@pytest.mark.parametrize("p", ["", "margin: 3", "legacy_version: true",
                               "margin: 0.5 legacy_version: true"])
def test_contrastive_loss(p):
    """Similar and dissimilar pairs on both sides of the margin, and one
    pair at distance 0 (the sqrt's floor)."""
    a, b = x_in((8, 2)), x_in((8, 2), seed=1) * 0.5
    b[3] = a[3]
    sim = np.array([1, 0, 0, 1, 0, 1, 0, 0], np.float32)
    text = net_text((8, 2), 'layer { name: "l" type: "ContrastiveLoss" '
                    'bottom: "data" bottom: "b" bottom: "sim" top: "l" '
                    f'contrastive_loss_param {{ {p} }} }}',
                    extra_inputs=[(8, 2), (8,)], extra_tops=["b", "sim"])
    check(text, {"data": a, "b": b, "sim": sim}, "l")
