"""BatchNorm, Scale and Bias in the port (ops/vision.py, ops/common.py)
against the reference package's, on the CPU.

Held, on the same numpy inputs (params drawn by the port, carried with
convert.py, or set by the case):
- the reference layer matrix's BatchNorm_train, BatchNorm_global,
  Scale_learned_bias, Scale_bottom, Bias_learned and Bias_bottom cases,
  and a few more (num_axes -1, axis 2, a 2-D BatchNorm, the default
  phase rule), through a one-layer net in both packages: the top within
  1e-5 absolute (unit-scale outputs; the reductions sum in other
  orders), the gradients of sum(top * G) within rtol 1e-4 / atol 1e-5,
  the moving update within rtol 1e-5 / atol 1e-6 and scale_factor bit
  for bit;
- under config lanes (C = 3), each lane of a laned and of an unlaned
  bottom equal to the single-config layer on that lane's slice, within
  1e-6; axis 0 and a laned second bottom refused by name;
- the schema's defaults for the three messages, and their bytes equal
  to protobuf's;
- the 3-param BatchNorm upgrade in read_net_param and in Net, with the
  upgraded layer's bytes equal to the reference's;
- in the Solver, the statistics' gradient and update an exact zero under
  SGD, Adam and AdaDelta, the statistics after the step the forward's
  advance, bit for bit.
"""
import os

import numpy as np
import pytest
import torch
from google.protobuf import text_format

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu.utils import io as jio
from rram_caffe_simulation_tpu_torch import convert
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.core.registry import (LayerContext,
                                                           create_layer)
from rram_caffe_simulation_tpu_torch.net import Net as TNet
from rram_caffe_simulation_tpu_torch.proto.schema import MESSAGES
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver import solver as tsolver
from rram_caffe_simulation_tpu_torch.utils import io as tio

from test_torch_layers import net_text

F32 = np.float32
TOP_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6


def x_in(shape, seed=0, scale=2.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(F32)


def bits(a):
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


# ---------------------------------------------------------------------------
# the layers through one-layer nets in both packages

def layer_text(ltype, param, bottoms=("data",)):
    bots = " ".join(f'bottom: "{b}"' for b in bottoms)
    return f'layer {{ name: "l" type: "{ltype}" {bots} top: "y" {param} }}'


def run_both(text, inputs, phase, params=None, seed=0):
    """(reference top, port top, reference grads, port grads, reference
    new params, port new params): grads of sum(y * G) w.r.t. every param
    and every input, in that order."""
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    with jax.enable_x64(False):
        jnet = JNet(jmsg, phase)
    tnet = TNet(tproto.parse(text, "NetParameter"), phase, device="cpu")
    tparams = tnet.init(prng.PRNGKey(seed))
    if params is not None:
        tparams["l"] = [torch.from_numpy(np.asarray(p, F32)) for p in params]
    jparams = {k: [jnp.asarray(a) for a in v]
               for k, v in convert.params_to_jax(tparams).items()}
    names = list(inputs)
    with jax.enable_x64(False):
        _, _, jnew = jnet.apply(jparams, {k: jnp.asarray(v) for k, v in
                                          inputs.items()}, with_updates=True)
        jy = jnet.apply(jparams, {k: jnp.asarray(v)
                                  for k, v in inputs.items()})[0]["y"]
        G = x_in(np.shape(jy), seed + 1, 1.0)

        def obj(p, xs):
            b, _ = jnet.apply(p, dict(zip(names, xs)))
            return jnp.sum(b["y"] * G)
        jg = jax.grad(obj, argnums=(0, 1))(
            jparams, [jnp.asarray(inputs[k]) for k in names])
    leaves = {k: [t.requires_grad_() for t in v] for k, v in tparams.items()}
    tin = {k: torch.from_numpy(v).requires_grad_() for k, v in
           inputs.items()}
    tblobs, _, tnew = tnet.apply(leaves, tin, with_updates=True)
    flat = [t for v in leaves.values() for t in v]
    tg = torch.autograd.grad((tblobs["y"] * torch.from_numpy(G)).sum(),
                             flat + [tin[k] for k in names],
                             allow_unused=True)
    jflat = [g for k in leaves for g in jg[0][k]] + list(jg[1])
    tg = [torch.zeros_like(t) if g is None else g
          for t, g in zip(flat + [tin[k] for k in names], tg)]
    return (np.asarray(jy), tblobs["y"].detach().numpy(),
            [np.asarray(g) for g in jflat], [g.numpy() for g in tg],
            {k: [np.asarray(a) for a in v] for k, v in jnew.items()},
            {k: [t.detach().numpy() for t in v] for k, v in tnew.items()})


def check_case(text, inputs, phase, params=None, stateful=False,
               param_grads=True):
    jy, ty, jg, tg, jnew, tnew = run_both(text, inputs, phase, params)
    assert jy.shape == ty.shape
    np.testing.assert_allclose(ty, jy, rtol=0, atol=TOP_ATOL)
    assert len(jg) == len(tg)
    if not param_grads:
        jg, tg = jg[-len(inputs):], tg[-len(inputs):]
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if stateful:
        mean, var, sf = tnew["l"]
        jmean, jvar, jsf = jnew["l"]
        np.testing.assert_allclose(mean, jmean, rtol=STAT_RTOL,
                                   atol=STAT_ATOL)
        np.testing.assert_allclose(var, jvar, rtol=STAT_RTOL,
                                   atol=STAT_ATOL)
        np.testing.assert_array_equal(bits(sf), bits(jsf))
    return ty, tnew


def np_bn_train(x, eps=1e-5):
    axes = (0,) + tuple(range(2, x.ndim))
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    mean = x.mean(axes)
    var = ((x - mean.reshape(bshape)) ** 2).mean(axes)
    return (x - mean.reshape(bshape)) / np.sqrt(var.reshape(bshape) + eps)


@pytest.mark.parametrize("shape", [(4, 3, 2, 2), (6, 5), (3, 4, 3, 5)],
                         ids=["matrix", "fc", "wide"])
@pytest.mark.parametrize("start", ["zeros", "running"])
def test_batchnorm_train(shape, start):
    """BatchNorm_train: batch statistics, the full backward, and the
    moving update from zero stats and from running ones."""
    x = x_in(shape, 30)
    c = shape[1]
    params = None
    if start == "running":
        rng = np.random.RandomState(3)
        params = [rng.randn(c), np.abs(rng.randn(c)) + 0.5, [2.7]]
    text = net_text(shape, layer_text(
        "BatchNorm", "batch_norm_param { moving_average_fraction: 0.9 }"))
    y, new = check_case(text, {"data": x}, tproto.TRAIN, params,
                        stateful=True)
    np.testing.assert_allclose(y, np_bn_train(x.astype(np.float64)),
                               atol=TOP_ATOL)
    m = shape[0] * int(np.prod(shape[2:]))
    axes = (0,) + tuple(range(2, len(shape)))
    x64 = x.astype(np.float64)
    p = [np.zeros(c), np.zeros(c), [0.0]] if params is None else params
    want_mean = 0.9 * np.asarray(p[0]) + x64.mean(axes)
    want_var = 0.9 * np.asarray(p[1]) + m / (m - 1.0) * x64.var(axes)
    np.testing.assert_allclose(new["l"][0], want_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new["l"][1], want_var, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sf", [2.0, 0.0], ids=["sf2", "sf0"])
def test_batchnorm_global(sf):
    """BatchNorm_global: the stored sums divided by scale_factor (0 when
    it is 0); no update, and the input's gradient (the statistics are
    never trained; at sf = 0 the reference's gradient for sf is NaN,
    the unselected branch's infinity times zero)."""
    shape = (4, 3, 2, 2)
    stats = [np.array([0.5, -1.0, 2.0]), np.array([1.0, 4.0, 0.25]), [sf]]
    text = net_text(shape, layer_text(
        "BatchNorm", "batch_norm_param { use_global_stats: true }"))
    x = x_in(shape, 30)
    y, new = check_case(text, {"data": x}, tproto.TEST, stats,
                        param_grads=False)
    scale = 0.0 if sf == 0 else 1.0 / sf
    want = (x - (stats[0] * scale).reshape(1, -1, 1, 1)) / np.sqrt(
        (stats[1] * scale).reshape(1, -1, 1, 1) + 1e-5)
    np.testing.assert_allclose(y, want, atol=TOP_ATOL)
    for got, s in zip(new["l"], stats):                 # not advanced
        np.testing.assert_array_equal(got, np.asarray(s, F32))


@pytest.mark.parametrize("phase,global_", [(tproto.TRAIN, False),
                                           (tproto.TEST, True)])
def test_batchnorm_default_stats_follow_the_phase(phase, global_):
    """use_global_stats unset: global in TEST, the batch's in TRAIN."""
    lp = tproto.parse('name: "bn" type: "BatchNorm"', "LayerParameter")
    layer = create_layer(lp, phase)
    layer.setup([(4, 3, 2, 2)])
    assert layer.use_global_stats == global_
    assert [s.lr_mult for s in layer.param_specs()] == [0.0] * 3
    assert [s.decay_mult for s in layer.param_specs()] == [0.0] * 3
    blobs = layer.init_params(prng.PRNGKey(0))
    assert [tuple(b.shape) for b in blobs] == [(3,), (3,), (1,)]
    assert all(b.dtype == torch.float32 and not b.any() for b in blobs)


AFFINE_CASES = {
    "Scale_learned_bias": (
        "Scale", 'scale_param { axis: 1 num_axes: 1 bias_term: true '
        'filler { type: "gaussian" std: 1.0 } '
        'bias_filler { type: "gaussian" std: 0.5 } }', [], None),
    "Scale_default_filler": (
        "Scale", "scale_param { bias_term: true }", [], None),
    "Scale_num_axes_all": (
        "Scale", 'scale_param { axis: 1 num_axes: -1 filler { type: '
        '"uniform" min: -1 max: 1 } }', [], None),
    "Scale_axis2": (
        "Scale", 'scale_param { axis: 2 num_axes: 2 bias_term: true filler '
        '{ type: "gaussian" std: 1.0 } bias_filler { type: "gaussian" } }',
        [], None),
    "Scale_bottom": ("Scale", "scale_param { axis: 1 }", [(3,)], 11),
    "Scale_bottom_bias": ("Scale", 'scale_param { axis: 1 bias_term: true '
                          'bias_filler { type: "gaussian" } }', [(3, 4)],
                          12),
    "Bias_learned": (
        "Bias", 'bias_param { axis: 1 num_axes: 1 '
        'filler { type: "gaussian" std: 1.0 } }', [], None),
    "Bias_num_axes_all": (
        "Bias", 'bias_param { num_axes: -1 filler { type: "gaussian" } }',
        [], None),
    "Bias_bottom": ("Bias", "bias_param { axis: 1 }", [(3,)], 10),
}


@pytest.mark.parametrize("case", list(AFFINE_CASES))
def test_scale_and_bias(case):
    ltype, param, extra, seed = AFFINE_CASES[case]
    shape = (2, 3, 4, 5)
    names = ["data"] + [f"b{i}" for i in range(len(extra))]
    text = net_text(shape, layer_text(ltype, param, names), extra, names[1:])
    inputs = {"data": x_in(shape, 0)}
    for i, s in enumerate(extra):
        inputs[f"b{i}"] = x_in(s, seed + i, 1.0)
    check_case(text, inputs, tproto.TRAIN)


def test_scale_params_follow_the_reference_key_chain():
    """init_params splits its key into (scale, bias) keys before either
    filler draws: the reference's params from the same key, bit for bit,
    and ones where the scale filler is unset."""
    for param in ('scale_param { bias_term: true filler { type: "gaussian" '
                  'std: 0.7 } bias_filler { type: "uniform" } }',
                  "scale_param { bias_term: true }",
                  'bias_param { filler { type: "gaussian" } }'):
        ltype = "Bias" if param.startswith("bias") else "Scale"
        text = layer_text(ltype, param)
        jlp = pb.LayerParameter()
        text_format.Parse(text[len("layer {"):-1], jlp)
        from rram_caffe_simulation_tpu.core.registry import \
            create_layer as jcreate
        jl = jcreate(jlp, pb.TRAIN)
        jl.setup([(2, 6, 3)])
        tl = create_layer(tproto.parse(text[len("layer {"):-1],
                                       "LayerParameter"), tproto.TRAIN)
        tl.setup([(2, 6, 3)])
        with jax.enable_x64(False):
            want = [np.asarray(a) for a in jl.init_params(
                jax.random.PRNGKey(9))]
        got = tl.init_params(prng.PRNGKey(9))
        assert len(got) == len(want)
        for a, b in zip(want, got):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(bits(b.numpy()), bits(a))


# ---------------------------------------------------------------------------
# config lanes: each lane against the single-config layer

C = 3


def make_layer(ltype, param, shapes, phase=tproto.TRAIN):
    lp = tproto.parse(f'name: "l" type: "{ltype}" {param}',
                      "LayerParameter")
    layer = create_layer(lp, phase)
    layer.setup(shapes)
    return layer


def lane_params(layer, seed):
    """(C, ...) params of every lane, random (BatchNorm's variance sums
    positive, its scale_factors 2, 0 and 5.5)."""
    rng = np.random.RandomState(seed)
    out = [torch.from_numpy(rng.randn(C, *p.shape).astype(F32))
           for p in layer.init_params(prng.PRNGKey(seed))]
    if layer.type_name == "BatchNorm":
        out[1] = out[1].abs() + 0.5
        out[2] = torch.tensor([[2.0], [0.0], [5.5]])
    return out


def laned(x):
    """(C, N, ch, ...) per-lane blobs as one laned blob (N, C*ch, ...)."""
    return x.transpose(0, 1).reshape((x.shape[1], -1) + tuple(x.shape[3:]))


LANE_CASES = {
    "BatchNorm_train": ("BatchNorm", "", tproto.TRAIN, (4, 3, 2, 2)),
    "BatchNorm_global": ("BatchNorm", "", tproto.TEST, (4, 3, 2, 2)),
    "BatchNorm_fc": ("BatchNorm", "", tproto.TRAIN, (5, 6)),
    "Scale_bias": ("Scale", "scale_param { bias_term: true }", tproto.TRAIN,
                   (2, 3, 4, 5)),
    "Scale_axis2": ("Scale", "scale_param { axis: 2 num_axes: -1 "
                    "bias_term: true }", tproto.TRAIN, (2, 3, 4, 5)),
    "Scale_fc": ("Scale", "scale_param { bias_term: true }", tproto.TRAIN,
                 (4, 6)),
    "Bias": ("Bias", "", tproto.TRAIN, (2, 3, 4, 5)),
    "Bias_axis3": ("Bias", "bias_param { axis: 3 }", tproto.TRAIN,
                   (2, 3, 4, 5)),
}


@pytest.mark.parametrize("bottom_laned", [True, False],
                         ids=["laned", "unlaned"])
@pytest.mark.parametrize("case", list(LANE_CASES))
def test_lanes_equal_single_config(case, bottom_laned):
    ltype, param, phase, shape = LANE_CASES[case]
    layer = make_layer(ltype, param, [shape], phase)
    params = lane_params(layer, 4)
    xs = torch.from_numpy(x_in((C,) + shape, 5))
    x = laned(xs) if bottom_laned else xs[0]
    ctx = LayerContext(phase=phase, lanes=C, laned=(bottom_laned,),
                       updates={})
    y = layer.apply(params, [x], ctx)[0]
    assert tuple(y.shape) == (shape[0], C * shape[1]) + shape[2:]
    per_lane = y.reshape((shape[0], C) + shape[1:]).transpose(0, 1)
    for c in range(C):
        one = LayerContext(phase=phase, updates={})
        want = layer.apply([p[c] for p in params],
                           [xs[c] if bottom_laned else xs[0]], one)[0]
        torch.testing.assert_close(per_lane[c], want, rtol=0, atol=1e-6)
        for got, w in zip(ctx.updates.get("l", []),
                          one.updates.get("l", [])):
            torch.testing.assert_close(got[c], w, rtol=1e-6, atol=1e-7)
    if ltype == "BatchNorm" and phase == tproto.TRAIN:
        assert [tuple(t.shape) for t in ctx.updates["l"]] == [
            (C, shape[1]), (C, shape[1]), (C, 1)]
    else:
        assert "l" not in ctx.updates


@pytest.mark.parametrize("ltype", ["Scale", "Bias"])
def test_second_bottom_under_lanes(ltype):
    """A shared second bottom feeds every lane; a laned one raises."""
    param = "scale_param { bias_term: true }" if ltype == "Scale" else ""
    layer = make_layer(ltype, param, [(2, 3, 4), (3,)])
    params = lane_params(layer, 6)
    xs = torch.from_numpy(x_in((C, 2, 3, 4), 7))
    b = torch.from_numpy(x_in((3,), 8))
    ctx = LayerContext(phase=tproto.TRAIN, lanes=C, laned=(True, False))
    y = layer.apply(params, [laned(xs), b], ctx)[0]
    per_lane = y.reshape(2, C, 3, 4).transpose(0, 1)
    for c in range(C):
        want = layer.apply([p[c] for p in params], [xs[c], b],
                           LayerContext(phase=tproto.TRAIN))[0]
        torch.testing.assert_close(per_lane[c], want, rtol=0, atol=1e-6)
    ctx = LayerContext(phase=tproto.TRAIN, lanes=C, laned=(True, True))
    with pytest.raises(NotImplementedError, match="laned second bottom"):
        layer.apply(params, [laned(xs), b.repeat(C)], ctx)


@pytest.mark.parametrize("ltype", ["Scale", "Bias"])
def test_axis0_under_lanes_raises(ltype):
    param = ("scale_param { axis: 0 num_axes: 1 }" if ltype == "Scale"
             else "bias_param { axis: 0 }")
    layer = make_layer(ltype, param, [(2, 3, 4)])
    params = [p.unsqueeze(0).repeat(C, *([1] * p.dim()))
              for p in layer.init_params(prng.PRNGKey(0))]
    ctx = LayerContext(phase=tproto.TRAIN, lanes=C, laned=(True,))
    with pytest.raises(NotImplementedError, match="axis 0 under config"):
        layer.apply(params, [torch.zeros(2, 3 * C, 4)], ctx)


# ---------------------------------------------------------------------------
# the schema and the BatchNorm upgrade

def test_schema_defaults_match_the_reference():
    for msg, fields in (("BatchNormParameter", ("use_global_stats",
                                                "moving_average_fraction",
                                                "eps")),
                        ("BiasParameter", ("axis", "num_axes")),
                        ("ScaleParameter", ("axis", "num_axes",
                                            "bias_term"))):
        ref = getattr(pb, msg)()
        mine = tproto.Message(msg)
        for f in fields:
            assert getattr(mine, f) == getattr(ref, f), (msg, f)
            assert not mine.HasField(f)
        if msg != "BatchNormParameter":
            assert mine.filler.type == ref.filler.type == "constant"
    lp = pb.LayerParameter()
    for name, num in (("batch_norm_param", 139), ("bias_param", 141),
                      ("scale_param", 142)):
        assert lp.DESCRIPTOR.fields_by_name[name].number == num
        assert MESSAGES["LayerParameter"].fields[name].number == num
    bn = tproto.Message("BatchNormParameter")
    assert bn.moving_average_fraction == float(F32(0.999))
    assert bn.eps == float(F32(1e-5))


def test_messages_encode_as_protobuf():
    text = ('name: "s" type: "Scale" bottom: "x" top: "x" '
            'batch_norm_param { use_global_stats: false '
            'moving_average_fraction: 0.95 eps: 0.001 } '
            'bias_param { axis: 2 num_axes: -1 filler { type: "gaussian" '
            'std: 0.5 } } '
            'scale_param { axis: -1 num_axes: 0 bias_term: true '
            'filler { type: "constant" value: 1.5 } '
            'bias_filler { type: "uniform" min: -1 } }')
    ref = pb.LayerParameter()
    text_format.Parse(text, ref)
    mine = tproto.parse(text, "LayerParameter")
    raw = tproto.encode(mine)
    assert raw == ref.SerializeToString()
    assert tproto.decode(raw, "LayerParameter") == mine


BN3 = ('layer { name: "bn" type: "BatchNorm" bottom: "data" top: "bn" '
       'param { lr_mult: 0 } param { lr_mult: 0 } param { lr_mult: 0 } }\n'
       'layer { name: "ip" type: "InnerProduct" bottom: "bn" top: "ip" '
       'param { lr_mult: 1 } inner_product_param { num_output: 2 } }')


def test_three_param_batchnorm_upgrade(tmp_path):
    """read_net_param and Net (an in-memory message) drop the three
    specs the reference's upgrade drops; the layer Net.to_proto writes
    is the reference's upgraded layer, byte for byte. Other layers'
    specs stay."""
    text = net_text((4, 3, 2, 2), BN3)
    path = tmp_path / "bn3.prototxt"
    path.write_text(text)
    mine = tio.read_net_param(str(path))
    ref = jio.read_net_param(str(path))
    assert [len(lp.param) for lp in mine.layer] == [0, 0, 1]
    assert [len(lp.param) for lp in ref.layer] == [0, 0, 1]
    assert tproto.encode(mine) == ref.SerializeToString()
    raw = tproto.parse(text, "NetParameter")
    assert len(raw.layer[1].param) == 3
    tnet = TNet(raw, tproto.TRAIN, device="cpu")
    assert len(raw.layer[1].param) == 3           # the caller's message
    assert len(tnet.layer_by_name["bn"].lp.param) == 0
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    with jax.enable_x64(False):
        jnet = JNet(jmsg, pb.TRAIN)
    params = tnet.init(prng.PRNGKey(1))
    jparams = convert.params_to_jax(params)
    assert tproto.encode(tnet.to_proto(params)) == \
        jnet.to_proto(jparams).SerializeToString()
    bn_ref = [lp for lp in ref.layer if lp.type == "BatchNorm"][0]
    bn_mine = [lp for lp in tnet.to_proto(params).layer
               if lp.type == "BatchNorm"][0]
    bn_mine.ClearField("blobs")
    assert tproto.encode(bn_mine) == bn_ref.SerializeToString()


def test_example_bn_net_upgrades_as_the_reference():
    """The repo's cifar10_full_sigmoid BN net, read by both packages:
    every BatchNorm layer's bytes equal after the upgrade."""
    path = "examples/cifar10/cifar10_full_sigmoid_train_test_bn.prototxt"
    full = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), path)
    mine = tio.read_net_param(full)
    ref = jio.read_net_param(full)
    mine_bn = [lp for lp in mine.layer if lp.type == "BatchNorm"]
    ref_bn = [lp for lp in ref.layer if lp.type == "BatchNorm"]
    assert len(mine_bn) == len(ref_bn) == 3
    for a, b in zip(mine_bn, ref_bn):
        assert len(a.param) == 0
        assert tproto.encode(a) == b.SerializeToString()


# ---------------------------------------------------------------------------
# the statistics in the Solver: a zero gradient and a zero update

BN_NET = (
    'name: "bn_tiny" layer { name: "in" type: "Input" top: "data" '
    'top: "label" input_param { shape { dim: 6 dim: 2 dim: 3 dim: 3 } '
    'shape { dim: 6 } } }\n'
    'layer { name: "conv" type: "Convolution" bottom: "data" top: "conv" '
    'convolution_param { num_output: 4 kernel_size: 3 pad: 1 '
    'weight_filler { type: "msra" } } }\n'
    'layer { name: "bn" type: "BatchNorm" bottom: "conv" top: "conv" }\n'
    'layer { name: "sc" type: "Scale" bottom: "conv" top: "conv" '
    'scale_param { bias_term: true } }\n'
    'layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }\n'
    'layer { name: "fc" type: "InnerProduct" bottom: "conv" top: "fc" '
    'inner_product_param { num_output: 3 weight_filler { type: "msra" } '
    '} }\n'
    'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc" '
    'bottom: "label" top: "loss" }')


def tiny_batch(seed):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(6, 2, 3, 3).astype(F32),
            "label": rng.randint(0, 3, 6).astype(F32)}


@pytest.mark.parametrize("rule", ["SGD", "Adam", "AdaDelta"])
def test_statistics_take_a_zero_gradient_and_update(monkeypatch, rule):
    text = (f'net_param {{ {BN_NET} }} type: "{rule}" base_lr: 0.1 '
            'momentum: 0.9 weight_decay: 0.01 lr_policy: "fixed" '
            'clip_gradients: 1000 random_seed: 2 delta: 1e-6')
    seen = []
    orig = tsolver.clip_gradients

    def record(g, clip, lanes=0):
        seen.append({k: v.clone() for k, v in g.items()})
        return orig(g, clip, lanes)
    monkeypatch.setattr(tsolver, "clip_gradients", record)
    batches = [tiny_batch(i) for i in range(3)]
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                train_feed=iter(batches).__next__)
    stats = ["bn/0", "bn/1", "bn/2"]
    for it in range(3):
        before = {k: [t.clone() for t in v] for k, v in s.params.items()}
        _, _, advanced = s.net.apply(
            before, {k: torch.from_numpy(v) for k, v in
                     batches[it].items()}, with_updates=True)
        s.step(1)
        for i, k in enumerate(stats):
            assert not seen[-1][k].any(), (rule, it, k)
            assert torch.equal(s.params["bn"][i], advanced["bn"][i]), \
                (rule, it, k)
            for bank in s.history[k].values():
                assert not bank.any(), (rule, it, k)
        assert not torch.equal(s.params["sc"][0], before["sc"][0])
    assert s.params["bn"][2].item() == pytest.approx(1 + 0.999 + 0.999 ** 2,
                                                     rel=1e-6)
    assert all(s.history[k] for k in stats)


def test_a_param_the_loss_never_reads_raises():
    """Only BatchNorm's statistics may miss the graph: any other param
    without a gradient (a side branch the loss never reads, or a routing
    fault) raises by name rather than train on a zero gradient."""
    side = ('layer { name: "side" type: "InnerProduct" bottom: "conv" '
            'top: "side" inner_product_param { num_output: 2 } }')
    text = (f'net_param {{ {BN_NET}\n{side} }} base_lr: 0.1 '
            'lr_policy: "fixed" random_seed: 2')
    batches = [tiny_batch(0)]
    s = TSolver(tproto.parse(text, "SolverParameter"), device="cpu",
                train_feed=iter(batches).__next__)
    with pytest.raises(RuntimeError, match=r"\['side/0', 'side/1'\]"):
        s.step(1)
