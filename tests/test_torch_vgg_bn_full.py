"""The experiment template's VGG11-BN net at full width
(models/cifar10_vgg11/cifar10_vgg11_template.prototxt): the port's Solver
draws the reference package's params from the seed, bit for bit (msra
fillers, Scale's key split, BatchNorm's zeros). The rest of the net's
checks are in tests/test_torch_vgg_bn.py."""
import numpy as np
from google.protobuf import text_format

import jax

from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver

from test_torch_solver import REPO
from test_torch_vgg_bn import bits, template_param


def test_full_width_params_equal_the_reference(monkeypatch):
    """The port's Solver from the template draws the reference's
    params: the solver key split once, then every owner layer's split."""
    monkeypatch.chdir(REPO)
    ts = TSolver(template_param(), device="cpu")
    assert ts.net.name == "CIFAR10_VGG11_BN"
    assert [ly.type_name for ly in ts.net.layers].count("BatchNorm") == 10
    assert [ly.type_name for ly in ts.net.layers].count("Scale") == 10
    assert [r.layer_name for r in ts.net.failure_param_refs] == [
        "fc1", "fc1", "fc2", "fc2", "fc3", "fc3"]
    jmsg = pb.NetParameter()
    with open(f"{REPO}/{ts.param.net}") as f:
        text_format.Parse(f.read(), jmsg)
    with jax.enable_x64(False):
        jnet = JNet(jmsg, pb.TRAIN)
        _, k_init = jax.random.split(jax.random.PRNGKey(ts.seed))
        jp = jnet.init(k_init)
    assert set(jp) == set(ts.params)
    for ln, vals in jp.items():
        assert len(vals) == len(ts.params[ln]), ln
        for a, b in zip(vals, ts.params[ln]):
            assert b.shape == a.shape, ln
            np.testing.assert_array_equal(bits(b.numpy()), bits(a),
                                          err_msg=ln)
    assert ts.params["scale_conv1"][0].eq(1).all()
    assert tuple(ts.params["bn_fc2"][2].shape) == (1,)
