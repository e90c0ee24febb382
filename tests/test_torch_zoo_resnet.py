"""ResNet-50 (models/resnet50) in the port against the reference, on the
CPU, at batch 2 with every num_output but fc1000's divided by 16.

- It trains from its solver.prototxt, 3 steps in lockstep with the
  reference's Solver (tests/test_torch_zoo.py `lockstep` with `kinks`:
  losses within 1e-4 relative, banks exact but for exact-0 writes,
  fc1000's params and history within rtol 1e-4 on every cell,
  BatchNorm's statistics within 1e-4 of their largest value and its
  scale factor bit for bit; every other leaf's step update and history
  within a relative norm gap of 1e-1 alone and 5e-2 all together): the
  stand-in LMDB, crop 224 with mirror, faults on fc1000 at N(250, 120).
  The path: 53 BatchNorm/Scale pairs on batch statistics, 16 Eltwise
  sums, a MAX and a global AVE pool.
- Why `kinks`: the float32 forward of either package parts from the
  port's float64 forward by up to ~1e-4 of a blob's largest value at the
  last stage (the port's no further than the reference's), so a
  pre-activation that close to zero passes a ReLU in one package only
  (up to res5c's at this seed) and every gradient below it moves. The
  gaps read on a sound port, steps 0, 1, 2: the largest leaf's 4.44e-2,
  3.65e-3, 1.45e-2 (updates and history alike), all leaves' 1.93e-2,
  4.36e-4, 2.45e-3. A wrong BatchNorm, Scale or Eltwise backward moves
  the leaves below it by their own size.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp
from google.protobuf import text_format

from rram_caffe_simulation_tpu.net import Net as JNet
from rram_caffe_simulation_tpu.proto import pb
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.core import prng
from rram_caffe_simulation_tpu_torch.net import Net as TNet

from test_torch_zoo import lockstep, no_x64, one_torch_thread, standin  # noqa: F401,E501
from test_torch_zoo import NARROW, ZOO, zoo_net_text, zoo_solver_text


def test_trains_in_lockstep_with_the_reference(monkeypatch, standin):
    ts, apart, readings = lockstep(
        monkeypatch, zoo_solver_text("resnet50", standin), 3, kinks=True)
    assert len(readings["update"]) == len(readings["history"]) == 3
    assert ts._fault_keys == ["fc1000/0", "fc1000/1"]
    assert sum(ly.type_name == "BatchNorm" for ly in ts.net.layers) == 53
    assert ts.broken_fraction() > 0 and apart <= 20


def test_the_forward_gap_is_float32_rounding(standin):
    """Both packages' float32 forwards against the port's float64 forward
    of the same params and batch: each stage within 2e-4 of the blob's
    largest value, the port's gap no larger than twice the reference's,
    the loss within 1e-5 relative."""
    text = zoo_net_text(ZOO["resnet50"][1], standin, 2, NARROW)
    jmsg = pb.NetParameter()
    text_format.Parse(text, jmsg)
    jnet = JNet(jmsg, pb.TRAIN)
    tnet = TNet(tproto.parse(text, "NetParameter"), tproto.TRAIN,
                device="cpu")
    params = tnet.init(prng.PRNGKey(0))
    rs = np.random.RandomState(0)
    batch = {"data": (rs.rand(2, 3, 224, 224) * 255 - 117).astype(
        np.float32), "label": rs.randint(0, 1000, 2).astype(np.float32)}
    key = prng.PRNGKey(5)
    got, loss = tnet.apply(params, {k: torch.from_numpy(v) for k, v in
                                    batch.items()}, rng=key)
    wide, wide_loss = tnet.apply(
        {ln: [v.double() for v in vals] for ln, vals in params.items()},
        {k: torch.from_numpy(v).double() for k, v in batch.items()},
        rng=key)
    want, want_loss = jax.jit(lambda p, b: jnet.apply(p, b))(
        {ln: [jnp.asarray(v.numpy()) for v in vals]
         for ln, vals in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(loss) == float(np.float32(float(loss)))
    np.testing.assert_allclose(float(loss), float(wide_loss), rtol=1e-5)
    np.testing.assert_allclose(float(want_loss), float(wide_loss), rtol=1e-5)
    for blob in ("res2a", "res3a", "res4a", "res5a_branch2c", "res5c",
                 "pool5", "fc1000"):
        ref64 = wide[blob].numpy()
        scale = np.abs(ref64).max()
        port_gap = np.abs(got[blob].numpy() - ref64).max() / scale
        ref_gap = np.abs(np.asarray(want[blob]) - ref64).max() / scale
        assert port_gap <= 2e-4 and ref_gap <= 2e-4, blob
        assert port_gap <= 2 * ref_gap + 1e-6, (blob, port_gap, ref_gap)
