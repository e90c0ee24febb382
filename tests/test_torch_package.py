"""Package rules of the port: it imports neither JAX nor the reference
package (nor protobuf), its entry points default to the card and raise
rather than fall back to the CPU, and they run on the CPU when asked by
name. chip_smoke.py refuses to report without a card or without the
repository around it."""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.net import Net
from rram_caffe_simulation_tpu_torch.solver import Solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NET = ('name: "n" layer { name: "in" type: "Input" top: "data" top: "label" '
       'input_param { shape { dim: 4 dim: 6 } shape { dim: 4 } } } '
       'layer { name: "fc" type: "InnerProduct" bottom: "data" top: "fc" '
       'inner_product_param { num_output: 3 weight_filler { type: "xavier" '
       '} } } layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc" '
       'bottom: "label" top: "loss" }')
SOLVER = (f'net_param {{ {NET} }} base_lr: 0.1 lr_policy: "fixed" '
          'random_seed: 1 failure_pattern { type: "gaussian" mean: 300 '
          'std: 100 }')


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import rram_caffe_simulation_tpu_torch as p
        names = [m.name for m in pkgutil.walk_packages(p.__path__,
                                                       p.__name__ + ".")]
        for n in names:
            importlib.import_module(n)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib")
                     or n.startswith("google.protobuf")
                     or n == "rram_caffe_simulation_tpu"
                     or n.startswith("rram_caffe_simulation_tpu."))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 20 else 0)
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Net(tproto.parse(NET, "NetParameter"), tproto.TRAIN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Solver(tproto.parse(SOLVER, "SolverParameter"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Net(tproto.parse(NET, "NetParameter"), tproto.TRAIN, device="cuda")


def test_entry_points_run_on_cpu_when_asked():
    net = Net(tproto.parse(NET, "NetParameter"), tproto.TRAIN, device="cpu")
    params = net.init(torch.Generator().manual_seed(0))
    blobs, loss = net.apply(params, {
        "data": torch.from_numpy(np.ones((4, 6), np.float32)),
        "label": torch.tensor([0.0, 1.0, 2.0, 1.0])})
    assert blobs["fc"].shape == (4, 3) and torch.isfinite(loss)
    rng = np.random.RandomState(0)
    data = rng.randn(4, 6).astype(np.float32)
    label = np.array([0, 1, 2, 1], np.float32)
    s = Solver(tproto.parse(SOLVER, "SolverParameter"), device="cpu",
               train_feed=lambda: {"data": data, "label": label})
    s.step(3)
    assert s.iter == 3 and np.isfinite(s.smoothed_loss)
    assert s.net.failure_param_refs and 0.0 <= s.broken_fraction() <= 1.0


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_repo(tmp_path, alone):
    """No CUDA device here: the script exits non-zero and prints no "ok"
    line, in the repository and copied alone into an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
