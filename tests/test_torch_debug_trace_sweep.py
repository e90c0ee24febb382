"""debug_info and the watchdog in the port's sweep (parallel/sweep.py)
against the reference package's: per-lane debug vectors, per-config
sentinel state and the sweep's watchdog (snapshot, halt), with the
helpers of tests/test_torch_debug_trace.py."""
import glob

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.parallel import SweepRunner as JSweep
from rram_caffe_simulation_tpu_torch.parallel import SweepRunner as TSweep

from test_torch_debug_trace import (ABS, REL, ListSink,
                                    assert_records_equal, port_solver,
                                    ref_solver, solver_text)

# ---------------------------------------------------------------------------
# the sweep

def port_sweep(text, C=4, **kw):
    return TSweep(port_solver(text), C, device="cpu", **kw)


def ref_sweep(text, C=4, **kw):
    with jax.enable_x64(False):
        return JSweep(ref_solver(text), C, **kw)


def test_sweep_debug_vectors_equal_the_reference_per_lane(tmp_path):
    text = solver_text(str(tmp_path / "s"))
    port, ref = port_sweep(text), ref_sweep(text)
    for _ in range(2):
        port.step(1)
        with jax.enable_x64(False):
            ref.step(1)
    got = {k: v for k, v in port.last_metrics["debug"].items()
           if k != "sentinel"}
    want = jax.tree.map(np.asarray, ref.last_metrics["debug"])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=REL, atol=ABS,
                                   err_msg=k)
    for k, v in port.last_metrics["debug"]["sentinel"].items():
        np.testing.assert_array_equal(v.numpy(), want["sentinel"][k])


def test_sweep_reports_per_config_sentinel_state(tmp_path):
    text = solver_text(str(tmp_path / "s"))
    states = []
    for make in (port_sweep, ref_sweep):
        r = make(text)
        w = np.array(r.params["fc2"][0])
        w[2, 0, 0] = np.nan
        r.params["fc2"][0] = (torch.from_numpy(w) if make is port_sweep
                              else jnp.asarray(w))
        with jax.enable_x64(False):
            r.step(1)
        states.append(r.sentinel_state())
    got, want = states
    assert [st["tripped"] for st in got] == [False, False, True, False]
    assert got[2]["phase"] == "forward" and "fc2" in got[2]["entry"]
    assert got[2]["flags"]["nan"] is True
    for a, b in zip(got, want):
        assert_records_equal(a, b)


def _sweep_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("Sweep")]


@pytest.mark.parametrize("policy", ["snapshot", "halt"])
def test_sweep_watchdog_as_the_reference(tmp_path, capsys, policy):
    """enable_watchdog under a SweepRunner (depth 0): one poisoned lane
    quarantined by its sentinel, the diagnostic naming the lane and the
    layer; "snapshot" checkpoints the sweep (restorable, the lane still
    quarantined) and trains on, "halt" stops it until restore(), also
    across step() calls."""
    lines = []
    for make, sub in ((port_sweep, "p"), (ref_sweep, "r")):
        (tmp_path / sub).mkdir()
        text = solver_text(str(tmp_path / sub / "snap"), debug=False)
        s = port_solver(text) if make is port_sweep else ref_solver(text)
        s.enable_metrics(ListSink())
        s.enable_watchdog(policy)
        with jax.enable_x64(False):
            r = (TSweep(s, 3, device="cpu", pipeline_depth=0)
                 if make is port_sweep else JSweep(s, 3, pipeline_depth=0))
        w = np.array(r.params["fc2"][0])
        w[2].flat[0] = np.nan
        r.params["fc2"][0] = (torch.from_numpy(w) if make is port_sweep
                              else jnp.asarray(w))
        capsys.readouterr()
        with jax.enable_x64(False):
            r.step(4, chunk=1)
            it = r.iter
            r.step(2, chunk=1)
        lines.append(_sweep_lines(capsys.readouterr().out))
        assert r.quarantined().tolist() == [2]
        if policy == "halt":
            assert it == r.iter == 1
        else:
            assert r.iter == 6
        if make is port_sweep:
            port = r
        r.close()
    got, want = [[ln.replace(str(tmp_path / sub), "D") for ln in ls]
                 for ls, sub in zip(lines, "pr")]
    assert got == want
    assert "(forward phase, layer fc2, top blob fc2)" in got[0]
    files = glob.glob(str(tmp_path / "p" / "snap_sweep_iter_*.ckpt.npz"))
    if policy == "halt":
        assert not files
        return
    assert [f.rsplit("_", 1)[1] for f in files] == ["1.ckpt.npz"]
    r2 = port_sweep(solver_text(str(tmp_path / "q"), debug=False), C=3)
    r2.restore(files[0])
    assert r2.quarantined().tolist() == [2] and r2.iter == 1
    assert port._stop is False
