"""The sweep's config_block in the port against the port's unblocked
runner: a blocked runner (the step on lane slices, each block's result
written back into the resident rows) equals the unblocked runner bit for
bit, every lane: losses, outputs, params, history, fault banks,
quarantine and every field of the metrics records but the timings;
untiled C = 8 in blocks of 4 and 2 (one lane poisoned in a later block;
read noise, whose seeds come from each lane's own key), tiled C = 4 in
blocks of 2, threshold and tracked remapping in the lanes,
pipeline_depth 2 with the census, the narrow VGG-BN net, and the debug
trace's vectors and sentinels. The rest of config_block and evaluate is
held in tests/test_torch_config_block.py."""
import json

import pytest

from test_torch_config_block import (assert_same_state, bits_equal,
                                     records_text, runner)
from test_torch_sweep import SOLVER, batches
from test_torch_sweep_strategies import strategy_text
from test_torch_tiles import conv_batches, conv_solver_text
from test_torch_vgg_bn_sweep import SOLVER as VGG_SOLVER


CASES = {
    # name: (text, batches, C, block, runner options, poisoned lane)
    "untiled-4": (SOLVER, "small", 8, 4,
                  {"metrics": True, "pipeline_depth": 0}, None),
    # read noise: each lane's crossbar seed comes from its global key
    "untiled-noise": (SOLVER + " rram_forward { sigma: 0.05 }", "small",
                      8, 4, {}, None),
    "untiled-2-poisoned": (SOLVER, "small", 8, 2,
                           {"metrics": True, "pipeline_depth": 0}, 5),
    "tiled": (conv_solver_text(), "conv", 4, 2,
              {"conv_im2col": "implicit", "metrics": True,
               "pipeline_depth": 0}, None),
    "strategies": ("remap", "small", 8, 4,
                   {"metrics": True, "pipeline_depth": 0}, None),
    "pipelined": (SOLVER, "small", 8, 2,
                  {"metrics": True, "pipeline_depth": 2,
                   "health_every": 2}, None),
    "vgg_bn": (VGG_SOLVER, "small", 4, 2, {}, None),
    "debug": (SOLVER + " debug_info: true", "small", 4, 2,
              {"pipeline_depth": 0}, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_equals_unblocked(tmp_path, case):
    text, kind, C, B, opts, poison = CASES[case]
    if text == "remap":
        text = strategy_text(tmp_path, "remap")
    bs = conv_batches(6, seed=5) if kind == "conv" else batches(6, seed=2)
    runs = []
    for block in (0, B):
        r, sink = runner(text, bs, C, block, **opts)
        assert len(r._blocks) == (1 if block == 0 else C // B)
        if poison is not None:
            r.params["ip2"][0][poison].view(-1)[0] = float("nan")
        losses, outs = [], []
        for _ in range(3):
            lo, out = r.step(2, chunk=2)
            losses.append(lo.copy())
            outs.append({k: v.copy() for k, v in out.items()})
        runs.append((r, sink, losses, outs))
    (a, sa, la, oa), (b, sb, lb, ob) = runs
    for x, y in zip(la, lb):
        assert x.tobytes() == y.tobytes()
    for x, y in zip(oa, ob):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].tobytes() == y[k].tobytes(), k
    assert_same_state(a, b)
    assert records_text(sa) == records_text(sb)
    if opts.get("metrics"):
        assert len(sa.records) >= 3
    if case == "pipelined":
        assert a.health_summary() == b.health_summary() is not None
    if poison is not None:
        assert a.quarantined().tolist() == [poison]
    if case == "debug":
        for k, v in a.last_metrics["debug"].items():
            w = b.last_metrics["debug"][k]
            if isinstance(v, dict):
                for kk in v:
                    assert bits_equal(v[kk], w[kk]), (k, kk)
            else:
                assert bits_equal(v, w), k
        assert json.dumps(a.sentinel_state()) == \
            json.dumps(b.sentinel_state())
        assert b.sentinel_state()[poison]["tripped"]
    for r in (a, b):
        r.close()
