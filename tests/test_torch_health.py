"""The port's crossbar health plane (fault/mapping.py census helpers,
observe/health.py CensusProgram and HealthLedger, the Solver's
enable_health and the SweepRunner's health_every) against the
reference package's.

Held on one fault state (lifetimes spread over every histogram bin,
broken cells stuck at -1, 0 and +1), f32 and packed, untiled and tiled:
histograms, counts and the tile geometry equal the reference's exactly,
life_min exactly, the f32 fractions and means within 1e-6 relative
(f32 reductions in another order). HealthLedger's forecast and summary
equal the reference's fed the same records. A port Solver with
enable_health and a port sweep with health_every write the reference's
health records (from one seed: the same banks), the sweep's with its
lane map, every one valid under both schemas: those two runs are in
tests/test_torch_health_runs.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import mapping as jmapping
from rram_caffe_simulation_tpu.fault.processes import FaultSpec
from rram_caffe_simulation_tpu.observe import health as jhealth
from rram_caffe_simulation_tpu_torch.fault import mapping as tmapping
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.fault.processes import \
    FaultSpec as TFaultSpec
from rram_caffe_simulation_tpu_torch.observe import counters as tcounters
from rram_caffe_simulation_tpu_torch.observe import health as thealth

from test_torch_observe import close

SHAPES = {"conv/0": (6, 3, 3, 3), "ip/0": (10, 27), "ip/1": (10,)}
DECREMENT = 100.0
TILES = [None, "2x2", "cells=4x8"]


def fault_state(lanes=0, seed=0):
    """Lifetimes log-spread over (1, 3e8) (every bin), a quarter of the
    cells broken (in (-300, 0], a few writes past the last), stuck
    values in {-1, 0, +1}."""
    rng = np.random.RandomState(seed)
    lead = (lanes,) if lanes else ()
    life, stuck = {}, {}
    for k, shape in SHAPES.items():
        alive = 10.0 ** rng.uniform(0, 8.5, lead + shape)
        broken = -rng.randint(0, 4, lead + shape) * DECREMENT \
            + rng.uniform(-DECREMENT, 0, lead + shape)
        life[k] = np.where(rng.rand(*(lead + shape)) < 0.25, broken,
                           alive).astype(np.float32)
        stuck[k] = rng.randint(-1, 2, lead + shape).astype(np.float32)
    return {"lifetimes": life, "stuck": stuck}


def spec_of(state):
    return {"decrement": DECREMENT, "life_dtype": "int32",
            "last_dim": {k: int(v.shape[-1])
                         for k, v in state["lifetimes"].items()}}


def both_tiles(text):
    return (None if text is None else jmapping.TileSpec.parse(text),
            tmapping.TileSpec.parse(text))


def host(tree):
    return jax.tree.map(lambda a: np.asarray(a).tolist(), tree)


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("lanes", [0, 3])
def test_per_tile_health_equals_the_reference(tiles, lanes):
    state = fault_state(lanes)
    jt, tt = both_tiles(tiles)
    lead = 1 if lanes else 0
    for k in SHAPES:
        life, stuck = state["lifetimes"][k], state["stuck"][k]
        nd = life.ndim - lead
        want = host(jmapping.per_tile_health(
            jnp.asarray(life), jnp.asarray(stuck), jt, jhealth.LIFE_EDGES,
            nd))
        got = tcounters.to_host(tmapping.per_tile_health(
            torch.from_numpy(life), torch.from_numpy(stuck), tt,
            thealth.LIFE_EDGES, nd))
        assert close(got, want) == [], k
        shape = SHAPES[k]
        assert tmapping.health_tiles(shape, tt) == \
            jmapping.health_tiles(shape, jt)


@pytest.mark.parametrize("tiles", ["2x2", "cells=4x8"])
@pytest.mark.parametrize("lanes", [0, 3])
def test_per_tile_counters_equal_the_reference(tiles, lanes):
    state = fault_state(lanes, seed=1)
    jt, tt = both_tiles(tiles)
    for k in ("conv/0", "ip/0"):
        life, stuck = state["lifetimes"][k], state["stuck"][k]
        fn = lambda l, s: jmapping.per_tile_counters(l, s, jt)
        if lanes:
            fn = jax.vmap(fn)
        want = host(fn(jnp.asarray(life), jnp.asarray(stuck)))
        got = tcounters.to_host(tmapping.per_tile_counters(
            torch.from_numpy(life), torch.from_numpy(stuck), tt, lanes))
        assert close(got, want) == [], k


@pytest.mark.parametrize("lanes", [0, 3])
def test_log_histogram_and_ages_equal_the_reference(lanes):
    rng = np.random.RandomState(2)
    lead = (lanes,) if lanes else ()
    # ages on and next to every edge: the binning's side matters
    edges = jhealth.AGE_EDGES
    vals = np.array([0.0, -1.0] + [e for e in edges]
                    + [np.nextafter(np.float32(e), np.float32(np.inf))
                       for e in edges] + [2e5], np.float32)
    age = rng.choice(vals, lead + (8, 12)).astype(np.float32)
    for axes in ((-1,), (-2, -1)):
        want = np.asarray(jmapping.log_histogram(jnp.asarray(age), edges,
                                                 axes))
        got = tmapping.log_histogram(torch.from_numpy(age), edges, axes)
        np.testing.assert_array_equal(got.numpy(), want)
    for tiles in TILES:
        jt, tt = both_tiles(tiles)
        want = host(jmapping.per_tile_ages(jnp.asarray(age), jt, edges, 2))
        got = tcounters.to_host(tmapping.per_tile_ages(
            torch.from_numpy(age), tt, edges, 2))
        assert close(got, want) == []


def _census_pair(tiles, packed, stacked):
    lanes = 3 if stacked else 0
    state = fault_state(lanes, seed=3)
    jt, tt = both_tiles(tiles)
    stack = FaultSpec.parse("endurance_stuck_at").build(tiles=jt)
    spec = None
    if packed:
        spec = spec_of(state)
        state = tpacked.pack_state(
            {g: {k: torch.from_numpy(v) for k, v in leaves.items()}
             for g, leaves in state.items()}, spec)
        jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    else:
        jstate = jax.tree.map(jnp.asarray, state)
        state = jax.tree.map(torch.from_numpy, state)
    want = jhealth.CensusProgram(stack, stacked=stacked, pack_spec=spec)(
        jstate)
    got = thealth.CensusProgram(
        TFaultSpec.parse("endurance_stuck_at").build(tiles=tt),
        stacked=stacked, pack_spec=spec)(state)
    return got, want


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_census_equals_the_reference(tiles, packed, stacked):
    got, want = _census_pair(tiles, packed, stacked)
    assert close(got, want) == []
    assert sorted(got) == sorted(SHAPES)


def _records(n=4):
    """A short stream of sweep census records with a lane map (a lane
    going idle, -1, midway), and single-run ones."""
    recs = []
    for i in range(n):
        got, _ = _census_pair("2x2", False, True)
        for name, st in got.items():
            st["broken_frac"] = [
                [min(1.0, b + 0.05 * i * (lane + 1)) for b in row]
                for lane, row in enumerate(st["broken_frac"])]
            st["life_mean"] = [[m - 1000.0 * i for m in row]
                               for row in st["life_mean"]]
        recs.append({"type": "health", "iter": 10 * (i + 1),
                     "decrement": DECREMENT,
                     "life_edges": list(thealth.LIFE_EDGES),
                     "lane_map": [0, 1, 2] if i < 2 else [0, -1, 2],
                     "params": got})
    single, _ = _census_pair(None, True, False)
    recs.append({"type": "health", "iter": 5, "decrement": DECREMENT,
                 "params": single})
    return recs


@pytest.mark.parametrize("threshold", [None, 0.1])
def test_ledger_equals_the_reference(threshold):
    kw = {} if threshold is None else {"threshold": threshold}
    t, j = thealth.HealthLedger(**kw), jhealth.HealthLedger(**kw)
    assert t.summary() is None and j.summary() is None
    for rec in _records() + [{"type": "span"}]:
        t.update(rec)
        j.update(rec)
    assert t.summary() == j.summary()
    assert t.forecast() == j.forecast()
    assert t.worst_tiles(5) == j.worst_tiles(5)
