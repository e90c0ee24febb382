"""Kernel B1's group wrapper (`fused_update_fail_leaves`) and its host
plan (`b1_plan`) on the CPU.

The group on CPU tensors runs the plain version leaf by leaf; it is held
bit for bit against the reference's per-leaf `fused_update_fail` (its
Pallas kernel in interpret mode, `jax.vmap` for the lanes) at the
untiled and tiled slices' leaves. The kernel's index maps (tiles of
4096 cells leaf after leaf, a thread's four chunks of four cells, the
bank byte by row and column) are emulated here in numpy from
csrc/fused_epilogue.cu: every cell of every leaf is taken exactly once,
never a padding column of the bank, and the emulated kernel gives the
plain version's bits."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu.fault import fused as jfused
from rram_caffe_simulation_tpu.fault import packed as jpacked
from rram_caffe_simulation_tpu_torch import proto as tproto
from rram_caffe_simulation_tpu_torch.fault import fused as tfused
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.solver import Solver as TSolver
from rram_caffe_simulation_tpu_torch.solver import solver as tsolver

from test_torch_solver import REPO, SOLVER

MODES = tfused.FUSED_MODES
# a step's fault leaves: the untiled slice (ip1, ip2) and the tiled one
# (conv_also: conv1-3 weights and biases too), CIFAR-10-quick
UNTILED = [(64, 1024), (64,), (10, 64), (10,)]
TILED = [(32, 3, 5, 5), (32,), (32, 32, 5, 5), (32,), (64, 32, 5, 5),
         (64,), (64, 1024), (64,), (10, 64), (10,)]
LEAF_SETS = {"untiled": UNTILED, "tiled": TILED}


def leaf(shape, seed, dtype=np.int32):
    """(data, upd, life_q, bank) with exact-zero, tiny (around the 1e-20
    write gate) and regular updates, counters near zero."""
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


def group(shapes, C, dtype, seed=0):
    lead = (C,) if C > 1 else ()
    return [leaf(lead + tuple(s), seed + i, dtype)
            for i, s in enumerate(shapes)]


def as_torch(leaves):
    return [[torch.from_numpy(np.ascontiguousarray(lf[j])) for lf in leaves]
            for j in range(4)]


def assert_bits(a, b):
    x, y = np.asarray(a), np.asarray(b)
    if x.dtype == np.float32:
        x, y = x.view(np.uint32), y.view(np.uint32)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("leaf_set", sorted(LEAF_SETS))
def test_group_matches_reference_per_leaf(leaf_set, C, dtype, mode):
    leaves = group(LEAF_SETS[leaf_set], C, dtype)
    one = lambda *a: jfused.fused_update_fail(*a, mode=mode)
    ref = jax.jit(lambda ls: [(jax.vmap(one) if C > 1 else one)(*lf)
                              for lf in ls])(
        [tuple(jnp.asarray(a) for a in lf) for lf in leaves])
    td, tq = tfused.fused_update_fail_leaves(*as_torch(leaves), mode=mode)
    assert len(td) == len(tq) == len(leaves)
    for (jd, jq), d, q in zip(ref, td, tq):
        assert_bits(d.numpy(), jd)
        assert_bits(q.numpy(), jq)


# ---------------------------------------------------------------------------
# the kernel's index maps, emulated (csrc/fused_epilogue.cu `tile`)

def tile_cells(lf, t):
    """Kernel B1's maps for tile t of the launch on leaf `lf` (a B1Leaf):
    (flat cell, bank byte, bit shift, taken) a (chunk slot, thread, cell)
    each. Chunk c = (t - first_tile) * 1024 + k * 256 + thread holds
    cells 4c .. 4c + 3; the bank byte is c where L % 4 == 0, else walked
    from divmod(4c, L) a column at a time, as the kernel does."""
    k = np.arange(tfused.B1_CHUNKS)[:, None]
    c = ((t - lf.first_tile) * tfused.B1_THREADS * tfused.B1_CHUNKS
         + k * tfused.B1_THREADS + np.arange(tfused.B1_THREADS))
    flat = 4 * c[..., None] + np.arange(4)
    taken = flat < lf.cells
    if lf.L % 4 == 0:
        byte = np.repeat(c[..., None], 4, axis=-1)
        shift = np.broadcast_to(2 * np.arange(4), flat.shape)
        return flat, byte, shift, taken
    Lb = -(-lf.L // 4)
    row, col = np.divmod(4 * c, lf.L)
    byte, shift = np.empty_like(flat), np.empty_like(flat)
    for i in range(4):
        byte[..., i] = row * Lb + col // 4
        shift[..., i] = 2 * (col % 4)
        col = col + 1
        wrap = col == lf.L
        col, row = np.where(wrap, 0, col), np.where(wrap, row + 1, row)
    return flat, byte, shift, taken


def launch_tiles(table):
    """(tile, leaf) in the order a block strides: the kernel's leaf search
    (`while (t >= leaf[e + 1].first_tile) ++e`)."""
    e = 0
    for t in range(sum(lf.tiles for lf in table)):
        while e + 1 < len(table) and t >= table[e + 1].first_tile:
            e += 1
        yield t, table[e]


def emulate(leaves, mode, capacity=tfused.B1_LEAVES):
    """The kernel on numpy leaves through the plan's launches; also how
    often each cell was taken."""
    plan = tfused.b1_plan([(lf[0].size, lf[0].shape[-1]) for lf in leaves],
                          capacity)
    outs = [(np.empty_like(lf[0]), np.empty_like(lf[2])) for lf in leaves]
    seen = [np.zeros(lf[0].size, np.int64) for lf in leaves]
    for table in plan:
        for t, lf in launch_tiles(table):
            data, upd, lq, bank = (a.reshape(-1) for a in leaves[lf.index])
            flat, byte, shift, taken = tile_cells(lf, t)
            f, b, s = flat[taken], byte[taken], shift[taken]
            np.add.at(seen[lf.index], f, 1)
            q = lq[f].astype(np.int64)
            if mode == "write":
                gate = np.abs(upd[f]) >= np.float32(1e-20)
            else:
                gate = np.full(f.shape, mode == "always")
            q2 = np.where((q > 0) & gate, q - 1, q)
            stuck = ((bank[b].astype(np.int64) >> s) & 3).astype(
                np.float32) - np.float32(1.0)
            od, oq = (o.reshape(-1) for o in outs[lf.index])
            od[f] = np.where(q2 <= 0, stuck, data[f] - upd[f])
            oq[f] = q2
    return outs, seen, plan


def check_tile_maps(lf):
    """Tile j of a leaf takes exactly its cells [4096 j, 4096 (j + 1)),
    each once, with the bank byte and bits of (row, col) = divmod(cell,
    L) and never a padding column; checked at the first, a middle and the
    last tile (no arrays of the leaf's size)."""
    Lb = -(-lf.L // 4)
    for j in sorted({0, lf.tiles // 2, lf.tiles - 1}):
        flat, byte, shift, taken = tile_cells(lf, lf.first_tile + j)
        f = np.sort(flat[taken])
        lo = j * tfused.B1_TILE
        np.testing.assert_array_equal(
            f, np.arange(lo, min(lo + tfused.B1_TILE, lf.cells)))
        row, col = np.divmod(flat[taken], lf.L)
        np.testing.assert_array_equal(byte[taken], row * Lb + col // 4)
        np.testing.assert_array_equal(shift[taken], 2 * (col % 4))
        # the bits stay inside the row's first L codes
        col_of_bits = 4 * (byte[taken] - row * Lb) + shift[taken] // 2
        assert (col_of_bits < lf.L).all()


@pytest.mark.parametrize("C", [1, 64, 512])
@pytest.mark.parametrize("leaf_set", sorted(LEAF_SETS))
def test_b1_plan_covers_each_cell_once(leaf_set, C):
    shapes = LEAF_SETS[leaf_set]
    leaves = [(C * int(np.prod(s)), s[-1]) for s in shapes]
    plan = tfused.b1_plan(leaves)
    assert len(plan) == 1                       # one launch a step
    (table,) = plan
    assert [lf.index for lf in table] == list(range(len(shapes)))
    first = 0
    for lf, (cells, L) in zip(table, leaves):
        assert (lf.cells, lf.L, lf.first_tile) == (cells, L, first)
        assert lf.tiles == -(-cells // tfused.B1_TILE)
        first += lf.tiles
        check_tile_maps(lf)
    # every tile of the launch belongs to exactly the leaf that owns it
    owners = [lf.index for _, lf in launch_tiles(table)]
    assert owners == [lf.index for lf in table for _ in range(lf.tiles)]


@pytest.mark.parametrize("L", [1, 3, 5, 10])
def test_b1_emulated_kernel_on_ragged_rows_equals_plain(L):
    """Leaves whose rows are not whole bank bytes, over more than one tile
    and with a partial last chunk (and a second, single-row leaf), through
    the emulated kernel: every cell once, the plain version's bits."""
    rows = tfused.B1_TILE // L + 7
    leaves = [leaf((rows, L), L), leaf((3, L), 100 + L)]
    for mode in MODES:
        outs, seen, _ = emulate(leaves, mode)
        for lf, (od, oq), n in zip(leaves, outs, seen):
            assert (n == 1).all()
            pd, pq = tfused.fused_update_fail_plain(
                *[torch.from_numpy(a) for a in lf], mode=mode)
            assert_bits(od, pd.numpy())
            assert_bits(oq, pq.numpy())


@pytest.mark.parametrize("n_leaves,capacity", [(37, tfused.B1_LEAVES),
                                               (10, 4)])
def test_b1_plan_larger_than_a_table(n_leaves, capacity):
    """A group larger than a table takes ceil(n / capacity) launches of the
    same kernel; each leaf is in exactly one, tiles numbered from 0 in
    each; the emulated launches give the plain version's bits."""
    rng = np.random.RandomState(n_leaves)
    shapes = [tuple(int(v) for v in rng.randint(1, 40, size=rng.randint(1, 3)))
              for _ in range(n_leaves)]
    leaves = [leaf(s, i) for i, s in enumerate(shapes)]
    outs, seen, plan = emulate(leaves, "write", capacity)
    assert len(plan) == -(-n_leaves // capacity)
    assert [lf.index for table in plan for lf in table] == list(
        range(n_leaves))
    for table in plan:
        assert len(table) <= capacity and table[0].first_tile == 0
    for lf, (od, oq), n in zip(leaves, outs, seen):
        assert (n == 1).all()
        pd, pq = tfused.fused_update_fail_plain(
            *[torch.from_numpy(a) for a in lf])
        assert_bits(od, pd.numpy())
        assert_bits(oq, pq.numpy())


def _bad_groups():
    d, u, q, b = (torch.from_numpy(a) for a in leaf((4, 8), 0))
    d2, u2, q2, b2 = (torch.from_numpy(a) for a in leaf((3, 5), 1))
    return {
        "mixed dtypes": (([d, d2], [u, u2], [q, q2.short()], [b, b2]), {},
                         TypeError, "one life_q dtype"),
        "mixed devices": (([d, d2.to("meta")], [u, u2], [q, q2], [b, b2]),
                          {}, ValueError, "different devices"),
        "wrong bank shape": (([d, d2], [u, u2], [q, q2], [b, b2[:, :1]]), {},
                             ValueError, "stuck_bits shape"),
        "unknown mode": (([d], [u], [q], [b]), {"mode": "sometimes"},
                         ValueError, "mode"),
        "lists of other lengths": (([d, d2], [u], [q, q2], [b, b2]), {},
                                   ValueError, "leaves"),
        "int64 counters": (([d], [u], [q.long()], [b]), {}, TypeError,
                           "int16 or int32"),
    }


@pytest.mark.parametrize("case", sorted(_bad_groups()))
def test_group_wrapper_raises(case):
    args, kw, err, match = _bad_groups()[case]
    with pytest.raises(err, match=match):
        tfused.fused_update_fail_leaves(*args, **kw)


def test_fused_tail_equals_per_leaf_sequence():
    """The solver's tail (one group call) against the per-leaf calls it
    replaces, on the tiled leaf set at C = 3; the dicts passed in stay."""
    keys = [f"leaf{i}" for i in range(len(TILED))]
    leaves = group(TILED, 3, np.int32, seed=40)
    d, u, q, b = as_torch(leaves)
    data = dict(zip(keys, d))
    data["other"] = torch.ones(3)
    upd = dict(zip(keys, u))
    state = {"life_q": dict(zip(keys, q)), "stuck_bits": dict(zip(keys, b))}
    before = {k: v.clone() for k, v in state["life_q"].items()}
    nd, ns = tsolver.fused_tail(tfused.fused_update_fail_leaves, keys, data,
                                upd, state)
    assert nd["other"] is data["other"]
    for k in keys:
        pd, pq = tfused.fused_update_fail_plain(
            data[k], upd[k], state["life_q"][k], state["stuck_bits"][k])
        assert_bits(nd[k].numpy(), pd.numpy())
        assert_bits(ns["life_q"][k].numpy(), pq.numpy())
        assert_bits(state["life_q"][k].numpy(), before[k].numpy())
    assert ns["stuck_bits"] is state["stuck_bits"]


def test_solver_group_tail_equals_unfused_steps(monkeypatch):
    """A CPU Solver whose tail is the group call against the same solver
    with the unfused tail (`data - upd`, then `fail_packed`): params and
    counters bit-identical over a few steps."""
    monkeypatch.chdir(REPO)
    runs = []
    for fused in (True, False):
        s = TSolver(tproto.parse(SOLVER, "SolverParameter"), device="cpu",
                    hw_engine="cuda", dtype_policy="ternary",
                    fault_format="packed", fused_epilogue=fused)
        assert s._step_fn.fused_epilogue_resolved is fused
        s.step(3)
        runs.append(s)
    a, b = runs
    for k, q in a.fault_state["life_q"].items():
        assert_bits(q.numpy(), b.fault_state["life_q"][k].numpy())
    for ln, vals in a.params.items():
        for x, y in zip(vals, b.params[ln]):
            assert_bits(x.detach().numpy(), y.detach().numpy())
