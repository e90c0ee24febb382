"""Fused ApplyUpdate + Fail epilogue (counterpart of the reference
package's fault/fused.py): the SGD subtract and the packed fault
transition of a step's fault leaves in one pass, kernel B1
(csrc/fused_epilogue.cu).

Semantics are exactly `data - upd` followed by `packed.fail_packed`,
leaf by leaf, bit for bit; `fused_update_fail_plain` is that sequence
written out, and the card's kernel is held against it with
`torch.equal`.

`fused_update_fail_leaves` takes a step's fault leaves as one group
and launches B1 once for all of them: the leaves travel as a table in
the kernel's parameters, and `b1_plan` numbers the kernel's tiles (4096
consecutive cells of one leaf each) leaf after leaf, at most
`B1_LEAVES` leaves a launch. The reference launches its Pallas kernel
once per leaf (fault/processes/base.py:122-129); the function of each
leaf is the same. `fused_update_fail` is the one-leaf group, the
counterpart of the reference's per-leaf function; `fused_tail` is a
step's call on its fault leaves. The mode is the fault-process stack's
("write" endurance, "always" read disturb, "never" a static defect map);
`FUSED_LIB.tagged` counts the launches by mode.

What bounds B1 on an H100 is bytes (each operand read once, each output
written once); the kernel moves them in 16-byte streaming loads and
stores, a thread four chunks of four cells with every load issued
before any store. Every leaf of a group shares one counter dtype (the
pack spec chooses it for the whole state) and one mode; a leaf whose
operands are off the 16-byte grid (a view) takes scalar loads in the
same launch, never a copy.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from .. import kernels
from . import packed as fault_packed

FUSED_MODES = ("write", "always", "never")

B1_THREADS = 256            # csrc/fused_epilogue.cu kThreads
B1_CHUNKS = 4               # chunks of 4 cells a thread takes from a tile
B1_TILE = 4 * B1_CHUNKS * B1_THREADS     # cells a tile: 4096
B1_LEAVES = 16              # leaves the table of one launch holds

_VP = ctypes.c_void_p
FUSED_LIB = kernels.CudaLibrary(
    "fused_epilogue.cu",
    {"rram_fused_update_fail_leaves":
        [ctypes.c_int, ctypes.c_int, _VP, _VP, ctypes.c_longlong,
         ctypes.c_int, _VP]})
_LQ_BYTES = {torch.int16: 2, torch.int32: 4}

B1Leaf = collections.namedtuple("B1Leaf", "index cells L first_tile tiles")
B1Leaf.__doc__ = """One leaf of a B1 launch's table: its index in the
group, its cells and last axis L, and its tiles (`first_tile` counted
from the launch's first)."""


def b1_plan(leaves, capacity: int = B1_LEAVES):
    """Kernel B1's launches for a group of leaves given as (cells, L):
    a list of tables of at most `capacity` leaves each, every table a
    tuple of `B1Leaf`. A leaf's cells fill ceil(cells / B1_TILE) tiles,
    numbered leaf after leaf from 0 in each launch; tile j of a leaf
    holds its cells [j * B1_TILE, (j + 1) * B1_TILE)."""
    launches = []
    for start in range(0, len(leaves), capacity):
        table, first = [], 0
        for i in range(start, min(start + capacity, len(leaves))):
            cells, L = leaves[i]
            tiles = -(-int(cells) // B1_TILE)
            table.append(B1Leaf(i, int(cells), int(L), first, tiles))
            first += tiles
        launches.append(tuple(table))
    return launches


def fused_update_fail_plain(data, upd, life_q, stuck_bits,
                            mode: str = "write"):
    """The plain PyTorch version of kernel B1 on one leaf: `data - upd`,
    then `fail_packed`."""
    L = data.shape[-1]
    new, state = fault_packed.fail_packed(
        {"leaf": data - upd}, {"life_q": {"leaf": life_q},
                               "stuck_bits": {"leaf": stuck_bits}},
        {"leaf": upd}, {"last_dim": {"leaf": L}}, mode=mode)
    return new["leaf"], state["life_q"]["leaf"]


def fused_update_fail_leaves_plain(datas, upds, life_qs, banks,
                                   mode: str = "write"):
    """The plain version of a group: `fused_update_fail_plain` leaf by
    leaf; ([data'], [life_q'])."""
    outs = [fused_update_fail_plain(*leaf, mode=mode)
            for leaf in zip(datas, upds, life_qs, banks)]
    return [o[0] for o in outs], [o[1] for o in outs]


def _check(data, upd, life_q, stuck_bits):
    if data.dtype != torch.float32 or upd.dtype != torch.float32:
        raise TypeError("fused_update_fail: data and upd must be float32")
    if life_q.dtype not in _LQ_BYTES:
        raise TypeError(f"fused_update_fail: life_q must be int16 or "
                        f"int32, got {life_q.dtype}")
    if stuck_bits.dtype != torch.uint8:
        raise TypeError("fused_update_fail: stuck_bits must be uint8")
    if upd.shape != data.shape or life_q.shape != data.shape:
        raise ValueError(f"fused_update_fail: shapes differ: data "
                         f"{tuple(data.shape)}, upd {tuple(upd.shape)}, "
                         f"life_q {tuple(life_q.shape)}")
    L = data.shape[-1]
    want = tuple(data.shape[:-1]) + (-(-L // 4),)
    if tuple(stuck_bits.shape) != want:
        raise ValueError(f"fused_update_fail: stuck_bits shape "
                         f"{tuple(stuck_bits.shape)}, expected {want}")


def fused_update_fail_leaves(datas, upds, life_qs, banks,
                             mode: str = "write"):
    """([data'], [life_q']) of one step for a group of fault leaves:
    per leaf data' = where(life_q' <= 0, stuck, data - upd), the counter
    decremented per `mode`. Leading axes (a config axis) fold into rows.
    On CUDA tensors this launches kernel B1 once for up to `B1_LEAVES`
    leaves; on CPU tensors it runs the plain version leaf by leaf. The
    outputs are new tensors."""
    if mode not in FUSED_MODES:
        raise ValueError(f"unknown fused epilogue mode {mode!r} "
                         f"(expected one of {FUSED_MODES})")
    groups = (list(datas), list(upds), list(life_qs), list(banks))
    if len({len(g) for g in groups}) != 1:
        raise ValueError(f"fused_update_fail: {[len(g) for g in groups]} "
                         "data, upd, life_q and stuck_bits leaves")
    leaves = list(zip(*groups))
    for leaf in leaves:
        _check(*leaf)
    if not leaves:
        return [], []
    if len({q.dtype for q in groups[2]}) != 1:
        raise TypeError(f"fused_update_fail: one life_q dtype a group, got "
                        f"{sorted({str(q.dtype) for q in groups[2]})}")
    if len({t.device for leaf in leaves for t in leaf}) != 1:
        raise ValueError("fused_update_fail: operands on different devices")
    datas, upds, life_qs, banks = groups
    if not datas[0].is_cuda:
        return fused_update_fail_leaves_plain(datas, upds, life_qs, banks,
                                              mode)
    if not all(t.is_contiguous() for leaf in leaves for t in leaf):
        raise ValueError("fused_update_fail: operands must be contiguous")
    out_d = [torch.empty_like(d) for d in datas]
    out_q = [torch.empty_like(q) for q in life_qs]
    shapes = [(d.numel(), d.shape[-1]) for d in datas]
    stream = kernels.stream_ptr(datas[0].device)
    for table in b1_plan(shapes):
        tiles = sum(leaf.tiles for leaf in table)
        if not tiles:
            continue
        ptrs = (ctypes.c_void_p * (6 * len(table)))(*[
            t.data_ptr() for leaf in table for t in (
                datas[leaf.index], upds[leaf.index], life_qs[leaf.index],
                banks[leaf.index], out_d[leaf.index], out_q[leaf.index])])
        plan = (ctypes.c_longlong * (3 * len(table)))(*[
            v for leaf in table for v in (leaf.cells, leaf.L,
                                          leaf.first_tile)])
        FUSED_LIB.call("rram_fused_update_fail_leaves",
                       _LQ_BYTES[life_qs[0].dtype], len(table), ptrs, plan,
                       tiles, FUSED_MODES.index(mode), stream, tag=mode)
    return out_d, out_q


def fused_tail(fused_fn, keys, data, upd, fault_state):
    """A step's fused ApplyUpdate+Fail: `fused_fn` (the group wrapper of
    kernel B1, or its plain version, with the process stack's
    `fused_mode` bound) called once on the fault leaves `keys` of `data`
    (pre-update values), `upd` and the packed banks. Returns (data with
    those leaves replaced, fault_state with the new counters); the dicts
    passed in are not changed."""
    new_d, new_q = fused_fn([data[k] for k in keys], [upd[k] for k in keys],
                            [fault_state["life_q"][k] for k in keys],
                            [fault_state["stuck_bits"][k] for k in keys])
    return ({**data, **dict(zip(keys, new_d))},
            {**fault_state,
             "life_q": {**fault_state["life_q"], **dict(zip(keys, new_q))}})


def fused_update_fail(data, upd, life_q, stuck_bits, mode: str = "write"):
    """(data', life_q') of one step for one fault leaf: the group of one
    (`fused_update_fail_leaves`), the counterpart of the reference's
    per-leaf function."""
    (d,), (q,) = fused_update_fail_leaves([data], [upd], [life_q],
                                          [stuck_bits], mode)
    return d, q
