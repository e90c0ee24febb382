"""On-device metric reductions of the train step (counterpart of the
reference package's observe/counters.py).

The counters are tensor reductions computed inside the step: they stay
on the device as a small tree of scalars (per-lane vectors under the
sweep's config axis) and reach the host only where the caller already
waits, at a display boundary or on the sweep's consumer. `HostCopy`
starts that transfer without waiting: non-blocking copies into pinned
host buffers and an event after them, which the reading thread waits
on.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def _lane_sum(t: torch.Tensor, lanes: int) -> torch.Tensor:
    return t.reshape(lanes, -1).sum(1) if lanes else t.sum()


def mean_abs(x: torch.Tensor) -> torch.Tensor:
    """asum/count of a blob (Blob::asum_data()/count()), f32."""
    return x.float().abs().mean()


def global_norm_sq(tree: Dict[str, torch.Tensor],
                   lanes: int = 0) -> torch.Tensor:
    """Sum of squares over a flat dict of tensors, f32 (per lane under
    `lanes`)."""
    return sum(_lane_sum(v.float() * v.float(), lanes)
               for v in tree.values())


def write_traffic_saved(before: Dict[str, torch.Tensor],
                        after: Dict[str, torch.Tensor], epsilon: float,
                        lifetimes: Optional[Dict[str, torch.Tensor]] = None,
                        lanes: int = 0) -> torch.Tensor:
    """Cells whose pending write the threshold strategy suppressed this
    step: |update| >= epsilon would have decremented the cell's lifetime,
    but the strategy zeroed it. `lifetimes` (pre-fail) counts alive
    cells only: a suppressed write to a broken cell saves nothing.
    An integer count (per lane under `lanes`)."""
    saved = None
    for k in before:
        suppressed = (before[k].abs() >= epsilon) & (after[k] == 0)
        if lifetimes is not None:
            suppressed = suppressed & (lifetimes[k] > 0)
        n = _lane_sum(suppressed, lanes)
        saved = n if saved is None else saved + n
    if saved is None:
        return torch.zeros((lanes,) if lanes else (), dtype=torch.int64)
    return saved


def tree_map(fn, tree):
    """`fn` over the tensor leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class HostCopy:
    """Host copies of a tree's tensors, started without waiting: a card
    tensor is copied with non_blocking into a pinned buffer on the
    current stream and an event recorded after the copies; a CPU tensor
    is cloned. `wait()` blocks on the event (which releases the GIL)
    and returns the host tree."""

    def __init__(self, tree):
        cuda = []

        def put(t):
            t = t.detach()
            if t.device.type != "cuda":
                return t.clone()
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            cuda.append(t.device)
            return buf
        self.tree = tree_map(put, tree)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(cuda[0]))

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.tree


def host_values(tree):
    """A tree of host tensors as Python numbers: scalars and nested
    lists (JSON-serialisable)."""
    return tree_map(lambda t: t.item() if t.dim() == 0 else t.tolist(),
                    tree)


def to_host(metrics):
    """The metrics tree as Python numbers, in one transfer: every card
    tensor copied at once, one wait."""
    return host_values(HostCopy(metrics).wait())
