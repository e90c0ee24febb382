"""SweepRunner: a Monte-Carlo sweep of C fault configs trained at once
(counterpart of the reference package's parallel/sweep.py SweepRunner).

    runner = SweepRunner(solver, n_configs=512, engine="cuda",
                         packed_state=True, dtype_policy="ternary")
    losses = runner.step(iters, chunk=5)      # (C,) last-iteration losses

Every config lane starts from the solver's params and SGD history and
draws its own fault state, its lifetimes re-anchored to the lane's
(mean, std). One step is the solver's step body built with a config
axis (`Solver.make_train_step(lanes=C)`): the lanes share one batch per
iteration, kernel B2 reads every lane's InnerProduct weights in one
launch per layer, kernel B1 runs ApplyUpdate+Fail once per fault leaf,
and kernel B4 (RRAM_POOL_BWD=cuda) takes each MAX pooling backward over
all lanes' planes. A lane whose loss goes non-finite is quarantined:
its update, and every later one, is discarded while the other lanes
train on unchanged.

With `preload` and a Data layer that decodes deterministically, the
whole LMDB lives on the device and step t gathers records
(t*B + arange(B)) % N there, the host cursor's order; losses stay on
the device until a chunk of `chunk` iterations ends.

Not ported yet, each refused by name: mesh, config_block,
remat_segments, compute_dtype, pipeline_depth, stall_timeout_s,
health_every, conv_im2col, self-healing, checkpoint/restore and fault
state files. The genetic strategy never reaches a sweep: the port's
Solver refuses every failure strategy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.feed import can_materialize, materialize_data_source
from ..device import resolve_device
from ..fault import engine as fault_engine
from ..fault import packed as fault_packed

SWEEP_ENGINES = ("auto", "cuda", "torch")
# constructor options of the reference runner this slice does not port,
# with the value that means "off"
UNPORTED_OPTIONS = {"mesh": None, "config_block": 0, "remat_segments": 0,
                    "compute_dtype": None, "pipeline_depth": None,
                    "stall_timeout_s": None, "health_every": 0,
                    "conv_im2col": None}


def _not_ported(what: str):
    raise NotImplementedError(f"SweepRunner: {what} is not ported to the "
                              "PyTorch/CUDA package yet")


def _lane_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.view((-1,) + (1,) * (like.dim() - 1))


class SweepRunner:
    """C fault configs of one solver, trained together on `device` (the
    card by default; raises without one unless device="cpu", which
    must be the solver's device too).

    `engine`: "cuda" runs kernels B2/B1 (their wrappers take the plain
    versions on CPU tensors), "torch" the plain versions by name, "auto"
    is "cuda" on a CUDA device. `packed_state`, `dtype_policy` and
    `fused_epilogue` are the solver's step options."""

    def __init__(self, solver, n_configs: int, means=None, stds=None,
                 preload: bool = True, engine: str = "auto",
                 packed_state: bool = False, dtype_policy=None,
                 fused_epilogue=None, device=None, **options):
        for name, value in options.items():
            if name not in UNPORTED_OPTIONS:
                raise TypeError(f"SweepRunner got an unexpected option "
                                f"{name!r}")
            if value != UNPORTED_OPTIONS[name]:
                _not_ported(f"{name}={value!r}")
        if engine not in SWEEP_ENGINES:
            raise ValueError(f"unknown sweep engine {engine!r} (expected "
                             f"one of {SWEEP_ENGINES})")
        if n_configs < 1:
            raise ValueError(f"n_configs must be >= 1, got {n_configs}")
        if solver.fault_state is None:
            raise ValueError("SweepRunner needs a solver with a "
                             "failure_pattern")
        self.device = resolve_device(device)
        if solver.device != self.device:
            raise ValueError(f"SweepRunner on {self.device} needs a solver "
                             f"on the same device (it is on "
                             f"{solver.device})")
        self.solver = solver
        self.n = int(n_configs)
        self.iter = 0
        self.last_losses: Optional[np.ndarray] = None
        self.chunk_losses: Optional[np.ndarray] = None   # (k, C)
        if engine == "auto":
            engine = "cuda" if self.device.type == "cuda" else "torch"
        self.engine = engine

        pattern = solver.param.failure_pattern
        flat = solver._flat(solver.params)
        shapes = {k: tuple(flat[k].shape) for k in solver._fault_keys}
        state = fault_engine.stack_fault_states(
            solver.gen, shapes, pattern, self.n, means=means, stds=stds)
        self._pack_spec = None
        if packed_state:
            # counter dtype sized from every configured (mean, std)
            self._pack_spec = fault_packed.make_pack_spec(
                state, solver.fail_decrement,
                means=[float(pattern.mean)] if means is None else means,
                stds=[float(pattern.std)] if stds is None else stds)
            state = fault_packed.pack_state(state, self._pack_spec,
                                            device=self.device)
        else:
            state = {g: {k: v.to(self.device) for k, v in grp.items()}
                     for g, grp in state.items()}
        self.fault_states = state

        def bcast(t):
            return t.unsqueeze(0).repeat((self.n,) + (1,) * t.dim())
        self.params = {ln: [None if t is None else bcast(t) for t in vals]
                       for ln, vals in solver.params.items()}
        self.history = {k: {s: bcast(v) for s, v in slots.items()}
                        for k, slots in solver.history.items()}
        self.quarantine = torch.zeros(self.n, dtype=torch.bool,
                                      device=self.device)

        self._step = solver.make_train_step(
            hw_engine=engine, dtype_policy=dtype_policy,
            fault_format="packed" if packed_state else "f32",
            pack_spec=self._pack_spec, fused_epilogue=fused_epilogue,
            lanes=self.n)
        self.engine_resolved = self._step.hw_engine_resolved
        self.fused_epilogue_resolved = self._step.fused_epilogue_resolved
        self.fused_epilogue_reason = self._step.fused_epilogue_reason

        self._dataset = None
        self._ds_batch = self._ds_n = 0
        layer = self._materializable_layer() if preload else None
        arrays = materialize_data_source(layer) if layer is not None \
            else None
        if arrays is not None:
            self._dataset = {k: torch.from_numpy(v).to(self.device)
                             for k, v in arrays.items()}
            self._ds_batch = int(layer.lp.data_param.batch_size)
            self._ds_n = next(iter(arrays.values())).shape[0]
            self._arange = torch.arange(self._ds_batch, device=self.device)

    # ------------------------------------------------------------------
    def _materializable_layer(self):
        """The single Data layer whose DB can live on the device, or
        None (a custom feed, another layer mix, random transforms)."""
        if self.solver.custom_train_feed:
            return None
        src = [ly for ly in self.solver.net.layers if ly.is_data_source]
        if len(src) != 1 or not can_materialize(src[0]):
            return None
        return src[0]

    def _batch(self, it: int) -> dict:
        if self._dataset is None:
            return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                    for k, v in self.solver.train_feed().items()}
        # the host cursor's wrap-around order; the offset is exact host
        # integer arithmetic
        start = (it * self._ds_batch) % self._ds_n
        idx = (self._arange + start) % self._ds_n
        return {k: a.index_select(0, idx) for k, a in self._dataset.items()}

    def step(self, iters: int = 1, chunk: int = 1) -> np.ndarray:
        """Run `iters` sweep iterations, `chunk` of them per host round
        trip (the per-lane losses of a chunk are read back together,
        into `chunk_losses`). Returns the last iteration's per-lane
        losses, (C,)."""
        done = 0
        while done < iters:
            k = min(max(chunk, 1), iters - done)
            losses = []
            for _ in range(k):
                p2, h2, f2, loss, _ = self._step(
                    self.params, self.history, self.fault_states,
                    self._batch(self.iter), self.iter, self.solver.gen)
                self._commit(p2, h2, f2, loss)
                losses.append(loss)
                self.iter += 1
            self.chunk_losses = torch.stack(losses).cpu().numpy()
            self.last_losses = self.chunk_losses[-1]
            done += k
        return self.last_losses

    def _commit(self, params, history, fault_states, loss):
        """The per-lane quarantine (the reference's
        _make_quarantine_step): a lane whose loss is non-finite, or that
        was quarantined before, keeps its pre-step state."""
        bad = self.quarantine | ~torch.isfinite(loss)

        def keep(old, new):
            if new is old or new is None:
                return new
            return torch.where(_lane_mask(bad, new), old, new)
        self.params = {ln: [keep(o, v) for o, v in zip(self.params[ln],
                                                        vals)]
                       for ln, vals in params.items()}
        self.history = {k: {s: keep(self.history[k][s], v)
                            for s, v in slots.items()}
                        for k, slots in history.items()}
        self.fault_states = {g: {k: keep(self.fault_states[g][k], v)
                                 for k, v in grp.items()}
                             for g, grp in fault_states.items()}
        self.quarantine = bad

    # ------------------------------------------------------------------
    def quarantined(self) -> np.ndarray:
        """Ids of quarantined lanes, ascending."""
        return np.flatnonzero(self.quarantine.cpu().numpy())

    def broken_fractions(self) -> np.ndarray:
        """Per-lane share of broken cells over every fault leaf, (C,)."""
        lives = self.fault_states.get("life_q",
                                      self.fault_states.get("lifetimes"))
        broken = sum((v <= 0).reshape(self.n, -1).sum(1)
                     for v in lives.values())
        total = sum(v[0].numel() for v in lives.values())
        return (broken.double() / max(total, 1)).cpu().numpy()

    def _state_tensors(self):
        for vals in self.params.values():
            yield from (t for t in vals if t is not None)
        for slots in self.history.values():
            yield from slots.values()
        for _, v in fault_engine.iter_state_leaves(self.fault_states):
            yield v
        yield self.quarantine

    def bytes_per_step_est(self) -> int:
        """Device-memory bytes one sweep iteration must move for its
        resident state: every state leaf (params, history, fault banks,
        the quarantine mask) read and written once, plus the batch
        gathered from the device dataset. Activations are left out, as
        the reference leaves them out (its conv-patch term is 0 without
        tiled convolutions)."""
        total = 2 * sum(t.numel() * t.element_size()
                        for t in self._state_tensors())
        if self._dataset is not None:
            total += self._ds_batch * sum(
                a[0].numel() * a.element_size()
                for a in self._dataset.values())
        return int(total)

    def lane_state(self, i: int):
        """(params, history, fault_state) of lane i, copies without the
        config axis: the state a single-config Solver would hold."""
        params = {ln: [None if t is None else t[i].clone() for t in vals]
                  for ln, vals in self.params.items()}
        history = {k: {s: v[i].clone() for s, v in slots.items()}
                   for k, slots in self.history.items()}
        fault = {g: {k: v[i].clone() for k, v in grp.items()}
                 for g, grp in self.fault_states.items()}
        return params, history, fault

    # the reference runner's durability and self-healing layers
    def enable_self_healing(self, *args, **kwargs):
        _not_ported("self-healing")

    def submit_configs(self, *args, **kwargs):
        _not_ported("self-healing (submit_configs)")

    def checkpoint(self, *args, **kwargs):
        _not_ported("checkpoint")

    def restore(self, *args, **kwargs):
        _not_ported("restore")

    def save_fault_states(self, *args, **kwargs):
        _not_ported("save_fault_states")
