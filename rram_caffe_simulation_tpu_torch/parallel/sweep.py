"""SweepRunner: a Monte-Carlo sweep of C fault configs trained at once
(counterpart of the reference package's parallel/sweep.py SweepRunner).

    runner = SweepRunner(solver, n_configs=512, engine="cuda",
                         packed_state=True, dtype_policy="ternary")
    losses = runner.step(iters, chunk=5)      # (C,) last-iteration losses

Every config lane starts from the solver's params and SGD history and
draws its own fault state, its lifetimes re-anchored to the lane's
(mean, std), with the reference's keys: the C configs split from the
solver key folded with 0xFA117, and lane c's step key fold_in(fold_in(
solver key, it), c). One step is the solver's step body built with a config
axis (`Solver.make_train_step(lanes=C)`): the lanes share one batch per
iteration, kernel B2 reads every lane's InnerProduct weights in one
launch per layer, kernel B1 runs ApplyUpdate+Fail once per fault leaf,
and kernel B4 (RRAM_POOL_BWD=cuda) takes each MAX pooling backward over
all lanes' planes. BatchNorm's statistics are per lane ((C, ch),
scale_factor (C, 1)), advanced by the lane's own batch statistics and
carried by checkpoints like any other param. A lane whose loss goes
non-finite is quarantined:
its update, and every later one, is discarded while the other lanes
train on unchanged.

With `preload` and a Data layer that decodes deterministically, the
whole LMDB lives on the device and step t gathers records
(t*B + arange(B)) % N there, the host cursor's order; losses stay on
the device until a chunk of `chunk` iterations ends.

The solver's tile spec carries over: every lane draws each crossbar
tile on its own, and a tiled layer's read is one launch of kernel B2t
(InnerProduct, premat conv) or B3 (`conv_im2col="implicit"`) over all
lanes.

Durability: `checkpoint(path)` writes the whole resumable state (params,
history, fault banks, quarantine mask, iteration, solver key) as the
reference's v6 single-file `.npz`, `restore(path)` reads it back, or the
reference's v4 distributed directory, from either package, with the
reference's refusals; an f32 checkpoint restores into packed banks and
the reverse. `save_fault_states(path)` writes the fault state in the f32
layout. Both write through a temp file and an atomic rename, optionally
on a background thread (`wait_for_writes`, `close`). A continued run
equals the run that never stopped, bit for bit: the step's keys and
the device dataset's order depend on the iteration alone.

The solver's failure strategies run in every lane: threshold and
remapping (tracked or not) inside the laned step, each lane ranking and
permuting by its own fault state on the iterations the solver's
`_remap_due_at` names (one clock for all lanes; tracked remapping's
`remap_slots` start as the identity in every lane and are a fault-state
group, so checkpoints carry them); the genetic search on the host
between steps, one copy of the solver's `GeneticStrategy` a lane, each
seeded alike, before the iterations `_genetic_due_at` names (a chunk
ends there), and never in a quarantined lane. `iter_size` > 1 feeds stacked host
sub-batches (no device-resident dataset).

Not ported yet, each refused by name: mesh, config_block,
remat_segments, compute_dtype, pipeline_depth, stall_timeout_s,
health_every, self-healing, distributed checkpoints (writing), and a
checkpoint of a runner whose lanes run the genetic strategy (the
reference stores its search state as a pickle of its own classes).
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import async_exec
from ..core import prng
from ..data.feed import can_materialize, materialize_data_source
from ..device import resolve_device
from ..fault import engine as fault_engine
from ..fault import packed as fault_packed
from ..solver.solver import stack_batches

SWEEP_ENGINES = ("auto", "cuda", "torch")
CHECKPOINT_VERSION = 6  # the reference's; v1-v5 restore as it upgrades them
LEGACY_PROCESS = "endurance_stuck_at"   # the port's only fault process
LEGACY_TILES = "1x1"    # the mapping of a checkpoint older than v6
SWEEP_FOLD = 0xFA117    # the reference's fold of the solver key for the draw
# constructor options of the reference runner this slice does not port,
# with the value that means "off"
UNPORTED_OPTIONS = {"mesh": None, "config_block": 0, "remat_segments": 0,
                    "compute_dtype": None, "pipeline_depth": None,
                    "stall_timeout_s": None, "health_every": 0}


def _not_ported(what: str):
    raise NotImplementedError(f"SweepRunner: {what} is not ported to the "
                              "PyTorch/CUDA package yet")


def _lane_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host array that no later step can change: the device fetch of
    a card tensor, a copy of a CPU one."""
    t = t.detach()
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


def _savez_writer(arrays: Dict[str, np.ndarray]):
    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
    return write


class SweepRunner:
    """C fault configs of one solver, trained together on `device` (the
    card by default; raises without one unless device="cpu", which
    must be the solver's device too).

    `engine`: "cuda" runs kernels B2/B1 (their wrappers take the plain
    versions on CPU tensors), "torch" the plain versions by name, "auto"
    is "cuda" on a CUDA device. `packed_state`, `dtype_policy`,
    `fused_epilogue` and `conv_im2col` are the solver's step options;
    `conv_im2col_requested/_resolved/_reason` record the conv operand
    mode that runs."""

    def __init__(self, solver, n_configs: int, means=None, stds=None,
                 preload: bool = True, engine: str = "auto",
                 packed_state: bool = False, dtype_policy=None,
                 fused_epilogue=None, device=None, conv_im2col=None,
                 **options):
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
        # the reference's sweep draw: the solver key folded with 0xFA117,
        # split over the C configs
        state = fault_engine.stack_fault_states(
            prng.fold_in(solver._key, SWEEP_FOLD), shapes, pattern, self.n,
            means=means, stds=stds, tiles=solver.tile_spec,
            device=self.device)
        if "remap_slots" in solver.fault_state:
            # tracked remapping: every lane starts at the solver's map
            state["remap_slots"] = {
                g: v.unsqueeze(0).repeat(self.n, 1)
                for g, v in solver.fault_state["remap_slots"].items()}
        self._pack_spec = None
        if packed_state:
            # counter dtype sized from every configured (mean, std)
            self._pack_spec = fault_packed.make_pack_spec(
                state, solver.fail_decrement,
                means=[float(pattern.mean)] if means is None else means,
                stds=[float(pattern.std)] if stds is None else stds)
            state = fault_packed.pack_state(state, self._pack_spec,
                                            device=self.device)
        self.fault_states = state

        def bcast(t):
            return t.unsqueeze(0).repeat((self.n,) + (1,) * t.dim())
        self.params = {ln: [None if t is None else bcast(t) for t in vals]
                       for ln, vals in solver.params.items()}
        self.history = {k: {s: bcast(v) for s, v in slots.items()}
                        for k, slots in solver.history.items()}
        self.quarantine = torch.zeros(self.n, dtype=torch.bool,
                                      device=self.device)
        self._bg_writer: Optional[async_exec.BackgroundWriter] = None
        # the genetic search: one copy of the solver's strategy a lane,
        # each with its own generator, seeded alike
        self._genetics = None
        if solver.strategies.genetic is not None:
            self._genetics = []
            for _ in range(self.n):
                g = copy.deepcopy(solver.strategies.genetic)
                g._rng = np.random.RandomState(g.seed)
                self._genetics.append(g)

        self._step = solver.make_train_step(
            hw_engine=engine, dtype_policy=dtype_policy,
            fault_format="packed" if packed_state else "f32",
            pack_spec=self._pack_spec, fused_epilogue=fused_epilogue,
            lanes=self.n, conv_im2col=conv_im2col)
        self._noise = self._step.noise
        self.engine_resolved = self._step.hw_engine_resolved
        self.conv_im2col_requested = self._step.conv_im2col_requested
        self.conv_im2col_resolved = self._step.conv_im2col_resolved
        self.conv_im2col_reason = self._step.conv_im2col_reason
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
        if self.solver.custom_train_feed or self.solver.param.iter_size > 1:
            return None
        src = [ly for ly in self.solver.net.layers if ly.is_data_source]
        if len(src) != 1 or not can_materialize(src[0]):
            return None
        return src[0]

    def _batch(self, it: int) -> dict:
        if self._dataset is None:
            return stack_batches(self.solver.train_feed,
                                 self.solver.param.iter_size, self.device)
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
            self._maybe_genetic()
            k = self._genetic_chunk_cap(min(max(chunk, 1), iters - done))
            losses = []
            for _ in range(k):
                p2, h2, f2, loss, _ = self._step(
                    self.params, self.history, self.fault_states,
                    self._batch(self.iter), self.iter,
                    self.lane_keys(self.iter))
                self._commit(p2, h2, f2, loss)
                losses.append(loss)
                self.iter += 1
            self.chunk_losses = torch.stack(losses).cpu().numpy()
            self.last_losses = self.chunk_losses[-1]
            done += k
        return self.last_losses

    def _genetic_due_at(self, iteration: int) -> bool:
        """Whether the genetic search runs before `iteration`, in every
        lane (one clock for all)."""
        g = self.solver.strategies.genetic
        return g is not None and g.due_at(iteration)

    def _genetic_chunk_cap(self, k: int) -> int:
        """Cut a chunk of k iterations short of the next iteration the
        genetic search is due at, so the search runs between chunks."""
        if self._genetics is not None:
            for j in range(1, k):
                if self._genetic_due_at(self.iter + j):
                    return j
        return k

    def _maybe_genetic(self):
        if self._genetics is not None and self._genetic_due_at(self.iter):
            self._apply_genetic()

    def _apply_genetic(self):
        """One genetic application in every lane that is not
        quarantined (a quarantined lane's params and generator stay as
        they are): the lanes' FC params and weight lifetimes (the
        mid-bin view of packed banks) to the host, each lane's search on
        its own slices with zero diffs, the params back."""
        s = self.solver
        flat = s._flat(self.params)
        keys = [k for pair in s.fc_pairs for k in pair if k is not None]
        data = {k: flat[k].detach().cpu().numpy().copy() for k in keys}
        weights = [w for w, _ in s.fc_pairs]
        state = (fault_packed.unpacked_view(self.fault_states,
                                            self._pack_spec, weights)
                 if self._pack_spec is not None else self.fault_states)
        lifetimes = {k: state["lifetimes"][k].detach().cpu().numpy()
                     for k in weights}
        quarantined = self.quarantine.cpu().numpy()
        for i, g in enumerate(self._genetics):
            if quarantined[i]:
                continue
            lane = {k: v[i] for k, v in data.items()}     # views
            g.apply(lane, {k: np.zeros_like(v) for k, v in lane.items()},
                    {k: v[i] for k, v in lifetimes.items()})
        flat.update({k: torch.from_numpy(v).to(self.device)
                     for k, v in data.items()})
        self.params = s._unflat(flat, self.params)

    def lane_keys(self, it: int) -> np.ndarray:
        """(C, 2) step keys of iteration `it`: lane c's is
        fold_in(fold_in(solver key, it), c), as the reference's sweep
        derives them (with the step's noise, a block of iterations in one
        vectorised pass: Solver's StepNoise)."""
        return self._noise.step_key(self.solver._key, it, self.n)

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
        """Per-lane share of broken cells over every fault leaf, (C,):
        the count times 1 / cells in float64, as the reference's jitted
        census computes it (XLA turns its division by a constant into a
        product with the reciprocal)."""
        lives = self.fault_states.get("life_q",
                                      self.fault_states.get("lifetimes"))
        broken = sum((v <= 0).reshape(self.n, -1).sum(1)
                     for v in lives.values())
        total = sum(v[0].numel() for v in lives.values())
        return (broken.double() * (1.0 / max(total, 1))).cpu().numpy()

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
        gathered from the device dataset, plus the tiled convolutions'
        operands (`conv_patch_bytes_est`). Other activations are left
        out, as the reference leaves them out."""
        total = 2 * sum(t.numel() * t.element_size()
                        for t in self._state_tensors())
        if self._dataset is not None:
            total += self._ds_batch * sum(
                a[0].numel() * a.element_size()
                for a in self._dataset.values())
        return int(total + self.conv_patch_bytes_est())

    def conv_patch_bytes_est(self) -> int:
        """Bytes of the conv operands one step builds for its tiled
        Convolutions, by resolved mode (the reference's estimate): premat
        lanes*M*K*4 (the patch rows), tilewise lanes*M*min(bk, K)*4 (one
        K-tile slab), implicit lanes*N*C_in*Hp*Wp*4 (the padded flat
        activation the gather reads). Forward only: the implicit
        backward builds premat-shaped rows, counted nowhere, like every
        other activation."""
        solver = self.solver
        tiles_ctx = solver._tiles_ctx()
        mode = self.conv_im2col_resolved or "premat"
        total = 0
        for lname, tl in (tiles_ctx or {}).items():
            layer = solver.net.layer_by_name[lname]
            if layer.type_name != "Convolution":
                continue
            n, _, oh, ow = layer.top_shapes[0]
            m, kdim = n * oh * ow, int(np.prod(layer.weight_shape[1:]))
            if mode == "premat":
                total += m * kdim * 4
            elif mode == "tilewise":
                total += m * min(int(tl[0]), kdim) * 4
            else:
                _, c_in, h, w = solver.net.blob_shapes[layer.lp.bottom[0]]
                total += (n * c_in * (h + 2 * layer.pad[0])
                          * (w + 2 * layer.pad[1]) * 4)
        return int(total * self.n)

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

    # the reference runner's self-healing layer
    def enable_self_healing(self, *args, **kwargs):
        _not_ported("self-healing")

    def submit_configs(self, *args, **kwargs):
        _not_ported("self-healing (submit_configs)")

    # ------------------------------------------------------------------
    # durability: checkpoint / restore and the fault state files

    def _write(self, path: str, arrays: Dict[str, np.ndarray],
               background: bool):
        """One atomic .npz write of host arrays, on the background
        writer or inline."""
        if background and self._bg_writer is None:
            self._bg_writer = async_exec.BackgroundWriter()
        async_exec.write(path, _savez_writer(arrays),
                         self._bg_writer if background else None)

    def save_fault_states(self, path: str, background: bool = True) -> str:
        """Write the config-stacked fault state to `path` as an .npz
        ({"group/key": (C, ...) array}), always in the f32 layout
        (lifetimes, stuck values; packed banks as their mid-bin view,
        which keeps the broken census exact). The caller's thread pays
        the device fetch; the write runs on the background writer
        (`background=False` writes inline, as atomically)."""
        flat = {name: _host_copy(v) for name, v in
                fault_engine.iter_state_leaves(self.fault_states)}
        if self._pack_spec is not None:
            flat = fault_packed.convert_flat(flat, to_packed=False,
                                             spec=self._pack_spec)
        self._write(path, flat, background)
        return path

    def _state_arrays(self) -> Dict[str, torch.Tensor]:
        """Every resumable leaf under its checkpoint name: the params
        (shared slots skipped), the history, the fault state and the
        quarantine mask. The name set is the restore contract."""
        out = {}
        for layer, vals in self.params.items():
            for slot, v in enumerate(vals):
                if v is not None:
                    out[f"params/{layer}/{slot}"] = v
        for key, slots in self.history.items():
            for sname, v in slots.items():
                out[f"history/{key}/{sname}"] = v
        for name, v in fault_engine.iter_state_leaves(self.fault_states):
            out[f"fault/{name}"] = v
        out["quarantine"] = self.quarantine
        return out

    def _set_state_arrays(self, arrays: Dict[str, torch.Tensor]):
        """The inverse of `_state_arrays` (key sets already checked)."""
        self.params = {
            layer: [arrays.get(f"params/{layer}/{slot}", v)
                    for slot, v in enumerate(vals)]
            for layer, vals in self.params.items()}
        self.history = {
            key: {s: arrays[f"history/{key}/{s}"] for s in slots}
            for key, slots in self.history.items()}
        self.fault_states = {
            group: {k: arrays[f"fault/{group}/{k}"] for k in tree}
            for group, tree in self.fault_states.items()}
        self.quarantine = arrays["quarantine"]

    def _process_canonical(self) -> str:
        """The fault process the runner trains under (the v5 pin): the
        port has the reference's endurance process alone."""
        return LEGACY_PROCESS

    def _tile_canonical(self) -> str:
        """The tile mapping the runner trains under (the v6 pin)."""
        return self.solver.tile_spec.canonical()

    def _ckpt_meta(self) -> dict:
        """The checkpoint's meta block, every key the reference writes:
        no virtual time, the identity lane map, every lane at `iter`,
        and no self-healing block."""
        return {"version": CHECKPOINT_VERSION, "iter": int(self.iter),
                "n_configs": int(self.n),
                "fault_format": ("packed" if self._pack_spec is not None
                                 else "f32"),
                "pack_spec": self._pack_spec,
                "fault_process": self._process_canonical(),
                "tile_spec": self._tile_canonical(),
                "key": [int(x) for x in np.asarray(self.solver._key).ravel()],
                "seed": int(self.solver.seed),
                "virtual_time": False,
                "quarantined": [int(i) for i in self.quarantined()],
                "lane_map": list(range(self.n)),
                "lane_done": [int(self.iter)] * self.n}

    def checkpoint(self, path: str, background: bool = False,
                   distributed: Optional[bool] = None) -> str:
        """Write the whole resumable sweep state to `path`, one .npz
        (the reference's v6 layout: every `_state_arrays` leaf and
        `__meta__`, the meta as JSON bytes). The device fetch runs here;
        the write goes through a temp file and an atomic rename, on the
        background writer with `background=True`. A runner built with
        the same configuration continues from it bit for bit
        (`restore`)."""
        if distributed:
            _not_ported("checkpoint(distributed=True) (the v4 directory "
                        "layout is read by restore, not written)")
        if self._genetics is not None:
            _not_ported("checkpoint of a sweep whose lanes run the genetic "
                        "strategy (the reference stores the search state as "
                        "a pickle of its own classes)")
        self.wait_for_writes()
        self.solver.wait_for_snapshots()
        arrays = {name: _host_copy(v)
                  for name, v in self._state_arrays().items()}
        arrays["__meta__"] = np.frombuffer(
            json.dumps(self._ckpt_meta()).encode(), np.uint8)
        if os.path.isdir(path):
            # a distributed checkpoint under this name: replaced
            import shutil
            shutil.rmtree(path)
        self._write(path, arrays, background)
        return path

    @staticmethod
    def _load_checkpoint_data(path: str):
        """(arrays, meta, genetics bytes or None) of either layout: the
        single .npz file, or the v4 distributed directory, whose shards'
        row blocks are put back together into whole arrays here."""
        if os.path.isdir(path):
            mpath = os.path.join(path, "manifest.json")
            if not os.path.exists(mpath):
                raise ValueError(
                    f"{path} is not a committed distributed checkpoint "
                    "(missing manifest.json — the write was interrupted "
                    "before the commit record landed)")
            with open(mpath) as f:
                manifest = json.load(f)
            pieces: Dict[str, list] = {}
            for sh in manifest["shards"]:
                lo = int(sh["rows"][0])
                with np.load(os.path.join(path, sh["file"])) as z:
                    for name in z.files:
                        pieces.setdefault(name, []).append((lo, z[name]))
            data = {}
            for name, blocks in pieces.items():
                blocks.sort(key=lambda b: b[0])
                off = 0
                for b_lo, b_arr in blocks:
                    if b_lo != off:
                        raise ValueError(
                            f"distributed checkpoint {path}: leaf {name!r} "
                            f"rows are not a contiguous partition (gap at "
                            f"row {off})")
                    off += b_arr.shape[0]
                data[name] = np.concatenate([b[1] for b in blocks], axis=0)
            gen = None
            gp = os.path.join(path, "global.npz")
            if os.path.exists(gp):
                with np.load(gp) as z:
                    for name in z.files:
                        if name == "__genetics__":
                            gen = z[name]
                        else:
                            data[name] = z[name]
            return data, manifest["meta"], gen
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        raw = data.pop("__meta__", None)
        if raw is None:
            raise ValueError(f"{path} is not a SweepRunner checkpoint "
                             "(missing __meta__)")
        meta = json.loads(bytes(bytearray(raw)).decode())
        return data, meta, data.pop("__genetics__", None)

    def restore(self, path: str):
        """Load a checkpoint of either package into this runner, which
        must have the same configuration: the configs, fault process,
        tile spec, solver key, no virtual time, no genetic or
        self-healing state, the same leaves and shapes; each mismatch
        raises. Fault leaves convert between the f32 and packed formats
        (`fault_packed.convert_flat`); every leaf lands contiguous, in
        the live leaf's dtype, on the runner's device."""
        self.wait_for_writes()
        self.solver.wait_for_snapshots()
        data, meta, gen = self._load_checkpoint_data(path)
        found = meta.get("version")
        if found not in (1, 2, 3, 4, 5, CHECKPOINT_VERSION):
            raise ValueError(
                f"checkpoint {path} has format version {found!r} but this "
                f"build expects version {CHECKPOINT_VERSION} (v1-v5 "
                "checkpoints are upgraded in place)")
        if int(meta["n_configs"]) != self.n:
            raise ValueError(
                f"checkpoint {path} holds {meta['n_configs']} configs but "
                f"this runner was built with {self.n}")
        ck_proc = meta.get("fault_process", LEGACY_PROCESS)
        if str(ck_proc) != self._process_canonical():
            raise ValueError(
                f"checkpoint {path} was trained under fault process "
                f"{ck_proc!r} but this runner runs "
                f"{self._process_canonical()!r}; resume with the same "
                "fault_process spec the checkpoint was written under")
        ck_tiles, my_tiles = meta.get("tile_spec", LEGACY_TILES), \
            self._tile_canonical()
        if str(ck_tiles) != my_tiles:
            raise ValueError(
                f"checkpoint {path} was trained under tile spec "
                f"{ck_tiles!r} but this runner maps crossbars as "
                f"{my_tiles!r}; resume with the same tile_spec the "
                "checkpoint was written under (pre-v6 checkpoints are the "
                "untiled '1x1' mapping)")
        key = [int(x) for x in np.asarray(self.solver._key).ravel()]
        if list(meta["key"]) != key:
            raise ValueError(
                f"checkpoint {path} was taken under a different solver RNG "
                f"key (seed {meta.get('seed')}); resume with the same "
                "random_seed the checkpoint was written under")
        if bool(meta.get("virtual_time", False)):
            raise ValueError(
                f"checkpoint {path} was written with virtual_time=True (a "
                "self-healing service sweep); the port's runner has no "
                "virtual time")
        if gen is not None:
            raise ValueError(
                f"checkpoint {path} carries genetic-strategy state (a "
                "pickle of the reference's classes), which the port "
                "cannot read")
        if self._genetics is not None:
            raise ValueError(
                f"checkpoint {path} and this runner disagree on the "
                "genetic strategy (the runner's lanes run it, the "
                "checkpoint holds no search state)")
        if meta.get("healing") is not None:
            _not_ported(f"self-healing (checkpoint {path} carries its "
                        "lane map and retry queue)")
        ck_fmt = meta.get("fault_format", "f32")
        my_fmt = "packed" if self._pack_spec is not None else "f32"
        ck_spec = meta.get("pack_spec")
        if ck_fmt != my_fmt or (ck_fmt == "packed"
                                and ck_spec != self._pack_spec):
            fault = {name[len("fault/"):]: arr for name, arr in data.items()
                     if name.startswith("fault/")}
            if ck_fmt == "packed":
                fault = fault_packed.convert_flat(fault, to_packed=False,
                                                  spec=ck_spec)
            if my_fmt == "packed":
                fault = fault_packed.convert_flat(fault, to_packed=True,
                                                  spec=self._pack_spec)
            data = {name: arr for name, arr in data.items()
                    if not name.startswith("fault/")}
            data.update({f"fault/{name}": arr for name, arr in fault.items()})
        current = self._state_arrays()
        saved, live = set(data), set(current)
        if saved != live:
            raise ValueError(
                f"checkpoint {path} state keys do not match this runner: "
                f"missing {sorted(live - saved)}, unexpected "
                f"{sorted(saved - live)}")
        placed = {}
        for name, arr in data.items():
            cur = current[name]
            if tuple(arr.shape) != tuple(cur.shape):
                raise ValueError(
                    f"checkpoint {path}: leaf {name!r} has shape "
                    f"{tuple(arr.shape)}, expected {tuple(cur.shape)}")
            placed[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=cur.device, dtype=cur.dtype)
        self._set_state_arrays(placed)
        self.iter = int(meta["iter"])
        self.last_losses = self.chunk_losses = None
        return self

    def wait_for_writes(self):
        """Barrier for background writes (re-raises the first writer
        error)."""
        if self._bg_writer is not None:
            self._bg_writer.wait()

    def close(self):
        """Land the queued writes and stop the writer thread (a writer
        error re-raises here); later calls do nothing."""
        writer, self._bg_writer = self._bg_writer, None
        if writer is not None:
            try:
                writer.wait()
            finally:
                writer.close()
