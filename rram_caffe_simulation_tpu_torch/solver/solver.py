"""Solver: the RRAM fault-training step, eager on tensors (counterpart
of the reference package's solver/solver.py; reference solver.cpp Step
:238 and sgd_solver.cpp ComputeUpdate :102, ApplyUpdate :119).

One iteration keeps the fork's order (solver.cpp:299-305):

    ForwardBackward -> ComputeUpdate -> ApplyStrategy -> ApplyUpdate -> Fail

ApplyStrategy is a seam with no strategy behind it in this slice (the
threshold, remap and genetic strategies come later; a solver that
configures one raises). With the crossbar read armed (rram_forward.sigma
> 0 or a quantizing dtype_policy) every InnerProduct weight is read
through `crossbar_matmul` (kernel B2 on the "cuda" engine), biases
through `quantize_ste`/`perturb_weight`; with packed banks and the
fused epilogue, ApplyUpdate+Fail of every fault leaf is kernel B1.

Not ported yet (a solver asking for one raises, except test nets:
test_interval is not acted on): snapshot/restore, test nets, metrics,
watchdog, health, data/tensor/pipeline parallelism, a sub-f32 compute
dtype, iter_size > 1, clip_gradients, L1 regularization, the five
other update rules and tiled crossbars.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import proto
from ..data.feed import build_feed
from ..device import resolve_device
from ..fault import engine as fault_engine
from ..fault import packed as fault_packed
from ..fault.fused import fused_update_fail, fused_update_fail_plain
from ..fault.hw_aware import perturb_weight, quantize_ste
from ..net.builder import Net
from ..utils.io import read_net_param, read_solver_param
from . import updates as U
from .lr_policies import learning_rate_fn

HW_ENGINES = ("auto", "cuda", "torch")
DTYPE_POLICY_BITS = {None: 0, "": 0, "f32": 0, "float32": 0, "ternary": 2,
                     "int8": 8}


def _lane_seeds(gen: torch.Generator, lanes: int, device) -> torch.Tensor:
    """(lanes,) int32 crossbar seeds from the CPU generator, placed on
    `device` without a blocking copy (a pinned buffer; a plain copy to
    the card would wait for the stream at every step)."""
    seeds = torch.randint(0, 2 ** 31 - 1, (lanes,), generator=gen,
                          dtype=torch.int32)
    if torch.device(device).type != "cuda":
        return seeds
    return seeds.pin_memory().to(device, non_blocking=True)


def _train_net_param(param) -> proto.Message:
    """Solver::InitTrainNet (solver.cpp:95-130): exactly one of net /
    net_param / train_net / train_net_param."""
    sources = [f for f in ("net", "net_param", "train_net",
                           "train_net_param") if param.HasField(f)]
    if len(sources) != 1:
        raise ValueError("specify exactly one train net source "
                         f"(got {len(sources)})")
    src = sources[0]
    if src in ("net_param", "train_net_param"):
        return getattr(param, src).copy()
    return read_net_param(getattr(param, src))


class Solver:
    """Owns the train net, params, SGD history and fault state, and runs
    the step. `device` defaults to the card (raises without one unless
    device="cpu"). The step's configuration (engine, dtype policy,
    fault-bank format, fused epilogue) is fixed at construction;
    `make_train_step` builds other configurations for comparison."""

    def __init__(self, param, device=None,
                 train_feed: Optional[Callable] = None,
                 fail_decrement: Optional[float] = None,
                 hw_engine: str = "auto", dtype_policy=None,
                 fault_format: str = "f32", fused_epilogue=None):
        if isinstance(param, str):
            param = read_solver_param(param)
        self.param = param
        self.device = resolve_device(device)
        self.type = param.type[:-6] if param.type.endswith("Solver") \
            else param.type
        if self.type not in U.UPDATE_RULES:
            raise NotImplementedError(
                f"solver type {self.type!r} is not ported (SGD is)")
        if param.iter_size > 1:
            raise NotImplementedError("iter_size > 1 is not ported")
        if param.clip_gradients >= 0:
            raise NotImplementedError("clip_gradients is not ported")
        if param.regularization_type != "L2":
            raise NotImplementedError(
                f"regularization {param.regularization_type!r} is not "
                "ported (L2 is)")
        if param.failure_strategy:
            raise NotImplementedError(
                "failure strategies (threshold, remapping, genetic) are "
                "not ported; ApplyStrategy is a no-op in this slice")
        if param.HasField("rram_forward") and param.rram_forward.tiles \
                not in ("", "1x1"):
            raise NotImplementedError("tiled crossbars are not ported")
        self.iter = 0
        self.losses: list = []
        self.smoothed_loss = 0.0
        self.last_loss = None
        self.last_outputs = {}
        self.seed = (int(param.random_seed) if param.random_seed >= 0
                     else int(time.time()) & 0x7FFFFFFF)
        # one CPU generator for every draw (init, fault state, per-step
        # seeds), so a seed gives the same run on any device
        self.gen = torch.Generator().manual_seed(self.seed)

        self.net = Net(_train_net_param(param), proto.TRAIN,
                       stages=tuple(param.train_state.stage),
                       level=param.train_state.level, device=self.device)
        self.params = self.net.init(self.gen)
        seen = set()
        self._owner_refs = [
            r for r in self.net.learnable_params
            if r.key == (r.layer_name, r.slot)
            and not (r.key in seen or seen.add(r.key))]
        self.history = U.init_history(self.type, self._flat(self.params))

        self.fail_decrement = 100.0 if fail_decrement is None \
            else float(fail_decrement)
        if not self.fail_decrement > 0:
            raise ValueError(f"fail_decrement must be > 0, got "
                             f"{fail_decrement!r}")
        self._fault_keys = [fault_engine.param_key(r.layer_name, r.slot)
                            for r in self.net.failure_param_refs]
        pattern = param.failure_pattern
        if param.HasField("failure_pattern") and pattern.conv_also:
            raise NotImplementedError("failure_pattern.conv_also (conv "
                                      "crossbars) is not ported")
        refs = self.net.failure_param_refs
        self._crossbar_keys = {
            fault_engine.param_key(refs[i].layer_name, refs[i].slot)
            for i in self.net.fc_params_ids}
        self.fault_state = None
        if (param.HasField("failure_pattern") and self._fault_keys
                and pattern.type == "gaussian"):
            flat = self._flat(self.params)
            shapes = {k: tuple(flat[k].shape) for k in self._fault_keys}
            state = fault_engine.init_fault_state(self.gen, shapes, pattern)
            self.fault_state = {g: {k: v.to(self.device)
                                    for k, v in grp.items()}
                                for g, grp in state.items()}
        if (param.HasField("rram_forward")
                and (param.rram_forward.sigma or param.rram_forward.adc_bits)
                and self.fault_state is None):
            raise ValueError(
                "rram_forward is configured but no fault engine is active "
                "— it requires failure_pattern { type: 'gaussian' } and at "
                "least one InnerProduct layer")
        if param.HasField("rram_forward") and \
                param.rram_forward.adc_bits == 1:
            raise ValueError("rram_forward.adc_bits = 1 gives a symmetric "
                             "quantizer zero levels; use adc_bits >= 2")

        self.custom_train_feed = train_feed is not None
        self.train_feed = train_feed or build_feed(self.net)
        self._lr_fn = learning_rate_fn(param)
        self.pack_spec = None
        if fault_format == "packed" and self.fault_state is not None:
            self.pack_spec = fault_packed.make_pack_spec(
                self.fault_state, self.fail_decrement, pattern=pattern)
            self.fault_state = fault_packed.pack_state(self.fault_state,
                                                       self.pack_spec)
        self._step_fn = self.make_train_step(
            hw_engine=hw_engine, dtype_policy=dtype_policy,
            fault_format=fault_format, pack_spec=self.pack_spec,
            fused_epilogue=fused_epilogue)

    # ------------------------------------------------------------------
    def _flat(self, params) -> Dict[str, torch.Tensor]:
        return {fault_engine.param_key(r.layer_name, r.slot):
                params[r.layer_name][r.slot] for r in self._owner_refs}

    def _unflat(self, flat, like) -> dict:
        out = {ln: list(vals) for ln, vals in like.items()}
        for r in self._owner_refs:
            out[r.layer_name][r.slot] = flat[
                fault_engine.param_key(r.layer_name, r.slot)]
        return out

    # ------------------------------------------------------------------
    def make_train_step(self, hw_engine: str = "auto", dtype_policy=None,
                        fault_format: str = "f32", pack_spec=None,
                        fused_epilogue=None, lanes: int = 0):
        """Build step(params, history, fault_state, batch, it, gen) ->
        (params', history', fault_state', loss, outputs).

        `lanes` = C > 0 builds the same step over C config lanes (the
        sweep, parallel/sweep.py): params, history and fault state carry
        a leading C axis, the batch is shared, the loss is (C,), each
        lane has its own quantization grid and crossbar seed, and every
        kernel launches once for all lanes (Net.apply gives the layout).

        `hw_engine`: "cuda" reads crossbar weights through kernel B2 and
        runs the fused tail as kernel B1 (their wrappers: on CPU tensors
        the plain versions); "torch" calls the plain versions by name;
        "auto" is "cuda" on a CUDA device, else "torch". Either engine
        engages only when the crossbar read is armed (sigma > 0 or a
        quantizing `dtype_policy`: "ternary" = 2 bits, "int8" = 8).
        `fault_format` "packed" runs on the packed banks (with the
        `pack_spec` they were built with). `fused_epilogue`: None fuses
        when the crossbar read and the packed banks line up, True
        requires it, False keeps the unfused tail."""
        param = self.param
        if hw_engine not in HW_ENGINES:
            raise ValueError(f"unknown hw_engine {hw_engine!r} (expected "
                             f"one of {HW_ENGINES})")
        if dtype_policy not in DTYPE_POLICY_BITS:
            raise ValueError(f"unknown dtype_policy {dtype_policy!r} "
                             "(expected None, 'ternary', or 'int8')")
        if fault_format not in ("f32", "packed"):
            raise ValueError(f"unknown fault_format {fault_format!r} "
                             "(expected 'f32' or 'packed')")
        engine = hw_engine if hw_engine != "auto" else (
            "cuda" if self.device.type == "cuda" else "torch")
        has_fault = self.fault_state is not None
        q_bits = DTYPE_POLICY_BITS[dtype_policy]
        if q_bits and not has_fault:
            raise ValueError("dtype_policy quantizes the fault-target "
                             "crossbar cells and needs an active fault "
                             "engine (failure_pattern { type: 'gaussian' })")
        packed_on = fault_format == "packed"
        if packed_on and pack_spec is None:
            raise ValueError("fault_format='packed' needs the pack_spec the "
                             "banks were built with (make_pack_spec)")
        rf = param.rram_forward if param.HasField("rram_forward") else None
        hw_sigma = float(rf.sigma) if rf is not None and has_fault else 0.0
        adc_bits = int(rf.adc_bits) if rf is not None and has_fault else 0
        crossbar_on = bool(hw_sigma) or bool(q_bits)
        use_kernel = engine == "cuda"
        # weights are read through the crossbar kernel, biases through the
        # plain quantize/perturb (the reference's solver.py:723, :890-899)
        crossbar_keys = self._crossbar_keys if crossbar_on else set()
        fused_reason = None
        if fused_epilogue is False:
            fused_on, fused_reason = False, "disabled (fused_epilogue=False)"
        elif not crossbar_on:
            fused_on, fused_reason = False, (
                "crossbar read not armed (the epilogue is its kernel tail)")
        elif not packed_on:
            fused_on, fused_reason = False, (
                "needs the packed fault banks (fault_format='packed')")
        else:
            fused_on = True
        if fused_epilogue and not fused_on:
            raise ValueError(f"fused_epilogue=True cannot engage: "
                             f"{fused_reason}")
        fused_fn = fused_update_fail if use_kernel else fused_update_fail_plain

        net = self.net
        owner_keys = [fault_engine.param_key(r.layer_name, r.slot)
                      for r in self._owner_refs]
        lr_mults = {k: r.lr_mult for k, r in zip(owner_keys, self._owner_refs)}
        decay_mults = {k: r.decay_mult
                       for k, r in zip(owner_keys, self._owner_refs)}
        fault_keys = list(self._fault_keys)
        hp = U.Hyper(param)
        rule = U.UPDATE_RULES[self.type]
        lr_fn = self._lr_fn
        weight_decay = float(param.weight_decay)
        decrement = self.fail_decrement

        def broken_stuck(fault_state, k):
            if packed_on:
                return (fault_state["life_q"][k] <= 0,
                        fault_packed.unpack_stuck(
                            fault_state["stuck_bits"][k],
                            pack_spec["last_dim"][k]))
            return (fault_state["lifetimes"][k] <= 0,
                    fault_state["stuck"][k])

        def step(params, history, fault_state, batch, it, gen):
            # -- ForwardBackward --
            leaves = {k: v.detach().requires_grad_()
                      for k, v in self._flat(params).items()}
            read = dict(leaves)
            crossbar = None
            if crossbar_on:
                crossbar = {}
                for k in fault_keys:
                    broken_k, stuck_k = broken_stuck(fault_state, k)
                    if k in crossbar_keys:
                        seed = (_lane_seeds(gen, lanes, broken_k.device)
                                if lanes else
                                int(torch.randint(0, 2 ** 31 - 1, (),
                                                  generator=gen)))
                        crossbar[k.rsplit("/", 1)[0]] = (
                            broken_k, stuck_k, seed, hw_sigma, q_bits,
                            use_kernel)
                    else:
                        wk = read[k]
                        if q_bits:
                            wk = quantize_ste(wk, q_bits, lanes=lanes)
                        read[k] = perturb_weight(wk, broken_k, stuck_k, gen,
                                                 hw_sigma)
            blobs, loss = net.apply(self._unflat(read, params), batch,
                                    adc_bits=adc_bits, crossbar=crossbar,
                                    lanes=lanes)
            # lanes are independent: d(sum of lane losses)/d(lane c's
            # params) is lane c's own gradient
            grads = torch.autograd.grad(loss.sum() if lanes else loss,
                                        [leaves[k] for k in owner_keys])
            g = dict(zip(owner_keys, grads))
            data = {k: v.detach() for k, v in leaves.items()}

            # -- ComputeUpdate (sgd_solver.cpp:102-117) --
            rate = lr_fn(it)
            upd, new_hist = {}, {}
            for k in owner_keys:
                diff = g[k]
                local_decay = weight_decay * decay_mults[k]
                if local_decay:                    # L2 (sgd_solver.cpp:149)
                    diff = diff + local_decay * data[k]
                local_rate = float(np.float32(rate) * np.float32(lr_mults[k]))
                upd[k], new_hist[k] = rule(diff, history[k], local_rate, hp,
                                           it + 1)

            # -- ApplyStrategy (solver.cpp:302): no strategy in this slice

            # -- ApplyUpdate (sgd_solver.cpp:119); under the fused
            # epilogue the fault leaves' subtract moves into Fail --
            fused_keys = set(fault_keys) if fused_on else set()
            data = {k: v if k in fused_keys else v - upd[k]
                    for k, v in data.items()}

            # -- Fail (solver.cpp:305; failure_maker.cu:23-40) --
            if has_fault:
                if fused_on:
                    life_q = dict(fault_state["life_q"])
                    for k in fault_keys:
                        data[k], life_q[k] = fused_fn(
                            data[k], upd[k], life_q[k],
                            fault_state["stuck_bits"][k])
                    fault_state = {**fault_state, "life_q": life_q}
                else:
                    fp = {k: data[k] for k in fault_keys}
                    fd = {k: upd[k] for k in fault_keys}
                    if packed_on:
                        fp, fault_state = fault_packed.fail_packed(
                            fp, fault_state, fd, pack_spec)
                    else:
                        fp, fault_state = fault_engine.fail(
                            fp, fault_state, fd, decrement)
                    data.update(fp)
            outputs = {name: blobs[name].detach()
                       for name in net.output_names}
            return (self._unflat(data, params), new_hist, fault_state,
                    loss.detach(), outputs)

        step.hw_engine_resolved = engine if crossbar_on else None
        step.fused_epilogue_resolved = fused_on
        step.fused_epilogue_reason = None if fused_on else fused_reason
        return step

    # ------------------------------------------------------------------
    def _next_batch(self) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in self.train_feed().items()}

    def step(self, iters: int):
        """Run `iters` training iterations (Solver::Step, solver.cpp:238);
        the loss stays on the device until display or the end."""
        param = self.param
        start_iter = self.iter
        average_loss = max(param.average_loss, 1)
        self.losses = []
        for _ in range(iters):
            batch = self._next_batch()
            (self.params, self.history, self.fault_state, loss,
             self.last_outputs) = self._step_fn(
                self.params, self.history, self.fault_state, batch,
                self.iter, self.gen)
            self.last_loss = loss
            if len(self.losses) < average_loss:
                self.losses.append(loss)
            else:
                self.losses[(self.iter - start_iter) % average_loss] = loss
            if param.display and self.iter % param.display == 0:
                self._materialize_smoothed_loss()
                print(f"Iteration {self.iter}, lr = {self._lr_fn(self.iter):g}",
                      flush=True)
                print(f"Iteration {self.iter}, loss = "
                      f"{self.smoothed_loss:g}", flush=True)
            self.iter += 1
        self._materialize_smoothed_loss()

    def _materialize_smoothed_loss(self) -> float:
        if self.losses:
            self.smoothed_loss = float(torch.stack(self.losses).mean())
        return self.smoothed_loss

    def broken_fraction(self) -> float:
        if self.fault_state is None:
            return 0.0
        return fault_engine.broken_fraction(self.fault_state)
