"""The engine's memory tiers: ZeRO-Offload to host memory, ZeRO-Infinity to
NVMe, and per-layer parameter streaming, ported from the JAX engine's
offload paths (``runtime/engine.py:326-389`` and ``:539-611``, the update
at ``:764-840``, the NVMe step at ``:1801-1852``).

``OffloadTier`` owns the tier's state and its step; ``DeepSpeedEngine``
delegates to it when ``zero_optimization.offload_optimizer`` is ``cpu`` or
``nvme``. The state tree keeps the JAX engine's layout:

* ``offload_optimizer: cpu``: ``params`` is the compute-dtype copy on the
  device; ``master`` (fp32) and ``opt`` live in pinned host memory;
* ``offload_optimizer: nvme``: ``params`` as above; ``opt`` is empty, the
  masters and moments are on disk (``NvmeTieredOptimizer``);
* ``offload_param`` (``cpu``, or ``nvme`` with the NVMe optimizer):
  ``params`` stays in pinned host memory too and the model streams it a
  layer at a time (``ParamStreamer``); gradients land in a pinned fp32 host
  tree.

Under a data-parallel world above 1 (``zero``: the engine's
``ZeroRuntime``; the ``cpu`` tier) the masters and the moments are this
rank's shards, laid out as the optimizer state (``opt_layouts``), as the
JAX engine lays out its host ``master``; the engine reduces the gradients
onto them (stage 3: its streamer), the host update writes each updated
shard's compute-dtype copy back (to the device, or under
``offload_param``, stage 3 only, to the host shards the engine's streamer
gathers from), and at stages 1-2 those shards are all-gathered into the
replicated parameters.

A step: with the parameters on the device, each micro-batch's gradient
(compute dtype) is added leaf by leaf into an fp32 accumulator on the
device as soon as autograd has it (a post-accumulate hook), so the device
holds 2P + 4P bytes of model state (the JAX estimator's figure). Then
unscale, finiteness, the global norm and clipping run where the gradients
are, and ONE fetch brings the finite flag, the learning rate and the step
to the host: a step that is not finite touches neither the host state,
the disk nor the device parameters. Otherwise the host update runs in
place: for the cpu tier chunk by chunk (gradient chunk device-to-host into
a pinned buffer, Adam on the host, the compute-dtype copy host-to-device,
the copies of the next chunk overlapping this one's update); for the NVMe
tier group by group (``NvmeTieredOptimizer.step``).
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import torch

from ...ops.optimizers import tree_leaves, tree_map
from ...utils.logging import log_dist
from ..swap_tensor import flatten
from .host_optimizer import (ADAM_FAMILY, AdamScratch, adam_params, adam_step_, host_empty, host_like,
                             leafwise_update_)
from .nvme_optimizer import NvmeTieredOptimizer
from .param_offload import ParamStreamer

CHUNK = 1 << 24  # elements per device<->host chunk of the cpu tier's update (64 MiB of fp32)


class GradLeaves(dict):
    """The parameters as autograd leaves, with ``grads`` the tree their
    gradients accumulate into (fp32, on the device)."""

    grads: dict


def _drain_into(acc: torch.Tensor, leaf: torch.Tensor) -> None:
    """Post-accumulate hook: the micro-batch's gradient into the fp32
    accumulator, then freed."""
    acc.add_(leaf.grad)
    leaf.grad = None


def _keys(tree) -> list[str]:
    """The JAX NVMe tier's leaf keys: paths joined with '/', tree order."""
    return ["/".join(map(str, path)) for path, _ in flatten(tree)]


class OffloadTier:
    def __init__(self, config, params: dict, device: torch.device, opt_init, opt_update, zero=None):
        """``params``: the fp32 initial parameters (on ``device``; this
        rank's shards at ZeRO stage 3); ``zero``: the engine's ZeRO runtime
        at a data-parallel world above 1."""
        z = config.zero_optimization
        self.zero = zero
        owned = params if zero is None else zero.owned(params)
        self.kind = z.offload_optimizer.device  # cpu | nvme
        self.streamed = z.offload_param.device != "none"
        self.device = device
        self.pin = device.type == "cuda"
        self.cdt = config.compute_dtype
        self.opt_type = config.optimizer.type.lower()
        self.opt_update = opt_update
        self.adam = adam_params(self.opt_type, config.optimizer.params) if self.opt_type in ADAM_FAMILY else None
        self.stats = {"pinned_bytes": 0, "pin_s": 0.0, "update_s": 0.0, "d2h_bytes": 0, "h2d_bytes": 0}

        t0 = time.perf_counter()
        self.master = None
        self.opt: dict = {}
        self.nvme: Optional[NvmeTieredOptimizer] = None
        if self.kind == "cpu":
            self.master = tree_map(lambda p: self._host(p, torch.float32), owned)
            shapes = opt_init(tree_map(lambda p: torch.empty_like(p, device="meta"), owned))
            self.opt = tree_map(lambda t: self._host(t, t.dtype, zero=True), shapes)
        else:
            aio = config.aio
            kw = dict(config.optimizer.params)
            self.nvme = NvmeTieredOptimizer(
                dict(zip(_keys(params), (p for _, p in flatten(params)))),
                lr=float(kw.get("lr", 1e-3)), betas=tuple(kw.get("betas", (0.9, 0.999))),
                eps=float(kw.get("eps", 1e-8)), weight_decay=float(kw.get("weight_decay", 0.0)),
                adam_w_mode=self.opt_type == "adamw", swap_dir=z.offload_optimizer.nvme_path,
                sub_group_bytes=int(z.sub_group_size), n_threads=aio.thread_count or 4, pin=self.pin,
                out_dtype=self.cdt)
        if self.streamed:
            self.params = tree_map(lambda p: self._host(p, self.cdt if p.is_floating_point() else p.dtype), params)
            self.streamer: Optional[ParamStreamer] = None
            if zero is None:  # (ZeRO-3 over the mesh: the engine's streamer gathers these shards)
                grads = tree_map(lambda p: self._host(p, torch.float32, zero=True), params)
                self.streamer = ParamStreamer(self.params, grads, device)
            self.acc = None
        else:
            self.params = tree_map(lambda p: p.to(self.cdt) if p.is_floating_point() else p, params)
            self.streamer = None
            # (at stage 3 the engine's streamer reduces the gradients into its own shards)
            self.acc = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
                        if zero is None or zero.stage < 3 else None)
        # where the update writes each owned leaf's compute-dtype copy: the
        # parameter itself, or (a shard at stages 1-2) a buffer gathered after
        self._gathered = [] if zero is None or zero.stage not in (1, 2) else [
            i for i, lay in enumerate(tree_leaves(zero.opt_layouts)) if lay.sharded]
        self._dest = list(tree_leaves(self.params))
        for i in self._gathered:
            self._dest[i] = torch.empty(tree_leaves(self.master)[i].shape, dtype=self.cdt, device=device)
        self.stats["pin_s"] = time.perf_counter() - t0
        self._scratch = AdamScratch()
        self._bufs = None
        if self.kind == "cpu" and not self.streamed and self.pin:
            n = min(CHUNK, max((p.numel() for p in tree_leaves(owned)), default=1))
            self._bufs = [(host_empty((n,), torch.float32, True), host_empty((n,), self.cdt, True),
                           torch.cuda.Event(), torch.cuda.Event()) for _ in range(2)]
            self.stats["pinned_bytes"] += 2 * n * (4 + torch.empty((), dtype=self.cdt).element_size())
        where = {"cpu": "pinned host memory" if self.pin else "host memory", "nvme": z.offload_optimizer.nvme_path}
        log_dist(f"offload: optimizer state in {where[self.kind]}"
                 + (", parameters streamed per layer from host memory" if self.streamed else "")
                 + f"; {self.stats['pinned_bytes'] / 2**30:.2f} GiB of host buffers allocated in "
                 f"{self.stats['pin_s']:.2f} s", ranks=[0])

    def _host(self, t: torch.Tensor, dtype, zero: bool = False) -> torch.Tensor:
        """A host buffer for ``t``'s values (or zeros), pinned on a card."""
        if zero:
            out = host_empty(t.shape, dtype, self.pin)
            out.zero_()
        else:
            out = host_like(t, self.pin, dtype)
        self.stats["pinned_bytes"] += out.numel() * out.element_size() if self.pin else 0
        return out

    # -- the state the engine keeps ---------------------------------------
    def state_entries(self) -> dict:
        out = {"params": self.params, "opt": self.opt}
        if self.master is not None:
            out["master"] = self.master
        return out

    # -- a step -------------------------------------------------------------
    def grad_leaves(self):
        """What the micro-batches differentiate: the host tree through the
        streamer, or the device parameters as leaves whose gradients drain
        into the (zeroed) fp32 accumulator."""
        if self.streamed:
            self.streamer.begin_step()
            return self.streamer.view()
        for a in tree_leaves(self.acc):
            a.zero_()
        leaves = GradLeaves(tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), self.params))
        for leaf, a in zip(tree_leaves(leaves), tree_leaves(self.acc)):
            if leaf.requires_grad:
                leaf.register_post_accumulate_grad_hook(functools.partial(_drain_into, a))
        leaves.grads = self.acc
        return leaves

    def backward_micro(self, model, leaves, mb: dict, loss_scale, kw: dict) -> torch.Tensor:
        """One micro-batch's forward and backward; returns the detached loss."""
        if not self.streamed:
            loss = model.loss(leaves, mb, **kw)
            (loss * loss_scale).backward()
            return loss.detach().float()
        with self.streamer.micro_batch():
            loss = model.loss(leaves, mb, **kw)
            self.streamer.phase = "backward"
            (loss * loss_scale).backward()
        return loss.detach().float()

    def gradients(self, leaves) -> dict:
        """The step's accumulated fp32 gradients: on the host when
        streamed, else on the device."""
        if self.streamed:
            return self.streamer.finish()
        return leaves.grads

    def update(self, grads: dict, step1: int, lr: float) -> None:
        """The host update of a finite step, in place."""
        t0 = time.perf_counter()
        if self.kind == "nvme":
            out = dict(zip(_keys(self.params), (p for _, p in flatten(self.params))))
            self.nvme.step(dict(zip(_keys(grads), (g for _, g in flatten(grads)))), lr=lr, out=out)
        elif self.streamed or not self.pin:
            self._host_update(grads, step1, lr)
        else:
            self._chunked_update(grads, step1, lr)
        if self._gathered:  # stages 1-2: every rank's updated shards into the replicated parameters
            from .stage_1_and_2 import all_gather_rows

            lays, params = tree_leaves(self.zero.opt_layouts), tree_leaves(self.params)
            for i, full in zip(self._gathered, all_gather_rows([self._dest[i] for i in self._gathered],
                                                               [lays[i] for i in self._gathered],
                                                               self.zero.gather_bucket)):
                params[i].copy_(full)
        self.stats["update_s"] = time.perf_counter() - t0

    def _host_update(self, grads: dict, step1: int, lr: float) -> None:
        """Everything on the host (streamed parameters, or a CPU engine):
        the optimizer over the masters, then the compute-dtype copies."""
        g = [t.float() if t.device.type == "cpu" else t.float().cpu() for t in tree_leaves(grads)]
        master, params = tree_leaves(self.master), self._dest
        if self.adam is not None:
            m, v = tree_leaves(self.opt["m"]), tree_leaves(self.opt["v"])
            for gi, p, mi, vi in zip(g, master, m, v):
                adam_step_(p, mi, vi, gi.contiguous(), lr=lr, step=step1, scratch=self._scratch, **self.adam)
        else:
            leafwise_update_(self.opt_update, g, {k: tree_leaves(t) for k, t in self.opt.items()}, master,
                             step1, lr)
        for dst, src in zip(params, master):
            dst.copy_(src)

    def _chunked_update(self, grads: dict, step1: int, lr: float) -> None:
        """The cpu tier with the parameters on the card: chunk k's gradient
        comes over while chunk k-1 is updated; each updated chunk is cast on
        the host and copied back to the device behind an event."""
        if self.adam is None:  # any other optimizer: a leaf at a time, synchronously
            gh = [g.cpu() for g in tree_leaves(grads)]
            leafwise_update_(self.opt_update, gh, {k: tree_leaves(t) for k, t in self.opt.items()},
                             tree_leaves(self.master), step1, lr)
            for dst, src in zip(self._dest, tree_leaves(self.master)):
                dst.copy_(src)
            return
        g_dev = [g.reshape(-1) for g in tree_leaves(grads)]
        master = [t.view(-1) for t in tree_leaves(self.master)]
        m = [t.view(-1) for t in tree_leaves(self.opt["m"])]
        v = [t.view(-1) for t in tree_leaves(self.opt["v"])]
        p_dev = [t.view(-1) for t in self._dest]
        chunks = [(i, lo, min(g.numel(), lo + CHUNK)) for i, g in enumerate(g_dev)
                  for lo in range(0, g.numel(), CHUNK)]
        issued = [False, False]  # an H2D copy from the slot's staging is in flight

        def fetch(k):
            i, lo, hi = chunks[k]
            gbuf, _, d2h, _ = self._bufs[k % 2]
            gbuf[:hi - lo].copy_(g_dev[i][lo:hi], non_blocking=True)
            d2h.record()
            self.stats["d2h_bytes"] += (hi - lo) * 4

        if chunks:
            fetch(0)
        for k, (i, lo, hi) in enumerate(chunks):
            if k + 1 < len(chunks):
                fetch(k + 1)
            gbuf, stage, d2h, h2d = self._bufs[k % 2]
            d2h.synchronize()
            adam_step_(master[i][lo:hi], m[i][lo:hi], v[i][lo:hi], gbuf[:hi - lo], lr=lr, step=step1,
                       scratch=self._scratch, **self.adam)
            if issued[k % 2]:
                h2d.synchronize()  # the staging slot's previous copy has read it
            stage[:hi - lo].copy_(master[i][lo:hi])
            p_dev[i][lo:hi].copy_(stage[:hi - lo], non_blocking=True)
            h2d.record()
            issued[k % 2] = True
            self.stats["h2d_bytes"] += (hi - lo) * stage.element_size()
        for _, _, _, h2d in self._bufs:
            h2d.synchronize()

    # -- checkpoints ----------------------------------------------------------
    def adopt(self, state: dict, has_master: bool) -> dict:
        """A loaded state into the tier's own buffers, in place (pinning
        kept): a checkpoint without ``master`` (saved without the cpu tier)
        rebuilds the masters from its parameters."""
        for dst, src in zip(tree_leaves(self.params), tree_leaves(state["params"])):
            if src is not dst:
                dst.copy_(src)
        if self.master is not None:
            source = state["master"] if has_master else (
                state["params"] if self.zero is None else self.zero.owned(state["params"]))
            for dst, src in zip(tree_leaves(self.master), tree_leaves(source)):
                if src is not dst:
                    dst.copy_(src)
        for dst, src in zip(tree_leaves(self.opt), tree_leaves(state.get("opt", {}))):
            if src is not dst:
                dst.copy_(src)
        return {**state, **self.state_entries()}

    def master_params_host(self) -> dict:
        """The fp32 parameters keyed as the NVMe tier keys them (for its
        lossy re-warm from loaded parameters)."""
        return dict(zip(_keys(self.params), (p.detach().float().cpu() for _, p in flatten(self.params))))

    def close(self) -> None:
        if self.nvme is not None:
            self.nvme.close()
