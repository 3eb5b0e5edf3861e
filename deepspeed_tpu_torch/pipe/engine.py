"""Pipeline execution and the pipeline engine, the port of
``deepspeed_tpu/pipe/engine.py`` (reference ``runtime/pipe/engine.py``:
``PipelineEngine`` :36, ``train_batch`` :294, ``_exec_schedule`` :1359; p2p
``runtime/pipe/p2p.py``).

Each rank of the mesh's ``pipe`` axis runs one stage (its ``[K, ...]``
layers) and the stages hand activations on with ``comm.ppermute`` over
``pipe`` (gloo stages a CUDA tensor through pinned host memory). Two
schedules, as in JAX:

  * ``pipeline_apply`` (GPipe): M + S - 1 ticks; at tick t stage s computes
    micro-batch t - s and sends its output to stage s + 1. It is one
    autograd function (``_GPipe``): its backward runs the ticks in reverse,
    each stage differentiating its micro-batches with autograd and sending
    the input gradients back over the reversed sends. Every micro-batch's
    graph is kept until the backward (GPipe's memory profile). Without a
    ``pipe`` axis above 1 the S stages run in this process in turn and
    autograd goes through them directly (JAX's ``mesh=None``).
  * ``pipeline_train_1f1b`` (the executed 1F1B): ``TrainSchedule``'s
    closed-form clocks over 2M + 2S - 2 ticks; a stage stashes only its
    micro-batches' inputs (at most S) and recomputes its forward in the
    backward, the last stage seeding the backward with the loss scale. It
    returns the gradients and the ``(is_fwd, fwd_mb, is_bwd, bwd_mb)``
    trace.

``PipelineEngine`` is the training engine over a ``PipelinedTransformer``:
``gradient_accumulation_steps`` is the micro-batch count, every pipe rank
takes the same global batch (stage 0 reads the tokens, the last stage the
labels), data parallelism splits each micro-batch over ``data`` x
``fsdp``, and the update is the base engine's, whose ZeRO reduction sums
the gradients of the leaves every stage holds over ``pipe`` and whose
norm, non-finite count and loss scale count each piece once over the whole
world, so every stage takes the same step or skips it.
"""

from __future__ import annotations

import json
from typing import Optional

import torch

from .. import comm
from ..comm.mesh import DP_AXES
from ..module_inject.layers import TPParams, plan_of
from ..runtime.engine import DeepSpeedEngine
from ..telemetry.collective_ledger import pipeline_bubble_fraction
from ..utils.logging import log_dist


def _stage_slice(tree: dict) -> dict:
    """A rank's ``[1, K, ...]`` stage leaves as ``[K, ...]``."""
    return {k: v[0] for k, v in tree.items()}


def _apply_in_process(stage_fn, stage_params: dict, x_mb: torch.Tensor, S: int) -> torch.Tensor:
    """Every stage in this process, tick by tick (stage s on micro-batch
    t - s at tick t); autograd runs through it as written."""
    M = x_mb.shape[0]
    per_stage = [{k: v[s] for k, v in stage_params.items()} for s in range(S)]
    entering = [None] * S  # the activation entering each stage this tick
    outs = [None] * M
    for t in range(M + S - 1):
        nxt = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            y = stage_fn(per_stage[s], x_mb[m] if s == 0 else entering[s])
            if s == S - 1:
                outs[m] = y
            else:
                nxt[s + 1] = y
        entering = nxt
    return torch.stack(outs)


class _Schedule:
    """What ``_GPipe`` needs beside its tensors: the stage function, the
    stage leaves' names, S, this rank's stage, and whether the caller
    differentiates (outside ``no_grad`` the stages keep their graphs)."""

    def __init__(self, stage_fn, names, S: int, mesh):
        self.stage_fn = stage_fn
        self.names = names
        self.S = S
        self.stage = mesh.axis_index("pipe")
        self.grad = torch.is_grad_enabled()


class _GPipe(torch.autograd.Function):
    """GPipe over the ``pipe`` axis on this rank: the forward's ticks, then
    in ``backward`` the same ticks in reverse. The last stage returns its
    outputs [M, ...]; the other stages zeros of that shape (their gradient
    is ignored: theirs comes from the next stage)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x_mb: torch.Tensor, *leaves):
        S, s = sched.S, sched.stage
        M = x_mb.shape[0]
        params = {n: t.detach().requires_grad_(t.requires_grad) for n, t in zip(sched.names, leaves)}
        fwd = [(i, i + 1) for i in range(S - 1)]
        outs = torch.zeros_like(x_mb)
        msg = None
        saved = {}
        for t in range(M + S - 1):
            m = t - s
            send = None
            if 0 <= m < M:
                h = (x_mb[m] if s == 0 else msg).detach().requires_grad_(sched.grad and (s > 0 or x_mb.requires_grad))
                with torch.set_grad_enabled(sched.grad):
                    y = sched.stage_fn(params, h)
                if sched.grad:
                    saved[m] = (h, y)
                if s == S - 1:
                    outs[m] = y.detach()
                else:
                    send = y.detach()
            if t < M + S - 2:  # the last tick's output has no reader
                msg = comm.ppermute(torch.zeros_like(x_mb[0]) if send is None else send, "pipe", fwd)
        ctx.sched, ctx.saved, ctx.params, ctx.M = sched, saved, params, M
        ctx.x_grad = s == 0 and x_mb.requires_grad
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        sched, saved, params, M = ctx.sched, ctx.saved, ctx.params, ctx.M
        S, s = sched.S, sched.stage
        bwd = [(i, i - 1) for i in range(1, S)]
        leaves = list(params.values())
        want = [p for p in leaves if p.requires_grad]
        grads = [torch.zeros_like(p) if p.requires_grad else None for p in leaves]
        gx = torch.zeros_like(g_outs) if ctx.x_grad else None
        msg = None
        for t in reversed(range(M + S - 1)):
            m = t - s
            send = None
            if 0 <= m < M:
                h, y = saved.pop(m)
                gy = g_outs[m] if s == S - 1 else msg
                inputs = want + ([h] if h.requires_grad else [])
                got = torch.autograd.grad(y, inputs, gy, allow_unused=True)
                it = iter(got[:len(want)])
                for i, p in enumerate(leaves):
                    if p.requires_grad:
                        g = next(it)
                        if g is not None:
                            grads[i].add_(g)
                if h.requires_grad:
                    gh = got[-1] if got[-1] is not None else torch.zeros_like(h)
                    if s > 0:
                        send = gh
                    elif gx is not None:
                        gx[m] = gh
            if t > 0:  # the first tick's input gradient has no reader
                msg = comm.ppermute(torch.zeros_like(g_outs[0]) if send is None else send.to(g_outs.dtype),
                                    "pipe", bwd)
        ctx.saved = ctx.params = None
        return (None, gx, *grads)


def pipeline_apply(stage_fn, stage_params: dict, x_mb: torch.Tensor, num_stages: int, mesh=None):
    """Stream M micro-batches through S stages (GPipe); returns the last
    stage's outputs [M, mb, ...].

    stage_fn:     (one stage's params {name: [K, ...]}, h [mb, ...]) -> h
    stage_params: the stage leaves, ``[S, K, ...]`` in one process, or over
                  a mesh whose ``pipe`` axis is S this rank's ``[1, K, ...]``
    x_mb:         [M, mb, ...] stage 0's (embedded) inputs; on the other
                  ranks of a ``pipe`` axis only its shape and dtype are read
    mesh:         the mesh (None, or ``pipe`` of 1: every stage here)

    Over a ``pipe`` axis the result is the last stage's outputs on the last
    stage and zeros on the others; differentiating it runs the schedule's
    backward on every stage (every rank of the axis must differentiate its
    result, as ``PipelinedTransformer.loss`` does). The clock has M + S - 1
    ticks, S - 1 of them fill and drain on each stage (the bubble)."""
    S = num_stages
    if mesh is None or mesh.shape.get("pipe", 1) == 1:
        return _apply_in_process(stage_fn, stage_params, x_mb, S)
    if mesh.shape["pipe"] != S:
        raise ValueError(f"mesh 'pipe' axis is {mesh.shape['pipe']} but the pipeline has {S} stages")
    names = list(stage_params)
    local = _stage_slice(stage_params)
    return _GPipe.apply(_Schedule(stage_fn, names, S, mesh), x_mb, *(local[n] for n in names))


def pipeline_train_1f1b(stage_fn, loss_head, stage_params: dict, head_params: dict, x_mb: torch.Tensor,
                        labels_mb: torch.Tensor, loss_scale, num_stages: int, mesh):
    """Execute the clocked 1F1B ``TrainSchedule`` (pipe/schedule.py) on this
    rank's stage (JAX ``pipe/engine.py:125-281``): at tick t stage s runs the
    forward of micro-batch (t - s)/2 and/or the backward of micro-batch
    (t - (2S-1-s))/2, the schedule's closed-form clocks, with activations
    and gradients exchanged by ``comm.ppermute`` over ``pipe`` (Send/Recv
    Activation and Grad). A stage stashes only the inputs of its in-flight
    micro-batches (at most S buffers, the 1F1B memory bound) and rebuilds its
    graph in the backward (one extra forward a micro-batch). The last stage
    seeds each backward with ``loss_scale`` through ``loss_head``.

    Args:
      stage_fn:     (stage params {name: [K, ...]}, h [mb, ...]) -> h
      loss_head:    (head_params, h [mb, ...], labels [mb, ...]) -> scalar loss
      stage_params: this rank's ``[1, K, ...]`` stage leaves
      head_params:  the leaves every stage holds (read by the last stage)
      x_mb:         [M, mb, ...] stage 0's embedded micro-batches (the other
                    stages read only its shape and dtype)
      labels_mb:    [M, mb, ...] the last stage's labels
    Returns (loss, grads_stage {name: [1, K, ...]}, grads_head, grads_x,
    trace): the mean loss over the micro-batches (reduced over ``pipe``, so
    every stage returns it), this rank's gradients of the mean times
    ``loss_scale`` (a stage's own; the head's on the last stage, zeros
    elsewhere; the embedding cotangent [M, mb, ...] on stage 0, zeros
    elsewhere); and ``trace`` = (is_fwd, fwd_mb, is_bwd, bwd_mb), each a
    list over the ticks, for conformance with ``TrainSchedule``."""
    M = x_mb.shape[0]
    S = num_stages
    if mesh is None or mesh.shape.get("pipe", 1) != S:
        raise ValueError(f"the executed 1F1B runs over a mesh whose 'pipe' axis is {S}")
    s = mesh.axis_index("pipe")
    ticks = 2 * M + 2 * S - 2
    names = list(stage_params)
    sp = {n: t.detach()[0].requires_grad_() for n, t in stage_params.items()}
    hp = {n: t.detach().requires_grad_(t.is_floating_point()) for n, t in head_params.items()}
    head_names = [n for n, t in hp.items() if t.requires_grad]
    gstage = {n: torch.zeros_like(t) for n, t in sp.items()}
    ghead = {n: torch.zeros_like(t) for n, t in hp.items()}
    gx = torch.zeros_like(x_mb)
    zero_msg = torch.zeros_like(x_mb[0])
    fwd_msg = bwd_msg = zero_msg
    stash = [None] * S
    loss_sum = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    seed = torch.as_tensor(loss_scale, dtype=torch.float32, device=x_mb.device)
    trace = ([], [], [], [])
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    bwd_perm = [(i, i - 1) for i in range(1, S)]
    for t in range(ticks):
        tf = t - s
        is_fwd = tf >= 0 and tf % 2 == 0 and tf // 2 < M
        mF = min(max(tf // 2, 0), M - 1)
        tb = t - (2 * S - 1 - s)
        is_bwd = tb >= 0 and tb % 2 == 0 and tb // 2 < M
        mB = min(max(tb // 2, 0), M - 1)
        y_f = zero_msg
        if is_fwd:
            x_in = (x_mb[mF] if s == 0 else fwd_msg).detach()
            with torch.no_grad():
                y_f = stage_fn(sp, x_in)
            stash[mF % S] = x_in
        gx_out = zero_msg
        if is_bwd:
            x_b = stash[mB % S].requires_grad_(s > 0 or x_mb.requires_grad)
            stash[mB % S] = None
            with torch.enable_grad():
                y = stage_fn(sp, x_b)
                wrt = list(sp.values()) + ([x_b] if x_b.requires_grad else [])
                if s == S - 1:
                    lv = loss_head(hp, y, labels_mb[mB])
                    got = torch.autograd.grad(lv, wrt + [hp[n] for n in head_names], seed.to(lv.dtype),
                                              allow_unused=True)
                    for n, g in zip(head_names, got[len(wrt):]):
                        if g is not None:
                            ghead[n].add_(g)
                    loss_sum = loss_sum + lv.detach().float()
                    got = got[:len(wrt)]
                else:
                    got = torch.autograd.grad(y, wrt, bwd_msg, allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    gstage[n].add_(g)
            if x_b.requires_grad:
                g_in = got[-1] if got[-1] is not None else torch.zeros_like(x_b)
                if s == 0:
                    gx[mB] = g_in
                gx_out = g_in.to(zero_msg.dtype)
        fwd_msg = comm.ppermute(y_f, "pipe", fwd_perm)
        bwd_msg = comm.ppermute(gx_out, "pipe", bwd_perm)
        for lst, v in zip(trace, (int(is_fwd), mF, int(is_bwd), mB)):
            lst.append(v)
    loss = comm.all_reduce(loss_sum, "pipe") / M
    gstage = {n: (g / M)[None] for n, g in gstage.items()}
    ghead = {n: g / M for n, g in ghead.items()}
    return loss, gstage, ghead, gx / M, trace


class PipelineEngine(DeepSpeedEngine):
    """Engine for pipelined models (reference PipelineEngine,
    runtime/pipe/engine.py:36; JAX ``pipe/engine.py:283``).

    ``gradient_accumulation_steps`` from the config becomes the number of
    micro-batches streamed through the pipeline (reference pipe/engine.py:83
    micro_batches = gradient_accumulation_steps); the base engine's
    sequential accumulation is replaced by the pipeline (gas = 1).
    ``pipeline.schedule`` is ``gpipe`` (the model's loss through
    ``pipeline_apply``, its backward the schedule's reverse) or ``1f1b``
    (``pipeline_train_1f1b``). The mesh's ``pipe`` axis must equal the
    model's stage count: a world of pipe x data x fsdp x model ranks."""

    _PIPELINED = True

    def __init__(self, model, config, params: Optional[dict] = None, device=None):
        required = ("num_micro_batches", "num_stages", "layers_per_stage")
        missing = [a for a in required if not hasattr(model, a)]
        if missing:
            raise TypeError(
                "PipelineEngine requires a pipelined model "
                f"(pipe.module.PipelinedTransformer or equivalent with {required}); "
                f"missing attributes: {missing}"
            )
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        raw = config if isinstance(config, dict) else getattr(config, "raw", {})
        self._pipe_schedule = ((raw.get("pipeline", {}) or {}).get("schedule", "gpipe")).lower()
        if self._pipe_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pipeline.schedule must be gpipe|1f1b, got {self._pipe_schedule}")
        if self._pipe_schedule == "1f1b" and getattr(getattr(model, "config", None), "moe_every", 0) > 0:
            raise NotImplementedError(
                "MoE under the executed 1F1B schedule is not wired up (the "
                "clocked program has no aux-loss channel); use "
                "pipeline.schedule='gpipe' for PPxEP")
        super().__init__(model=model, config=config, params=params, device=device)
        # Config gas IS the microbatch count (reference pipe/engine.py:83).
        # A model left at the default adopts it; an explicit conflicting value
        # is an error rather than a silent override.
        gas = self.gradient_accumulation_steps
        if model.num_micro_batches in (1, gas):
            model.num_micro_batches = gas
        elif gas != 1:
            raise ValueError(
                f"gradient_accumulation_steps={gas} in the config conflicts with "
                f"num_micro_batches={model.num_micro_batches} on the model; set one of them"
            )
        self.micro_batches = model.num_micro_batches
        self.num_stages = model.num_stages
        pipe_axis = self.mesh.shape.get("pipe", 1)
        if pipe_axis != self.num_stages:
            raise ValueError(
                f"mesh 'pipe' axis is {pipe_axis} but the model has "
                f"{self.num_stages} stages; build the mesh with "
                f"MeshConfig(pipe={self.num_stages}, ...) or stages execute replicated"
            )
        self.stage_id = self.mesh.axis_index("pipe")
        # accumulation happens inside the pipeline
        self.gradient_accumulation_steps = 1
        self.last_trace = None  # the executed 1F1B's (is_fwd, fwd_mb, is_bwd, bwd_mb)
        self.telemetry.ledger.set_pipeline(self.num_stages, self.micro_batches, self._pipe_schedule)
        self.telemetry.registry.gauge("train/pipe/bubble_fraction").set(
            pipeline_bubble_fraction(self.num_stages, self.micro_batches))
        log_dist(f"pipeline engine: {self.num_stages} stages x {model.layers_per_stage} layers, "
                 f"{self.micro_batches} microbatches, schedule {self._pipe_schedule}", ranks=[0])

    def _rank_rows(self, batch: dict) -> dict:
        """This rank's rows of each of the M micro-batches of ``batch`` (the
        global batch, or already this rank's rows), micro-batch major: every
        pipe rank takes the same ones, each micro-batch's rows split over the
        data axes as JAX's batch spec splits them."""
        M, b = self.micro_batches, self.micro_batch_size
        out = {}
        for k, v in batch.items():
            v = v.reshape(M, v.shape[0] // M, *v.shape[1:])
            if v.shape[1] != b:
                v = v[:, self.dp_rank * b:(self.dp_rank + 1) * b]
            out[k] = v.reshape(M * b, *v.shape[2:])
        return out

    def _train_step_program(self, state: dict, dev_batch: dict) -> dict:
        """The watched step: this rank's rows through the schedule, then the
        base engine's update. The loss is the last stage's, summed over
        ``pipe`` so every rank returns it."""
        rows = self._rank_rows(dev_batch)
        leaves = self._grad_leaves()
        if self._pipe_schedule == "1f1b":
            loss = self._accumulate_1f1b(leaves, rows)
        else:
            loss = self._accumulate(leaves, rows, 0)
            loss = comm.all_reduce(loss, "pipe")
        if self.zero is not None:
            loss = comm.all_reduce(loss, DP_AXES, "mean")
        return {"loss": loss, **self._apply_update(leaves, 1)}

    def _accumulate_1f1b(self, leaves, mb: dict) -> torch.Tensor:
        """The executed 1F1B on this rank: the embedding outside the
        schedule with its own backward (stage 0's input cotangent), the
        stage and head gradients from ``pipeline_train_1f1b``, all
        differentiated into ``leaves``' ``.grad`` through the compute-dtype
        cast. Returns the loss (every stage's: reduced over ``pipe``)."""
        from ..models import transformer as tfm

        model = self.model
        cp = self._compute_copy(leaves)
        inputs, labels = tfm.split_batch(mb)
        inputs, labels = inputs.long(), labels.long()
        x_mb = model.embed_micro_batches(cp, inputs)
        M = model.num_micro_batches
        labels_mb = labels.reshape((M, labels.shape[0] // M) + tuple(labels.shape[1:]))
        fn = model.stage_fn(cp, x_mb.shape[1], inputs.shape[1], inputs.device)
        head = {k: v for k, v in cp.items() if k != "layers"}
        weight = self._label_weight(mb)
        scale = self.state["loss_scale"] if weight is None else self.state["loss_scale"] * weight
        plan = plan_of(cp)

        def loss_head(hp, y, lab):  # the head's leaves carry the plan, as the model reads them
            return model.head_loss(hp if plan is None else TPParams(hp, plan), y, lab)

        loss, g_stage, g_head, gx, self.last_trace = pipeline_train_1f1b(
            fn, loss_head, cp["layers"], head, x_mb if self.stage_id == 0 else x_mb.detach(), labels_mb, scale,
            self.num_stages, self.mesh)
        outs, grads = [cp["layers"][n] for n in g_stage], list(g_stage.values())
        if self.stage_id == self.num_stages - 1:  # the head's gradients live on the last stage
            tied = [n for n in g_head if head[n].requires_grad]
            outs += [head[n] for n in tied]
            grads += [g_head[n] for n in tied]
        if self.stage_id == 0:
            outs.append(x_mb)
            grads.append(gx.to(x_mb.dtype))
        torch.autograd.backward(outs, grads)
        return loss if weight is None else loss * weight

    def train_batch(self, batch: Optional[dict] = None, data_iter=None) -> dict:
        """Reference signature accepts an iterator (pipe/engine.py:294)."""
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs a batch or data_iter")
            batch = next(data_iter)
        return super().train_batch(batch)

    def eval_batch(self, batch: Optional[dict] = None, data_iter=None) -> float:
        """The loss of ``batch`` through the pipeline's forward, without an
        update (every pipe rank returns the last stage's)."""
        if batch is None:
            if data_iter is None:
                raise ValueError("eval_batch needs a batch or data_iter")
            batch = next(data_iter)
        return super().eval_batch(batch)

    def _eval_loss(self, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            loss = self.model.loss(self._compute_copy(self.state["params"]), self._rank_rows(batch))
        loss = comm.all_reduce(loss.float(), "pipe")
        return comm.all_reduce(loss, DP_AXES, "mean") if self.zero is not None else loss
