"""Pipeline modules: layer partitioning and the stage-stacked transformer,
the port of ``deepspeed_tpu/pipe/module.py`` (reference
``runtime/pipe/module.py``: ``LayerSpec`` :23, ``TiedLayerSpec`` :71,
``PipelineModule`` :85, ``_partition_layers`` :361).

``PipelineModule`` takes layers that are ``nn.Module``s or functions on
tensors and partitions them into contiguous stages (uniform, by parameter
count, or by a type regex). ``PipelinedTransformer`` is the flagship
transformer with its ``[L, ...]`` layer stack reshaped to ``[S, K, ...]``
(``K = L / S`` layers a stage; logical axis ``stage``, which
``parallel/sharding.py`` maps to the mesh's ``pipe`` axis). Over a mesh
whose ``pipe`` axis is S, each rank holds its stage's ``[1, K, ...]`` slice
beside the leaves every stage holds (``wte``, ``wpe``, ``lnf_*``, the head),
and its loss streams the micro-batches through ``pipe/engine.py``
``pipeline_apply``: stage 0 embeds, the last stage applies the final
LayerNorm and the loss (the fused loss kernel runs there only), and a
stage's layers run the model's own layer body and attention dispatch (the
flash kernels on a card). Without a ``pipe`` axis above 1 all S stages run
in this process in turn, JAX's ``mesh=None`` case.

Tied layers need no machinery of their own: the tied embedding lives
outside the stage stack, every stage holds it, and its gradient is summed
over ``pipe`` by the engine's reduction (``runtime/zero/stage_1_and_2.py``
``reduce_grads``), the reference's ``ReduceTiedGrads``.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..models import transformer as tfm
from ..models.transformer import Model, TransformerConfig
from ..module_inject.layers import plan_of
from ..runtime.activation_checkpointing.checkpointing import remat_context_fn


# ---------------------------------------------------------------------------
# Balanced partitioning (reference: _partition_layers module.py:361 +
# deepspeed/runtime/utils partition_balanced)
# ---------------------------------------------------------------------------

def partition_uniform(num_items: int, num_parts: int) -> list[int]:
    """Boundaries [p0..p_num_parts]; part i = [b[i], b[i+1])."""
    base = num_items // num_parts
    rem = num_items % num_parts
    bounds = [0]
    for i in range(num_parts):
        bounds.append(bounds[-1] + base + (1 if i < rem else 0))
    return bounds


def partition_balanced(weights: Sequence[float], num_parts: int) -> list[int]:
    """Contiguous partition minimizing the max part weight (binary search over
    the bottleneck + greedy feasibility check)."""
    n = len(weights)
    assert n >= num_parts, f"cannot split {n} items into {num_parts} parts"
    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + w)

    def feasible(cap: float) -> Optional[list[int]]:
        bounds = [0]
        start = 0
        for _ in range(num_parts):
            # furthest end with sum(start:end) <= cap, at least one item,
            # leaving enough items for the remaining parts
            end = start + 1
            while end < n and prefix[end + 1] - prefix[start] <= cap:
                end += 1
            remaining_parts = num_parts - len(bounds)
            end = min(end, n - remaining_parts)
            if prefix[end] - prefix[start] > cap:
                return None
            bounds.append(end)
            start = end
        return bounds if bounds[-1] == n else None

    lo = max(weights) if weights else 0.0
    hi = prefix[-1]
    best = feasible(hi)
    for _ in range(50):
        mid = (lo + hi) / 2
        b = feasible(mid)
        if b is not None:
            best, hi = b, mid
        else:
            lo = mid
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# LayerSpec machinery (generic models)
# ---------------------------------------------------------------------------

class LayerSpec:
    """Deferred layer: its constructor called lazily so a stage only materializes its
    own layers (the reference's motivation, module.py:23-55)."""

    def __init__(self, typename: Callable, *args, **kwargs):
        self.typename = typename
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.typename(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerSpec({getattr(self.typename, '__name__', self.typename)})"


class TiedLayerSpec(LayerSpec):
    """Layer whose parameters are shared with every other layer of the same
    ``key`` (reference module.py:71): the first one built is the module every
    layer of the key calls, through ``forward_fn(module, x)`` when given."""

    def __init__(self, key: str, typename: Callable, *args, forward_fn=None, **kwargs):
        super().__init__(typename, *args, **kwargs)
        self.key = key
        self.forward_fn = forward_fn


class PipelineModule(torch.nn.Module):
    """Container that partitions a layer list into ``num_stages`` contiguous
    stages (reference PipelineModule, module.py:85). A layer is an
    ``nn.Module`` or a function on tensors; tied layers (``TiedLayerSpec``)
    share one module, registered once under ``tied``. ``forward`` runs every
    layer in order, ``stage_forward`` one stage's."""

    def __init__(self, layers: Sequence, num_stages: int, partition_method: str = "parameters",
                 loss_fn: Optional[Callable] = None):
        super().__init__()
        self.specs = [l if isinstance(l, LayerSpec) else LayerSpec(lambda f=l: f) for l in layers]
        self.num_stages = num_stages
        self.partition_method = partition_method
        self.loss_fn = loss_fn
        self.tied = torch.nn.ModuleDict()
        built = []
        for spec in self.specs:
            if isinstance(spec, TiedLayerSpec):
                if spec.key not in self.tied:
                    layer = spec.build()
                    if not isinstance(layer, torch.nn.Module):
                        raise TypeError(f"tied layer {spec.key!r} must be an nn.Module (it shares parameters)")
                    self.tied[spec.key] = layer
                built.append(self.tied[spec.key])
            else:
                built.append(spec.build())
        self.built = built
        # the untied modules' parameters, registered on this module
        self.owned = torch.nn.ModuleList(
            [m for spec, m in zip(self.specs, built) if isinstance(m, torch.nn.Module)
             and not isinstance(spec, TiedLayerSpec)])
        self.parts = self._partition_layers(partition_method)

    # -- partitioning -------------------------------------------------------
    def _layer_weight(self, layer, method: str) -> float:
        if method == "uniform":
            return 1.0
        if method == "parameters":
            n = sum(p.numel() for p in layer.parameters()) if isinstance(layer, torch.nn.Module) else 0
            return float(n) or 1.0
        raise ValueError(method)

    def _partition_layers(self, method: str) -> list[int]:
        m = method.lower()
        if m == "uniform":
            return partition_uniform(len(self.built), self.num_stages)
        if m == "parameters":
            w = [self._layer_weight(l, "parameters") for l in self.built]
            return partition_balanced(w, self.num_stages)
        if m.startswith("type:"):
            regex = m.split(":", 1)[1]
            w = [
                1.0 if re.search(regex, type(l).__name__, re.IGNORECASE) else 0.0
                for l in self.built
            ]
            if sum(w) == 0:
                raise ValueError(f"partition regex {regex!r} matched no layers")
            return partition_balanced(w, self.num_stages)
        raise ValueError(f"unknown partition_method {method!r}")

    def stage_layers(self, stage_id: int) -> list:
        return self.built[self.parts[stage_id]: self.parts[stage_id + 1]]

    def _run(self, lo: int, hi: int, x):
        for spec, layer in zip(self.specs[lo:hi], self.built[lo:hi]):
            fwd = getattr(spec, "forward_fn", None)
            x = fwd(layer, x) if fwd is not None else layer(x)
        return x

    def stage_forward(self, stage_id: int, x):
        """Stage ``stage_id``'s layers on ``x``."""
        return self._run(self.parts[stage_id], self.parts[stage_id + 1], x)

    def forward(self, x):
        """Every layer in order (the sequential reference of the stages)."""
        return self._run(0, len(self.built), x)


# ---------------------------------------------------------------------------
# Stage-stacked pipelined transformer
# ---------------------------------------------------------------------------

class PipelinedTransformer(Model):
    """Flagship transformer with its layer stack pipelined over the mesh's
    ``pipe`` axis (JAX ``pipe/module.py:208``): the ``[L, ...]`` stack is
    reshaped to ``[S, L/S, ...]`` (axis 0 ``stage``), and the loss streams
    ``num_micro_batches`` micro-batches through the stages
    (``pipe/engine.py`` ``pipeline_apply``). ``num_micro_batches`` plays the
    role of gradient accumulation steps: one ``train_batch`` = micro-batches
    × micro_bs × dp (reference ``runtime/pipe/engine.py:294``)."""

    def __init__(self, cfg: TransformerConfig, num_stages: int, num_micro_batches: int = 1):
        if cfg.num_layers % num_stages != 0:
            raise AssertionError(f"num_layers={cfg.num_layers} must divide evenly into {num_stages} stages")
        if cfg.hidden_dropout > 0 or cfg.attn_dropout > 0 or cfg.pld_enabled:
            raise NotImplementedError(
                "dropout/progressive-layer-drop under pipeline parallelism is "
                "not wired up (per-stage rng routing); disable them"
            )
        if cfg.moe_every > 0:
            raise NotImplementedError("PipelinedTransformer with MoE (moe_every > 0: the expert stacks split over "
                                      "the stages and the aux loss carried between them) is not ported to "
                                      "deepspeed_tpu_torch yet")
        super().__init__(cfg)
        self.num_stages = num_stages
        self.num_micro_batches = num_micro_batches
        self.layers_per_stage = cfg.num_layers // num_stages

    # -- params: reshape [L, ...] -> [S, L/S, ...] --------------------------
    def init(self, generator: torch.Generator, device="cpu", place=None):
        flat = tfm.init(self.config, generator, device, place)
        S, K = self.num_stages, self.layers_per_stage
        flat["layers"] = {k: v.reshape((S, K) + tuple(v.shape[1:])) for k, v in flat["layers"].items()}
        return flat

    def logical_axes(self) -> dict:
        axes = tfm.logical_axes(self.config)
        axes["layers"] = {k: ("stage",) + ax for k, ax in axes["layers"].items()}
        return axes

    # -- the stages ----------------------------------------------------------
    def stage_fn(self, params, rows: int, seq: int, device) -> Callable:
        """``fn(stage_params, h)``: one stage's ``K`` layers (``stage_params``
        its ``[K, ...]`` leaves) on ``h`` [rows, seq, d], with the model's
        layer body and attention dispatch under ``params``' plan; under
        ``remat`` each layer is a checkpointed region with the configured
        policy (JAX's ``jax.checkpoint`` of the pipelined body)."""
        cfg = self.config
        tp = plan_of(params)
        attn_fn = tfm._attention_dispatch(cfg, device, tp)
        fused_bias = getattr(attn_fn, "handles_fused_bias", False)
        bias = None if fused_bias else tfm.attn_bias(cfg, seq, device, tp)
        positions = torch.arange(seq, device=device)[None, :].expand(rows, seq)

        def body(lp, x):
            return tfm._layer_body(cfg, lp, x, bias, positions, attn_fn, tp=tp)

        def fn(stage_params, h):
            remat = cfg.remat and cfg.remat_policy != "everything_saveable" and torch.is_grad_enabled()
            kw = {}
            if remat and (context_fn := remat_context_fn(cfg.remat_policy)) is not None:
                kw["context_fn"] = context_fn
            for lp in tfm._layers({"layers": stage_params}):
                h = checkpoint(body, lp, h, use_reentrant=False, preserve_rng_state=False, **kw) if remat \
                    else body(lp, h)
            return h

        return fn

    def head_loss(self, params, hidden, labels) -> torch.Tensor:
        """The last stage's part: final LayerNorm, then the token-mean loss
        (``loss_impl``: the fused loss kernel, or the chunked loss)."""
        cfg = self.config
        h = tfm.layer_norm(hidden, params["lnf_scale"], params["lnf_bias"], cfg.layernorm_epsilon)
        return tfm.lm_loss_from_hidden(cfg, params, h, labels)

    def embed_micro_batches(self, params, inputs) -> torch.Tensor:
        """Stage 0's input: the embedded ``inputs`` [B, S] as [M, B/M, S, d]."""
        M = self.num_micro_batches
        B = inputs.shape[0]
        if B % M:
            raise AssertionError(f"batch {B} not divisible by {M} microbatches")
        x, _ = tfm.embed(self.config, params, inputs, tp=plan_of(params))
        return x.reshape((M, B // M) + tuple(x.shape[1:]))

    def pipe_size(self, params) -> int:
        """The ``pipe`` axis of the mesh ``params``' plan lives on (1 without
        a plan: every stage runs in this process)."""
        tp = plan_of(params)
        return 1 if tp is None else tp.mesh.shape.get("pipe", 1)

    # -- the pipelined loss --------------------------------------------------
    def loss(self, params, batch: dict, rng=None, step=None, row_offset: int = 0):
        """The token-mean loss of ``batch`` through the pipeline. Over a
        ``pipe`` axis of S ranks ``params`` holds this rank's stage
        (``[1, K, ...]`` leaves): the last stage returns the loss, every
        other stage a zero that anchors its part of the backward (the sum
        over ``pipe`` is the loss, which the engine reduces)."""
        from .engine import pipeline_apply

        if rng is not None:
            raise NotImplementedError("dropout/progressive-layer-drop under pipeline parallelism is "
                                      "not wired up (per-stage rng routing); disable them")
        inputs, labels = tfm.split_batch(batch)
        inputs, labels = inputs.long(), labels.long()
        B, seq = inputs.shape
        x_mb = self.embed_micro_batches(params, inputs)
        fn = self.stage_fn(params, x_mb.shape[1], seq, inputs.device)
        tp = plan_of(params)
        if self.pipe_size(params) == 1:
            out = pipeline_apply(fn, params["layers"], x_mb, self.num_stages, None)
            return self.head_loss(params, out.reshape((B,) + tuple(out.shape[2:])), labels)
        stage = tp.mesh.axis_index("pipe")
        if stage != 0:
            x_mb = x_mb.detach()  # only stage 0's input is read
        out = pipeline_apply(fn, params["layers"], x_mb, self.num_stages, tp.mesh)
        if stage != self.num_stages - 1:
            return out.sum() * 0.0
        return self.head_loss(params, out.reshape((B,) + tuple(out.shape[2:])), labels)
