"""Generative inference engine (the port of
``deepspeed_tpu/inference/engine.py``).

``InferenceEngine`` holds the model's parameters on one device in the
engine dtype and serves ``forward`` (full logits) and ``generate`` (prefill
plus a token-at-a-time decode loop over ``apply_with_cache``). It runs on
CUDA unless the caller passes ``device="cpu"``; with no GPU and no explicit
CPU request it raises rather than fall back.

Tensor parallelism (``tensor_parallel.tp_size`` or ``mp_size`` above 1, as
the JAX engine reads them): every one of ``tp_size`` processes builds the
engine. It joins the launcher's world (``comm.init_distributed``, unless a
process group is already up), builds the mesh ``MeshConfig(data=-1,
model=tp_size)`` as JAX does, and keeps its slice of every parameter by
the JAX engine's specs (``module_inject.TensorParallel`` over
``DEFAULT_TP_RULES``) as a ``TPParams`` tree the model reads. ``forward``
and ``generate`` return the same full outputs on every rank: the logits
are all-gathered to the full vocabulary, and every rank samples them with
the same seeded generator. Refused by name: ``tp_size`` above 1 in a
single process (one process drives one device here), a world other than
``tp_size`` (a data axis above 1), and quantization.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import comm
from ..comm.mesh import SERVING_AXES, MeshConfig
from ..models import transformer as tfm
from ..models.transformer import Model, TransformerConfig
from ..module_inject.layers import TensorParallel, TPParams
from ..utils.logging import log_dist
from ..utils.world import refuse_multi_process_world
from .sampling import SamplerConfig, sample_logits, update_seen

_DTYPES = {
    "fp16": torch.bfloat16,  # fp16 is served as bf16, as in the JAX package
    "half": torch.bfloat16,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "float32": torch.float32,
}


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the current CUDA device; raises when no GPU
    is present and the caller did not ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _tp_world(tp_size: int) -> int:
    """The world a tensor-parallel engine serves: the launcher's (refused
    unless it is 1 or ``tp_size``), or the process group's when one is up
    (refused likewise)."""
    what = "deepspeed_tpu_torch.init_inference"
    world = refuse_multi_process_world(what, tp_size)
    if comm.is_initialized():
        group = comm.get_world_size()
        if group > 1 and group != tp_size:
            raise NotImplementedError(
                f"{what}: the process group holds {group} ranks but tp_size is {tp_size}: a data axis above 1 "
                "(data-parallel serving) is not ported to deepspeed_tpu_torch yet")
        world = max(world, group)
    if tp_size > 1 and world == 1:
        raise NotImplementedError(
            f"{what}: tp_size={tp_size} in a single process: one process drives one device in "
            "deepspeed_tpu_torch, so tensor-parallel serving runs tp_size processes (launch WORLD_SIZE=tp_size, "
            "or join a process group of tp_size ranks with comm.init_distributed first)")
    return world


class InferenceEngine:
    def __init__(self, model: Model | None = None, config: dict | None = None,
                 params: dict | None = None, device=None):
        config = dict(config or {})
        tp_size = int(config.get("tensor_parallel", {}).get("tp_size", config.get("mp_size", 1)))
        _tp_world(tp_size)
        qcfg = config.get("quantize", config.get("quant", {}))
        if isinstance(qcfg, dict) and qcfg.get("enabled"):
            raise NotImplementedError("weight-only quantization is not ported yet")
        dtype = config.get("dtype", torch.bfloat16)
        if isinstance(dtype, str):
            if dtype not in _DTYPES:
                raise ValueError(f"unsupported dtype {dtype!r}; one of {sorted(_DTYPES)}")
            if dtype in ("fp16", "half"):
                log_dist("inference dtype fp16 requested: serving in bfloat16 "
                         "(same memory, wider exponent)", ranks=[0])
            dtype = _DTYPES[dtype]
        if model is None:
            raise ValueError("InferenceEngine needs a model")
        if tp_size > 1 and model.config.moe_every > 0:
            raise NotImplementedError(f"MoE at tp_size={tp_size} (the experts split over the model axis) is not "
                                      "ported to deepspeed_tpu_torch yet; tp_size 1 serves it")
        if model.config.dtype != dtype:
            model = Model(model.config.replace(dtype=dtype))

        if device is None and tp_size > 1 and torch.cuda.is_available():
            # one rank a device: the launcher's local rank picks it
            device = torch.device("cuda", comm.get_local_rank() % torch.cuda.device_count())
            torch.cuda.set_device(device)
        self.device = resolve_device(device)
        self.model = model
        self.cfg: TransformerConfig = model.config
        self.dtype = dtype
        self.max_out_tokens = config.get("max_out_tokens", self.cfg.max_seq_len)
        self.mesh = None
        self.tp: Optional[TensorParallel] = None
        if tp_size > 1:
            comm.init_distributed(device=self.device)
            self.mesh = comm.build_mesh(MeshConfig(data=-1, model=tp_size), axes_list=SERVING_AXES)
        if params is None:
            # drawn on the host, so every tp_size draws the same weights
            params = model.init(torch.Generator().manual_seed(0), "cpu" if self.mesh else self.device)
        if isinstance(params, TPParams):  # already this rank's slices (interop.tp_params_from_jax)
            if self.mesh is None or params.tp.mesh.shape != self.mesh.shape:
                raise ValueError(f"params hold the slices of a {params.tp.mesh.shape} mesh; this engine's is "
                                 f"{None if self.mesh is None else self.mesh.shape}")
            self.tp = TensorParallel(self.mesh, model.logical_axes(), params.tp.full_shapes)
        elif self.mesh is not None:
            # each rank keeps its slices, by the JAX engine's specs
            self.tp = TensorParallel(self.mesh, model.logical_axes(), params)
            params = self.tp.shard(params)
        n_params = sum(math.prod(s) for s in _leaves(self.tp.full_shapes)) if self.tp else \
            sum(t.numel() for t in _leaves(params))
        # weights live in the engine dtype; integer leaves keep theirs
        self.params = _cast(params, self.device, dtype)
        if self.tp is not None:
            self.params = TPParams(self.params, self.tp)
        mesh = f"mesh={self.mesh.shape}, " if self.mesh is not None else ""
        log_dist(f"inference engine: {n_params / 1e6:.1f}M params, tp={tp_size}, {mesh}device={self.device}, "
                 f"dtype={dtype}", ranks=[0])

    @property
    def heads(self) -> int:
        """The attention heads this rank computes (its KV cache's)."""
        return self.cfg.num_heads if self.tp is None else self.tp.heads(self.cfg.num_heads)

    @torch.inference_mode()
    def forward(self, tokens) -> torch.Tensor:
        """Full (non-incremental) forward: tokens [B, S] -> logits [B, S, V] fp32."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self.model.apply(self.params, tokens)

    __call__ = forward

    @torch.inference_mode()
    def generate(self, prompt_tokens, max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, repetition_penalty: float = 1.0,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompt [B, S] int -> generated [B, max_new_tokens] int32 (numpy).

        Temperature (<= 0 greedy), top-k, top-p and repetition penalty over
        prompt and generated history. Prefill runs the prompt through
        ``apply_with_cache``; then each of the ``max_new_tokens - 1`` decode
        steps runs one token per row, with the decode-attention kernel in
        every layer. The KV cache is written in place, and the position
        stays on the device, so the loop reads nothing back until the end.
        ``generator`` (on the engine's device) drives sampling; default
        seed 0."""
        cfg = self.cfg
        prompt = torch.as_tensor(prompt_tokens, dtype=torch.long, device=self.device)
        B, S = prompt.shape
        budget = min(cfg.max_seq_len, self.max_out_tokens)
        if S + max_new_tokens > budget:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds the "
                f"sequence budget {budget} (min of model max_seq_len "
                f"{cfg.max_seq_len} and max_out_tokens {self.max_out_tokens})")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        scfg = SamplerConfig(float(temperature), int(top_k), float(top_p),
                             float(repetition_penalty))
        use_seen = scfg.repetition_penalty != 1.0
        # the cache is rounded up to a multiple of 128, as the JAX engine
        # allocates it; positions past the live prefix are masked
        Smax = -(-(S + max_new_tokens) // 128) * 128
        cache = tfm.init_cache(cfg, B, Smax, dtype=cfg.dtype, device=self.device, heads=self.heads)
        seen = None
        if use_seen:
            seen = update_seen(torch.zeros(B, cfg.vocab_size, dtype=torch.bool,
                                           device=self.device), prompt)

        out = torch.empty(B, max_new_tokens, dtype=torch.int32, device=self.device)
        logits, cache = tfm.apply_with_cache(cfg, self.params, prompt, cache, 0, last_only=True)
        tok = sample_logits(logits[:, -1], generator, scfg, seen=seen)
        out[:, 0] = tok
        pos = torch.tensor(S, dtype=torch.int32, device=self.device)
        for i in range(1, max_new_tokens):
            if use_seen:
                seen = update_seen(seen, tok[:, None])
            logits, cache = tfm.apply_with_cache(cfg, self.params, tok[:, None].long(), cache, pos)
            tok = sample_logits(logits[:, 0], generator, scfg, seen=seen)
            out[:, i] = tok
            pos += 1
        return out.cpu().numpy()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _cast(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype if tree.is_floating_point() else tree.dtype)
