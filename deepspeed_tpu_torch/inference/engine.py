"""Generative inference engine (the port of
``deepspeed_tpu/inference/engine.py``).

``InferenceEngine`` holds the model's parameters on one device in the
engine dtype and serves ``forward`` (full logits) and ``generate`` (prefill
plus a token-at-a-time decode loop over ``apply_with_cache``). It runs on
CUDA unless the caller passes ``device="cpu"``; with no GPU and no explicit
CPU request it raises rather than fall back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import transformer as tfm
from ..models.transformer import Model, TransformerConfig
from ..utils.logging import log_dist
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


class InferenceEngine:
    def __init__(self, model: Model | None = None, config: dict | None = None,
                 params: dict | None = None, device=None):
        config = dict(config or {})
        tp_size = config.get("tensor_parallel", {}).get("tp_size", config.get("mp_size", 1))
        if tp_size > 1:
            raise NotImplementedError("tensor parallelism is not ported yet; use tp_size=1")
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
        if model.config.dtype != dtype:
            model = Model(model.config.replace(dtype=dtype))

        self.device = resolve_device(device)
        self.model = model
        self.cfg: TransformerConfig = model.config
        self.dtype = dtype
        self.max_out_tokens = config.get("max_out_tokens", self.cfg.max_seq_len)
        if params is None:
            params = model.init(torch.Generator().manual_seed(0), self.device)
        # weights live in the engine dtype; integer leaves keep theirs
        self.params = _cast(params, self.device, dtype)
        n_params = sum(t.numel() for t in _leaves(self.params))
        log_dist(f"inference engine: {n_params / 1e6:.1f}M params, device={self.device}, "
                 f"dtype={dtype}", ranks=[0])

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
        cache = tfm.init_cache(cfg, B, Smax, dtype=cfg.dtype, device=self.device)
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
