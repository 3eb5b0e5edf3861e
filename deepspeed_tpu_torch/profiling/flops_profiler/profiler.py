"""FLOPs / params / latency profiler (the port of
``deepspeed_tpu/profiling/flops_profiler/profiler.py``; DeepSpeed's
``FlopsProfiler``).

The JAX profiler walks a function's jaxpr with a per-primitive table; the
port runs the function once under ``telemetry.cost.CostCounter``, which
applies the same table to the ATen ops it dispatches and adds each
hand-written kernel's own reckoning of its work. Matmuls count exactly
(2·M·N·K), elementwise ops one FLOP per output element, transcendentals
two, reductions one per input element. Per-module rows come from the
model's named scopes (``embed``, ``attn``, ``ffn``, ``lm_head``: the JAX
model's ``jax.named_scope``s, at the same places), nested as ``a/b``.
Latency is a second run of the function, timed to its last kernel.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ...telemetry.cost import CostCounter


def scope_tree(by_scope: dict[str, float]) -> dict:
    """Fold flat 'a/b/c' scope paths into a nested tree of
    ``{'flops': subtree_total, 'children': {...}}`` nodes. FLOPs recorded at
    an interior scope surface as its own row AND roll up into ancestors, so
    every level's children (+ own unattributed remainder) sum to the node."""
    root = {"flops": 0.0, "children": {}}
    for path, f in by_scope.items():
        parts = [p for p in path.split("/") if p] if path else []
        node = root
        node["flops"] += f
        for part in parts:
            node = node["children"].setdefault(part, {"flops": 0.0, "children": {}})
            node["flops"] += f
    return root


def _num(x: float, suffix: str = "") -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(x) < 1000:
            return f"{x:.2f} {unit}{suffix}"
        x /= 1000
    return f"{x:.2f} E{suffix}"


def _tensors(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _sync(tree) -> None:
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@dataclass
class ProfileResult:
    total_flops: float
    total_params: int
    latency_s: Optional[float]
    by_primitive: dict[str, float]  # by ATen op (or kernel) name
    by_scope: dict[str, float] = field(default_factory=dict)
    matmul_flops: float = 0.0
    matmul_by_scope: dict[str, float] = field(default_factory=dict)
    # the counter's cost fields: bytes_accessed, the kernels' own rows
    cost: dict = field(default_factory=dict)

    @property
    def tflops_per_sec(self) -> Optional[float]:
        if self.latency_s:
            return self.total_flops / self.latency_s / 1e12
        return None


class FlopsProfiler:
    """Profiles a function of tensors (DeepSpeed's profiles a module).

    Usage (as ``get_model_profile``, DeepSpeed ``profiler.py:900``)::

        prof = FlopsProfiler()
        res = prof.profile(fn, *args)        # counted run + timed run
        prof.print_model_profile(res)
    """

    def __init__(self, config=None):
        self.config = config

    @torch.no_grad()
    def profile(self, fn: Callable, *args, time_it: bool = True, params: Any = None) -> ProfileResult:
        with CostCounter() as c:
            out = fn(*args)
        n_params = sum(t.numel() for t in _tensors(params)) if params is not None else 0
        latency = None
        if time_it:
            _sync((args, out))
            t0 = time.perf_counter()
            out = fn(*args)
            _sync((args, out))
            latency = time.perf_counter() - t0
        return ProfileResult(c.flops, n_params, latency, dict(c.by_op), dict(c.by_scope), c.matmul_flops,
                             dict(c.matmul_by_scope), c.totals())

    def print_model_profile(self, res: ProfileResult, detailed: bool = True,
                            depth: int = -1, top_modules: int = 0, output_file=None):
        """Aggregates + per-op table + the depth-limited per-module tree
        (DeepSpeed ``profiler.py:235`` print_model_profile: each row is a
        named scope with its FLOPs and share; ``depth`` limits nesting,
        ``top_modules`` keeps only the largest rows per level)."""
        lines = [
            "-" * 60,
            "deepspeed_tpu_torch flops profiler (reference: flops-profiler)",
            "-" * 60,
            f"params:               {_num(float(res.total_params))}",
            f"fwd FLOPs (counted):  {_num(res.total_flops, 'FLOPs')}",
            f"fwd FLOPs (matmul):   {_num(res.matmul_flops, 'FLOPs')}",
        ]
        by = res.cost.get("bytes_accessed")
        if by:
            lines.append(f"bytes accessed:       {_num(by, 'B')}")
            lines.append(f"arith intensity:      {res.total_flops / by:.2f} FLOPs/B")
        if res.latency_s:
            lines.append(f"latency:              {res.latency_s*1e3:.2f} ms")
            lines.append(f"achieved:             {res.tflops_per_sec:.2f} TFLOPS")
        if detailed and res.by_primitive:
            lines.append("per-op breakdown:")
            for k, v in sorted(res.by_primitive.items(), key=lambda kv: -kv[1]):
                share = 100.0 * v / max(res.total_flops, 1.0)
                lines.append(f"  {k:24s} {_num(v, 'FLOPs'):>14s}  {share:5.1f}%")
        if detailed and res.by_scope and any(k for k in res.by_scope):
            lines.append("per-module breakdown (named scopes):")
            tree = scope_tree(res.by_scope)

            def emit(node, indent, d):
                kids = sorted(node["children"].items(), key=lambda kv: -kv[1]["flops"])
                if top_modules > 0:
                    kids = kids[:top_modules]
                for name, child in kids:
                    share = 100.0 * child["flops"] / max(res.total_flops, 1.0)
                    lines.append(
                        f"{'  ' * indent}  {name:<{max(24 - 2 * indent, 4)}s} "
                        f"{_num(child['flops'], 'FLOPs'):>14s}  {share:5.1f}%"
                    )
                    if d != 0:
                        emit(child, indent + 1, d - 1)

            emit(tree, 0, depth if depth >= 0 else -1)
        lines.append("-" * 60)
        text = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(text + "\n")
        else:
            print(text)
        return text


def get_model_profile(model, tokens_shape=(1, 128), time_it: bool = True, device="cpu"):
    """DeepSpeed's ``get_model_profile`` (``profiler.py:900``): the forward
    of ``model`` (a ``models.transformer.Model``) at zero tokens of
    ``tokens_shape`` on ``device``, weights from seed 0 -> (flops, params,
    latency)."""
    params = model.init(torch.Generator().manual_seed(0), device)
    tokens = torch.zeros(tokens_shape, dtype=torch.long, device=device)
    res = FlopsProfiler().profile(lambda p, t: model.apply(p, t), params, tokens, time_it=time_it, params=params)
    return res.total_flops, res.total_params, res.latency_s


__all__ = ["FlopsProfiler", "ProfileResult", "get_model_profile", "scope_tree"]
