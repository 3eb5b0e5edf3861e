"""FLOP and byte counting for the program ledger and the flops profiler.

The JAX package reads a compiled program's cost from XLA
(``cost_analysis``, ``memory_analysis``) and the flops profiler walks its
jaxpr. PyTorch runs eagerly, so the port counts what a call dispatches:
``CostCounter`` is a ``TorchDispatchMode`` that sees every ATen op the call
runs (the backward's too) and adds its work to its totals.

  * FLOPs, with the JAX profiler's per-op table (``profiler.py:30-120``):
    matmuls and convolutions exactly (``torch.utils.flop_counter``'s
    formulas, 2·M·N·K for a product), elementwise arithmetic one per output
    element, transcendentals two, reductions one per input element. The
    fused ATen ops (softmax, LayerNorm, GELU) count what their JAX
    decompositions count, per element; an op the table does not know
    counts no FLOP.
  * Bytes: each op reads its tensor inputs and writes its outputs once, so
    an eager call's traffic is their sum; an indexed read or write (an
    embedding lookup, a KV-cache scatter) moves the rows it names, not the
    tensor it indexes. Views, allocations and other metadata ops move
    nothing.
  * Only ops with a tensor on the counter's device count (``device=None``
    counts every device), so host work beside a device program (the
    memory tiers' host Adam) stays out of a CUDA engine's rows.

The hand-written kernels are ctypes launches the dispatcher never sees.
Each one runs inside ``kernel(device, costs)``: the active counters add
the kernel's own reckoning of its work (the numerator of its bound in
``PERF.md``: causal pairs halved, a sparse layout's block pairs), and the
body's ops, the plain twin's on the CPU included, are not counted again.
Nothing is launched for it, and the kernels' ``.launches`` counters move
only where they launch. ``paused()`` stops counting for work that is not
the program's (a CUDA graph's warm-up). ``scope(name)`` names the ops
inside it for the flops profiler's per-module rows (the JAX model's
``jax.named_scope``s).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..utils.logging import logger

# active counters, in entry order: a module global, not a thread-local,
# because the autograd engine runs a CUDA backward on its own thread
_COUNTERS: list["CostCounter"] = []
_PAUSED = [0]
_LOCAL = threading.local()  # .scopes: the calling thread's scope stack

# per output element
_ELEMENTWISE = {
    "add": 1, "add_": 1, "sub": 1, "sub_": 1, "rsub": 1, "mul": 1, "mul_": 1, "div": 1, "div_": 1,
    "neg": 1, "abs": 1, "maximum": 1, "minimum": 1, "clamp": 1, "clamp_": 1, "clamp_min": 1,
    "clamp_max": 1, "where": 1, "masked_fill": 1, "masked_fill_": 1, "relu": 1, "bitwise_and": 1,
    "bitwise_or": 1, "bitwise_xor": 1, "logical_and": 1, "logical_or": 1, "reciprocal": 1, "square": 1,
    "addcmul": 2, "addcmul_": 2, "addcdiv": 2, "addcdiv_": 2, "lerp": 2, "lerp_": 2,
    "exp": 2, "exp_": 2, "exp2": 2, "expm1": 2, "log": 2, "log1p": 2, "log2": 2, "tanh": 2, "sigmoid": 2,
    "erf": 2, "rsqrt": 2, "sqrt": 2, "sqrt_": 2, "sin": 2, "cos": 2, "pow": 2,
    # fused ops, as many per element as their JAX decompositions count
    "gelu": 8, "_softmax": 6, "_log_softmax": 6, "native_layer_norm": 7, "threshold_backward": 1,
    "gelu_backward": 10, "_softmax_backward_data": 3, "_log_softmax_backward_data": 3,
    "native_layer_norm_backward": 9,
}
# per input element
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "var", "var_mean", "std",
               "norm", "linalg_vector_norm", "any", "all", "argmax", "argmin", "nll_loss_forward"}
# indexed reads and writes touch the rows they name, not the whole tensor
# they index: a gather reads and writes its output's bytes, a scatter its
# values' (with the indices, both ways)
_GATHERS = {"index", "index_select", "gather", "embedding", "take", "take_along_dim"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "index_copy", "index_copy_", "index_add", "index_add_"}
# ops that move no data: allocations and metadata (views are ``is_view``)
_NO_DATA = {"empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like", "_unsafe_view",
            "lift_fresh", "set_", "resize_", "record_stream", "_reshape_alias", "sym_size", "sym_stride",
            "sym_numel", "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type"}


def counting() -> bool:
    """Whether some counter takes records now."""
    return bool(_COUNTERS) and not _PAUSED[0]


@contextlib.contextmanager
def paused():
    """No counter counts inside (a CUDA graph's warm-up runs the program
    once more than the program's own work)."""
    _PAUSED[0] += 1
    try:
        yield
    finally:
        _PAUSED[0] -= 1


_NULL = contextlib.nullcontext()


def kernel(device, costs: Callable[[], dict[str, tuple[float, float]]]):
    """A context for a body that launches hand-written kernels on
    ``device`` (or runs their plain twin on the CPU): the active counters
    take ``costs()`` -> {kernel name: (flops, bytes)} for them, and count
    none of the body's ops. With no counter active it is a shared no-op
    context and ``costs`` is not called."""
    if not counting():
        return _NULL
    device = torch.device(device)
    for name, (flops, nbytes) in costs().items():
        for c in list(_COUNTERS):
            c.add_kernel(name, device, float(flops), float(nbytes))
    return paused()


class _Scope:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "scopes", None)
        if stack is None:
            stack = _LOCAL.scopes = []
        stack.append(self.name)

    def __exit__(self, *exc):
        _LOCAL.scopes.pop()


def scope(name: str):
    """Name the ops inside for the per-module rows, nested as ``a/b``
    (nothing at all while no counter is active)."""
    return _Scope(name) if _COUNTERS else _NULL


def _current_scope() -> str:
    return "/".join(getattr(_LOCAL, "scopes", ()) or ())


def _tensors(tree, out: list) -> list:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def tensor_bytes(tree, device=None) -> int:
    """Bytes of the tensors in a nesting of lists, tuples and dicts (those
    on ``device`` when it is given)."""
    dev = None if device is None else torch.device(device)
    return sum(t.numel() * t.element_size() for t in _tensors(tree, [])
               if dev is None or _same_device(t.device, dev))


def _same_device(d: torch.device, want: torch.device) -> bool:
    return d.type == want.type and (want.index is None or d.index is None or d.index == want.index)


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of the ATen ops dispatched inside it (and
    of the kernels reported through ``kernel``) that touch ``device``
    (every device when None).

    ``flops`` and ``bytes`` are the totals; ``by_op`` maps an op (or a
    kernel's name) to its FLOPs, ``by_scope`` a ``scope`` path to its
    FLOPs and ``matmul_by_scope`` the same for matmul-class ops only;
    ``kernels`` maps a kernel's name to its calls, FLOPs and bytes."""

    def __init__(self, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device)
        self.flops = 0.0
        self.bytes = 0.0
        self.matmul_flops = 0.0
        self.ops = 0
        self.by_op: dict[str, float] = {}
        self.by_scope: dict[str, float] = {}
        self.matmul_by_scope: dict[str, float] = {}
        self.kernels: dict[str, dict] = {}

    def __enter__(self):
        out = super().__enter__()
        _COUNTERS.append(self)
        return out

    def __exit__(self, *exc):
        _COUNTERS.remove(self)
        return super().__exit__(*exc)

    def _mine(self, t: torch.Tensor) -> bool:
        return self.device is None or _same_device(t.device, self.device)

    def add_kernel(self, name: str, device: torch.device, flops: float, nbytes: float) -> None:
        if self.device is not None and not _same_device(device, self.device):
            return
        self._add(name, flops, nbytes, matmul=True)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def _add(self, name: str, flops: float, nbytes: float, matmul: bool) -> None:
        self.ops += 1
        self.bytes += nbytes
        if not flops:
            return
        self.flops += flops
        self.by_op[name] = self.by_op.get(name, 0.0) + flops
        where = _current_scope()
        self.by_scope[where] = self.by_scope.get(where, 0.0) + flops
        if matmul:
            self.matmul_flops += flops
            self.matmul_by_scope[where] = self.matmul_by_scope.get(where, 0.0) + flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _PAUSED[0]:
            try:
                self._count(func, args, kwargs, out)
            # dstpu: allow[broad-except] -- counting rides a LIVE dispatch: a formula that cannot read an op's arguments must drop that op's count, never fail the program it observes
            except Exception as e:  # noqa: BLE001
                logger.debug(f"cost counter skipped {func}: {e}")
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace != "aten" or func.is_view or name in _NO_DATA:
            return  # the port's own ops report through kernel(); views move nothing
        ins = _tensors((args, kwargs), [])
        outs = _tensors(out, [])
        mine_in = [t for t in ins if self._mine(t)]
        mine_out = [t for t in outs if self._mine(t)]
        if not mine_in and not mine_out:
            return
        if name in _GATHERS:
            moved = [t for t in mine_out] * 2 + [t for t in mine_in[1:] if not t.is_floating_point()]
        elif name in _SCATTERS:
            moved = mine_in[1:] * 2
        else:
            moved = mine_in + mine_out
        nbytes = sum(t.numel() * t.element_size() for t in moved)
        matmul = packet in flop_registry
        if matmul:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        elif name in _ELEMENTWISE:
            flops = _ELEMENTWISE[name] * (_numel(outs[0]) if outs else 0)
            if name.startswith("native_layer_norm"):
                flops = _ELEMENTWISE[name] * _numel(ins[0])
        elif name in _REDUCTIONS:
            flops = _numel(ins[0]) if ins else 0
        else:
            flops = 0
        self._add(name, float(flops), float(nbytes), matmul)

    def totals(self) -> dict:
        """{flops, bytes_accessed, matmul_flops, ops, kernels}: the ledger's
        cost fields (zeros dropped, as XLA's absent fields are)."""
        out: dict = {"ops": self.ops}
        if self.flops > 0:
            out["flops"] = self.flops
            out["matmul_flops"] = self.matmul_flops
        if self.bytes > 0:
            out["bytes_accessed"] = self.bytes
        if self.kernels:
            out["kernels"] = {k: dict(v) for k, v in self.kernels.items()}
        return out


# TorchDispatchMode wraps a subclass's __torch_dispatch__ in
# torch._disable_dynamo, whose first call imports torch._dynamo (with sympy
# and DTensor): seconds of every fresh process's first counted program.
# Nothing in the port compiles with dynamo, so the counter keeps its plain
# method.
CostCounter.__torch_dispatch__ = getattr(CostCounter.__torch_dispatch__, "__wrapped__",
                                         CostCounter.__torch_dispatch__)


__all__ = ["CostCounter", "counting", "kernel", "paused", "scope", "tensor_bytes"]
