"""The host tier's optimizer update and buffers: the role of the reference's
``csrc/adam/cpu_adam.cpp`` (and of the JAX engine's
``compute_on('device_host')`` update region, ``engine.py:764-840``).

``adam_step_`` updates an fp32 master and its Adam moments IN PLACE from an
fp32 gradient, a cache-sized chunk at a time through scratch buffers,
so a step allocates nothing the size of the model and the pinned buffers
stay the ones the tier allocated. Its arithmetic is the JAX NVMe tier's
numpy update (``nvme_optimizer.py:229-236``) operation for operation, each
rounded to fp32 in the same order, so the port's NVMe tier reproduces the
JAX one bit for bit. ``leafwise_update_`` runs any other optimizer of
``ops/optimizers.py`` one leaf at a time and copies the result back into
the buffers.

``host_empty`` allocates a host buffer, pinned when the tier copies it to
or from the card; a failed allocation raises ``HostMemoryError`` with the
byte count (the tier never goes on in pageable memory).
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 20  # elements per pass of the update: 4 MiB of each fp32 operand

ADAM_FAMILY = ("adam", "adamw", "fusedadam", "cpuadam")


class HostMemoryError(RuntimeError):
    pass


def host_empty(shape, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """An uninitialised host tensor, pinned when ``pin``; raises
    ``HostMemoryError`` naming the bytes when it cannot be had."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    try:
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=pin)
    except RuntimeError as e:
        kind = "pinned host" if pin else "host"
        raise HostMemoryError(f"could not allocate {nbytes} bytes ({nbytes / 2**30:.2f} GiB) of {kind} memory "
                              f"for a {tuple(shape)} {dtype} buffer: {e}") from e


def host_like(t: torch.Tensor, pin: bool, dtype=None) -> torch.Tensor:
    """A host copy of ``t`` (in ``dtype``), pinned when ``pin``."""
    out = host_empty(t.shape, dtype or t.dtype, pin)
    out.copy_(t)
    return out


class AdamScratch:
    """The chunk-sized fp32 buffers ``adam_step_`` works in."""

    def __init__(self, n: int = CHUNK):
        self.a, self.b, self.c = (torch.empty(n, dtype=torch.float32) for _ in range(3))
        self.d = torch.empty(n, dtype=torch.float64)


def adam_step_(master: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *, lr: float,
               step: int, betas, eps: float, weight_decay: float, adamw: bool,
               bias_correction: bool = True, scratch: AdamScratch = None) -> None:
    """One Adam/AdamW update of contiguous fp32 CPU tensors, in place on
    ``master``, ``m`` and ``v`` (``g`` is read only). In the JAX NVMe tier's
    order: ``g' = g + wd·p`` (Adam), ``m = b1·m + (1-b1)·g'``,
    ``v = b2·v + ((1-b2)·g')·g'``, ``u = (m/bc1) / (sqrt(v/bc2) + eps)``,
    ``u += wd·p`` (AdamW), ``p -= lr·u``."""
    b1, b2 = betas
    bc1, bc2 = (1.0 - b1 ** step, 1.0 - b2 ** step) if bias_correction else (1.0, 1.0)
    scratch = scratch or AdamScratch()
    fp, fm, fv, fg = (t.view(-1) for t in (master, m, v, g))
    n = fp.numel()
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        p, mm, vv, gg = fp[lo:hi], fm[lo:hi], fv[lo:hi], fg[lo:hi]
        t1, t2 = scratch.a[:hi - lo], scratch.b[:hi - lo]
        if weight_decay and not adamw:  # plain Adam: L2 in the gradient
            gg = torch.mul(p, weight_decay, out=scratch.c[:hi - lo]).add_(gg)
        mm.mul_(b1)
        torch.mul(gg, 1.0 - b1, out=t1)
        mm.add_(t1)
        vv.mul_(b2)
        torch.mul(gg, 1.0 - b2, out=t1)
        t1.mul_(gg)
        vv.add_(t1)
        torch.div(vv, bc2, out=t1)
        # fp32 sqrt through fp64: PyTorch's vectorised fp32 sqrt is not
        # correctly rounded on every CPU (AVX-512), numpy's is; the fp64
        # root rounded once to fp32 is
        d = scratch.d[:hi - lo]
        d.copy_(t1).sqrt_()
        t1.copy_(d)
        t1.add_(eps)
        torch.div(mm, bc1, out=t2)
        t2.div_(t1)
        if weight_decay and adamw:  # decoupled decay
            torch.mul(p, weight_decay, out=t1)
            t2.add_(t1)
        t2.mul_(lr)
        p.sub_(t2)


def adam_params(opt_type: str, params: dict) -> dict:
    """The host Adam's keyword arguments from an optimizer block: the decay
    mode follows the optimizer's name, as on the device and in the JAX
    tiers."""
    p = dict(params)
    return {"betas": tuple(p.get("betas", (0.9, 0.999))), "eps": float(p.get("eps", 1e-8)),
            "weight_decay": float(p.get("weight_decay", 0.0)), "adamw": opt_type.lower() == "adamw",
            "bias_correction": bool(p.get("bias_correction", True))}


def leafwise_update_(opt_update, grads: list, opt: dict, master: list, step: int, lr: float) -> None:
    """Any optimizer of ``ops/optimizers.py`` on the host, one leaf at a
    time: ``grads`` and ``master`` are the leaves in tree order, ``opt`` maps
    each state name to its leaves in the same order; results are copied
    back into the buffers."""
    step_t = torch.tensor(step, dtype=torch.int32)
    lr_t = torch.tensor(lr, dtype=torch.float32)
    for i, (g, p) in enumerate(zip(grads, master)):
        sub = {k: {"x": leaves[i]} for k, leaves in opt.items()}
        new_p, new_sub = opt_update({"x": g}, sub, {"x": p}, step_t, lr_t)
        p.copy_(new_p["x"])
        for k, leaves in opt.items():
            leaves[i].copy_(new_sub[k]["x"])
