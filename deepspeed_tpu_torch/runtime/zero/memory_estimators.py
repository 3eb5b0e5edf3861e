"""ZeRO memory estimators, copied from
``deepspeed_tpu/runtime/zero/memory_estimators.py`` (reference
``estimate_zero{1,2,3}_model_states_mem_needs``,
runtime/zero/stage_1_and_2.py:2287 and the stage3.py equivalents).

The byte model follows the engines' state layout (``runtime/engine.py``),
not the reference's fp16 flat buffers:

  * params: fp32 on the device (4P), or the compute dtype (2P) when the
    optimizer is offloaded (the fp32 masters move to host memory)
  * gradients: fp32 (4P), replicated (stages 0/1) or sharded over the
    ZeRO axis (stages 2/3)
  * optimizer state (Adam m+v, and the fp32 master where it applies): 8P
    fp32, sharded over the ZeRO axis from stage 1, host-resident under
    offload

Activation memory is left out, as in the reference. The port runs on one
device, where ``num_chips`` is 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ...ops.optimizers import tree_leaves


@dataclass
class MemoryEstimate:
    per_chip_hbm: int  # bytes
    per_host_dram: int  # bytes (offloaded master+moments)

    def __str__(self):
        gb = 1024**3
        return (
            f"per-chip HBM: {self.per_chip_hbm / gb:.2f} GB, "
            f"per-host DRAM: {self.per_host_dram / gb:.2f} GB"
        )


def _estimate(
    total_params: int,
    stage: int,
    num_chips: int = 1,
    num_hosts: int = 1,
    offload_optimizer: bool = False,
    compute_dtype_bytes: int = 2,
) -> MemoryEstimate:
    P = total_params
    N = max(1, num_chips)
    opt_bytes = 8 * P  # Adam m+v fp32 (master fp32 counted with params)
    if offload_optimizer:
        params_dev = compute_dtype_bytes * P  # bf16 working copy only
        master_host = 4 * P
        if stage >= 1:
            # ZeRO-sharded over all chips; each host holds its chips' shards
            host = (opt_bytes + master_host) // max(1, num_hosts)
        else:
            # stage 0: replicated — every process keeps a full host copy
            host = opt_bytes + master_host
    else:
        params_dev = 4 * P
        host = 0
        if stage >= 1:
            opt_bytes //= N
    grads = 4 * P
    if stage >= 2:
        grads //= N
    if stage >= 3:
        params_dev //= N
    hbm = params_dev + grads + (0 if offload_optimizer else opt_bytes)
    return MemoryEstimate(per_chip_hbm=hbm, per_host_dram=host)


def estimate_zero1_model_states_mem_needs(
    total_params: int, num_chips: int = 1, num_hosts: int = 1, offload_optimizer: bool = False
) -> MemoryEstimate:
    return _estimate(total_params, 1, num_chips, num_hosts, offload_optimizer)


def estimate_zero2_model_states_mem_needs(
    total_params: int, num_chips: int = 1, num_hosts: int = 1, offload_optimizer: bool = False
) -> MemoryEstimate:
    return _estimate(total_params, 2, num_chips, num_hosts, offload_optimizer)


def estimate_zero3_model_states_mem_needs(
    total_params: int, num_chips: int = 1, num_hosts: int = 1, offload_optimizer: bool = False
) -> MemoryEstimate:
    return _estimate(total_params, 3, num_chips, num_hosts, offload_optimizer)


def count_params(model) -> int:
    """The parameter count of a model bundle (``models/transformer.Model``:
    has ``init``), from shapes only: the init runs under fake tensors, so no
    parameter is allocated."""
    with FakeTensorMode():
        params = model.init(torch.Generator(), "cpu")
    return sum(t.numel() for t in tree_leaves(params))


def estimate_from_model(model, **kw) -> MemoryEstimate:
    """Estimate for a model bundle without materialising its parameters."""
    stage = kw.pop("stage", 3)
    return _estimate(count_params(model), stage, **kw)


def print_mem_estimates(total_params: int, num_chips: int = 1, num_hosts: int = 1) -> None:
    """Human-readable table over all stages × offload, like the reference's
    printout (stage_1_and_2.py:2323)."""
    print(f"Model states memory needs for {total_params/1e9:.2f}B params, {num_chips} chips:")
    print(f"{'stage':>6} {'offload':>8} {'HBM/chip':>12} {'DRAM/host':>12}")
    for stage in (0, 1, 2, 3):
        for off in (False, True):
            e = _estimate(total_params, stage, num_chips, num_hosts, off)
            gb = 1024**3
            print(
                f"{stage:>6} {str(off):>8} {e.per_chip_hbm/gb:>10.2f}GB {e.per_host_dram/gb:>10.2f}GB"
            )
