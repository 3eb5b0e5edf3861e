"""Mixture of experts on one rank, the port of ``deepspeed_tpu/moe/``:
GShard top-1/top-2 gating with capacity, dispatch and combine through a
slot table, and the stacked expert bank. Expert parallelism is not ported:
a world or an expert mesh axis above 1 raises."""

from .experts import apply_experts, experts_logical_axes, init_experts
from .layer import init_moe_params, moe_ffn_apply, moe_ffn_dense, moe_layers, moe_logical_axes
from .sharded_moe import (
    EXPERT_AXES,
    compute_capacity,
    moe_dispatch_combine,
    route,
    top1_gating,
    top2_gating,
)
