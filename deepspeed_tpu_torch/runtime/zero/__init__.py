"""ZeRO's single-device memory tiers, ported from ``deepspeed_tpu/runtime/zero``:
the memory estimators, tiled linears, the NVMe-tiered optimizer, per-layer
parameter streaming and the host update. ``partition_parameters``
(``Init``, ``GatheredParameters``) comes with parallelism."""

from .memory_estimators import (  # noqa: F401
    MemoryEstimate,
    count_params,
    estimate_from_model,
    estimate_zero1_model_states_mem_needs,
    estimate_zero2_model_states_mem_needs,
    estimate_zero3_model_states_mem_needs,
    print_mem_estimates,
)
from .tiling import TiledLinear, TiledLinearConfig, split_tensor_along_dim  # noqa: F401
