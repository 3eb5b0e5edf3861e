"""ZeRO, ported from ``deepspeed_tpu/runtime/zero``: the data-parallel
stages (``stage_1_and_2.py``, ``stage3.py``), ``partition_parameters``
(``Init``, ``GatheredParameters``), and the memory tiers (``offload.py``;
over the ranks' shards for the cpu tier): the memory estimators, tiled
linears, the NVMe-tiered optimizer, per-layer parameter streaming and the
host update."""

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
from .partition_parameters import GatheredParameters, Init  # noqa: F401
