"""Block-sparse attention: the sparsity-config family, the CUDA
block-sparse flash kernels with their plain versions, and the module API
(the port of ``deepspeed_tpu/ops/sparse_attention``)."""

from .kernels import sparse_flash_attention  # noqa: F401
from .sparsity_config import (  # noqa: F401
    SPARSITY_CONFIGS,
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
from .sparse_self_attention import (  # noqa: F401
    BertSparseSelfAttention,
    SparseAttentionUtils,
    SparseSelfAttention,
)
