"""``deepspeed_tpu_torch.comm``: the communication façade, ported from
``deepspeed_tpu/comm/__init__.py``.

Code above this layer does ``from deepspeed_tpu_torch import comm as dist``
as reference code does ``from deepspeed import comm as dist``. The world's
ranks are laid out over one named mesh (``mesh.py``), and a collective
names a mesh axis, or a tuple of axes, where the reference names a process
group (``collectives.py``, over ``torch.distributed``). The 1-bit
compressed all-reduce (the JAX package's ``compressed``) comes with the
1-bit optimizers and is not exported yet.
"""

from .collectives import (
    all_gather,
    all_reduce,
    all_to_all,
    axis_index,
    axis_size_in_jit,
    barrier,
    broadcast_in_axis,
    broadcast_object,
    copy_to_model,
    destroy_distributed,
    gather_from_model,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    mpi_discovery,
    ppermute,
    recording,
    reduce_from_model,
    reduce_scatter,
    ring_shift,
    scatter_to_model,
    world_codes,
)
from .logger import CommsLogger, comms_logger, get_bw
from .mesh import (
    AXIS_ORDER,
    DP_AXES,
    Mesh,
    MeshConfig,
    axis_size,
    batch_sharding,
    build_hybrid_mesh,
    build_mesh,
    current_mesh,
    data_parallel_size,
    named_sharding,
    replicated,
    single_device_mesh,
)
