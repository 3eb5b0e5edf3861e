"""Pipeline parallelism (reference: deepspeed/runtime/pipe/), the port of
``deepspeed_tpu/pipe/``: the rank topology, the instruction schedules, the
pipelined modules and the pipeline engine over the mesh's ``pipe`` axis."""

from .engine import PipelineEngine, pipeline_apply, pipeline_train_1f1b
from .module import (
    LayerSpec,
    PipelinedTransformer,
    PipelineModule,
    TiedLayerSpec,
    partition_balanced,
    partition_uniform,
)
from .schedule import InferenceSchedule, PipeSchedule, TrainSchedule
from .topology import (
    PipeDataParallelTopology,
    PipelineParallelGrid,
    PipeModelDataParallelTopology,
    ProcessTopology,
)
