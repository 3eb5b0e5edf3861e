"""Config key names + defaults, a copy of ``deepspeed_tpu/runtime/constants.py``
(the port keeps its own copy so it never imports the JAX package). Keys keep
DeepSpeed spelling so one JSON config drives both packages."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"

FP16 = "fp16"
BF16 = "bf16"
AMP = "amp"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

PRESCALE_GRADIENTS = "prescale_gradients"
SPARSE_GRADIENTS = "sparse_gradients"

ZERO_OPTIMIZATION = "zero_optimization"

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

SEED = "seed"
SEED_DEFAULT = 0

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
MEMORY_BREAKDOWN = "memory_breakdown"

ACTIVATION_CHECKPOINTING = "activation_checkpointing"
SPARSE_ATTENTION = "sparse_attention"
FLOPS_PROFILER = "flops_profiler"
COMMS_LOGGER = "comms_logger"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
MONITOR_CSV = "csv_monitor"
TELEMETRY = "telemetry"
SERVING = "serving"
SERVING_ROUTER = "router"  # sub-block of SERVING (inference/router.py)
RESILIENCE = "resilience"
CURRICULUM_LEARNING = "curriculum_learning"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
ELASTICITY = "elasticity"
AUTOTUNING = "autotuning"
COMPRESSION_TRAINING = "compression_training"
AIO = "aio"
DATALOADER_DROP_LAST = "dataloader_drop_last"
CHECKPOINT = "checkpoint"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
DUMP_STATE = "dump_state"

# TPU-only section: mesh axis sizes (pipe/data/fsdp/context/model).
MESH = "mesh"

ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
ROUTE_ENCODE = "encode"
