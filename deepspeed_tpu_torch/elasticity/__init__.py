"""Elastic training (the port of ``deepspeed_tpu/elasticity``): the batch
algebra (``compute_elastic_config``) and the agent that relaunches a
worker across failures, hangs and membership changes
(``DSElasticAgent``). ``python -m deepspeed_tpu_torch.elasticity -c CFG
[-w N]`` inspects a config."""

from .elasticity import (  # noqa: F401
    ElasticityConfigError,
    ElasticityError,
    ElasticityIncompatibleWorldSize,
    compute_elastic_config,
    get_valid_gpus,
)
from .elastic_agent import HEARTBEAT_ENV, DSElasticAgent, WorkerSpec  # noqa: F401
