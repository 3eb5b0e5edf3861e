"""Generative inference: the one-shot ``InferenceEngine`` and the
continuous-batching ``ServingEngine`` over it.

    engine = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16"})
    serving = ServingEngine(engine, config={"n_slots": 16,
        "prefix_cache": {"enabled": True, "n_slots": 8, "max_prefix_len": 512},
        "chunked_prefill": {"enabled": True, "chunk_size": 256},
        "speculation": {"enabled": True, "depth": 8}})
    results = serving.serve([Request(uid=i, prompt=p, max_new_tokens=128) for i, p in ...])

A fleet of replicas behind one ``Router`` (``router.py``), in process or
as worker processes reached through ``rpc.ReplicaClient``, with the
request journal of ``journal.py``:

    router = Router(engine, config={"n_slots": 16, "router": {"replicas": 2}})
    results = router.serve([Request(uid=i, prompt=p, max_new_tokens=128) for i, p in ...])

``router.autoscale`` (or an ``Autoscaler`` around a ``WorkerSupervisor``)
grows, shrinks and heals the fleet, ``Router.rolling_upgrade`` replaces it
replica by replica, and ``launcher/http_gateway.HttpGateway`` puts it behind
HTTP with SSE token streams.
"""

from .engine import InferenceEngine  # noqa: F401
from .serving import Request, RequestResult, ServingEngine  # noqa: F401
from .journal import RequestJournal  # noqa: F401
from .router import Router  # noqa: F401
from .autoscaler import Autoscaler  # noqa: F401
from .rpc import ReplicaClient, RpcClient, RpcServer  # noqa: F401
