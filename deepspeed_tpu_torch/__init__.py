"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``, for one
NVIDIA Hopper GPU.

It carries the training path and the serving path so far:

    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds_config)
    metrics = engine.train_batch({"tokens": tokens})   # int [B, S+1]

    engine, _, loader, _ = deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds_config,
                                                          training_data=dataset)
    for batch in loader:                                # dicts of numpy [train_batch_size, ...]
        engine.train_batch(batch)

    engine = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16"})
    tokens = engine.generate(prompt, max_new_tokens=256)

    from deepspeed_tpu_torch.inference import Request, ServingEngine
    serving = ServingEngine(engine, config={"n_slots": 16,
        "prefix_cache": {"enabled": True, "n_slots": 8, "max_prefix_len": 512},
        "chunked_prefill": {"enabled": True, "chunk_size": 256},
        "speculation": {"enabled": True, "depth": 8}})
    results = serving.serve([Request(uid=i, prompt=p, max_new_tokens=128) for i, p in ...])

``ServingEngine`` is continuous batching over a slot KV cache, with its
decode step one CUDA graph on the card (``inference/serving.py``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .utils.logging import log_dist, logger  # noqa: F401


def initialize(args=None, model=None, config=None, config_params=None, model_parameters=None,
               training_data=None, collate_fn=None, device=None, **kwargs):
    """Build a training engine (the port of ``deepspeed_tpu.initialize``).

    Returns ``(engine, engine, dataloader, engine.lr_schedule)``: the
    optimizer and the schedule live inside the engine's step, so those slots
    hold the engine's handles. With ``training_data`` (an indexable dataset
    of dicts, tuples or arrays) the third slot is the engine's
    ``deepspeed_io`` loader over it (``collate_fn`` overrides the default
    ``np.stack`` collation), else None. ``model_parameters`` takes a
    parameter dict (e.g. from ``interop.params_from_jax``), so both packages
    can start from the same weights."""
    from .runtime.engine import DeepSpeedEngine

    cfg = config if config is not None else config_params
    if cfg is None and args is not None:
        cfg = getattr(args, "deepspeed_config", None)
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if cfg is None:
        raise ValueError("deepspeed_tpu_torch.initialize: config is required")
    engine = DeepSpeedEngine(model=model, config=cfg, params=model_parameters, device=device, **kwargs)
    dataloader = None
    if training_data is not None:
        io_kw = {"collate_fn": collate_fn} if collate_fn is not None else {}
        dataloader = engine.deepspeed_io(training_data, **io_kw)
    return engine, engine, dataloader, engine.lr_schedule


def init_inference(model=None, config=None, **kwargs):
    """Build an inference engine (the port of ``deepspeed_tpu.init_inference``).
    ``kwargs``: ``params`` (a parameter dict, e.g. from
    ``interop.params_from_jax``) and ``device``."""
    from .inference.engine import InferenceEngine

    return InferenceEngine(model=model, config=config or {}, **kwargs)
