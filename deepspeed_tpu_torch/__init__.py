"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``, for one
NVIDIA Hopper GPU.

It carries the serving path so far:

    engine = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16"})
    tokens = engine.generate(prompt, max_new_tokens=256)

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .utils.logging import log_dist, logger  # noqa: F401


def init_inference(model=None, config=None, **kwargs):
    """Build an inference engine (the port of ``deepspeed_tpu.init_inference``).
    ``kwargs``: ``params`` (a parameter dict, e.g. from
    ``interop.params_from_jax``) and ``device``."""
    from .inference.engine import InferenceEngine

    return InferenceEngine(model=model, config=config or {}, **kwargs)
