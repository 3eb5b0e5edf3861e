"""Tensor-parallel building blocks: the port of the layers half of
``deepspeed_tpu/module_inject/`` (``layers.py``). The HF policies
(``replace_policy.py``) are not ported yet."""

from .layers import LinearAllreduce, LinearLayer, ReplaceWithTensorSlicing, TensorParallel

__all__ = ["LinearAllreduce", "LinearLayer", "ReplaceWithTensorSlicing", "TensorParallel"]
