"""Megatron-style state-dict loading with tensor-parallel re-slicing (a copy
of ``deepspeed_tpu/checkpoint/state_dict_factory.py``).

Load a checkpoint saved at TP degree N and serve it at TP degree M,
merging shards (N > M) or splitting them (N < M), with the fused QKV matrix
needing head-aware treatment (``merge_query_key_value`` /
``split_query_key_value``). State dicts are flat {name: numpy array} maps
(from .npz files or in memory); re-slicing is pure numpy. Axis rules follow
Megatron conventions:

  column-parallel (sharded on OUTPUT dim 0 … transposed storage):
      attention.query_key_value.weight/bias (head-interleaved!), mlp
      dense_h_to_4h
  row-parallel (sharded on INPUT dim):
      attention.dense, mlp dense_4h_to_h
  replicated: layernorms, biases of row-parallel layers

QKV versions: v0 stores each shard PROJECTION-major — [q_block; k_block;
v_block] stacked — so a naive concat of shards would interleave rank
blocks ([q0 k0 v0 q1 k1 v1]) instead of grouping projections ([q0 q1 k0 k1
v0 v1]); v>=1.0 stores head-major blocks where plain dim-0 concat/split is
correct.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

COLUMN_PARALLEL = (
    r"query_key_value\.weight$", r"query_key_value\.bias$",
    r"dense_h_to_4h\.weight$", r"dense_h_to_4h\.bias$",
    r"word_embeddings\.weight$", r"lm_head\.weight$",
)
ROW_PARALLEL = (
    r"attention\.dense\.weight$", r"dense_4h_to_h\.weight$",
)
QKV = (r"query_key_value\.(weight|bias)$",)


def _matches(name: str, patterns) -> bool:
    return any(re.search(p, name) for p in patterns)


def merge_query_key_value(shards: Sequence[np.ndarray], num_heads: int = 0, version: float = 2.0):
    """Merge per-TP-rank fused QKV shards (reference merge_query_key_value
    :243). version 0: shards are projection-major [q;k;v] — split each into
    its three projections and concatenate per-projection across ranks;
    version >= 1.0: head-major blocks, plain concat."""
    if version == 0:
        parts3 = [s.reshape((3, s.shape[0] // 3) + s.shape[1:]) for s in shards]
        merged = np.concatenate(parts3, axis=1)  # [3, n*hn, ...]
        return merged.reshape((-1,) + merged.shape[2:])
    return np.concatenate(shards, axis=0)


def split_query_key_value(param: np.ndarray, n: int, index: int, num_heads: int = 0,
                          version: float = 2.0):
    """Take TP-rank ``index``'s slice of a fused QKV parameter (reference
    split_query_key_value :281)."""
    if version == 0:
        p3 = param.reshape((3, param.shape[0] // 3) + param.shape[1:])
        part = np.split(p3, n, axis=1)[index]  # [3, local, ...]
        return part.reshape((-1,) + part.shape[2:])
    return np.split(param, n, axis=0)[index]


class MegatronSDLoader:
    """Load ``ckpt_list`` (one state dict per source TP rank) and serve
    ``get_split_state_dict(mp_world_size, mp_rank)`` at any target degree."""

    def __init__(self, ckpt_list: Sequence, num_heads: int, version: float = 2.0):
        self.state_dicts = [self._load(c) for c in ckpt_list]
        self.num_heads = num_heads
        self.version = version

    @staticmethod
    def _load(c):
        if isinstance(c, dict):
            return {k: np.asarray(v) for k, v in c.items()}
        if str(c).endswith(".npz"):
            with np.load(c) as z:
                return {k: z[k] for k in z.files}
        raise ValueError(f"unsupported checkpoint entry {c!r} (dict or .npz)")

    # -- merge all source shards to TP=1 ------------------------------------
    def merge_state_dict(self) -> dict:
        sds = self.state_dicts
        if len(sds) == 1:
            return dict(sds[0])
        out = {}
        for name in sds[0]:
            parts = [sd[name] for sd in sds]
            if _matches(name, QKV):
                out[name] = merge_query_key_value(parts, self.num_heads, self.version)
            elif _matches(name, COLUMN_PARALLEL):
                out[name] = np.concatenate(parts, axis=0)
            elif _matches(name, ROW_PARALLEL):
                out[name] = np.concatenate(parts, axis=1)
            else:
                out[name] = parts[0]  # replicated
        return out

    # -- serve any target degree -------------------------------------------
    def get_split_state_dict(self, mp_world_size: int, mp_rank: int) -> dict:
        full = self.merge_state_dict()
        if mp_world_size == 1:
            return full
        out = {}
        for name, p in full.items():
            if _matches(name, QKV):
                out[name] = split_query_key_value(
                    p, mp_world_size, mp_rank, self.num_heads, self.version
                )
            elif _matches(name, COLUMN_PARALLEL):
                out[name] = np.split(p, mp_world_size, axis=0)[mp_rank]
            elif _matches(name, ROW_PARALLEL):
                out[name] = np.split(p, mp_world_size, axis=1)[mp_rank]
            else:
                out[name] = p
        return out


class SDLoaderFactory:
    @staticmethod
    def get_sd_loader(ckpt_list, sd_type: str = "Megatron", num_heads: int = 1,
                      version: Optional[float] = 2.0):
        if sd_type.lower() == "megatron":
            return MegatronSDLoader(
                ckpt_list, num_heads=num_heads,
                version=2.0 if version is None else version,  # 0 is a real version
            )
        raise ValueError(f"unknown sd_type {sd_type!r}")
