"""Sparse gradient representation + sparse all-reduce, ported from
``deepspeed_tpu/runtime/sparse_tensor.py``.

Reference: ``runtime/sparse_tensor.py:11`` (SparseTensor wrapping torch
sparse COO) + ``engine.py:2297 sparse_allreduce``: embedding gradients are
exchanged as (indices, values) instead of the dense [V, D] matrix. Rows
are gathered by token id with a fixed row count (``count`` rows valid,
padding after them), as in the JAX package; ``sparse_all_reduce`` gathers
every rank's rows over a mesh axis through ``comm/``, so the bytes land in
the comms logger. The ``sparse_gradients`` flag parses as in JAX, which
does not act on it in its engine either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..comm.collectives import all_gather


class SparseTensor(NamedTuple):
    """Row-sparse matrix: ``values[i]`` is the dense row at ``indices[i]``;
    ``count`` rows are valid (padding after it)."""

    indices: torch.Tensor  # [N] int32 row ids (padded entries = 0)
    values: torch.Tensor  # [N, D]
    count: torch.Tensor  # 0-d int32
    dense_shape: tuple  # (num_rows, D)

    def to_dense(self) -> torch.Tensor:
        n = self.indices.shape[0]
        mask = (torch.arange(n, device=self.values.device) < self.count)[:, None]
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype, device=self.values.device)
        return out.index_add_(0, self.indices.long(), torch.where(mask, self.values, torch.zeros_like(self.values)))


def from_embedding_grad(token_ids: torch.Tensor, row_grads: torch.Tensor, vocab_size: int) -> SparseTensor:
    """tokens [T] + per-occurrence grads [T, D] -> SparseTensor over [V, D].
    Duplicate token ids keep separate rows (``to_dense`` adds them), as torch
    COO before coalescing."""
    T, D = row_grads.shape
    return SparseTensor(indices=token_ids.to(torch.int32), values=row_grads,
                        count=torch.tensor(T, dtype=torch.int32, device=row_grads.device),
                        dense_shape=(vocab_size, D))


def sparse_all_reduce(st: SparseTensor, axis) -> SparseTensor:
    """All-reduce by concatenating every rank's (indices, values) over the
    mesh axis (reference sparse_allreduce_bucket: all_gather of indices +
    values, engine.py:2323): the result has N x axis-size rows, still
    row-sparse; each rank's padding rows are zeroed, and ``count`` is the
    whole padded length (``to_dense`` keeps every block's prefix)."""
    idx = all_gather(st.indices, axis)
    vals = all_gather(st.values, axis)
    counts = all_gather(st.count.reshape(1), axis)  # [world]
    n = st.indices.shape[0]
    local_pos = torch.arange(idx.shape[0], device=idx.device) % n
    mask = (local_pos < torch.repeat_interleave(counts, n))[:, None]
    vals = torch.where(mask, vals, torch.zeros_like(vals))
    return SparseTensor(indices=idx, values=vals,
                        count=torch.tensor(idx.shape[0], dtype=torch.int32, device=idx.device),
                        dense_shape=st.dense_shape)
