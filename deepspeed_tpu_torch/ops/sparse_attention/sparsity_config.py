"""Block-sparse attention sparsity patterns, copied from
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (plain numpy; the
port keeps its own copy because importing any ``deepspeed_tpu`` submodule
imports jax).

The Dense / Fixed / Variable / BigBird / BSLongformer family of the
reference DeepSpeed (``deepspeed/ops/sparse_attention/sparsity_config.py``):
``make_layout(seq_len)`` yields a numpy [H, nq, nk] 0/1 block mask that the
CUDA block-sparse kernels (``ops/sparse_attention/kernels.py``) compress
into per-block lists of active blocks. The random blocks draw from
``np.random.default_rng(seed)`` in the JAX module's order, so both packages
give the same layouts bit for bit.
"""

from __future__ import annotations

import numpy as np


class SparsityConfig:
    def __init__(self, num_heads: int, block: int = 128, different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} must be divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=np.int64)

    def propagate_first_head(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local windows of ``num_local_blocks``; the last ``num_global_blocks``
    of each window attend/are attended globally (vertical stripes; horizontal
    too when ``horizontal_global_attention``)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 128,
        different_layout_per_head: bool = False,
        num_local_blocks: int = 4,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
        num_different_global_patterns: int = 1,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks:
            raise ValueError("num_local_blocks must be divisible by num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"attention must be uni/bidirectional, got {attention}")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention needs bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("num_different_global_patterns > 1 needs different_layout_per_head")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        for h in range(self.num_heads if self.different_layout_per_head else 1):
            # local windows
            for start in range(0, n, L):
                end = min(start + L, n)
                layout[h, start:end, start:end] = 1
            # global stripes: representative blocks of each window (pattern
            # rotates across heads when multiple patterns are requested)
            pattern = h % self.num_different_global_patterns
            for start in range(0, n, L):
                g_lo = start + L - (pattern + 1) * G
                g_hi = start + L - pattern * G
                g_lo, g_hi = max(0, min(g_lo, n)), max(0, min(g_hi, n))
                if g_lo >= g_hi:
                    continue
                layout[h, :, g_lo:g_hi] = 1  # vertical: everyone attends reps
                if self.horizontal_global_attention:
                    layout[h, g_lo:g_hi, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.propagate_first_head(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes + explicit global block indices."""

    def __init__(
        self,
        num_heads: int,
        block: int = 128,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 0,
        local_window_blocks=(4,),
        global_block_indices=(0,),
        global_block_end_indices=None,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
        seed: int = 0,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None
        )
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads if self.different_layout_per_head else 1):
            # variable-size local windows (last size repeats)
            start = 0
            i = 0
            while start < n:
                w = self.local_window_blocks[min(i, len(self.local_window_blocks) - 1)]
                end = min(start + w, n)
                layout[h, start:end, start:end] = 1
                start = end
                i += 1
            # global blocks
            if self.global_block_end_indices:
                spans = zip(self.global_block_indices, self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in self.global_block_indices)
            for lo, hi in spans:
                lo, hi = max(0, min(lo, n)), max(0, min(hi, n))
                layout[h, :, lo:hi] = 1
                if self.horizontal_global_attention:
                    layout[h, lo:hi, :] = 1
            # random blocks
            for q in range(n):
                for r in rng.integers(0, n, size=self.num_random_blocks):
                    layout[h, q, r] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.propagate_first_head(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding-window + global blocks."""

    def __init__(
        self,
        num_heads: int,
        block: int = 128,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 1,
        num_sliding_window_blocks: int = 3,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
        seed: int = 0,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads if self.different_layout_per_head else 1):
            for q in range(n):
                layout[h, q, max(0, q - w) : min(n, q + w + 1)] = 1  # sliding window
                for r in rng.integers(0, n, size=self.num_random_blocks):
                    layout[h, q, r] = 1
            g = min(self.num_global_blocks, n)
            layout[h, :, :g] = 1  # first blocks are global
            layout[h, :g, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.propagate_first_head(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Longformer: sliding window + explicit global block indices."""

    def __init__(
        self,
        num_heads: int,
        block: int = 128,
        different_layout_per_head: bool = False,
        num_sliding_window_blocks: int = 3,
        global_block_indices=(0,),
        global_block_end_indices=None,
        attention: str = "bidirectional",
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None
        )
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads if self.different_layout_per_head else 1):
            for q in range(n):
                layout[h, q, max(0, q - w) : min(n, q + w + 1)] = 1
            if self.global_block_end_indices:
                spans = zip(self.global_block_indices, self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in self.global_block_indices)
            for lo, hi in spans:
                lo, hi = max(0, min(lo, n)), max(0, min(hi, n))
                layout[h, :, lo:hi] = 1
                layout[h, lo:hi, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.propagate_first_head(layout)


SPARSITY_CONFIGS = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "variable": VariableSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
}
