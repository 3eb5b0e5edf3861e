"""Data loading, copied from ``deepspeed_tpu/runtime/dataloader.py``
(host-only numpy; the port keeps its own copy because importing any
``deepspeed_tpu`` submodule imports jax).

Reference: ``deepspeed/runtime/dataloader.py`` — ``DeepSpeedDataLoader``
(:33, DistributedSampler over DP ranks) and ``RepeatingLoader`` (:10).

The port runs on one device, so ``DeepSpeedEngine.deepspeed_io`` builds the
loader with one replica and the global ``train_batch_size``: each batch is
a dict of numpy arrays (``_default_collate``), or whatever ``collate_fn``
returns, that ``train_batch`` takes as it is. The sampler keeps the
reference's semantics (rank-strided indexing, per-epoch reshuffling from
``seed + epoch``, drop_last), so the port and the JAX package read a dataset
in the same order, and ``state_dict``/``load_state_dict`` carry the cursor
through a checkpoint in the JAX package's format.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration (reference :10)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DistributedSampler:
    """Rank-strided index sampler with per-epoch shuffling — the semantics of
    torch's DistributedSampler the reference relies on (dataloader.py:77)."""

    def __init__(
        self,
        num_samples: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        assert 0 <= rank < num_replicas
        self.num_samples_total = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.per_rank = num_samples // num_replicas
        else:
            self.per_rank = math.ceil(num_samples / num_replicas)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return self.per_rank

    def __iter__(self) -> Iterator[int]:
        n = self.num_samples_total
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            idx = np.arange(n)
        if self.drop_last:
            idx = idx[: self.per_rank * self.num_replicas]
        else:  # pad by wrapping so every rank sees per_rank samples
            pad = self.per_rank * self.num_replicas - n
            if pad > 0:
                idx = np.concatenate([idx, idx[:pad]])
        return iter(idx[self.rank :: self.num_replicas].tolist())


class DeepSpeedDataLoader:
    """Batching loader over an indexable dataset (reference :33).

    dataset[i] must return a dict of numpy-convertible leaves (or a tuple);
    ``collate_fn`` overrides the default np.stack collation. ``batch_size``
    here is the per-iteration batch this process must supply; the port's
    engine passes its whole ``train_batch_size`` (one device, one replica).
    """

    def __init__(
        self,
        dataset: Sequence,
        batch_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.sampler = DistributedSampler(
            len(dataset), num_replicas, rank, shuffle=shuffle, seed=seed, drop_last=drop_last
        )
        self.collate_fn = collate_fn or _default_collate
        self._len = len(self.sampler) // batch_size if drop_last else math.ceil(
            len(self.sampler) / batch_size
        )
        self.batches_yielded = 0  # within the current epoch
        self._resume_skip = 0  # batches to fast-forward on the next __iter__

    def set_epoch(self, epoch: int) -> None:
        if int(epoch) != self.sampler.epoch:
            # a NEW epoch voids any pending resume skip; re-announcing the
            # current epoch (the canonical `loader.set_epoch(e)` at the top
            # of the epoch loop, re-run after a mid-epoch resume) must NOT —
            # the restored cursor would silently replay the epoch from 0
            self._resume_skip = 0
            self.batches_yielded = 0
        self.sampler.set_epoch(epoch)

    def __len__(self):
        return self._len

    # -- checkpointable cursor (docs/resilience.md "elastic resume") -------
    def state_dict(self) -> dict:
        """The data cursor a resumed run needs to continue mid-epoch
        without re-reading or skipping samples. ``batches_yielded`` counts
        batches HANDED OUT — a batch fetched but not yet trained when a
        preemption fires must be replayed, which is why the engine
        checkpoints the cursor it snapshotted at the last *completed* step,
        not this live count. ``global_samples`` (samples consumed this
        epoch across ALL replicas) is the topology-free form: a resume on
        a different dp world rescales through it."""
        return {
            "epoch": self.sampler.epoch,
            "batches_yielded": self.batches_yielded,
            "batch_size": self.batch_size,
            "num_replicas": self.num_replicas,
            "sampler_seed": self.sampler.seed,
            "shuffle": self.sampler.shuffle,
            "global_samples": self.batches_yielded * self.batch_size * self.num_replicas,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore the cursor; the next ``__iter__`` fast-forwards to it.
        Same batch geometry resumes at the exact batch index; a changed
        geometry (elastic dp resize — ``compute_elastic_config`` picked a
        new micro-batch, so per-process ``batch_size * num_replicas``
        moved) converts through the epoch's global sample count, so the
        resumed run consumes each remaining sample exactly once."""
        self.sampler.set_epoch(int(sd.get("epoch", 0)))
        if int(sd.get("sampler_seed", self.sampler.seed)) != self.sampler.seed:
            raise ValueError(
                "dataloader.load_state_dict: sampler seed mismatch "
                f"({sd.get('sampler_seed')} saved vs {self.sampler.seed} "
                "live) — the shuffled sample order would silently diverge")
        if bool(sd.get("shuffle", self.sampler.shuffle)) != self.sampler.shuffle:
            raise ValueError(
                "dataloader.load_state_dict: shuffle mismatch "
                f"({sd.get('shuffle')} saved vs {self.sampler.shuffle} live) "
                "— the sample order would silently diverge")
        here = self.batch_size * self.num_replicas
        saved = int(sd.get("batch_size", self.batch_size)) * int(
            sd.get("num_replicas", self.num_replicas))
        if saved == here:
            skip = int(sd.get("batches_yielded", 0))
        else:
            global_samples = int(sd.get(
                "global_samples", int(sd.get("batches_yielded", 0)) * saved))
            skip, rem = divmod(global_samples, here)
            if rem:
                # the old geometry's boundary falls inside a new global
                # batch: replay the partial batch (never skip samples)
                import warnings

                warnings.warn(
                    f"dataloader cursor rescale: {global_samples} consumed "
                    f"samples is not a multiple of the new global batch "
                    f"{here}; {rem} samples of the boundary batch are "
                    "replayed", stacklevel=2)
        self._resume_skip = min(skip, self._len)
        self.batches_yielded = self._resume_skip

    def __iter__(self):
        skip, self._resume_skip = self._resume_skip, 0
        self.batches_yielded = skip
        batch: list[Any] = []
        emitted = 0
        to_skip = skip * self.batch_size  # indices, not materialized samples
        for i in self.sampler:
            if to_skip > 0:
                to_skip -= 1
                continue
            batch.append(self.dataset[i])
            if len(batch) == self.batch_size:
                # count BEFORE yielding: a batch handed to the caller is
                # consumed (the engine trains on it before any checkpoint)
                emitted += 1
                self.batches_yielded = skip + emitted
                yield self.collate_fn(batch)
                batch = []
        if batch and skip + emitted < self._len:
            self.batches_yielded = skip + emitted + 1
            yield self.collate_fn(batch)


def _default_collate(samples: list):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[j]) for s in samples]) for j in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])
