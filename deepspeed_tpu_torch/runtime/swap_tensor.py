"""NVMe tensor swapping, the ZeRO-Infinity tier's file layer, ported from
``deepspeed_tpu/runtime/swap_tensor.py`` (reference:
runtime/swap_tensor/partitioned_param_swapper.py:35 +
pipelined_optimizer_swapper.py) over the native async-I/O engine
(``csrc/aio/dstpu_aio.cpp`` through ``ops/aio.py``).

The swapper moves trees of HOST tensors (the NVMe optimizer's groups) to
disk and back. The file layout is the JAX package's: one file
``swap<sid:06d>.bin`` per ``swap_out``, the leaves in JAX's tree order (dict
keys sorted) back to back, and a manifest of ``{offset, nbytes, dtype,
shape}`` entries. Large leaves go to the engine in pieces of at most
``PIECE_BYTES`` so its threads share one leaf.

Usage:
    swapper = TensorSwapper(path, n_threads=4)
    manifest = swapper.swap_out(tree, async_op=True)   # returns at once
    ...
    swapper.synchronize()                              # writes durable
    tree2 = swapper.swap_in(manifest)                  # blocking read
    swapper.swap_in(manifest, out=buffers)             # into given tensors

With ``async_op`` the leaves are written from the caller's own tensors (no
copy is made): they must not change, and must stay alive, until
``synchronize()`` returns; the swapper keeps a reference to each until then.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..ops.aio import AsyncIOHandle

PyTree = Any

PIECE_BYTES = 64 << 20  # the largest single read or write handed to the aio engine

# dtype names as numpy (and the JAX manifest) spell them
_DTYPES = {torch.float32: "float32", torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.float64: "float64", torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
           torch.uint8: "uint8", torch.int16: "int16", torch.bool: "bool"}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPES[dtype]


def torch_dtype(name: str) -> torch.dtype:
    return _BY_NAME[name]


def flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs of nested dicts in JAX's tree order (keys sorted)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def unflatten(pairs) -> PyTree:
    """Nested dicts from (path, leaf) pairs; the empty path is a bare leaf."""
    pairs = list(pairs)
    if len(pairs) == 1 and pairs[0][0] == ():
        return pairs[0][1]
    out: dict = {}
    for path, leaf in pairs:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def _as_tensor(leaf) -> torch.Tensor:
    t = leaf if torch.is_tensor(leaf) else torch.from_numpy(np.asarray(leaf, order="C"))  # 0-d stays 0-d
    if t.device.type != "cpu":
        raise ValueError(f"the swapper moves host tensors; got one on {t.device}")
    return t.detach().contiguous()


class TensorSwapper:
    def __init__(self, swap_dir: str, n_threads: int = 4, use_odirect: bool = False):
        # Each instance swaps into its own subdirectory run-<pid>-<rand>: two
        # swappers on one nvme_path never read each other's files. At init,
        # subdirectories whose pid is gone (a crashed run) are reclaimed.
        os.makedirs(swap_dir, exist_ok=True)
        self._reclaim_stale(swap_dir)
        self.swap_dir = os.path.join(swap_dir, f"run-{os.getpid()}-{os.urandom(4).hex()}")
        os.makedirs(self.swap_dir, exist_ok=True)
        self.handle = AsyncIOHandle(n_threads=n_threads, use_odirect=use_odirect)
        self._seq = 0
        self._inflight: list[int] = []
        self._held: dict[int, list[torch.Tensor]] = {}  # sid -> tensors its writes read
        self._dirty_paths: set[str] = set()
        self._lock = threading.Lock()

    @staticmethod
    def _reclaim_stale(swap_dir: str) -> None:
        """Remove run-<pid>-<rand> subdirectories whose pid is gone; a live
        pid's (another process sharing the directory) is left alone."""
        for name in os.listdir(swap_dir):
            m = re.fullmatch(r"run-(\d+)-[0-9a-f]+", name)
            if not m:
                continue
            try:
                os.kill(int(m.group(1)), 0)
                continue  # alive
            except ProcessLookupError:
                pass
            except PermissionError:
                continue  # alive under another uid
            shutil.rmtree(os.path.join(swap_dir, name), ignore_errors=True)

    @property
    def bytes_read(self) -> int:
        return self.handle.bytes_read

    @property
    def bytes_written(self) -> int:
        return self.handle.bytes_written

    def _pieces(self, t: torch.Tensor, offset: int):
        """(byte view, file offset) pieces of one leaf of at most
        ``PIECE_BYTES``."""
        raw = t.reshape(-1).view(torch.uint8) if t.numel() else t.reshape(-1)
        for lo in range(0, raw.numel(), PIECE_BYTES):
            yield raw[lo:lo + PIECE_BYTES], offset + lo

    # ------------------------------------------------------------------
    def swap_out(self, tree: PyTree, async_op: bool = False) -> dict:
        """Write every leaf into one new file; returns its manifest."""
        with self._lock:
            sid = self._seq
            self._seq += 1
        pairs = [(p, _as_tensor(leaf)) for p, leaf in flatten(tree)]
        path = os.path.join(self.swap_dir, f"swap{sid:06d}.bin")
        entries, tickets, offset = [], [], 0
        for _, t in pairs:
            nbytes = t.numel() * t.element_size()
            entries.append({"offset": offset, "nbytes": nbytes, "dtype": dtype_name(t.dtype),
                            "shape": list(t.shape)})
            for piece, off in self._pieces(t, offset):
                if async_op:
                    tickets.append(self.handle.async_pwrite(path, piece, off))
                else:
                    self.handle.pwrite(path, piece, off)
            offset += nbytes
        written = offset > 0
        if async_op:
            with self._lock:
                self._inflight.extend(tickets)
                self._held[sid] = [t for _, t in pairs]
                if written:
                    self._dirty_paths.add(path)
        elif written:
            self.handle.fsync(path)
        return {"path": path, "entries": entries, "paths": [p for p, _ in pairs], "sid": sid}

    def synchronize(self) -> None:
        """Drain every write in flight and fsync its file: the durability
        barrier. State is cleared only for work that completed, so after an
        error a retry (or ``close``) still drains what is left."""
        with self._lock:
            tickets = list(self._inflight)
            held = list(self._held)
            dirty = set(self._dirty_paths)
        errors: list[OSError] = []
        for t in tickets:
            try:
                self.handle.wait(t)
            except OSError as e:
                errors.append(e)
        synced = set()
        for p in dirty:
            try:
                self.handle.fsync(p)
                synced.add(p)
            except OSError as e:
                errors.append(e)
        with self._lock:
            done = set(tickets)
            self._inflight = [t for t in self._inflight if t not in done]
            self._dirty_paths -= synced
            if not self._inflight:
                for sid in held:
                    self._held.pop(sid, None)
        if errors:
            raise OSError(f"swap synchronize: {len(errors)} failure(s): {errors[0]}")

    def swap_in_async(self, manifest: dict, out: PyTree) -> list[int]:
        """Submit reads of every leaf of ``manifest`` into the tensors of
        ``out`` (the same tree, contiguous CPU tensors of the entries' dtypes
        and shapes); returns the tickets to ``wait_reads``."""
        bufs = [t for _, t in flatten(out)]
        if len(bufs) != len(manifest["entries"]):
            raise ValueError(f"swap_in: {len(bufs)} buffers for {len(manifest['entries'])} entries")
        tickets = []
        for e, buf in zip(manifest["entries"], bufs):
            if (dtype_name(buf.dtype) != e["dtype"] or list(buf.shape) != list(e["shape"])
                    or not buf.is_contiguous() or buf.device.type != "cpu"):
                raise ValueError(f"swap_in: a buffer of {buf.dtype} {tuple(buf.shape)} for entry {e}")
            for piece, off in self._pieces(buf, e["offset"]):
                tickets.append(self.handle.async_pread(manifest["path"], piece, off))
        return tickets

    def wait_reads(self, tickets: list[int]) -> None:
        errors = []
        for t in tickets:
            try:
                self.handle.wait(t)
            except OSError as e:
                errors.append(e)
        if errors:
            raise OSError(f"swap_in: {len(errors)} read(s) failed: {errors[0]}")

    def swap_in(self, manifest: dict, out: Optional[PyTree] = None) -> PyTree:
        """Read a manifest's leaves back: into ``out`` when given (returned),
        else into new CPU tensors in the saved tree's structure."""
        if out is None:
            leaves = [torch.empty(tuple(e["shape"]), dtype=torch_dtype(e["dtype"])) for e in manifest["entries"]]
            out = unflatten(zip(manifest["paths"], leaves))
        self.wait_reads(self.swap_in_async(manifest, out))
        return out

    def release(self, manifest: dict) -> None:
        try:
            os.remove(manifest["path"])
        except FileNotFoundError:
            pass

    def close(self) -> None:
        """Make every write durable, then join the engine's threads."""
        try:
            self.synchronize()
        finally:
            self.handle.close()
