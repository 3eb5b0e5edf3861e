"""Atomic, checksummed checkpoint save/load: the port of
``deepspeed_tpu/checkpoint/saver.py``, with the same on-disk format, so a
checkpoint moves between the two packages both ways.

Layout (format 3):

  <ckpt_dir>/
    manifest.json            — leaf index: shape/dtype + file name or shard
                               table, per-file crc32 digests, client state
                               (the commit record)
    <leafkey>.full.npy       — one file per whole (replicated) leaf
    <leafkey>.shard000.npy   — a sharded leaf's distinct shards, with each
                               one's index (its bounds in the whole leaf)

A data-parallel save (``layouts``: the ZeRO runtime's ``LeafLayout`` of each
sharded leaf) is the JAX multi-process save: every rank writes the shards it
is the first holder of, rank 0 the whole leaves, into one staging directory;
each rank's crc32s go into the staging directory beside its files; after a
meeting point rank 0 writes the manifest and renames the directory into place
(``_commit_stage``), and a second one holds every rank until the
checkpoint is committed. An async save does the same at its ``wait()``,
after its own writer thread, on the caller's thread. Each meeting point (the
staging directory's, the writes', the commit's) is an agreement over the
world of every rank's outcome (``_agree``), not a plain barrier: a rank whose
part failed still meets the others, and then every rank raises, so a retried
save retries on every rank together and a permanent failure raises
everywhere without a hang.

Leaf keys are the state tree's dict keys joined with ``::``
(``params::layers::wq``, ``opt::m::wte``, ``step``), as JAX's tree paths.

Atomicity and integrity, as in the JAX package:
  * a save stages into ``<ckpt_dir>.tmp``: every file is fsync'd, the
    manifest is written last, the staging directory is fsync'd, and only
    then is it renamed into place. A crash at any point leaves either the
    previous checkpoint intact or a ``.tmp`` directory that loading ignores
    and the next save reclaims;
  * every array file's crc32 lands in the manifest; ``verify_checkpoint``
    (run by default on load) re-digests the files and raises
    ``CheckpointCorruptError`` on a mismatch or a missing file, before any
    state is touched;
  * a missing directory or manifest raises ``CheckpointNotFoundError``.

Loading assembles each leaf whole from its ``.full.npy`` or from the
``.shardNNN.npy`` files of a sharded save (``_read_leaf``), so a checkpoint
the JAX engine wrote on its 8-device CPU mesh loads here; a leaf the loading
rank holds a shard of reads only that slice (``_read_slice``), whatever the
layout the checkpoint was saved in.

``async_save=True`` returns a ``SaveHandle`` after taking the snapshot:
each CUDA leaf is copied into a pinned host buffer (``HostStaging``, one per
engine) on a side stream that first waits for the work that produced the
state, and the source tensors are recorded on that stream, so their memory
is not reused before the copy ends; CPU leaves are copied at once. The
snapshot is therefore fixed when ``save_checkpoint`` returns. A writer
thread waits for the copy, then writes the files; ``SaveHandle.wait()``
joins it and, on the caller's thread, writes the manifest, renames the
staging directory into place and repoints 'latest'. A write error in the
thread is re-raised by ``wait()``.

Fault injection: every file write is guarded by
``resilience.faults.maybe_io_error``, so an installed injector can fail the
Nth write to prove the atomicity story.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from .. import comm
from ..resilience.errors import (CheckpointCorruptError, CheckpointNotFoundError, CheckpointPeerError,
                                 CheckpointPeerPermanentError, PermanentIOError)
from ..resilience.faults import maybe_io_error
from .digest import file_crc32

_SEP = "::"
_MANIFEST = "manifest.json"
_STAGE_SUFFIX = ".tmp"


def _flatten_with_paths(tree, prefix: tuple = ()) -> dict[str, Any]:
    """Leaves of nested dicts/lists keyed by their ``::``-joined path, in
    JAX's tree order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_with_paths(v, prefix + (i,)))
        return out
    return {_SEP.join(str(p) for p in prefix): tree}


def _unflatten_like(tree, flat: dict, prefix: tuple = ()):
    """The structure of ``tree`` with each leaf taken from ``flat``."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, flat, prefix + (i,)) for i, v in enumerate(tree))
    return flat[_SEP.join(str(p) for p in prefix)]


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_durable(path: str, data: bytes) -> None:
    """Guarded durable write: fault-injection hook, then write + fsync."""
    maybe_io_error(path)
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class _Crc32Writer:
    """File-object shim that crc32s bytes as they stream through, so the
    digest covers exactly the bytes ``np.save`` wrote."""

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        return self._f.write(b)


def _save_array_durable(path: str, arr: np.ndarray) -> int:
    """Guarded durable ``np.save`` returning the crc32 of the bytes written
    (fault-injection hook, then streamed write + fsync)."""
    maybe_io_error(path)
    with open(path, "wb") as f:
        w = _Crc32Writer(f)
        np.save(w, arr)
        f.flush()
        os.fsync(f.fileno())
    return w.crc


def _to_numpy(leaf) -> np.ndarray:
    """A leaf's host array. A bfloat16 tensor (the memory tiers' compute-dtype
    parameters) is written as its fp32 values, which hold it exactly: numpy
    has no bfloat16, and the JAX loader casts an fp32 file to the manifest's
    ``bfloat16`` where it cannot cast the raw ``<V2`` payload its own saver
    writes."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return leaf.detach().float().cpu().numpy()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    """The manifest's dtype of a leaf, as the JAX package names it."""
    if torch.is_tensor(leaf):
        return str(leaf.dtype).rsplit(".", 1)[-1]
    return str(np.asarray(leaf).dtype)


def _leaf_tensor(arr: np.ndarray, entry: dict) -> torch.Tensor:
    """A read leaf as a tensor of the manifest's dtype: a ``bfloat16`` leaf
    is the JAX saver's raw 2-byte payload (``<V2``) or the port's fp32
    values."""
    if entry["dtype"] != "bfloat16":
        return torch.from_numpy(arr)
    if arr.dtype.itemsize == 2 and arr.dtype.kind == "V":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16)


def write_latest(path: str, tag: str) -> None:
    """Durably (re)point a 'latest' tag file: tmp + fsync + rename +
    directory fsync, so a crash never surfaces a truncated or lost tag."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(tag)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(os.path.dirname(os.path.abspath(path)) or ".")


def _commit_stage(stage_dir: str, ckpt_dir: str, staged: list[str]) -> None:
    """Rename the staged directory into place. Over an existing checkpoint of
    the same tag, the old manifest is unlinked first and the new one moved
    in last: the manifest is the commit record, so every crash window leaves
    either the old checkpoint or no manifest (not found), never a manifest
    whose digests cover a half-replaced file set."""
    if not os.path.exists(ckpt_dir):
        os.rename(stage_dir, ckpt_dir)
    else:
        old_manifest = os.path.join(ckpt_dir, _MANIFEST)
        if os.path.exists(old_manifest):
            os.unlink(old_manifest)
            _fsync_path(ckpt_dir)
        for name in staged:
            os.replace(os.path.join(stage_dir, name), os.path.join(ckpt_dir, name))
        _fsync_path(ckpt_dir)  # the data renames are durable before the manifest's
        os.replace(os.path.join(stage_dir, _MANIFEST), os.path.join(ckpt_dir, _MANIFEST))
        _fsync_path(ckpt_dir)
        os.rmdir(stage_dir)
        for name in os.listdir(ckpt_dir):  # .npy files the previous save wrote and this one did not
            if name.endswith(".npy") and name not in staged:
                os.unlink(os.path.join(ckpt_dir, name))
    _fsync_path(os.path.dirname(os.path.abspath(ckpt_dir)) or ".")


def _failure_code(err: Optional[BaseException]) -> int:
    """A rank's part in a save's agreement: 0 ok, 1 a transient ``OSError``,
    2 a ``PermanentIOError`` or any other error (not retried)."""
    if err is None:
        return 0
    return 2 if isinstance(err, PermanentIOError) or not isinstance(err, OSError) else 1


def _agree(err: Optional[BaseException], what: str) -> None:
    """One of a multi-rank save's meeting points: every rank's failure code
    is agreed over the world (``comm.world_codes``) before any rank goes
    on, so a rank whose work failed still meets the others. On a failure
    anywhere every rank raises: a failing rank its own error, the others a
    ``CheckpointPeerError`` naming the failing ranks, of the permanent kind
    when any rank's failure was permanent."""
    codes = comm.world_codes(_failure_code(err))
    if err is not None:
        raise err
    bad = [r for r, c in enumerate(codes) if c]
    if bad:
        kind = CheckpointPeerPermanentError if max(codes) == 2 else CheckpointPeerError
        raise kind(f"checkpoint save: {what} failed on rank(s) {bad}", ranks=bad)


def _meet(world: int, what: str, fn) -> None:
    """Run ``fn`` (this rank's work before a meeting point, or None), then
    meet: in a world above 1 through ``_agree``, which raises on every rank
    when ``fn`` failed on any; in a world of 1 ``fn``'s error propagates."""
    if world == 1:
        if fn is not None:
            fn()
        return
    err = None
    try:
        if fn is not None:
            fn()
    # dstpu: allow[broad-except] -- the error is not swallowed: _agree re-raises it on this rank after the world's agreement, which every rank must reach or the others would wait on a rank that raised
    except Exception as e:
        err = e
    _agree(err, what)


class SaveHandle:
    """Handle of a save. ``wait()`` joins the writer thread (if any), then
    finishes the save on the calling thread: the writes' outcome (agreed
    over the world in a multi-rank save, where a writer's error raises on
    every rank), the manifest, the rename into place and 'latest'."""

    def __init__(self, thread: Optional[threading.Thread] = None, error: Optional[list] = None,
                 finalize=None):
        self._thread = thread
        self._error = error if error is not None else []
        self._finalize = finalize

    def wait(self) -> bool:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._finalize is not None:
            fin, self._finalize = self._finalize, None
            fin()
        elif self._error:
            raise self._error[0]
        return True


class HostStaging:
    """The pinned host buffer an async save snapshots CUDA leaves into,
    grown to the state's size once and reused by every later save, with
    the side stream the copies run on. It serves one save at a time: a new
    snapshot first waits for the previous save's writer thread."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None
        self._stream = None
        self._writer: Optional[threading.Thread] = None

    def snapshot(self, flat: dict) -> tuple[dict, Any]:
        """{key: tensor} -> ({key: host numpy array}, the CUDA event that
        ends the copies, or None). CUDA leaves land in the pinned buffer;
        CPU leaves are cloned."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        cuda = {k: v for k, v in flat.items() if torch.is_tensor(v) and v.is_cuda}
        out = {k: None if k in cuda else _to_numpy(v.clone() if torch.is_tensor(v) else v)
               for k, v in flat.items()}  # in the state's order: the guarded writes count in it
        if not cuda:
            return out, None
        offsets, total = {}, 0
        for k, v in cuda.items():
            offsets[k] = total
            total += -(-v.numel() * v.element_size() // 64) * 64  # 64-byte aligned views
        device = next(iter(cuda.values())).device
        if self._buf is None or self._buf.numel() < total:
            self._buf = None
            self._buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            for k, v in cuda.items():
                n = v.numel() * v.element_size()
                dst = self._buf[offsets[k]:offsets[k] + n].view(v.dtype).view(v.shape)
                dst.copy_(v.detach(), non_blocking=True)
                v.record_stream(self._stream)  # the memory is not reused before the copy ends
                # bfloat16 stays a tensor; the writer converts it (_to_numpy)
                out[k] = dst if v.dtype == torch.bfloat16 else dst.numpy()
        event = torch.cuda.Event()
        event.record(self._stream)
        return out, event

    def bind(self, writer: threading.Thread) -> None:
        self._writer = writer


def save_checkpoint(ckpt_dir: str, state, client_state: Optional[dict] = None,
                    latest: Optional[tuple[str, str]] = None, async_save: bool = False,
                    staging: Optional[HostStaging] = None, layouts: Optional[dict] = None) -> SaveHandle:
    """Write ``state`` (nested dicts of tensors) to ``ckpt_dir`` atomically;
    ``latest=(path, tag)`` writes the tag file after the checkpoint is
    durable. Synchronous saves return a waited handle. ``async_save`` returns once the snapshot is taken (into ``staging``,
    or a buffer of this save's own); the caller's ``wait()`` finishes it.
    ``layouts`` ({leaf key: LeafLayout}) marks the leaves this rank holds a
    part of: a data-, tensor- or pipeline-parallel save (a stage's layers
    are a shard of their ``[S, K, ...]`` leaf), which every rank of the
    world makes. Each distinct shard is listed once, with its bounds on every
    split dimension, in the order of its first holder's rank (a JAX
    multi-device save's table), and written by that first holder."""
    rank, world = comm.get_rank(), comm.get_world_size()
    stage_dir = ckpt_dir + _STAGE_SUFFIX

    def stage():
        if os.path.exists(stage_dir):
            shutil.rmtree(stage_dir)  # a crashed or failed save's leftovers
        os.makedirs(stage_dir)

    # every attempt of a retried save starts here: the staging directory
    # exists, empty, before any rank writes
    _meet(world, "staging", stage if rank == 0 else None)
    manifest = {"leaves": {}, "client_state": client_state or {}, "format": 3, "checksums": {}}
    flat = _flatten_with_paths(state)
    layouts = layouts or {}
    mine = {}  # what this rank writes
    for key, leaf in flat.items():
        lay = layouts.get(key)
        fkey = key.replace("/", "_")
        if lay is not None and lay.partial:
            manifest["leaves"][key] = {"dtype": _dtype_name(leaf), "shape": list(lay.full_shape),
                                       "shards": [{"file": f"{fkey}.shard{j:03d}.npy", "index": b}
                                                  for j, b in enumerate(lay.table)]}
            if lay.writer:
                mine[key] = f"{fkey}.shard{lay.slot:03d}.npy"
        else:
            fname = f"{fkey}.full.npy"
            manifest["leaves"][key] = {"dtype": _dtype_name(leaf), "shape": list(leaf.shape), "file": fname}
            if rank == 0:
                mine[key] = fname
    event = None
    sub = {k: flat[k] for k in mine}
    if async_save:
        staging = staging if staging is not None else HostStaging()
        arrays, event = staging.snapshot(sub)
    else:
        arrays = {key: _to_numpy(leaf) for key, leaf in sub.items()}
    to_write = [(mine[key], arr) for key, arr in arrays.items()]
    crc_file = os.path.join(stage_dir, f"crc.rank{rank}.json")

    def write_files(errors):
        try:
            if event is not None:
                event.synchronize()
            crcs = {}
            for fname, arr in to_write:
                crcs[fname] = _save_array_durable(os.path.join(stage_dir, fname), _to_numpy(arr))
            manifest["checksums"].update(crcs)
            if world > 1:
                _write_durable(crc_file, json.dumps(crcs).encode())
        # dstpu: allow[broad-except] -- the async writer runs on its own thread: every failure kind (OSError, np.save's ValueError, MemoryError) is captured and re-raised by SaveHandle.wait(); a narrower clause would let one vanish with the thread and read as a saved checkpoint
        except Exception as e:
            errors.append(e)

    def commit():
        if world > 1:
            for r in range(world):
                path = os.path.join(stage_dir, f"crc.rank{r}.json")
                with open(path) as f:
                    manifest["checksums"].update(json.load(f))
                os.unlink(path)
        tmp = os.path.join(stage_dir, _MANIFEST + ".tmp")
        _write_durable(tmp, json.dumps(manifest, indent=1).encode())
        os.replace(tmp, os.path.join(stage_dir, _MANIFEST))
        _fsync_path(stage_dir)
        _commit_stage(stage_dir, ckpt_dir, sorted(manifest["checksums"]))
        if latest is not None:
            write_latest(*latest)

    def finalize():
        def written():
            if errors:
                raise errors[0]

        # every rank's files (and crc32s) are durable, or every rank raises
        _meet(world, "the shard writes", written)
        # rank 0's manifest and commit; no rank reads or re-saves before it
        _meet(world, "rank 0's manifest and commit", commit if rank == 0 else None)

    errors: list = []
    if async_save:
        t = threading.Thread(target=write_files, args=(errors,), daemon=True, name="dstt-ckpt-writer")
        t.start()
        staging.bind(t)
        return SaveHandle(t, errors, finalize=finalize)
    write_files(errors)
    h = SaveHandle(None, errors, finalize=finalize)
    h.wait()
    return h


def _read_leaf(ckpt_dir: str, entry: dict) -> np.ndarray:
    """One leaf, whole and in a fresh array: its ``.full.npy``, or its
    shards (a JAX save on a device mesh) put together. Shards that do not
    cover the leaf raise ``CheckpointCorruptError``."""
    if "file" in entry:
        return np.array(np.load(os.path.join(ckpt_dir, entry["file"]), mmap_mode="r"))
    out = np.empty(entry["shape"], dtype=np.dtype("V2" if entry["dtype"] == "bfloat16" else entry["dtype"]))
    covered = 0
    for sh in entry["shards"]:
        sel = tuple(slice(lo, hi) for lo, hi in sh["index"])
        out[sel] = np.load(os.path.join(ckpt_dir, sh["file"]), mmap_mode="r")
        covered += int(np.prod([hi - lo for lo, hi in sh["index"]]))
    if covered != out.size:  # the JAX table lists distinct, non-overlapping shards
        raise CheckpointCorruptError(f"checkpoint {ckpt_dir}: the shards cover {covered} of {out.size} elements "
                                     f"of a leaf", path=ckpt_dir)
    return out


def _read_slice(ckpt_dir: str, entry: dict, bounds: list) -> np.ndarray:
    """The part ``bounds`` ([[lo, hi], ...]) of a leaf, read from its
    ``.full.npy`` (memory-mapped) or from the shards that overlap it."""
    sel = tuple(slice(lo, hi) for lo, hi in bounds)
    if "file" in entry:
        return np.array(np.load(os.path.join(ckpt_dir, entry["file"]), mmap_mode="r")[sel])
    out = np.empty([hi - lo for lo, hi in bounds],
                   dtype=np.dtype("V2" if entry["dtype"] == "bfloat16" else entry["dtype"]))
    covered = 0
    for sh in entry["shards"]:
        lo = [max(a, s0) for (a, _), (s0, _) in zip(bounds, sh["index"])]
        hi = [min(b, s1) for (_, b), (_, s1) in zip(bounds, sh["index"])]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        src = np.load(os.path.join(ckpt_dir, sh["file"]), mmap_mode="r")
        out[tuple(slice(l - b0, h - b0) for l, h, (b0, _) in zip(lo, hi, bounds))] = \
            src[tuple(slice(l - s0, h - s0) for l, h, (s0, _) in zip(lo, hi, sh["index"]))]
        covered += int(np.prod([h - l for l, h in zip(lo, hi)]))
    if covered != out.size:
        raise CheckpointCorruptError(f"checkpoint {ckpt_dir}: the shards cover {covered} of {out.size} elements "
                                     f"of a leaf's slice {bounds}", path=ckpt_dir)
    return out


def read_manifest(ckpt_dir: str) -> dict:
    """Parse a checkpoint's manifest: missing directory or manifest →
    ``CheckpointNotFoundError``; unparseable manifest → ``CheckpointCorruptError``."""
    path = os.path.join(ckpt_dir, _MANIFEST)
    if not os.path.isdir(ckpt_dir):
        raise CheckpointNotFoundError(f"no checkpoint directory at {ckpt_dir}", path=ckpt_dir)
    if not os.path.exists(path):
        raise CheckpointNotFoundError(f"checkpoint at {ckpt_dir} has no {_MANIFEST} (save never committed)",
                                      path=path)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"unreadable checkpoint manifest {path}: {e}", path=path) from e


def _manifest_files(manifest: dict) -> list[str]:
    files = []
    for entry in manifest.get("leaves", {}).values():
        if "file" in entry:
            files.append(entry["file"])
        else:
            files.extend(sh["file"] for sh in entry.get("shards", []))
    return files


def verify_checkpoint(ckpt_dir: str, manifest: Optional[dict] = None, digests: bool = True) -> dict:
    """Every manifest-referenced file exists and (with ``digests``, where the
    manifest records one) matches its crc32; raises
    ``CheckpointCorruptError`` on the first violation, returns the manifest."""
    if manifest is None:
        manifest = read_manifest(ckpt_dir)
    crcs = manifest.get("checksums", {}) if digests else {}
    for fname in _manifest_files(manifest):
        path = os.path.join(ckpt_dir, fname)
        if not os.path.exists(path):
            raise CheckpointCorruptError(f"checkpoint {ckpt_dir} is torn: missing {fname}", path=path)
        want = crcs.get(fname)
        if want is not None:
            got = file_crc32(path)
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint {ckpt_dir} is corrupt: {fname} crc32 {got:#010x} != recorded {want:#010x}",
                    path=path)
    return manifest


def find_checkpoints(root: str) -> list[str]:
    """Tags under ``root`` that carry a manifest, newest first: by the
    manifest's recorded ``global_steps``, manifest mtime as tiebreak. A tag
    whose manifest is unreadable sorts last; staging leftovers are never
    listed."""
    if not os.path.isdir(root):
        return []
    tags = []
    for name in os.listdir(root):
        if name.endswith(_STAGE_SUFFIX):
            continue
        mpath = os.path.join(root, name, _MANIFEST)
        if not os.path.isfile(mpath):
            continue
        try:
            with open(mpath) as f:
                steps = int(json.load(f).get("client_state", {}).get("global_steps", -1))
        except (OSError, ValueError, TypeError):
            steps = -2
        tags.append((steps, os.path.getmtime(mpath), name))
    return [name for _, _, name in sorted(tags, reverse=True)]


def load_checkpoint(ckpt_dir: str, state_like, verify: bool = True, layouts: Optional[dict] = None):
    """Restore into the structure of ``state_like`` -> (state, client_state).
    Each saved leaf comes back whole, in its saved dtype, on the device of
    the leaf it replaces, or, for a leaf ``layouts`` marks as sharded, this
    rank's shard of it; leaves the checkpoint lacks keep their current
    value. ``verify`` digests every file first, so a torn checkpoint raises
    ``CheckpointCorruptError`` before any state is touched."""
    manifest = read_manifest(ckpt_dir)
    if verify:
        verify_checkpoint(ckpt_dir, manifest=manifest)
    layouts = layouts or {}
    restored = {}
    for key, leaf in _flatten_with_paths(state_like).items():
        entry = manifest["leaves"].get(key)
        if entry is None:
            restored[key] = leaf
            continue
        lay = layouts.get(key)
        if lay is not None and lay.partial:
            if list(entry["shape"]) != list(lay.full_shape):
                raise CheckpointCorruptError(f"checkpoint {ckpt_dir}: leaf {key} has shape {entry['shape']}, the "
                                             f"engine's is {list(lay.full_shape)}", path=ckpt_dir)
            arr = _leaf_tensor(_read_slice(ckpt_dir, entry, lay.bounds()), entry)
        else:
            arr = _leaf_tensor(_read_leaf(ckpt_dir, entry), entry)  # a fresh C-ordered array, 0-d kept 0-d
        restored[key] = arr.to(leaf.device) if torch.is_tensor(leaf) else arr
    return _unflatten_like(state_like, restored), manifest.get("client_state", {})


def consolidate_checkpoint(ckpt_dir: str) -> dict[str, np.ndarray]:
    """Offline: every leaf as a full host array, keyed by its path."""
    manifest = read_manifest(ckpt_dir)
    return {key: _read_leaf(ckpt_dir, entry) for key, entry in manifest["leaves"].items()}
