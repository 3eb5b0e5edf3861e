"""Atomic, checksummed checkpoint save/load for one process: the port of the
single-process half of ``deepspeed_tpu/checkpoint/saver.py``, with the same
on-disk format, so a checkpoint moves between the two packages both ways.

Layout (format 3):

  <ckpt_dir>/
    manifest.json            — leaf index: shape/dtype + file name, per-file
                               crc32 digests, client state (the commit record)
    <leafkey>.full.npy       — one file per leaf (the port's leaves are whole)
    <leafkey>.shard000.npy   — a sharded leaf's distinct shards, as the JAX
                               engine writes them on a device mesh (read only)

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
the JAX engine wrote on its 8-device CPU mesh loads here.

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

from ..resilience.errors import CheckpointCorruptError, CheckpointNotFoundError
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
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; the engine state is fp32/int32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


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


class SaveHandle:
    """Handle of a save. ``wait()`` joins the writer thread (if any),
    re-raises its error, then finishes the save on the calling thread: the
    manifest, the rename into place and 'latest'."""

    def __init__(self, thread: Optional[threading.Thread] = None, error: Optional[list] = None,
                 finalize=None):
        self._thread = thread
        self._error = error if error is not None else []
        self._finalize = finalize

    def wait(self) -> bool:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error[0]
        if self._finalize is not None:
            fin, self._finalize = self._finalize, None
            fin()
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
            if v.dtype == torch.bfloat16:
                raise TypeError("bfloat16 leaves have no numpy dtype; the engine state is fp32/int32")
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
                out[k] = dst.numpy()
        event = torch.cuda.Event()
        event.record(self._stream)
        return out, event

    def bind(self, writer: threading.Thread) -> None:
        self._writer = writer


def save_checkpoint(ckpt_dir: str, state, client_state: Optional[dict] = None,
                    latest: Optional[tuple[str, str]] = None, async_save: bool = False,
                    staging: Optional[HostStaging] = None) -> SaveHandle:
    """Write ``state`` (nested dicts of tensors) to ``ckpt_dir`` atomically;
    ``latest=(path, tag)`` writes the tag file after the checkpoint is
    durable. Synchronous saves return a waited handle. ``async_save`` returns once the snapshot is taken (into ``staging``,
    or a buffer of this save's own); the caller's ``wait()`` finishes it."""
    stage_dir = ckpt_dir + _STAGE_SUFFIX
    if os.path.exists(stage_dir):
        shutil.rmtree(stage_dir)  # a crashed save's leftovers
    os.makedirs(stage_dir)
    manifest = {"leaves": {}, "client_state": client_state or {}, "format": 3, "checksums": {}}
    flat = _flatten_with_paths(state)
    event = None
    if async_save:
        staging = staging if staging is not None else HostStaging()
        arrays, event = staging.snapshot(flat)
    else:
        arrays = {key: _to_numpy(leaf) for key, leaf in flat.items()}
    to_write = []
    for key, arr in arrays.items():
        fname = f"{key.replace('/', '_')}.full.npy"
        manifest["leaves"][key] = {"dtype": str(arr.dtype), "shape": list(arr.shape), "file": fname}
        to_write.append((fname, arr))

    def write_files(errors):
        try:
            if event is not None:
                event.synchronize()
            for fname, arr in to_write:
                manifest["checksums"][fname] = _save_array_durable(os.path.join(stage_dir, fname), arr)
        # dstpu: allow[broad-except] -- the async writer runs on its own thread: every failure kind (OSError, np.save's ValueError, MemoryError) is captured and re-raised by SaveHandle.wait(); a narrower clause would let one vanish with the thread and read as a saved checkpoint
        except Exception as e:
            errors.append(e)

    def finalize():
        tmp = os.path.join(stage_dir, _MANIFEST + ".tmp")
        _write_durable(tmp, json.dumps(manifest, indent=1).encode())
        os.replace(tmp, os.path.join(stage_dir, _MANIFEST))
        _fsync_path(stage_dir)
        _commit_stage(stage_dir, ckpt_dir, sorted(manifest["checksums"]))
        if latest is not None:
            write_latest(*latest)

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
    out = np.empty(entry["shape"], dtype=np.dtype(entry["dtype"]))
    covered = 0
    for sh in entry["shards"]:
        sel = tuple(slice(lo, hi) for lo, hi in sh["index"])
        out[sel] = np.load(os.path.join(ckpt_dir, sh["file"]), mmap_mode="r")
        covered += int(np.prod([hi - lo for lo, hi in sh["index"]]))
    if covered != out.size:  # the JAX table lists distinct, non-overlapping shards
        raise CheckpointCorruptError(f"checkpoint {ckpt_dir}: the shards cover {covered} of {out.size} elements "
                                     f"of a leaf", path=ckpt_dir)
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


def load_checkpoint(ckpt_dir: str, state_like, verify: bool = True):
    """Restore into the structure of ``state_like`` -> (state, client_state).
    Each saved leaf comes back whole, in its saved dtype, on the device of
    the leaf it replaces; leaves the checkpoint lacks keep their current
    value. ``verify`` digests every file first, so a torn checkpoint raises
    ``CheckpointCorruptError`` before any state is touched."""
    manifest = read_manifest(ckpt_dir)
    if verify:
        verify_checkpoint(ckpt_dir, manifest=manifest)
    restored = {}
    for key, leaf in _flatten_with_paths(state_like).items():
        entry = manifest["leaves"].get(key)
        if entry is None:
            restored[key] = leaf
            continue
        arr = torch.from_numpy(_read_leaf(ckpt_dir, entry))  # a fresh C-ordered array, 0-d kept 0-d
        restored[key] = arr.to(leaf.device) if torch.is_tensor(leaf) else arr
    return _unflatten_like(state_like, restored), manifest.get("client_state", {})


def consolidate_checkpoint(ckpt_dir: str) -> dict[str, np.ndarray]:
    """Offline: every leaf as a full host array, keyed by its path."""
    manifest = read_manifest(ckpt_dir)
    return {key: _read_leaf(ckpt_dir, entry) for key, entry in manifest["leaves"].items()}
