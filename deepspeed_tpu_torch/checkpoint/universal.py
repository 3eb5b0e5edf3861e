"""Offline checkpoint reshaping, the universal-checkpoint tool set (a copy
of ``deepspeed_tpu/checkpoint/universal.py``: the two packages share the
on-disk format 3, so a reshape here writes the manifest and the files the
JAX tool writes).

A format-3 checkpoint is topology-free by construction: the manifest
records each leaf's *global* shape and per-file index bounds, and a load
assembles each leaf whole. What remains useful offline:

- ``inspect_checkpoint``  — per-leaf shapes/dtypes/file layout summary.
- ``reshape_checkpoint``  — rewrite the shard FILES for a target file count
  (balanced shard files per leaf, so each reader of a many-host load reads
  one file per leaf).
- ``merge_checkpoint``    — special case: one full file per leaf.

Reshaped output is a first-class checkpoint: the new manifest is format 3
with per-file crc32 digests recomputed over the rewritten (and copied)
files, so ``saver.verify_checkpoint`` and a digest-verified
``engine.load_checkpoint`` pass on it as on a live save.

All pure numpy over the manifest.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from .digest import file_crc32
from .zero_to_fp32 import MANIFEST, _read_full_leaf


def _load_manifest(ckpt_dir: str) -> dict:
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        return json.load(f)


def inspect_checkpoint(ckpt_dir: str) -> dict:
    m = _load_manifest(ckpt_dir)
    info = {"leaves": {}, "client_state": m.get("client_state", {})}
    n_files = 0
    total = 0
    for key, e in m["leaves"].items():
        files = 1 if "file" in e else len(e["shards"])
        n_files += files
        size = int(np.prod(e["shape"])) if e["shape"] else 1
        total += size
        info["leaves"][key] = {
            "shape": e["shape"], "dtype": e["dtype"], "files": files,
        }
    info["total_params"] = total
    info["total_files"] = n_files
    return info


def reshape_checkpoint(src_dir: str, dst_dir: str, num_files: int,
                       keys: Optional[list[str]] = None) -> dict:
    """Rewrite every (selected) leaf into ``num_files`` balanced shard files
    split along its largest divisible dim; leaves with no such dim are saved
    whole. Returns the new manifest."""
    os.makedirs(dst_dir, exist_ok=True)
    m = _load_manifest(src_dir)
    # the output is a fresh format-3 checkpoint: every file it references
    # gets a freshly computed digest below (stale src checksums — which
    # cover files this reshape REWRITES — must never be carried over)
    new_manifest = {"leaves": {}, "client_state": m.get("client_state", {}),
                    "format": 3, "checksums": {}}
    def _digest(fname: str) -> None:
        new_manifest["checksums"][fname] = file_crc32(
            os.path.join(dst_dir, fname))

    for key, entry in m["leaves"].items():
        if keys is not None and key not in keys:
            # unselected leaves keep their layout, but their files must come
            # along or the destination checkpoint dangles
            for fname in ([entry["file"]] if "file" in entry
                          else [s["file"] for s in entry["shards"]]):
                shutil.copyfile(os.path.join(src_dir, fname),
                                os.path.join(dst_dir, fname))
                _digest(fname)
            new_manifest["leaves"][key] = entry
            continue
        arr = _read_full_leaf(src_dir, entry)
        fkey = key.replace("/", "_")
        new_entry = {"dtype": entry["dtype"], "shape": entry["shape"]}
        axis = _split_axis(arr.shape, num_files)
        if num_files <= 1 or axis is None:
            fname = f"{fkey}.full.npy"
            np.save(os.path.join(dst_dir, fname[:-4]), arr)
            new_entry["file"] = fname
            _digest(fname)
        else:
            step = arr.shape[axis] // num_files
            shards = []
            for n in range(num_files):
                sel = [slice(None)] * arr.ndim
                sel[axis] = slice(n * step, (n + 1) * step)
                fname = f"{fkey}.shard{n:03d}.npy"
                np.save(os.path.join(dst_dir, fname[:-4]), arr[tuple(sel)])
                index = [[0, d] for d in arr.shape]
                index[axis] = [n * step, (n + 1) * step]
                shards.append({"file": fname, "index": index})
                _digest(fname)
            new_entry["shards"] = shards
        new_manifest["leaves"][key] = new_entry
    with open(os.path.join(dst_dir, MANIFEST), "w") as f:
        json.dump(new_manifest, f, indent=1)
    return new_manifest


def merge_checkpoint(src_dir: str, dst_dir: str) -> dict:
    """One full file per leaf (the 'gather everything' reshape)."""
    return reshape_checkpoint(src_dir, dst_dir, num_files=1)


def _split_axis(shape: tuple, num_files: int) -> Optional[int]:
    candidates = [(d, i) for i, d in enumerate(shape) if d % num_files == 0 and d >= num_files]
    if not candidates:
        return None
    return max(candidates)[1]
