#!/usr/bin/env python3
"""Recover a full fp32 state dict from a sharded deepspeed_tpu checkpoint.

Reference: ``utils/zero_to_fp32.py`` (:153-425) — the standalone script
DeepSpeed copies into every checkpoint directory (runtime/engine.py:3172) so
weights can be extracted later with no training stack, no distributed setup,
and no GPUs. Same contract here: this file is self-contained over numpy +
the checkpoint's JSON manifest (saver.py format 2) — jax is NOT required.

    python zero_to_fp32.py <checkpoint_dir> <output_file>

writes an ``.npz`` holding every parameter as fp32, keyed by its pytree path
(``params/layers/wq`` …). ``--torch`` additionally writes a ``.pt`` state
dict (requires torch) for loading into framework-agnostic tooling.

The PyTorch port keeps this copy: its checkpoints have the same format, and
``DeepSpeedEngine.save_checkpoint`` drops it beside them as the JAX engine does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

MANIFEST = "manifest.json"


def _read_full_leaf(ckpt_dir: str, entry: dict) -> np.ndarray:
    """Assemble one leaf from its replicated file or shard files. Shard
    coverage is verified — a gap would otherwise surface as uninitialized
    memory in the recovered weights."""
    shape = tuple(entry["shape"])
    dtype = np.dtype(entry["dtype"])
    if "file" in entry:
        return np.asarray(np.load(os.path.join(ckpt_dir, entry["file"]), mmap_mode="r"))
    out = np.empty(shape, dtype=dtype)
    filled = np.zeros(shape, dtype=bool)
    for sh in entry["shards"]:
        sel = tuple(slice(b[0], b[1]) for b in sh["index"])
        out[sel] = np.load(os.path.join(ckpt_dir, sh["file"]), mmap_mode="r")
        filled[sel] = True
    if not filled.all():
        missing = int(filled.size - filled.sum())
        raise ValueError(
            f"checkpoint shards cover only {filled.sum()}/{filled.size} elements "
            f"({missing} missing) for a leaf of shape {shape} — corrupt manifest?")
    return out


def get_fp32_state_dict_from_checkpoint(ckpt_dir: str, prefix: str = "params") -> dict:
    """Reference ``get_fp32_state_dict_from_zero_checkpoint``: consolidated
    fp32 weights keyed by parameter path. ``prefix`` selects the subtree
    ('params' = model weights; '' = everything incl. optimizer state)."""
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        manifest = json.load(f)
    out = {}
    for key, entry in manifest["leaves"].items():
        # pytree paths are joined with '::' (checkpoint/saver.py _SEP)
        if prefix and key != prefix and not key.startswith(prefix + "::"):
            continue
        arr = _read_full_leaf(ckpt_dir, entry)
        if arr.dtype in (np.float16, np.dtype("bfloat16") if hasattr(np, "bfloat16") else np.float16):
            arr = arr.astype(np.float32)
        try:
            import ml_dtypes  # bfloat16 arrays round-trip through numpy via ml_dtypes

            if arr.dtype == ml_dtypes.bfloat16:
                arr = arr.astype(np.float32)
        except ImportError:
            pass
        if arr.dtype.kind == "f" and arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        out[key] = arr
    return out


def convert_checkpoint_to_fp32_state_dict(ckpt_dir: str, output_file: str,
                                          prefix: str = "params",
                                          as_torch: bool = False) -> dict:
    sd = get_fp32_state_dict_from_checkpoint(ckpt_dir, prefix=prefix)
    if as_torch:
        import torch

        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                   output_file)
    else:
        np.savez(output_file, **sd)
    total = sum(v.size for v in sd.values())
    print(f"wrote {len(sd)} tensors ({total / 1e6:.1f}M params) to {output_file}")
    return sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--prefix", default="params",
                   help="subtree to extract ('' = everything incl. optimizer)")
    p.add_argument("--torch", action="store_true", help="write a torch .pt state dict")
    args = p.parse_args(argv)
    if not os.path.exists(os.path.join(args.checkpoint_dir, MANIFEST)):
        # tag-level dir? try latest
        latest = os.path.join(args.checkpoint_dir, "latest")
        if os.path.exists(latest):
            tag = open(latest).read().strip()
            args.checkpoint_dir = os.path.join(args.checkpoint_dir, tag)
        else:
            print(f"no {MANIFEST} in {args.checkpoint_dir}", file=sys.stderr)
            return 1
    convert_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, prefix=args.prefix, as_torch=args.torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
