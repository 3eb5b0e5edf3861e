"""Debug name maps for parameter trees (the port of
``deepspeed_tpu/utils/debug.py``; DeepSpeed's
``debug_extract_module_and_param_names``).

The port's parameters live in nested dicts whose paths are already the
names (``layers/wq``); these helpers render them and fill the same
id -> name table for log lines. A ``torch.nn.Module`` is walked through
``named_parameters``, with its dotted names.
"""

from __future__ import annotations

from typing import Any

import torch

param_names: dict[int, str] = {}


def _named_leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield name, p
    elif isinstance(tree, dict):
        for k in tree:
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def extract_param_names(params: Any) -> dict[str, Any]:
    """name -> leaf map; also fills the global id -> name table."""
    out = {}
    for name, leaf in _named_leaves(params):
        out[name] = leaf
        param_names[id(leaf)] = name
    return out


def debug_param_name(leaf) -> str:
    return param_names.get(id(leaf), f"<unnamed {tuple(getattr(leaf, 'shape', ())) or '?'}>")


def tree_summary(params: Any, max_leaves: int = 24) -> str:
    """A readable name / shape / dtype / device summary of a parameter tree."""
    leaves = list(_named_leaves(params))
    lines = []
    for name, leaf in leaves[:max_leaves]:
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else "?"
        lines.append(f"{name:60s} {str(shape):>20s} {str(getattr(leaf, 'dtype', '?')):>16s}  "
                     f"{getattr(leaf, 'device', '')}")
    if len(leaves) > max_leaves:
        lines.append(f"... {len(leaves) - max_leaves} more leaves")
    return "\n".join(lines)
