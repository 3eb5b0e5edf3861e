"""Durable small-file writes (a copy of ``deepspeed_tpu/utils/durability.py``):
the tmp + fsync + rename + directory-fsync sequence, and the directory
fsync that makes a rename survive a crash. The telemetry JSONL exporter
fsyncs the directory after it rotates its file."""

from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """fsync the directory holding ``path``: a rename is durable only once
    the directory entry is."""
    fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_durable_bytes(path: str, data: bytes) -> None:
    """Atomically install ``data`` at ``path``: tmp + flush + fsync + rename
    + directory fsync. A crash at any instant leaves the old content or the
    new, never a torn mix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path)
