"""THE manifest digest convention (format 3): chunked crc32 of a file's
bytes. One implementation on purpose — ``saver.verify_checkpoint`` (live
saves) and ``universal.reshape_checkpoint`` (offline reshapes) both import
it, so the scheme can never fork between the two sides. Stdlib-only so the
jax-free offline tooling (``universal.py``, the report CLI) stays jax-free.
The port keeps this copy, so both packages digest a checkpoint the same way."""

from __future__ import annotations

import zlib


def file_crc32(path: str) -> int:
    """Chunked so a digest pass never spikes RSS by the largest shard."""
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
    return crc
