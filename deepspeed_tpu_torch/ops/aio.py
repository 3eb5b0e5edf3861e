"""ctypes bindings for the NVMe tier's async-I/O engine
(``csrc/aio/dstpu_aio.cpp``), ported from ``deepspeed_tpu/ops/aio.py``.

Reference surface: the ``aio_handle`` class (csrc/aio/py_lib/
py_ds_aio.cpp:12-40: pread/pwrite/sync_pread/sync_pwrite/async_pread/
async_pwrite/wait). The library exports a C ABI, built at first use by
``op_builder.build_host`` with g++ into ``build/deepspeed_tpu_torch/`` (keyed
by the source's hash, as the CUDA builds are). A failed build raises with the
compiler's output: nothing falls back to another I/O path.

Buffers are contiguous CPU ``torch.Tensor``s (pinned where the tier copies
them to or from the card) or numpy arrays, addressed by their data pointer;
the caller keeps a buffer alive until its ticket is waited.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from . import op_builder

AIO_SOURCE = "aio/dstpu_aio.cpp"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the engine; raises
    ``RuntimeError`` with g++'s stderr when the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        # dstpu: allow[blocking-under-lock] -- serializing the one-time native build is this lock's job: concurrent g++ runs would race on the library, and every waiter needs it built
        lib = ctypes.CDLL(str(op_builder.build_host(AIO_SOURCE)))
        lib.dstpu_aio_new.restype = ctypes.c_void_p
        lib.dstpu_aio_new.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dstpu_aio_free.restype = None
        lib.dstpu_aio_free.argtypes = [ctypes.c_void_p]
        for name in ("dstpu_aio_submit_read", "dstpu_aio_submit_write"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.dstpu_aio_wait.restype = ctypes.c_int
        lib.dstpu_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.dstpu_aio_wait_all.restype = ctypes.c_int
        lib.dstpu_aio_wait_all.argtypes = [ctypes.c_void_p]
        lib.dstpu_aio_fsync.restype = ctypes.c_int
        lib.dstpu_aio_fsync.argtypes = [ctypes.c_char_p]
        for name in ("dstpu_aio_pread", "dstpu_aio_pwrite"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        _LIB = lib
        return _LIB


def aio_available() -> bool:
    """Whether the engine builds and loads here (the reference's
    ``is_compatible`` probe). The handle itself raises on a failed build."""
    try:
        _library()
    except (RuntimeError, OSError):
        return False
    return True


def _buffer(buf) -> tuple[int, int]:
    """(data pointer, bytes) of a contiguous CPU tensor or numpy array.
    Raises ``ValueError`` for anything else: a view's pointer with the
    view's size must never reach the engine."""
    if torch.is_tensor(buf):
        if buf.device.type != "cpu":
            raise ValueError(f"aio buffers must be CPU tensors, got one on {buf.device}")
        if not buf.is_contiguous():
            raise ValueError("aio buffers must be contiguous")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if isinstance(buf, np.ndarray):
        if not buf.flags["C_CONTIGUOUS"]:
            raise ValueError("aio buffers must be C-contiguous numpy arrays")
        return buf.ctypes.data, buf.nbytes
    raise ValueError(f"aio buffers are CPU tensors or numpy arrays, not {type(buf).__name__}")


class AsyncIOHandle:
    """The reference ``aio_handle`` surface over the ctypes ABI: async ops
    return integer tickets redeemed by ``wait``. ``bytes_read`` and
    ``bytes_written`` count what the handle moved (submitted reads and
    writes), for the tier's throughput."""

    def __init__(self, n_threads: int = 4, use_odirect: bool = False):
        self._lib = _library()
        self._h = self._lib.dstpu_aio_new(int(n_threads), int(use_odirect))
        # a handle dropped without close() still joins its threads when it
        # is collected
        self._finalizer = weakref.finalize(self, self._lib.dstpu_aio_free, self._h)
        self.bytes_read = 0
        self.bytes_written = 0

    def close(self) -> None:
        """Join the engine's threads (each waits for its queue to drain)."""
        if self._h:
            self._finalizer()
            self._h = None

    # -- synchronous ------------------------------------------------------
    def pread(self, path: str, buf, offset: int = 0) -> None:
        ptr, n = _buffer(buf)
        self.bytes_read += n
        if self._lib.dstpu_aio_pread(self._h, path.encode(), ptr, n, offset) != 0:
            raise OSError(f"aio pread failed: {path}")

    def pwrite(self, path: str, buf, offset: int = 0) -> None:
        ptr, n = _buffer(buf)
        self.bytes_written += n
        if self._lib.dstpu_aio_pwrite(self._h, path.encode(), ptr, n, offset) != 0:
            raise OSError(f"aio pwrite failed: {path}")

    sync_pread = pread
    sync_pwrite = pwrite

    # -- asynchronous -----------------------------------------------------
    def async_pread(self, path: str, buf, offset: int = 0) -> int:
        ptr, n = _buffer(buf)
        self.bytes_read += n
        return self._lib.dstpu_aio_submit_read(self._h, path.encode(), ptr, n, offset)

    def async_pwrite(self, path: str, buf, offset: int = 0) -> int:
        ptr, n = _buffer(buf)
        self.bytes_written += n
        return self._lib.dstpu_aio_submit_write(self._h, path.encode(), ptr, n, offset)

    def wait(self, ticket: Optional[int] = None) -> None:
        rc = (self._lib.dstpu_aio_wait_all(self._h) if ticket is None
              else self._lib.dstpu_aio_wait(self._h, ticket))
        if rc != 0:
            raise OSError(f"aio wait reported failure (rc={rc})")

    def fsync(self, path: str) -> None:
        """Durability barrier for one file (writes go through the page
        cache; one fsync per file at the barrier, not one per task)."""
        if self._lib.dstpu_aio_fsync(path.encode()) != 0:
            raise OSError(f"fsync failed: {path}")
