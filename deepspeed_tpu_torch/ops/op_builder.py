"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds; ``csrc/*.cuh`` holds what the sources share. The shared library goes to
``build/deepspeed_tpu_torch/`` beside the package, under a name keyed by the
hash of the source and the flags: an edited source is rebuilt, an unchanged
one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils.logging import logger

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepspeed_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# ptxas's lines per source built by this process: entry functions, registers,
# stack frame and spills, warnings
PTXAS_INFO: dict[str, list[str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library(name: str) -> tuple[Path, Path]:
    """(source, library path keyed by the hash of the source, the shared
    headers ``csrc/*.cuh`` and the flags)."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build_many(names) -> dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for sm_90a for each name not built before
    with this exact source and these flags: one nvcc per source, all started
    together. Waits for every compiler it started, then raises if any failed.
    Returns {name: library path}."""
    running = {}
    for name in names:
        src, lib = _library(name)
        if lib.exists() or name in running:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        running[name] = (src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (src, lib, tmp, proc) in running.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src} (exit {proc.returncode}):\n{out}{err}")
            continue
        PTXAS_INFO[name] = [line.strip() for line in (out + err).splitlines()
                            if "ptxas" in line or "stack frame" in line]
        for line in PTXAS_INFO[name]:
            if "registers" in line or "spill" in line:
                logger.info(f"{name}: {line}")
        os.replace(tmp, lib)  # atomic: a concurrent builder never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _library(name)[1] for name in names}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_many([name])[name]))
    return _loaded[name]
