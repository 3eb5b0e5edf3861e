"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds; ``csrc/*.cuh`` holds what the sources share. The shared library goes to
``build/deepspeed_tpu_torch/`` beside the package, under a name keyed by the
hash of the source and the flags: an edited source is rebuilt, an unchanged
one is loaded as it is.

``build_host`` does the same for a host-only C++ source under ``csrc/``
(the NVMe tier's async-I/O engine, ``csrc/aio/dstpu_aio.cpp``) with
``g++``; a failed build raises with the compiler's output.
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
        # dstpu: allow[rename-durability] -- a build cache, not durable state: the rename only keeps a concurrent builder from loading a partial file, and a library lost to a crash is rebuilt at its next load
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _library(name)[1] for name in names}


HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def build_host(rel_source: str) -> Path:
    """Compile the host C++ source ``csrc/<rel_source>`` with g++ into
    ``build/deepspeed_tpu_torch/`` under a name keyed by the hash of the
    source and the flags, once; returns the library path. Raises
    ``RuntimeError`` with the compiler's stderr when the build fails (or
    when there is no g++)."""
    src = CSRC_DIR / rel_source
    digest = hashlib.sha256(src.read_bytes() + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {src} needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp), str(src), "-lpthread"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    # dstpu: allow[rename-durability] -- a build cache, as in build_many: the rename only keeps a concurrent builder from loading a partial file
    os.replace(tmp, lib)
    return lib


def report() -> str:
    """The build state of every ``csrc/*.cu`` (the ds_report op section):
    built (the library for this exact source, headers and flags is on
    disk), loaded in this process, or not built yet; and whether ``nvcc``
    is there to build it."""
    try:
        nvcc = _nvcc()
    except RuntimeError:
        nvcc = None
    lines = [f"{'op name':24s} {'state':10s} library"]
    for src in sorted(CSRC_DIR.glob("*.cu")):
        _, lib = _library(src.stem)
        state = "loaded" if src.stem in _loaded else "built" if lib.exists() else "NOT BUILT"
        lines.append(f"{src.stem:24s} {state:10s} {lib.name}")
    lines.append(f"nvcc: {nvcc or 'not found (the kernels build on first use where it is)'}")
    return "\n".join(lines)


def loaded_count() -> int:
    """How many libraries this process has loaded: a caller that sees the
    count change across a call knows the call built or loaded one."""
    return len(_loaded)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_many([name])[name]))
    return _loaded[name]
