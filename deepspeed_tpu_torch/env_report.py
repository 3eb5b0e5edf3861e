"""Environment / compatibility report (the port of
``deepspeed_tpu/env_report.py``; DeepSpeed's ``ds_report``).

    python -m deepspeed_tpu_torch.env_report

Reports the Python, PyTorch and CUDA versions, each visible GPU's name and
power limit (``nvidia-smi``), ``nvcc`` and ``g++``, the build state of
each ``csrc/*.cu`` kernel source (``ops/op_builder.report``) and the
native host ops (``ops/native.py``).
"""

from __future__ import annotations

import shutil
import subprocess
import sys

import torch

GREEN_OK = "\033[92m[OKAY]\033[0m"
YELLOW_NO = "\033[93m[NO]\033[0m"


def _tool_version(cmd: list[str]) -> str | None:
    """The last line of ``cmd``'s version output, or None when it is not
    there or fails."""
    if shutil.which(cmd[0]) is None:
        return None
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln for ln in (proc.stdout + proc.stderr).splitlines() if ln.strip()]
    return lines[-1].strip() if proc.returncode == 0 and lines else None


def collect() -> dict:
    import numpy

    info: dict = {"python": sys.version.split()[0], "torch": torch.__version__,
                  "torch_cuda": torch.version.cuda, "numpy": numpy.__version__,
                  "cuda_available": torch.cuda.is_available()}
    if torch.cuda.is_available():
        info["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        smi = _tool_version(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
        info["nvidia_smi"] = smi
    else:
        info["devices"] = []
    from .ops import op_builder

    try:
        info["nvcc"] = op_builder._nvcc()
    except RuntimeError:
        info["nvcc"] = None
    info["nvcc_version"] = _tool_version([info["nvcc"], "--version"]) if info["nvcc"] else None
    info["gxx"] = shutil.which("g++")
    from .ops.native import aio_available, cpu_adam_available

    try:
        info["native_aio"] = aio_available()
    except (OSError, RuntimeError) as e:  # a diagnostic says when it cannot diagnose
        info["native_aio"] = False
        info["native_aio_error"] = f"{type(e).__name__}: {e}"[:200]
    info["native_cpu_adam"] = cpu_adam_available()
    return info


def main() -> int:
    info = collect()
    from .ops import op_builder

    print("-" * 60)
    print("deepspeed_tpu_torch environment report (reference: ds_report)")
    print("-" * 60)
    for k, v in info.items():
        status = GREEN_OK if v else YELLOW_NO
        print(f"{k:20s} {status}  {v}")
    print("-" * 60)
    print(op_builder.report())
    print("-" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
