"""Multinode runner command builders (the port of
``deepspeed_tpu/launcher/multinode_runner.py``).

Each runner turns (active resources, per-node payload) into the
transport's launch command lines; the payload is the port's per-node
launcher (``python -m deepspeed_tpu_torch.launcher.launch``), one process
per node:

- SSH / PDSH carry one command per node (the rank baked in for ssh,
  resolved from the hostname for pdsh through ``--node_rank=auto``);
- OpenMPI / MVAPICH give ONE ``mpirun`` that starts exactly one process
  per host, whose rank comes from the MPI env (``--node_rank=mpi``). MPI
  only places the processes; the collectives are ``torch.distributed``'s;
- ``local`` runs every node's payload as a local subprocess.

The argv of each ``get_cmd`` is JAX's for the same inputs. One default
differs: JAX's MVAPICH hostfile is the fixed ``/tmp/dstpu_mvapich_hostfile``,
which two jobs on one host would overwrite; the port's default is a file of
its own per runner (``tempfile.mkstemp`` under ``TMPDIR``).
"""

from __future__ import annotations

import os
import shlex
import shutil
import tempfile
from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Optional


class MultiNodeRunner(ABC):
    name: str = ""

    def __init__(self, launcher_args: str = "", env: Optional[dict] = None):
        self.launcher_args = shlex.split(launcher_args or "")
        self.env = dict(env or {})

    @abstractmethod
    def backend_exists(self) -> bool: ...

    @abstractmethod
    def get_cmd(self, active: "OrderedDict[str, list[int]]",
                node_cmd_for: "callable") -> list[list[str]]:
        """The process command lines to spawn on this controller.
        ``node_cmd_for(rank_spec)`` builds the per-node payload argv, where
        ``rank_spec`` is an int, 'mpi', or 'auto'."""


def _env_prefix(env: dict) -> str:
    return " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())


def _remote_payload(env: dict, argv: list[str]) -> str:
    return f"cd {shlex.quote(os.getcwd())} && {_env_prefix(env)} {shlex.join(argv)}"


class SSHRunner(MultiNodeRunner):
    name = "ssh"

    def backend_exists(self) -> bool:
        return shutil.which("ssh") is not None

    def get_cmd(self, active, node_cmd_for):
        cmds = []
        for rank, host in enumerate(active):
            payload = _remote_payload(self.env, node_cmd_for(rank))
            cmds.append(["ssh", "-o", "StrictHostKeyChecking=no", host,
                         *self.launcher_args, payload])
        return cmds


class PDSHRunner(MultiNodeRunner):
    """One pdsh fan-out; ranks resolve from hostnames."""

    name = "pdsh"

    def backend_exists(self) -> bool:
        return shutil.which("pdsh") is not None

    def get_cmd(self, active, node_cmd_for):
        hosts = ",".join(active)
        payload = _remote_payload(self.env, node_cmd_for("auto"))
        return [["pdsh", "-S", "-f", "1024", "-w", hosts,
                 *self.launcher_args, payload]]


class OpenMPIRunner(MultiNodeRunner):
    """mpirun with one slot per host."""

    name = "openmpi"

    def backend_exists(self) -> bool:
        return shutil.which("ompi_info") is not None and shutil.which("mpirun") is not None

    def get_cmd(self, active, node_cmd_for):
        total = len(active)
        hostlist = ",".join(f"{h}:1" for h in active)
        cmd = ["mpirun", "-n", str(total), "-H", hostlist,
               "--mca", "btl", "^openib", "--mca", "btl_tcp_if_include", "eth0"]
        for k, v in self.env.items():
            cmd += ["-x", f"{k}={v}"]
        cmd += [*self.launcher_args, *node_cmd_for("mpi")]
        return [cmd]


class MVAPICHRunner(MultiNodeRunner):
    """mpirun_rsh with an MV2 hostfile (by default a fresh file per runner)."""

    name = "mvapich"

    def __init__(self, launcher_args: str = "", env: Optional[dict] = None,
                 hostfile_path: Optional[str] = None):
        super().__init__(launcher_args, env)
        self.hostfile_path = hostfile_path
        # MV2 wants these for a sane TCP bring-up on clusters without IB
        self.env.setdefault("MV2_SMP_USE_CMA", "0")
        self.env.setdefault("MV2_DEBUG_SHOW_BACKTRACE", "1")

    def backend_exists(self) -> bool:
        return shutil.which("mpirun_rsh") is not None

    def get_cmd(self, active, node_cmd_for):
        if self.hostfile_path is None:
            fd, self.hostfile_path = tempfile.mkstemp(prefix="dstpu_mvapich_", suffix=".hostfile")
            os.close(fd)
        with open(self.hostfile_path, "w") as f:
            for h in active:
                f.write(f"{h}\n")
        total = len(active)
        cmd = ["mpirun_rsh", "-np", str(total), "-hostfile", self.hostfile_path]
        for k, v in self.env.items():
            cmd.append(f"{k}={v}")
        cmd += [*self.launcher_args, *node_cmd_for("mpi")]
        return [cmd]


class LocalRunner(MultiNodeRunner):
    """``--launcher local`` with several hosts: every node's payload as a
    local subprocess (multi-process debugging on one machine)."""

    name = "local"

    def backend_exists(self) -> bool:
        return True

    def get_cmd(self, active, node_cmd_for):
        return [node_cmd_for(rank) for rank in range(len(active))]


RUNNERS = {r.name: r for r in (SSHRunner, PDSHRunner, OpenMPIRunner,
                               MVAPICHRunner, LocalRunner)}


def get_runner(name: str, launcher_args: str = "", env: Optional[dict] = None) -> MultiNodeRunner:
    if name not in RUNNERS:
        raise ValueError(f"unknown launcher {name!r}; options: {sorted(RUNNERS)}")
    return RUNNERS[name](launcher_args, env)
