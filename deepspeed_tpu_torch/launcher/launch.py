"""Per-node launcher (the port of ``deepspeed_tpu/launcher/launch.py``).

One child per node: the user script, started in a session of its own with
the rendezvous env (``child_env``). The failure contract is JAX's: on a
signal to this launcher the child's whole process group is terminated, and
when the child exits non-zero the group is SIGKILLed, so no orphaned
process keeps holding the card.

``child_env`` sets the ``DSTPU_*`` keys and DeepSpeed's ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` as JAX's does, and torch's own spelling of
the coordinator, ``MASTER_ADDR`` / ``MASTER_PORT``, split from
``--coordinator``: what ``torch.distributed``'s ``env://`` rendezvous
reads.

    python -m deepspeed_tpu_torch.launcher.launch --node_rank 0 --num_nodes 1 \\
        --coordinator 127.0.0.1:29500 train.py --arg
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys

from ..utils.logging import logger


def parse_args(args=None):
    p = argparse.ArgumentParser()
    p.add_argument("--node_rank", type=str, required=True,
                   help="int rank, 'mpi' (read the MPI launcher's rank env), "
                        "or 'auto' (match hostname against world_info)")
    p.add_argument("--num_nodes", type=int, required=True)
    p.add_argument("--coordinator", type=str, required=True)
    p.add_argument("--world_info", type=str, default="")
    p.add_argument("user_script", type=str)
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    ns = p.parse_args(args)
    ns.node_rank = resolve_node_rank(ns.node_rank, ns.world_info)
    return ns


def resolve_node_rank(spec: str, world_info: str = "") -> int:
    """Node rank from an explicit int, the MPI launcher's env (OpenMPI,
    MVAPICH, PMI: the MPI runners start one process per node), or the
    hostname's position in world_info (pdsh, which sets no rank)."""
    if spec == "mpi":
        for var in ("OMPI_COMM_WORLD_RANK", "MV2_COMM_WORLD_RANK", "PMI_RANK",
                    "PMIX_RANK"):
            if var in os.environ:
                return int(os.environ[var])
        raise RuntimeError("--node_rank=mpi but no MPI rank variable in env")
    if spec == "auto":
        import socket

        from .runner import decode_world_info

        hosts = list(decode_world_info(world_info))
        name = socket.gethostname()
        short = name.split(".")[0]
        # exact match first: prefix matching alone mis-ranks host sets where
        # one name prefixes another (node1 / node10)
        for candidate in (name, short):
            if candidate in hosts:
                return hosts.index(candidate)
        # then FQDN-vs-short equivalence, requiring a '.' boundary
        for i, h in enumerate(hosts):
            if name.startswith(h + ".") or h.startswith(name + ".") or h.split(".")[0] == short:
                return i
        raise RuntimeError(f"hostname {name} not found in world_info hosts {hosts}")
    return int(spec)


def terminate_process_tree(pid: int, sig=signal.SIGTERM) -> None:
    """Signal the child's whole process group. The child was started with
    ``start_new_session=True``, so its pgid is its pid: the group is
    signalled directly (``os.getpgid(pid)`` would raise once the child is
    reaped, and miss its surviving children)."""
    try:
        os.killpg(pid, sig)
    except ProcessLookupError:
        pass


def child_env(node_rank: int, num_nodes: int, coordinator: str, world_info: str) -> dict:
    env = dict(os.environ)
    env.update(
        # the port's rendezvous keys, JAX's spelling
        DSTPU_COORDINATOR=coordinator,
        DSTPU_NUM_PROCESSES=str(num_nodes),
        DSTPU_PROCESS_ID=str(node_rank),
        DSTPU_WORLD_INFO=world_info,
        # DeepSpeed's spellings, which user scripts and the engines read
        RANK=str(node_rank),
        WORLD_SIZE=str(num_nodes),
        LOCAL_RANK="0",
    )
    # torch.distributed's env:// rendezvous
    addr, _, port = coordinator.rpartition(":")
    env["MASTER_ADDR"] = addr or coordinator
    if port.isdigit():
        env["MASTER_PORT"] = port
    return env


def main(args=None):
    args = parse_args(args)
    env = child_env(args.node_rank, args.num_nodes, args.coordinator, args.world_info)
    cmd = [sys.executable, args.user_script] + list(args.user_args)
    logger.info(f"node {args.node_rank}/{args.num_nodes}: exec {cmd}")
    proc = subprocess.Popen(cmd, env=env, start_new_session=True)

    def handler(signum, frame):
        logger.warning(f"signal {signum}: terminating child tree")
        terminate_process_tree(proc.pid, signal.SIGTERM)

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    rc = proc.wait()
    if rc != 0:
        terminate_process_tree(proc.pid, signal.SIGKILL)
    return rc


if __name__ == "__main__":
    sys.exit(main())
