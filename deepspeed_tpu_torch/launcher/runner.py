"""Multi-host launch orchestrator (the port of
``deepspeed_tpu/launcher/runner.py``; ``bin/dstpu``'s counterpart):

    python -m deepspeed_tpu_torch.launcher.runner --hostfile HOSTFILE train.py --arg

The unit of launch is one process per host, started through the per-node
launcher (``launcher/launch.py``) with the rendezvous env. The hostfile
dialect is DeepSpeed's (``hostname slots=N``); ``--include`` /
``--exclude`` filter it (``'w0@w1:0,2'``), and the active layout travels to
every node as ``--world_info``, base64 of its JSON, byte for byte JAX's
encoding. One active host (or none) launches in place; more go through the
``--launcher`` transport (``multinode_runner.py``).

``DSTPU_ENV_PREFIXES`` names the variables a multi-node launch exports to
the remote nodes: ``DSTPU_`` and ``PYTHON`` as in the JAX package, and in
place of its ``JAX_``, ``XLA_``, ``TPU_`` and ``LIBTPU_`` this card's
counterparts, ``CUDA_``, ``NCCL_`` and ``TORCH_``.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shlex
import subprocess
import sys
from collections import OrderedDict

from ..utils.logging import logger

DSTPU_ENV_PREFIXES = ("DSTPU_", "CUDA_", "NCCL_", "TORCH_", "PYTHON")
LAUNCH_MODULE = "deepspeed_tpu_torch.launcher.launch"


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="dstpu distributed launcher (reference: deepspeed CLI)"
    )
    parser.add_argument("-H", "--hostfile", type=str, default="/job/hostfile",
                        help="hostfile: lines of '<hostname> slots=<n>'")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="host filter, e.g. 'worker-0@worker-1:0,2'")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="host filter to drop")
    parser.add_argument("--num_nodes", type=int, default=-1)
    parser.add_argument("--master_addr", type=str, default="")
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--launcher", type=str, default="ssh",
                        choices=("ssh", "pdsh", "openmpi", "mvapich", "local"))
    parser.add_argument("--launcher_args", type=str, default="")
    parser.add_argument("--force_multi", action="store_true")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args)


def fetch_hostfile(path: str) -> "OrderedDict[str, int]":
    """Parse 'hostname slots=N' lines -> host -> slot count, in file order.
    A missing file gives an empty dict (single-node mode)."""
    if not os.path.isfile(path):
        return OrderedDict()
    resource_pool: OrderedDict[str, int] = OrderedDict()
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            host = parts[0]
            slots = 1
            for tok in parts[1:]:
                if tok.startswith("slots="):
                    try:
                        slots = int(tok.split("=", 1)[1])
                    except ValueError as e:
                        raise ValueError(f"{path}:{lineno}: bad slots in {line!r}") from e
            if host in resource_pool:
                raise ValueError(f"{path}:{lineno}: duplicate host {host!r}")
            resource_pool[host] = slots
    return resource_pool


def _parse_filter(spec: str) -> "OrderedDict[str, list[int] | None]":
    """'w0@w1:0,2' -> {w0: None (all slots), w1: [0, 2]}."""
    out: OrderedDict[str, list[int] | None] = OrderedDict()
    if not spec:
        return out
    for part in spec.split("@"):
        if ":" in part:
            host, slots = part.split(":", 1)
            out[host] = sorted(int(s) for s in slots.split(","))
        else:
            out[part] = None
    return out


def parse_resource_filter(
    resource_pool: "OrderedDict[str, int]",
    include_str: str = "",
    exclude_str: str = "",
) -> "OrderedDict[str, list[int]]":
    """Apply --include / --exclude to the hostfile pool -> host -> usable
    slot indices. Only one of include/exclude may be given."""
    if include_str and exclude_str:
        raise ValueError("--include and --exclude are mutually exclusive")
    pool = OrderedDict((h, list(range(n))) for h, n in resource_pool.items())
    if include_str:
        inc = _parse_filter(include_str)
        out: OrderedDict[str, list[int]] = OrderedDict()
        for host, slots in inc.items():
            if host not in pool:
                raise ValueError(f"--include host {host!r} not in hostfile")
            chosen = pool[host] if slots is None else slots
            bad = set(chosen) - set(pool[host])
            if bad:
                raise ValueError(f"--include slots {sorted(bad)} not available on {host}")
            out[host] = chosen
        return out
    if exclude_str:
        exc = _parse_filter(exclude_str)
        for host, slots in exc.items():
            if host not in pool:
                raise ValueError(f"--exclude host {host!r} not in hostfile")
            if slots is None:
                del pool[host]
            else:
                pool[host] = [s for s in pool[host] if s not in slots]
                if not pool[host]:
                    del pool[host]
        return pool
    return pool


def encode_world_info(active: "OrderedDict[str, list[int]]") -> str:
    """The world layout passed to each node: urlsafe base64 of its JSON."""
    return base64.urlsafe_b64encode(json.dumps(active).encode()).decode()


def decode_world_info(encoded: str) -> dict:
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


def build_node_command(
    node_rank,
    num_nodes: int,
    coordinator: str,
    world_info: str,
    user_script: str,
    user_args: list[str],
) -> list[str]:
    """The per-node command run through ssh/pdsh/mpirun or locally: the
    per-node launcher with the rendezvous arguments. ``node_rank`` is an
    int or one of the 'mpi'/'auto' specs (``launch.resolve_node_rank``)."""
    cmd = [
        sys.executable,
        "-m",
        LAUNCH_MODULE,
        f"--node_rank={node_rank}",
        f"--num_nodes={num_nodes}",
        f"--coordinator={coordinator}",
        f"--world_info={world_info}",
        user_script,
    ]
    return cmd + list(user_args)


def _exportable_env() -> dict:
    return {
        k: v for k, v in os.environ.items() if any(k.startswith(p) for p in DSTPU_ENV_PREFIXES)
    }


def main(args=None):
    args = parse_args(args)
    pool = fetch_hostfile(args.hostfile)
    active = parse_resource_filter(pool, args.include, args.exclude)
    if args.num_nodes > 0:
        active = OrderedDict(list(active.items())[: args.num_nodes])

    multi_node = (len(active) > 1) or args.force_multi
    if not active or not multi_node:
        # single node: the per-node launcher, in this process's environment
        host = next(iter(active), "localhost")
        coordinator = f"{args.master_addr or '127.0.0.1'}:{args.master_port}"
        world_info = encode_world_info(active or OrderedDict({host: [0]}))
        cmd = build_node_command(0, 1, coordinator, world_info, args.user_script, args.user_args)
        logger.info(f"single-node launch: {shlex.join(cmd)}")
        return subprocess.call(cmd)

    master = args.master_addr or next(iter(active))
    coordinator = f"{master}:{args.master_port}"
    world_info = encode_world_info(active)

    from .multinode_runner import get_runner

    runner = get_runner(args.launcher, args.launcher_args, _exportable_env())
    if not runner.backend_exists():
        logger.warning(f"launcher backend for {runner.name!r} not found on PATH")

    def node_cmd_for(rank_spec):
        return build_node_command(
            rank_spec, len(active), coordinator, world_info,
            args.user_script, args.user_args,
        )

    procs = []
    for cmd in runner.get_cmd(active, node_cmd_for):
        logger.info(f"[{runner.name}] {shlex.join(cmd)}")
        procs.append(subprocess.Popen(cmd))

    rc = 0
    try:
        for p in procs:
            rc |= p.wait()
    except KeyboardInterrupt:
        for p in procs:
            p.terminate()
        raise
    return rc


if __name__ == "__main__":
    sys.exit(main())
