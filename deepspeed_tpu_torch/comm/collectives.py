"""Named-axis collectives over ``torch.distributed``: the port of
``deepspeed_tpu/comm/collectives.py``.

The JAX package's collectives are traced inside ``jit``/``shard_map`` over
a mesh axis name; here they run eagerly on a tensor over the process group
of that axis (or tuple of axes) in the current mesh (``mesh.py``), and
their results are laid out as ``lax.psum_scatter`` / ``lax.all_gather`` /
``lax.all_to_all`` lay theirs out with ``tiled=True``: over an axis tuple
the first axis is major. Each call is recorded in the comms logger as
``(op, axis, bytes of its operand)``, once per call (JAX records once per
trace), and, while a watched program's first call is being measured, in
the collective ledger's row list (``recording``).

Mapping (reference op -> here):
    all_reduce          -> all_reduce (dist.all_reduce)          comm/comm.py:494
    reduce_scatter_base -> reduce_scatter (reduce_scatter_tensor) comm/comm.py:256
    all_gather_base     -> all_gather (all_gather_into_tensor)   comm/comm.py:325
    all_to_all_single   -> all_to_all (all_to_all_single)        comm/comm.py:222
    send/recv (PP p2p)  -> ppermute (batch_isend_irecv)          pipe/p2p.py:48
    broadcast           -> broadcast_in_axis (dist.broadcast)
    broadcast (objects) -> broadcast_object (a pickled payload; the
                           tensor-parallel serving driver's calls)

The tensor-parallel conjugates (Megatron's ``mappings.py``), autograd
functions over one axis whose backward is the other half of the pair, so a
tensor-parallel forward differentiates through its collectives:

    copy_to_model      identity         / all-reduce   (a column-parallel input)
    reduce_from_model  all-reduce       / identity     (a row-parallel epilogue)
    gather_from_model  all-gather       / own slice
    scatter_to_model   own slice        / all-gather   (partition_activations)

Their sums run in fp32 and are cast back, and each collective they issue,
forward or backward, is logged as the ones above are.

Routes. NCCL takes CUDA tensors and gloo CPU tensors. Gloo on CUDA tensors
takes the five collectives in ``GLOO_CUDA_NATIVE`` itself (the probe in
``chip_smoke.py`` phase 26 checks each); ``ppermute``'s point-to-point
sends over gloo are staged through a pinned host buffer (copy out, send
on the host, copy back). The route is chosen before the call from
(backend, device), never by catching a failed call, and the staged bytes
count as such in the comms logger. The arithmetic around a collective
stays on the tensor's device.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import logger
from .logger import _axis_label, comms_logger
from .mesh import AXIS_ORDER, Axes, _as_axes, current_mesh

# The collectives handed to gloo on CUDA tensors as they are: torch 2.11's
# gloo took all five on an H100 (chip_smoke.py phase 26 probes each and
# fails if one is refused; PERF.md keeps the table). Point-to-point
# (ppermute) is staged.
GLOO_CUDA_NATIVE = ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "all_to_all")

# torch 2.13 renames the flat collectives; 2.11 has only the old names
_ALL_GATHER_FLAT = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER_FLAT = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# the HLO op each collective is (JAX's broadcast_in_axis is an all-gather)
_HLO_OP = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter", "all_gather": "all-gather",
           "all_to_all": "all-to-all", "ppermute": "collective-permute", "broadcast": "all-gather"}
_RECORDING: list = []  # stack of row lists the collective ledger is filling


def init_distributed(dist_backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None, device=None,
                     auto_mpi_discovery: bool = True, timeout_s: float = 600.0, backend: Optional[str] = None,
                     **_: object) -> None:
    """Process-group bootstrap (the reference's ``deepspeed.init_distributed``,
    comm/comm.py:577). The world and the rank come from the arguments, else
    the env:// variables (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
    ``MASTER_PORT``) or the launcher's ``DSTPU_*`` spellings, else
    ``mpi_discovery``. The backend is ``backend`` (or ``dist_backend``) when
    given, else ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU. A
    world of 1 with no ``init_method`` starts no process group (its
    collectives are identities); an already initialized group is kept."""
    if dist.is_initialized():
        return
    env = os.environ
    if world_size is None:
        raw = env.get("WORLD_SIZE") or env.get("DSTPU_NUM_PROCESSES")
        world_size = int(raw) if raw else None
    if rank is None:
        raw = env.get("RANK") or env.get("DSTPU_PROCESS_ID")
        rank = int(raw) if raw else None
    coordinator = None
    if "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
    elif env.get("DSTPU_COORDINATOR"):
        coordinator = env["DSTPU_COORDINATOR"]
    if world_size is None and auto_mpi_discovery:
        disc = mpi_discovery()
        if disc is not None:
            world_size, rank = disc["world_size"], disc["rank"]
            coordinator = coordinator or disc["coordinator"]
            logger.info(f"rendezvous discovered from MPI/scheduler env: {disc}")
    world_size = 1 if world_size is None else int(world_size)
    rank = 0 if rank is None else int(rank)
    if init_method is None:
        if world_size == 1:
            return  # nothing to join; a later call may still join a world
        if coordinator is None:
            raise RuntimeError(f"init_distributed: a world of {world_size} needs MASTER_ADDR/MASTER_PORT, "
                               "DSTPU_COORDINATOR or an init_method")
        init_method = f"tcp://{coordinator}"
    chosen = backend or (dist_backend if dist_backend not in (None, "xla") else None)
    if chosen is None:
        dev = torch.device(device) if device is not None else None
        chosen = "nccl" if dev is not None and dev.type == "cuda" else "gloo"
    if chosen == "nccl" and device is not None and torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(chosen, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    logger.info(f"torch.distributed initialized: rank {rank}/{world_size} ({chosen}, {init_method})")


def destroy_distributed() -> None:
    """Leave the process group (if any) and forget the mesh: the process is
    a world of 1 again."""
    from .mesh import set_current_mesh

    if _up():
        dist.destroy_process_group()
    set_current_mesh(None)


def mpi_discovery(port: int = 29500) -> Optional[dict]:
    """(rank, world_size, coordinator) from a launcher's environment: the
    reference's ``mpi_discovery`` + AML/SageMaker paths (comm/comm.py:640-
    750), minus any MPI import. Recognized: OpenMPI (OMPI_*), MVAPICH/PMI
    (MV2_*/PMI_*), torchrun-style (RANK/WORLD_SIZE + MASTER_ADDR), Azure-ML
    (AZ_BATCH_MASTER_NODE). None when nothing is set."""
    env = os.environ
    rank = size = None
    for rk, sk in (("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
                   ("MV2_COMM_WORLD_RANK", "MV2_COMM_WORLD_SIZE"),
                   ("PMI_RANK", "PMI_SIZE"),
                   ("RANK", "WORLD_SIZE")):
        if rk in env and sk in env:
            rank, size = int(env[rk]), int(env[sk])
            break
    if rank is None:
        return None
    if "AZ_BATCH_MASTER_NODE" in env:  # AML: "<ip>:<port>"
        coordinator = env["AZ_BATCH_MASTER_NODE"]
    elif "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', port)}"
    else:
        local = None
        for lk in ("OMPI_COMM_WORLD_LOCAL_SIZE", "MPI_LOCALNRANKS", "MV2_COMM_WORLD_LOCAL_SIZE"):
            if lk in env:
                local = int(env[lk])
                break
        if size > 1 and local != size:
            # multi-host (or unknown): guessing each rank's own hostname
            # would point every node's rendezvous at itself and hang
            raise RuntimeError(
                "mpi_discovery: MPI rank env found but no MASTER_ADDR / "
                "AZ_BATCH_MASTER_NODE — export MASTER_ADDR=<rank-0 host> "
                "(mpirun -x MASTER_ADDR=...) for multi-node runs")
        import socket

        coordinator = f"{socket.gethostname()}:{port}"
    return {"rank": rank, "world_size": size, "coordinator": coordinator}


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


is_initialized = _up


def get_world_size(group: Optional[str] = None) -> int:
    """The world size; with ``group`` = a mesh axis name, that axis's size
    on the most recently built mesh."""
    if group is not None:
        mesh = current_mesh()
        if mesh is None or group not in mesh.shape:
            raise ValueError(f"unknown group {group!r}: no active mesh axis by that name "
                             f"(have {list(mesh.shape) if mesh else 'no mesh'})")
        return int(mesh.shape[group])
    return dist.get_world_size() if _up() else 1


def get_rank() -> int:
    return dist.get_rank() if _up() else 0


def get_local_rank() -> int:
    """The rank within its node: the ``LOCAL_RANK`` the launcher exported."""
    return int(os.environ.get("LOCAL_RANK", 0))


def barrier() -> None:
    """Every rank enters before any returns; a no-op in a world of 1."""
    if _up() and dist.get_world_size() > 1:
        dist.barrier()


def world_codes(code: int) -> list[int]:
    """Every rank's integer ``code``, in rank order, over the whole world:
    one all-reduce of a vector holding this rank's code at its index. Where
    a rank may fail between two meeting points, the meeting is this
    agreement rather than a plain barrier, so no rank waits on a rank that
    raised (the checkpoint saver's). ``[code]`` in a world of 1."""
    if not _up() or dist.get_world_size() == 1:
        return [int(code)]
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    codes = torch.zeros(dist.get_world_size(), dtype=torch.int64, device=dev)
    codes[dist.get_rank()] = int(code)
    dist.all_reduce(codes)
    return [int(c) for c in codes.tolist()]


# --------------------------------------------------------------------------
# Collectives over named mesh axes
# --------------------------------------------------------------------------

@contextlib.contextmanager
def recording():
    """Collect a row ``{op, axis, payload_bytes, group_size}`` (HLO op names)
    for every collective issued inside; the collective ledger wraps a
    watched program's first call in it."""
    rows: list = []
    _RECORDING.append(rows)
    try:
        yield rows
    finally:
        _RECORDING.remove(rows)


def _log(op: str, axis, tensor: torch.Tensor, n: int, staged: bool = False) -> None:
    comms_logger.record(op, axis, tensor, staged=staged)
    mesh = current_mesh()
    if _RECORDING and mesh is not None:
        # the ledger labels a collective as JAX's reads its replica groups:
        # the axes of size above 1, in mesh order (none: no wire traffic)
        kept = [a for a in AXIS_ORDER if a in _as_axes(axis) and mesh.shape[a] > 1]
        if kept:
            _RECORDING[-1].append({"op": _HLO_OP.get(op.split("[")[0], op), "axis": _axis_label(kept),
                                   "payload_bytes": tensor.numel() * tensor.element_size(), "group_size": n})


def _group(axis: Axes):
    """(process group, its size, members in the axes' order, this rank's
    index among them, the group-rank order of the members)."""
    mesh = current_mesh()
    if mesh is None:
        if _up() and dist.get_world_size() > 1:
            raise RuntimeError("a collective over a mesh axis needs a mesh: build_mesh() first")
        return None, 1, [0], 0, [0]
    axes = _as_axes(axis)
    members = mesh.members(axes)
    pg = mesh.group(axes)
    if pg is None and len(members) > 1:
        raise RuntimeError(f"mesh axes {axes} span {len(members)} ranks but no process group is up")
    in_group = sorted(members)  # torch orders a group's ranks by their global rank
    return pg, len(members), members, members.index(mesh.rank), [in_group.index(m) for m in members]


def _staged(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce(x: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
    """The sum (``mean``/``avg``, ``max``, ``min``) of ``x`` over the ranks
    of ``axis``, as a new tensor (reference comm/comm.py:494)."""
    if op not in ("sum", "mean", "avg", "max", "min"):
        raise ValueError(f"unsupported reduce op {op}")
    pg, n, *_ = _group(axis)
    _log(f"all_reduce[{op}]", axis, x, n)
    out = x.clone()
    if n == 1 and pg is None:
        return out
    red = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}.get(op, dist.ReduceOp.SUM)
    dist.all_reduce(out, op=red, group=pg)
    if op in ("mean", "avg"):
        out = out / n if out.is_floating_point() else out // n
    return out


def _gather_rows(x: torch.Tensor, pg, n: int, order: list[int]) -> torch.Tensor:
    """[n, *x.shape]: row i is the i-th member's ``x`` (in the axes' order)."""
    src = x.contiguous()
    if pg is None:
        return src.unsqueeze(0)
    flat = src.reshape(-1)  # the flat collectives take 1-D [m] -> [n * m]
    out = torch.empty(n * flat.numel(), dtype=src.dtype, device=src.device)
    _ALL_GATHER_FLAT(out, flat, group=pg)
    out = out.view(n, *src.shape)
    return out if order == list(range(n)) else out[order]


def all_gather(x: torch.Tensor, axis, gather_dimension: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``gather_dimension`` in the
    axes' order (``tiled``), or stacked on a new dimension there: the
    ZeRO-3 parameter fetch (comm/comm.py:325)."""
    pg, n, _, _, order = _group(axis)
    _log("all_gather", axis, x, n)
    rows = _gather_rows(x, pg, n, order)
    if not tiled:
        return rows.movedim(0, gather_dimension)
    return torch.cat(rows.unbind(0), dim=gather_dimension)


def reduce_scatter(x: torch.Tensor, axis, scatter_dimension: int = 0, tiled: bool = True) -> torch.Tensor:
    """The sum over the ranks of ``axis`` of ``x``, of which this rank keeps
    the chunk along ``scatter_dimension`` at its index in the axes' order:
    the ZeRO-2 gradient primitive (comm/comm.py:256). Untiled, the dimension
    must equal the axis size and is dropped."""
    pg, n, _, _, order = _group(axis)
    _log("reduce_scatter", axis, x, n)
    d = scatter_dimension % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"reduce_scatter: dimension {d} of {tuple(x.shape)} is not divisible by {n}")
    chunks = list(x.chunk(n, dim=d))
    if pg is None:
        out = chunks[0].clone()
    else:
        # row k of the input goes to group rank k, the member order[?] == k
        inv = [0] * n
        for i, k in enumerate(order):
            inv[k] = i
        inp = torch.stack([chunks[inv[k]] for k in range(n)]).reshape(-1)  # 1-D [n * m] -> [m]
        out = torch.empty(inp.numel() // n, dtype=x.dtype, device=x.device)
        _REDUCE_SCATTER_FLAT(out, inp, group=pg)
        out = out.view(chunks[0].shape)
    if not tiled:
        if x.shape[d] != n:
            raise ValueError(f"untiled reduce_scatter needs dimension {d} == {n}, got {x.shape[d]}")
        out = out.squeeze(d)
    return out


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """Chunk j of ``x`` along ``split_axis`` goes to the j-th member; the
    chunks received are concatenated along ``concat_axis`` in the members'
    order (lax.all_to_all, tiled; MoE dispatch, moe/sharded_moe.py:89)."""
    if not tiled:
        raise NotImplementedError("all_to_all: only the tiled layout is ported")
    pg, n, _, _, order = _group(axis)
    _log("all_to_all", axis, x, n)
    chunks = list(x.chunk(n, dim=split_axis))
    if pg is None:
        return x.clone()
    inv = [0] * n
    for i, k in enumerate(order):
        inv[k] = i
    inp = torch.stack([chunks[inv[k]] for k in range(n)]).contiguous()
    got = torch.empty_like(inp)
    dist.all_to_all_single(got, inp, group=pg)
    return torch.cat([got[order[i]] for i in range(n)], dim=concat_axis)


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    """Point-to-point permutation over ``axis``: for each (src, dst) in
    ``perm`` (indices along the axis), dst receives src's ``x``; a rank no
    pair sends to gets zeros (lax.ppermute; pipe/p2p.py:48). Over an axis
    tuple the indices run in the mesh's axis order whatever the tuple's
    order, as ``lax.ppermute`` reads them."""
    pg, n, members, me, _ = _group(tuple(sorted(_as_axes(axis), key=AXIS_ORDER.index)))
    staged = x.device.type == "cuda" and pg is not None and dist.get_backend(pg) == "gloo"
    _log("ppermute", axis, x, n, staged=staged)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = torch.zeros_like(x)
    if pg is None:
        return x.clone() if src else out
    send = _staged(x.contiguous()) if staged else x.contiguous()
    recv = torch.empty_like(send) if src else None
    ops = []
    for d in dst:
        if d == me:
            continue
        ops.append(dist.P2POp(dist.isend, send, members[d], group=pg))
    if src and src[0] != me:
        ops.append(dist.P2POp(dist.irecv, recv, members[src[0]], group=pg))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if src:
        out.copy_(x if src[0] == me else recv)
    return out


def ring_shift(x: torch.Tensor, axis, shift: int = 1) -> torch.Tensor:
    """Shift values around the ring formed by ``axis``."""
    n = axis_size_in_jit(axis)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)])


def broadcast_in_axis(x: torch.Tensor, axis, src_index: int = 0) -> torch.Tensor:
    """The ``src_index``-th member's ``x`` on every rank of ``axis``
    (comm/comm.py:222 broadcast)."""
    pg, n, members, _, _ = _group(axis)
    _log("broadcast", axis, x, n)
    out = x.clone()
    if pg is None:
        return out
    dist.broadcast(out, src=members[src_index], group=pg)
    return out


def broadcast_object(obj, axis, src_index: int = 0):
    """The ``src_index``-th member's Python object on every rank of
    ``axis``: its pickle, as a length then a byte tensor (two broadcasts),
    on the host under gloo and on the current CUDA device under nccl.
    Logged once, as a ``broadcast`` of the payload's bytes. The payload is
    unpickled, so only ranks of one job may send it. A rank that waits
    longer than the process group's timeout raises (``RuntimeError``)."""
    pg, n, members, me, _ = _group(axis)
    if pg is None:
        return obj
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(pg) == "nccl" else torch.device("cpu")
    if me == src_index:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8).to(dev)
        size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(size, src=members[src_index], group=pg)
    if me != src_index:
        payload = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    _log("broadcast", axis, payload, n)
    dist.broadcast(payload, src=members[src_index], group=pg)
    if me == src_index:
        return obj
    return pickle.loads(payload.cpu().numpy().tobytes())


# --------------------------------------------------------------------------
# The tensor-parallel conjugates (autograd through the collectives)
# --------------------------------------------------------------------------

def _sum32(x: torch.Tensor, axis) -> torch.Tensor:
    return all_reduce(x.float(), axis).to(x.dtype)


def _own_slice(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    n = axis_size_in_jit(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} is not divisible by the {axis!r} axis ({n})")
    return x.chunk(n, dim=dim)[axis_index(axis)].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum32(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, gather_dimension=dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.axis, ctx.dim), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _own_slice(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.axis, gather_dimension=ctx.dim), None, None


def copy_to_model(x: torch.Tensor, axis="model") -> torch.Tensor:
    """``x`` as it is; its gradient all-reduced over ``axis`` (in fp32): the
    input of a column-parallel product, whose ranks each see part of it."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis="model") -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (in fp32, cast back); its gradient
    passes as it is: a row-parallel product's partial sums."""
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis="model", dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in the axis's order; the
    gradient keeps this rank's slice."""
    return _GatherFromModel.apply(x, axis, dim % x.dim())


def scatter_to_model(x: torch.Tensor, axis="model", dim: int = -1) -> torch.Tensor:
    """This rank's slice of ``x`` on ``dim`` (``x`` the same on every rank of
    ``axis``); the gradient all-gathered back to the full width."""
    return _ScatterToModel.apply(x, axis, dim % x.dim())


def axis_index(axis) -> int:
    mesh = current_mesh()
    return 0 if mesh is None else mesh.axis_index(axis)


def axis_size_in_jit(axis) -> int:
    """The size of ``axis`` (or of an axis tuple) on the current mesh (JAX's
    name; nothing is traced here)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.axis_size(axis)
