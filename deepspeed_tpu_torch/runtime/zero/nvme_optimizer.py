"""NVMe-tiered optimizer, the ZeRO-Infinity optimizer-state tier, ported from
``deepspeed_tpu/runtime/zero/nvme_optimizer.py``.

Reference: ZeRO-Infinity keeps fp32 master weights and Adam moments on
NVMe (runtime/swap_tensor/partitioned_optimizer_swapper.py +
optimizer_utils.py), swaps each parameter group in over the aio engine,
steps it on the CPU (csrc/adam/cpu_adam.cpp) and swaps it back out: host
memory holds a group or two at a time, so the trainable size is bounded by
the disk, not by host or device memory.

The groups are the JAX tier's: the leaves, in the tree's order, cut into
groups of at most ``sub_group_bytes`` of fp32 master. Each group is one swap
file of ``{key: {master, m, v}}`` in the JAX layout (``TensorSwapper``). A
step reads group i+1 while it updates group i IN PLACE in its read buffer
(``host_optimizer.adam_step_``, the JAX numpy update's arithmetic), then
writes the group to a new file, fsyncs it and drops the old one. The
gradients may be device tensors: each group's come over to the host just
before its update, so no host copy of the whole gradient exists. With
``out`` the updated masters are cast into those tensors (the engine's
compute-dtype parameters, on the device) group by group.

``save_state`` / ``load_state`` write and read the JAX tier's files: one
``group<NNNN>.npz`` per group (``__gen__`` and ``<key>::master|m|v``) and
``meta.json`` last, each fsync'd before its rename, so either package loads
the other's.
"""

from __future__ import annotations

import json
import os
import time
import zipfile
from typing import Optional

import numpy as np
import torch

from ..swap_tensor import TensorSwapper
from .host_optimizer import AdamScratch, adam_step_, host_empty

_COMPONENTS = ("m", "master", "v")  # a group file's leaf order per key (sorted, as JAX flattens)


def _fsync_file(path: str) -> None:
    """fsync a file or directory by path (a directory fsync makes renames
    durable)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _GroupBuffers:
    """One host buffer set: the master/m/v arena a group is read into (in
    its file's layout), its gradients' arena and a compute-dtype staging
    arena for the copy back to the device; pinned when the tier serves a
    card."""

    def __init__(self, max_elems: int, pin: bool, out_dtype: Optional[torch.dtype]):
        self.state = host_empty((3 * max_elems,), torch.float32, pin)
        self.grads = host_empty((max_elems,), torch.float32, pin) if pin else None
        self.stage = host_empty((max_elems,), out_dtype, pin) if pin and out_dtype is not None else None
        self.tickets: list[int] = []  # reads into this set in flight
        self.old: Optional[dict] = None  # the manifest its group's write replaces
        self.event = None  # the device copies that read this set

    def views(self, keys: list[str], shapes: dict) -> dict:
        """{key: {m, master, v}} views into the arena in the file's order."""
        out, off = {}, 0
        for k in sorted(keys):
            n = int(np.prod(shapes[k]))
            out[k] = {}
            for comp in _COMPONENTS:
                out[k][comp] = self.state[off:off + n].view(shapes[k])
                off += n
        return out


class NvmeTieredOptimizer:
    def __init__(self, params_host: dict, lr: float = 1e-3, betas: tuple = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True, swap_dir: str = "",
                 sub_group_bytes: int = 1 << 28, n_threads: int = 4, pin: bool = False,
                 out_dtype: Optional[torch.dtype] = None, **_ignored):
        """``params_host``: {key: fp32 tensor or array} in the tree's order.
        ``pin``: the buffers are pinned (the gradients and ``out`` of
        ``step`` live on a card); ``out_dtype`` is then the dtype ``step``
        casts into."""
        self.lr = float(lr)
        self.b1, self.b2 = betas
        self.eps = eps
        self.wd = weight_decay
        self.adam_w = adam_w_mode
        self.step_count = 0
        self.swapper = TensorSwapper(swap_dir or _default_swap_dir(), n_threads=n_threads)
        self.shapes = {k: tuple(np.shape(p)) for k, p in params_host.items()}
        self.host_update_s = 0.0  # wall seconds of the last step's host work

        # byte-bounded groups (the reference's sub_group_size), in tree order
        self.groups: list[list[str]] = []
        cur, cur_bytes = [], 0
        for key, shape in self.shapes.items():
            nbytes = int(np.prod(shape)) * 4
            if cur and cur_bytes + nbytes > sub_group_bytes:
                self.groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(key)
            cur_bytes += nbytes
        if cur:
            self.groups.append(cur)
        self._group_index = {k: gi for gi, g in enumerate(self.groups) for k in g}
        max_elems = max((sum(int(np.prod(self.shapes[k])) for k in g) for g in self.groups), default=0)
        self._bufs = [_GroupBuffers(max_elems, pin, out_dtype) for _ in range(2)]
        self._scratch = AdamScratch()
        self.manifests: list[dict] = []
        self._write_all(lambda k: params_host[k], None)

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    # ------------------------------------------------------------------
    def _write_all(self, master_of, moments_of) -> list[dict]:
        """Write every group (masters from ``master_of(key)``, moments from
        ``moments_of(key) -> (m, v)`` or zeros) to new swap files, durably;
        returns the new manifests (and installs them)."""
        buf = self._bufs[0]
        new = []
        try:
            for g in self.groups:
                views = buf.views(g, self.shapes)
                for k in g:
                    views[k]["master"].copy_(_host_f32(master_of(k)).view(self.shapes[k]))
                    if moments_of is None:
                        views[k]["m"].zero_()
                        views[k]["v"].zero_()
                    else:
                        m, v = moments_of(k)
                        views[k]["m"].copy_(_host_f32(m).view(self.shapes[k]))
                        views[k]["v"].copy_(_host_f32(v).view(self.shapes[k]))
                new.append(self.swapper.swap_out(views))  # synchronous: the buffer is reused next
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            for m in new:
                self.swapper.release(m)
            raise
        old, self.manifests = self.manifests, new
        for m in old:
            self.swapper.release(m)
        return new

    def reset_from(self, params_host: dict, step_count: int = 0) -> None:
        """LOSSY resync (no saved tier state): masters rebuilt from
        ``params_host``, moments zeroed, and the bias-correction clock
        restarted (``step_count`` 0) unless real moments are restored."""
        self._write_all(lambda k: params_host[k], None)
        self.step_count = int(step_count)

    # ------------------------------------------------------------------
    # Checkpoint persistence (the JAX tier's files)
    def save_state(self, state_dir: str) -> None:
        """Every group's masters and moments and the step clock, as one
        ``.npz`` per group and ``meta.json`` last, each landed through tmp +
        fsync + rename under one generation stamp: a save that dies part-way
        leaves a directory ``load_state`` refuses as a whole."""
        os.makedirs(state_dir, exist_ok=True)
        gen = os.urandom(8).hex()
        gen_arr = np.frombuffer(bytes.fromhex(gen), dtype=np.uint8)
        buf = self._bufs[0]
        for gi, (g, manifest) in enumerate(zip(self.groups, self.manifests)):
            views = buf.views(g, self.shapes)
            self.swapper.swap_in(manifest, out=views)
            flat = {"__gen__": gen_arr}
            for key in sorted(g):
                for comp in ("master", "m", "v"):
                    flat[f"{key}::{comp}"] = views[key][comp].numpy()
            path = os.path.join(state_dir, f"group{gi:04d}.npz")
            np.savez(path + ".tmp.npz", **flat)
            _fsync_file(path + ".tmp.npz")
            os.replace(path + ".tmp.npz", path)
        meta_path = os.path.join(state_dir, "meta.json")
        with open(meta_path + ".tmp", "w") as f:
            json.dump({"step_count": self.step_count, "num_groups": len(self.groups), "gen": gen}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(meta_path + ".tmp", meta_path)
        _fsync_file(state_dir)

    def load_state(self, state_dir: str) -> bool:
        """Restore from ``save_state`` output (either package's); False, with
        the tier untouched, when the directory is absent, corrupt, from a
        partial save (mixed generations) or grouped otherwise."""
        try:
            with open(os.path.join(state_dir, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        if int(meta.get("num_groups", -1)) != len(self.groups) or not isinstance(meta.get("step_count"), int):
            return False
        gen = meta.get("gen")
        paths = [os.path.join(state_dir, f"group{gi:04d}.npz") for gi in range(len(self.groups))]
        try:
            for path, g in zip(paths, self.groups):
                with np.load(path) as z:
                    names = set(z.files)
                    if any(f"{k}::{c}" not in names for k in g for c in ("master", "m", "v")):
                        return False
                    if gen is not None and ("__gen__" not in names or bytes(z["__gen__"]).hex() != gen):
                        return False
            files = [np.load(p) for p in paths]
            try:
                def npz(k):
                    return files[self._group_index[k]]

                self._write_all(lambda k: npz(k)[f"{k}::master"], lambda k: (npz(k)[f"{k}::m"], npz(k)[f"{k}::v"]))
            finally:
                for z in files:
                    z.close()
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return False
        self.step_count = int(meta["step_count"])
        return True

    # ------------------------------------------------------------------
    def step(self, grads: dict, lr: Optional[float] = None, skip: bool = False,
             out: Optional[dict] = None) -> Optional[dict]:
        """One Adam(W) step over every group. ``grads``: {key: fp32 tensor or
        array}, on the host or a card. ``skip`` (an overflow) returns None
        without touching the disk: states and clock unchanged. With ``out``
        ({key: tensor}) each updated master is copied (cast) into it and
        ``out`` is returned; else fresh fp32 host copies of the masters."""
        if skip:
            return None
        t0 = time.perf_counter()
        lr = self.lr if lr is None else float(lr)
        self.step_count += 1
        result = {} if out is None else out
        n = len(self.groups)
        if n:
            self._read(0)
        for gi in range(n):
            buf = self._bufs[gi % 2]
            if gi + 1 < n:
                self._settle(self._bufs[(gi + 1) % 2])
                self._read(gi + 1)
            self.swapper.wait_reads(buf.tickets)
            buf.tickets = []
            views = buf.views(self.groups[gi], self.shapes)
            host_grads = self._grads_to_host(buf, self.groups[gi], grads)
            for key in self.groups[gi]:
                st = views[key]
                adam_step_(st["master"], st["m"], st["v"], host_grads[key], lr=lr, step=self.step_count,
                           betas=(self.b1, self.b2), eps=self.eps, weight_decay=self.wd, adamw=self.adam_w,
                           scratch=self._scratch)
            buf.old = self.manifests[gi]
            self.manifests[gi] = self.swapper.swap_out(views, async_op=True)
            self._emit(buf, views, result, out is None)
        for buf in self._bufs:
            self._settle(buf)
        self.host_update_s = time.perf_counter() - t0
        return result

    def _read(self, gi: int) -> None:
        buf = self._bufs[gi % 2]
        buf.tickets = self.swapper.swap_in_async(self.manifests[gi], buf.views(self.groups[gi], self.shapes))

    def _settle(self, buf: _GroupBuffers) -> None:
        """Before a buffer set is read into again: its group's writes are
        durable (the old file dropped) and its device copies have read it."""
        if buf.old is not None:
            self.swapper.synchronize()
            self.swapper.release(buf.old)
            buf.old = None
        if buf.event is not None:
            buf.event.synchronize()
            buf.event = None

    def _grads_to_host(self, buf: _GroupBuffers, keys: list[str], grads: dict) -> dict:
        """The group's gradients as contiguous fp32 host tensors: device ones
        copied into the pinned gradient arena (one synchronise), host ones
        taken as they are."""
        out, off, pending = {}, 0, False
        for k in keys:
            g = grads[k]
            if torch.is_tensor(g) and g.device.type == "cuda":
                n = g.numel()
                dst = buf.grads[off:off + n].view(g.shape)
                dst.copy_(g, non_blocking=True)
                off += n
                pending = True
                out[k] = dst
            else:
                out[k] = _host_f32(g).contiguous()
        if pending:
            torch.cuda.current_stream().synchronize()
        return out

    def _emit(self, buf: _GroupBuffers, views: dict, result: dict, copies: bool) -> None:
        if copies:
            for k, st in views.items():
                result[k] = st["master"].clone()
            return
        off = 0
        for k, st in views.items():
            dst, master = result[k], st["master"]
            if dst.device.type == "cuda" and buf.stage is not None:
                n = master.numel()
                stage = buf.stage[off:off + n].view(master.shape)
                stage.copy_(master)
                dst.copy_(stage, non_blocking=True)
                off += n
            else:
                dst.copy_(master)
        if off:
            buf.event = torch.cuda.Event()
            buf.event.record()

    def state_bytes(self) -> int:
        """Bytes of masters and moments on disk."""
        return sum(e["nbytes"] for m in self.manifests for e in m["entries"])

    def close(self) -> None:
        self.swapper.close()


def _host_f32(x) -> torch.Tensor:
    """A tensor or array as an fp32 host tensor (no copy when it is one)."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32))


def _default_swap_dir() -> str:
    import tempfile

    return os.path.join(tempfile.gettempdir(), "dstpu_nvme")
