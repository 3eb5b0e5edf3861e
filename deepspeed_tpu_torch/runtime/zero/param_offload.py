"""ZeRO-Infinity parameter tier: host-resident parameters streamed to the
device one layer at a time, ported from
``deepspeed_tpu/runtime/zero/param_offload.py``.

Reference: ``runtime/zero/partition_parameters.py:537`` (``zero.Init`` with
``remote_device='cpu'|'nvme'``) + ``parameter_offload.py`` +
``swap_tensor/partitioned_param_swapper.py:38``: each parameter's payload
lives in host memory and is copied to the device right before its
submodule's forward and backward, so models whose parameters exceed device
memory train on one device.

The JAX package streams a scanned layer slice with a custom VJP whose
forward is a host-to-device ``device_put`` and whose backward puts the
cotangent back on the host (``_stream_leaf``, :46-62). Here that is the
autograd function ``_Stream`` over a ``ParamStreamer``:

* forward: the layer's slices of the host stacks (pinned, compute dtype) are
  copied to the device on a copy stream, and the next layer's copy is
  started behind an event, so it overlaps this layer's compute;
* the matmuls would save the device copies for the backward, which would
  keep every layer's parameters on the device at once. Saved-tensor hooks
  replace a saved device copy by a note of where it came from, and the
  backward copies the layer again (prefetching the layer before it), as the
  reference fetches partitions again for the backward. Under remat the
  recompute streams the layer itself;
* backward: each slice's gradient goes device-to-host, in fp32, into its
  slice of the pinned host gradient tree: copied by the step's first
  micro-batch, accumulated (on the device, from the host value) by later
  ones, so the ``[L, ...]`` gradient stack never exists on the device.

The top-level leaves (embeddings, final LayerNorm, head) are streamed once
per micro-batch at entry and stay on the device until its backward: the
tied ``wte`` is streamed once for both of its uses. Without a streamer (the
tree is not a ``StreamedParams``, e.g. a model called directly on host
parameters) the same calls make plain differentiable copies
(``stream_to_device``).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Optional

import torch

from ...ops.optimizers import tree_map

LAYERS = "layers"


class StreamedParams(dict):
    """A host parameter tree bound to the ``ParamStreamer`` that moves it,
    as the engine hands it to the model's loss."""

    streamer: "ParamStreamer"


class _Restream:
    """What a saved device copy of a layer slice is replaced by."""

    __slots__ = ("layer", "name", "shape", "stride", "offset")

    def __init__(self, layer, name, t):
        self.layer, self.name = layer, name
        self.shape, self.stride, self.offset = tuple(t.shape), t.stride(), t.storage_offset()


class _Stream(torch.autograd.Function):
    """Device copies of one layer's slices (``key`` = layer index) or of the
    top-level leaves (``key`` = None); their gradients go to the host."""

    @staticmethod
    def forward(ctx, anchor, streamer, key):
        ctx.streamer, ctx.key = streamer, key
        names, outs = streamer._fetch(key)
        ctx.names = names
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.streamer._store_grads(ctx.key, ctx.names, grads)
        return None, None, None


class ParamStreamer:
    """Moves a host parameter tree (``params``: top-level leaves and the
    ``layers`` stacks ``[L, ...]``) to ``device`` for the model, and the
    gradients back into ``grads`` (fp32, the same tree). ``h2d_bytes`` and
    ``d2h_bytes`` count what it copied."""

    def __init__(self, params: dict, grads: dict, device):
        self.params, self.grads = params, grads
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.phase = "forward"
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._written: set = set()
        self._ready: dict = {}  # key -> (names, device tensors, event): prefetched or fetched for the backward
        self._live: dict[int, tuple] = {}  # storage pointer -> (weakref to the device copy, layer, name)
        self._anchor: Optional[torch.Tensor] = None
        names = list(params[LAYERS])
        self.num_layers = int(params[LAYERS][names[0]].shape[0]) if names else 0

    # -- the engine's side ----------------------------------------------
    def view(self) -> StreamedParams:
        """The host tree as the model's loss takes it."""
        p = StreamedParams(self.params)
        p.streamer = self
        return p

    def begin_step(self) -> None:
        """A new optimizer step: the first gradient of each slice is copied,
        later ones are added."""
        self._written.clear()

    @contextlib.contextmanager
    def micro_batch(self):
        """Around one micro-batch's forward and backward: a fresh anchor,
        the saved-tensor hooks that re-stream layer slices, and the phase
        the prefetch follows (set ``phase = "backward"`` before the
        backward)."""
        self._anchor = torch.zeros((), device=self.device, requires_grad=True)
        self.phase = "forward"
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
                yield
        finally:
            self._ready.clear()
            self._live.clear()
            self._anchor = None

    def finish(self) -> dict:
        """Wait for every gradient copy; slices that got no gradient this
        step are zeroed. Returns the host gradient tree."""
        if self.cuda:
            self._stream.synchronize()
        for key in [None, *range(self.num_layers)]:
            for name, dst in self._slices_of(self.grads, key):
                if (key, name) not in self._written:
                    dst.zero_()
        return self.grads

    # -- the model's side -----------------------------------------------
    def stream_top(self, params: StreamedParams) -> StreamedParams:
        out = StreamedParams(params)
        out.streamer = self
        names = [k for k, _ in self._top_items(self.params)]
        if names:
            out.update(zip(names, _Stream.apply(self._anchor, self, None)))
        return out

    def layer(self, i: int) -> dict:
        names = list(self.params[LAYERS])
        return dict(zip(names, _Stream.apply(self._anchor, self, i)))

    # -- internals -------------------------------------------------------
    @staticmethod
    def _top_items(tree):
        return [(k, v) for k, v in tree.items() if k != LAYERS]

    def _slices_of(self, tree, key):
        """(name, tensor) of ``key``'s slices in ``tree`` (params or grads)."""
        if key is None:
            return self._top_items(tree)
        return [(n, s[key]) for n, s in tree[LAYERS].items()]

    def _copy_in(self, key):
        """Start the host-to-device copy of ``key``'s slices -> (names,
        device tensors, event or None). This and ``_put_grads`` are the
        transport: ZeRO-3 (``stage3.py``) replaces them by an all-gather
        and a reduce-scatter and keeps the rest."""
        src = self._slices_of(self.params, key)
        names = [n for n, _ in src]
        self.h2d_bytes += sum(h.numel() * h.element_size() for _, h in src)
        if not self.cuda:
            return names, [h.to(self.device, copy=True) for _, h in src], None
        with torch.cuda.stream(self._stream):
            outs = [torch.empty(h.shape, dtype=h.dtype, device=self.device) for _, h in src]
            for o, (_, h) in zip(outs, src):
                o.copy_(h, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        compute = torch.cuda.current_stream(self.device)
        for o in outs:
            o.record_stream(compute)  # freed only after the compute stream's uses
        return names, outs, event

    def _fetch(self, key):
        """The device copies of ``key`` (waited for on the compute stream),
        prefetching the next layer in the phase's order."""
        got = self._ready.pop(key, None) or self._copy_in(key)
        if key is not None:
            nxt = key + 1 if self.phase == "forward" else key - 1
            if 0 <= nxt < self.num_layers and nxt not in self._ready:
                self._ready[nxt] = self._copy_in(nxt)
        names, outs, event = got
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        if key is not None:
            for name, t in zip(names, outs):
                self._live[t.untyped_storage().data_ptr()] = (weakref.ref(t), key, name)
        return names, outs

    def _pack(self, t):
        entry = self._live.get(t.untyped_storage().data_ptr()) if t.device == self.device else None
        if entry is not None:
            base = entry[0]()
            if base is not None and base.dtype == t.dtype:
                return _Restream(entry[1], entry[2], t)
        return t

    def _unpack(self, packed):
        if not isinstance(packed, _Restream):
            return packed
        key = ("bwd", packed.layer)
        got = self._ready.get(key)
        if got is None:
            got = self._ready.pop(packed.layer, None) or self._copy_in(packed.layer)
            names, outs, event = got
            if event is not None:
                torch.cuda.current_stream(self.device).wait_event(event)
            got = self._ready[key] = (names, outs, None)
            prev = packed.layer - 1
            if prev >= 0 and prev not in self._ready and ("bwd", prev) not in self._ready:
                self._ready[prev] = self._copy_in(prev)
        names, outs, _ = got
        base = outs[names.index(packed.name)]
        return base.as_strided(packed.shape, packed.stride, packed.offset)

    def _store_grads(self, key, names, grads) -> None:
        self._ready.pop(("bwd", key), None)  # the layer's backward is done
        self._put_grads(key, names, grads)

    def _put_grads(self, key, names, grads) -> None:
        """The gradients of ``key``'s slices into the host tree: copied on
        the step's first micro-batch, added to the host value after it."""
        dst_of = dict(self._slices_of(self.grads, key))
        # the fp32 gradients first, then the copy stream waits for them
        g32s = [None if g is None else g.float() for g in grads]
        if self.cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._stream.wait_event(done)
        for name, g32 in zip(names, g32s):
            if g32 is None:
                continue
            dst = dst_of[name]
            first = (key, name) not in self._written
            self._written.add((key, name))
            n = dst.numel() * dst.element_size()
            self.d2h_bytes += n
            self.h2d_bytes += 0 if first else n  # the running sum comes back to be added to
            if not self.cuda:
                dst.copy_(g32) if first else dst.add_(g32)
                continue
            with torch.cuda.stream(self._stream):
                if first:
                    dst.copy_(g32, non_blocking=True)
                else:
                    acc = dst.to(self.device, non_blocking=True)
                    acc.add_(g32)
                    dst.copy_(acc, non_blocking=True)
            g32.record_stream(self._stream)


def stream_to_device(tree, device):
    """Every leaf of a (host) tree as a copy on ``device`` whose gradient
    flows back to the host leaf: the JAX ``stream_to_device``, eagerly. The
    engine's ``ParamStreamer`` does the same a layer at a time, prefetched."""
    return tree_map(lambda t: t.to(device), tree)


def stream_top_level(params: dict, device) -> dict:
    """The tree with its top-level leaves on ``device`` (``layers`` stays on
    the host): through the params' streamer when they have one, else
    ``stream_to_device``."""
    streamer = getattr(params, "streamer", None)
    if streamer is not None:
        return streamer.stream_top(params)
    return {k: v if k == LAYERS else stream_to_device(v, device) for k, v in params.items()}


def layer_getter(params: dict, device) -> Callable[[int], dict]:
    """``get(i)`` -> layer i's leaves on ``device``, streamed."""
    streamer = getattr(params, "streamer", None)
    if streamer is not None:
        return streamer.layer
    stacks = params[LAYERS]
    slices = {n: torch.unbind(stacks[n], 0) for n in stacks}
    return lambda i: stream_to_device({n: s[i] for n, s in slices.items()}, device)
