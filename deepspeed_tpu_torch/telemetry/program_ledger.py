"""Program ledger (the port of ``deepspeed_tpu/telemetry/program_ledger.py``):
cost and memory accounting for every watched program, joined with the
measured wall times into achieved TFLOP/s, MFU and a roofline verdict.

Every hot path is a small, named inventory of programs that the recompile
watchdog wraps (``train/train_step``; ``serving/decode``,
``prefill[b]``, ``chunk_prefill[w]``, ``verify[d]``, the prefix copies,
``fill_slot``). The JAX ledger reads each one's cost from XLA. The port
runs eagerly, so the watchdog runs a program's first call at a new
signature (its "compile") under ``cost.CostCounter`` on the engine's
device and hands the ledger what it counted: FLOPs and bytes of every
ATen op and every hand-written kernel of the call, its backward
included. On the card the row also carries ``argument_bytes``,
``output_bytes`` and ``temp_bytes`` from the CUDA caching allocator around
that call (on the CPU these fields are absent). Only the first signature
per name is counted, as in JAX: later compilations add to ``compiles``
and ``compile_s``. A program that runs more or less work from one call to
the next (a curriculum's shorter batch, a serving decode over fewer live
keys) keeps the first call's row.

The derived columns are JAX's: ``achieved_tflops = flops / wall_p50``,
``mfu = achieved / peak`` and ``roofline`` from the arithmetic intensity
against the platform's critical intensity, with the roof and the fraction
of it reached. The peak table rates an H100 from its data sheet; the CPU
and an unknown GPU stay ``"unrated:<platform>"`` with no peak, so their
rows are labeled, never wrong.

``hbm_snapshot`` attributes device memory to named pools (params,
optimizer state, the slot KV cache, the prefix pool) beside the caching
allocator's own counts, with a warn threshold.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.logging import logger
from . import cost as _cost

# Per-platform peaks: dense bf16 TFLOP/s and HBM GB/s per device, one-way
# interconnect GB/s. The H100 rows are NVIDIA's data-sheet numbers: SXM5
# 989 TFLOP/s dense bf16 (1979 with sparsity), 3.35 TB/s HBM3, NVLink 4 at
# 900 GB/s both ways; PCIe 756 TFLOP/s dense bf16 (1513 with sparsity),
# 2.0 TB/s HBM2e, an NVLink bridge at 600 GB/s both ways.
PEAKS: dict[str, dict] = {
    "gpu_h100_sxm": {"label": "NVIDIA H100 SXM", "peak_tflops": 989.0, "peak_hbm_gbps": 3350.0,
                     "peak_ici_gbps": 450.0},
    "gpu_h100_pcie": {"label": "NVIDIA H100 PCIe", "peak_tflops": 756.0, "peak_hbm_gbps": 2000.0,
                      "peak_ici_gbps": 300.0},
    # rows on these are labeled but never rated
    "cpu": {"label": "cpu (unrated)", "peak_tflops": None, "peak_hbm_gbps": None, "peak_ici_gbps": None},
    "unknown": {"label": "unrated", "peak_tflops": None, "peak_hbm_gbps": None, "peak_ici_gbps": None},
}

# device-name substrings -> PEAKS key, most specific first: the PCIe card
# and the NVL card (not in the table) before the bare "h100" of the SXM
# parts ("NVIDIA H100 80GB HBM3")
_NAME_PATTERNS = (("h100 pcie", "gpu_h100_pcie"), ("h100 nvl", "unknown"), ("h100", "gpu_h100_sxm"))


def platform_peaks(device=None, name: Optional[str] = None) -> dict:
    """The peak entry of ``device`` (the current CUDA device when there is
    one, else the CPU): ``{platform, device_kind, label, peak_tflops,
    peak_hbm_gbps, peak_ici_gbps}``, ``platform`` being ``gpu`` or ``cpu``
    as in the JAX package. ``name`` stands in for the CUDA device's name.
    The CPU and a GPU the table does not know come back with None peaks
    and a label: callers render "unrated", never a wrong peak."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": device.type, "device_kind": device.type, **PEAKS["cpu"]}
    kind = name if name is not None else torch.cuda.get_device_name(device)
    low = kind.lower()
    key = next((k for pat, k in _NAME_PATTERNS if pat in low), "unknown")
    return {"platform": "gpu", "device_kind": kind, **PEAKS[key]}


class ProgramLedger:
    """Cost ledger over the watchdog's program inventory.

    ``measure`` runs a program's first call at a signature under the cost
    counter on the ledger's ``device``; ``capture`` records it. ``table``
    joins the rows with the registry's wall-time histograms through
    ``bind``'s patterns and computes the MFU and roofline rows. A binding
    can nominate a gauge name: ``table`` then publishes that program's MFU
    and arithmetic intensity as registry gauges, so
    ``telemetry_snapshot()`` carries them."""

    def __init__(self, registry=None, enabled: bool = True, device=None, collectives: bool = True,
                 ici_gbps: float = 0.0):
        from .collective_ledger import CollectiveLedger

        self.enabled = enabled
        # the collectives comm/ issues during each program's measured call
        self.collectives = CollectiveLedger(enabled=enabled and collectives)
        self._ici_gbps = float(ici_gbps) or None
        self.registry = registry
        self.device = None if device is None else torch.device(device)
        self.entries: dict[str, dict] = {}  # name -> row, in capture order
        # (prefix, wall_hist, gauge_prefix) join rules, first match wins
        self._bindings: list[tuple[str, str, Optional[str]]] = []
        self._peaks: Optional[dict] = None
        self._pipeline: Optional[dict] = None  # set by the pipeline engine

    @property
    def platform(self) -> dict:
        if self._peaks is None:
            self._peaks = platform_peaks(self.device)
        return self._peaks

    def set_platform(self, peaks: dict) -> None:
        """Override peak resolution (tests pin a synthetic platform so the
        MFU arithmetic is checked against hand-computed fixtures)."""
        self._peaks = dict(peaks)

    def set_mesh_shape(self, mesh_shape: dict) -> None:
        """The engine's mesh axis sizes, in mesh order, for the collective
        ledger's reconcile view."""
        self.collectives.set_mesh_shape(mesh_shape)

    def set_pipeline(self, num_stages: int, micro_batches: int, schedule: str) -> None:
        """Pipeline-engine nomination (JAX ``program_ledger.py:239``): attach
        the clocked schedule's bubble accounting (ticks = M+S-1, bubble =
        S-1 of them) to the train-step anatomy rows."""
        from .collective_ledger import pipeline_bubble_fraction

        self._pipeline = {"num_stages": int(num_stages), "micro_batches": int(micro_batches),
                          "schedule": schedule,
                          "bubble_fraction": pipeline_bubble_fraction(num_stages, micro_batches)}

    def set_device(self, device) -> None:
        """The engine's device: what the counter counts, and the peaks'."""
        self.device = torch.device(device)
        self._peaks = None

    # -- capture (the watchdog's compile path) ---------------------------

    def wants(self, name: str) -> bool:
        """Whether a compilation of ``name`` should run under the counter:
        only the first signature per name is costed."""
        return self.enabled and name not in self.entries

    def measure(self, fn, args, kwargs) -> tuple[object, dict]:
        """Run ``fn(*args, **kwargs)`` under the cost counter on the ledger's
        device -> (its result, the cost fields for ``capture``). On a CUDA
        device the fields add the caching allocator's bytes around the call:
        its tensor arguments, its outputs, and ``temp_bytes``, the peak
        allocation above both ends of the call."""
        dev = self.device
        cuda = dev is not None and dev.type == "cuda"
        if cuda:
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        from ..comm.collectives import recording

        with _cost.CostCounter(dev) as counter, recording() as comm_rows:
            out = fn(*args, **kwargs)
        fields = counter.totals()
        fields["_collectives"] = comm_rows  # for capture: the collective ledger's rows
        if cuda:
            after = torch.cuda.memory_allocated(dev)
            fields.update(argument_bytes=_cost.tensor_bytes((args, kwargs), dev),
                          output_bytes=_cost.tensor_bytes(out, dev),
                          temp_bytes=max(0, torch.cuda.max_memory_allocated(dev) - max(before, after)))
        return out, fields

    def capture(self, name: str, cost: Optional[dict], compile_s: float) -> None:
        """Record one compilation of watched path ``name`` with the cost the
        counter measured (None for a later signature, whose call ran
        uncounted). Never raises: this sits on the dispatch path."""
        if not self.enabled:
            return
        try:
            row = self.entries.get(name)
            cost = dict(cost or {})
            comm_rows = cost.pop("_collectives", None)
            if row is None:
                row = self.entries[name] = {"name": name, "compiles": 1, "compile_s": float(compile_s)}
                row.update(cost)
                if comm_rows:
                    self.collectives.record(name, comm_rows)
                flops, by = row.get("flops"), row.get("bytes_accessed")
                if flops and by:
                    row["arith_intensity"] = flops / by
            else:
                row["compiles"] += 1
                row["compile_s"] += float(compile_s)
        # dstpu: allow[broad-except] -- ledger capture rides the compile path of a LIVE call: any failure must be logged and dropped, or observability could fail the program it observes
        except Exception as e:  # noqa: BLE001
            logger.debug(f"program ledger capture failed for {name!r}: {e}")

    def bind(self, prefix: str, wall_hist: str, gauge: Optional[str] = None) -> None:
        """Join rule: programs whose name starts with ``prefix`` read their
        measured wall time from registry histogram ``wall_hist``; with
        ``gauge``, the first matching program's MFU and intensity are also
        published as ``<gauge>/mfu`` and ``<gauge>/arith_intensity``."""
        self._bindings = [b for b in self._bindings if b[0] != prefix]
        self._bindings.append((prefix, wall_hist, gauge))

    def _binding(self, name: str):
        for prefix, wall_hist, gauge in self._bindings:
            if name.startswith(prefix):
                return wall_hist, gauge
        return None, None

    def resolve(self) -> None:
        """JAX's lazy cost resolution; in the port a row is complete when it
        is captured, so there is nothing to resolve."""

    def _wall(self, registry, wall_hist):
        if registry is None or wall_hist is None:
            return None
        h = registry.get(wall_hist)
        return h.summary() if h is not None and hasattr(h, "summary") else None

    def _derive(self, row: dict, wall: Optional[dict]) -> dict:
        """Join one row with its measured wall-time summary and the platform
        peaks -> achieved TFLOP/s, MFU, roofline verdict."""
        peaks = self.platform
        out = dict(row)
        peak_tf = peaks.get("peak_tflops")
        peak_bw = peaks.get("peak_hbm_gbps")
        flops = out.get("flops")
        inten = out.get("arith_intensity")
        if wall and wall.get("count"):
            out["wall_p50_s"] = wall["p50"]
            out["wall_count"] = wall["count"]
            if flops and wall["p50"] > 0:
                out["achieved_tflops"] = flops / wall["p50"] / 1e12
        if peak_tf is None or peak_bw is None:
            out["roofline"] = "unrated:" + str(peaks.get("platform", "?"))
        elif inten is None:
            out["roofline"] = "unknown"
        else:
            critical = peak_tf * 1e12 / (peak_bw * 1e9)  # flops per byte
            out["roofline"] = "compute-bound" if inten >= critical else "hbm-bound"
            roof_tf = min(peak_tf, inten * peak_bw / 1e3)
            out["roof_tflops"] = roof_tf
            ach = out.get("achieved_tflops")
            if ach:
                out["mfu"] = ach / peak_tf
                out["roof_fraction"] = ach / roof_tf if roof_tf else None
        return out

    def table(self, registry=None) -> list[dict]:
        """One derived row per program, sorted by FLOPs. Publishes the bound
        gauges as a side effect (call BEFORE snapshotting the registry so
        they land in the same snapshot)."""
        registry = registry if registry is not None else self.registry
        rows = []
        published: set[str] = set()
        for name, row in self.entries.items():
            wall_hist, gauge = self._binding(name)
            derived = self._derive(row, self._wall(registry, wall_hist))
            if registry is not None and gauge is not None and gauge not in published:
                # the FIRST captured program matching the binding owns the
                # headline gauge: 'serving/decode#2' never overwrites it
                if derived.get("mfu") is not None:
                    published.add(gauge)
                    registry.gauge(f"{gauge}/mfu").set(derived["mfu"])
                if derived.get("arith_intensity") is not None:
                    published.add(gauge)
                    registry.gauge(f"{gauge}/arith_intensity").set(derived["arith_intensity"])
            rows.append(derived)
        return sorted(rows, key=lambda r: -(r.get("flops") or 0.0))

    def anatomy(self, registry=None) -> list[dict]:
        """Step-anatomy rows (``collective_ledger.step_anatomy``): modeled
        compute and HBM times per program beside its measured wall time and
        the collectives its measured call issued (comm times: labeled nulls
        unless ``ici_gbps`` rates the link).
        Publishes the nominated ``<gauge>/comm/*`` gauges as JAX does (call
        BEFORE snapshotting the registry)."""
        from .collective_ledger import step_anatomy

        registry = registry if registry is not None else self.registry
        rows = []
        published: set[str] = set()
        for name, row in self.entries.items():
            wall_hist, gauge = self._binding(name)
            arow = step_anatomy(row, self._wall(registry, wall_hist), self.platform, self.collectives.get(name),
                                ici_gbps=self._ici_gbps)
            if self._pipeline is not None and name.startswith("train/"):
                arow["pipeline"] = dict(self._pipeline)
            if registry is not None and gauge is not None and gauge not in published:
                # the same first-captured-program-owns-the-gauge rule as table()
                published.add(gauge)
                if arow.get("comm_time_s") is not None:
                    registry.gauge(f"{gauge}/comm/time_s").set(arow["comm_time_s"])
                if arow.get("exposed_comm_estimate_s") is not None:
                    registry.gauge(f"{gauge}/comm/exposed_s").set(arow["exposed_comm_estimate_s"])
                if arow.get("comm_bytes_total"):
                    registry.gauge(f"{gauge}/comm/bytes").set(arow["comm_bytes_total"])
            rows.append(arow)
        return rows


# ---------------------------------------------------------------------------
# device memory ledger
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    """Total bytes of the tensors in a dict/list/tuple nesting (metadata
    only, no device sync)."""
    return _cost.tensor_bytes(tree)


def hbm_snapshot(pools: dict[str, int], device=None, warn_fraction: float = 0.9) -> dict:
    """Device memory attributed to named pools, beside the allocator's own
    counts for ``device`` (``utils.memory.device_memory_stats``; none on
    the CPU). ``warn`` trips when the larger of the bytes in use and the
    bytes the caching allocator holds exceeds ``warn_fraction`` of the
    card's memory."""
    from ..utils import memory

    pools = {k: int(v) for k, v in pools.items() if v}
    out: dict = {
        "pools": pools,
        "pool_total_bytes": sum(pools.values()),
        "warn_fraction": float(warn_fraction),
        "warn": False,
    }
    stats = memory.device_memory_stats(device)
    if stats:
        in_use = int(stats.get("bytes_in_use", 0))
        limit = int(stats.get("bytes_limit", 0))
        out["device"] = {"bytes_in_use": in_use, "peak_bytes_in_use": int(stats.get("peak_bytes_in_use", 0)),
                         "bytes_limit": limit}
        held = max(in_use, int(stats.get("bytes_reserved", 0)))
        if "bytes_reserved" in stats:
            out["device"]["bytes_reserved"] = int(stats["bytes_reserved"])
        if limit > 0 and held > warn_fraction * limit:
            out["warn"] = True
    return out


__all__ = ["ProgramLedger", "platform_peaks", "PEAKS", "tree_bytes", "hbm_snapshot"]
