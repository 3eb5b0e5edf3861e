"""The collective ledger and the step anatomy: the port of
``CollectiveLedger``, ``_wire_factor``, ``step_anatomy`` and
``pipeline_bubble_fraction`` from ``deepspeed_tpu/telemetry/collective_ledger.py``.

The JAX ledger parses each compiled program's HLO for its collectives.
The port has no HLO: its collectives are the eager calls ``comm/`` issues,
so a watched program's first call (the call the program ledger's
``CostCounter`` counts FLOPs in) runs under ``comm.recording()``, and the
rows it collects, ``{op, axis, payload_bytes, group_size}`` with HLO op
names and payloads (operand bytes), are summarized as JAX summarizes the
parsed ops. ``parse_hlo_collectives`` and ``infer_axes`` have no
counterpart: the axis is known when the call is made. The port's
collectives are synchronous, so every summary's overlap verdict is
``serialized`` (or ``none``).

``step_anatomy`` joins one program's ledger row, its measured wall time,
the platform peaks and its collective summary. No link of the port is
rated (the platform table has no ``peak_ici_gbps``), so the comm times are
the labeled nulls JAX gives an unrated platform unless
``ledger.collectives.ici_gbps`` rates the link.
"""

from __future__ import annotations

from typing import Optional


# wire-time algorithm factors (ring algorithms): payload_bytes * factor /
# link bandwidth models the per-rank link time
def _wire_factor(op: str, group_size: int) -> float:
    n = max(2, group_size)
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op in ("reduce-scatter", "all-to-all"):
        return (n - 1) / n
    if op == "all-gather":
        # operand is the local shard; a ring moves it to n-1 peers
        return float(n - 1)
    return 1.0  # collective-permute: one hop


_MAX_DETAIL_OPS = 32


def summarize_ops(ops: list[dict]) -> dict:
    """One program's collective summary from its recorded rows: per-axis
    payload/wire bytes, per ``op@axis`` counts (the comms logger's
    reconcile view), and the overlap tallies (none: the calls are
    synchronous)."""
    bytes_by_axis: dict[str, int] = {}
    wire_by_axis: dict[str, float] = {}
    by_op_axis: dict[str, dict] = {}
    counts_by_op: dict[str, int] = {}
    detail = []
    for op in ops:
        axis, payload, gsize = op["axis"], op["payload_bytes"], op["group_size"]
        bytes_by_axis[axis] = bytes_by_axis.get(axis, 0) + payload
        wire_by_axis[axis] = wire_by_axis.get(axis, 0.0) + payload * _wire_factor(op["op"], gsize)
        ent = by_op_axis.setdefault(f"{op['op']}@{axis}", {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += payload
        counts_by_op[op["op"]] = counts_by_op.get(op["op"], 0) + 1
        if len(detail) < _MAX_DETAIL_OPS:
            detail.append({"op": op["op"], "async": False, "bytes": payload, "axis": axis,
                           "group_size": gsize, "overlapped": False})
    return {
        "n_collectives": len(ops),
        "counts_by_op": counts_by_op,
        "bytes_by_axis": bytes_by_axis,
        "wire_bytes_by_axis": wire_by_axis,
        "by_op_axis": by_op_axis,
        "async_pairs": 0,
        "overlapped_pairs": 0,
        "overlap_verdict": "serialized" if ops else "none",
        "ops": detail,
        "ops_truncated": max(0, len(ops) - len(detail)),
    }


class CollectiveLedger:
    """Per-program collective summaries, recorded from the rows of each
    watched program's first call. ``set_mesh_shape`` takes the engine's
    mesh axis sizes (in mesh order), which the comms logger's reconcile
    view canonicalizes its labels by."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.mesh_shape: Optional[dict[str, int]] = None
        self.programs: dict[str, dict] = {}

    def set_mesh_shape(self, mesh_shape: dict[str, int]) -> None:
        self.mesh_shape = {k: int(v) for k, v in mesh_shape.items()}

    def record(self, name: str, ops: list[dict]) -> None:
        if not self.enabled or not ops:
            return
        self.programs[name] = summarize_ops(ops)

    def get(self, name: str) -> Optional[dict]:
        return self.programs.get(name)

    def bytes_by_axis(self) -> dict[str, dict]:
        """Per-axis counts/bytes across every recorded program: the ledger's
        side of ``CommsLogger.reconcile``."""
        out: dict[str, dict] = {}
        for summ in self.programs.values():
            for key, ent in summ["by_op_axis"].items():
                axis = key.split("@", 1)[1]
                agg = out.setdefault(axis, {"count": 0, "bytes": 0})
                agg["count"] += ent["count"]
                agg["bytes"] += ent["bytes"]
        return out


def step_anatomy(row: dict, wall: Optional[dict], peaks: dict,
                 coll: Optional[dict],
                 ici_gbps: Optional[float] = None) -> dict:
    """Join one program's cost-model row, measured wall summary, platform
    peaks and collective summary into the where-does-the-time-go record.

    Rated platforms get modeled times; CPU/unknown keep the static facts
    (bytes per axis, overlap verdict) with LABELED null times — no peak, no
    fabricated comm roofline (`comm_rated: false`)."""
    peak_tf = peaks.get("peak_tflops")
    peak_bw = peaks.get("peak_hbm_gbps")
    ici = ici_gbps if ici_gbps else peaks.get("peak_ici_gbps")
    flops = row.get("flops")
    by = row.get("bytes_accessed")
    rated = peak_tf is not None and peak_bw is not None
    out: dict = {
        "name": row.get("name"),
        "platform": peaks.get("platform", "unknown"),
        "compute_time_s": (flops / (peak_tf * 1e12)
                           if rated and flops else None),
        "hbm_time_s": by / (peak_bw * 1e9) if rated and by else None,
    }
    if coll:
        out["comm_bytes_by_axis"] = dict(coll["bytes_by_axis"])
        out["comm_ops"] = dict(coll["counts_by_op"])
        out["overlap_verdict"] = coll["overlap_verdict"]
        out["async_pairs"] = coll["async_pairs"]
        out["overlapped_pairs"] = coll["overlapped_pairs"]
    else:
        out["comm_bytes_by_axis"] = {}
        out["comm_ops"] = {}
        out["overlap_verdict"] = "none"
    out["comm_bytes_total"] = sum(out["comm_bytes_by_axis"].values())
    out["comm_rated"] = bool(ici) and coll is not None
    if out["comm_rated"]:
        ctba = {axis: wb / (ici * 1e9)
                for axis, wb in coll["wire_bytes_by_axis"].items()}
        out["comm_time_by_axis"] = ctba
        out["comm_time_s"] = sum(ctba.values())
    else:
        # labeled nulls: an unrated platform (CPU fallback, unknown TPU
        # generation) must never carry a fabricated comm time
        out["comm_time_by_axis"] = None
        out["comm_time_s"] = None
    wall_p50 = wall.get("p50") if wall and wall.get("count") else None
    if wall_p50:
        out["wall_p50_s"] = wall_p50
    if (wall_p50 and rated
            and (out["compute_time_s"] or out["hbm_time_s"])):
        device_t = max(out["compute_time_s"] or 0.0, out["hbm_time_s"] or 0.0)
        comm_t = out["comm_time_s"] or 0.0
        # wall beyond the slower of (device roof, comm roof) is time the
        # schedule failed to hide — 0 for a perfectly overlapped step
        out["exposed_comm_estimate_s"] = max(
            0.0, wall_p50 - max(device_t, comm_t))
    else:
        out["exposed_comm_estimate_s"] = None
    return out


def pipeline_bubble_fraction(num_stages: int, micro_batches: int) -> float:
    """Fill/drain fraction of the clocked pipeline schedule: ticks =
    M + S - 1, of which S - 1 are bubble (pipe/engine.py docstring; same
    fraction for the executed 1F1B and the autodiff GPipe profile)."""
    s, m = int(num_stages), int(micro_batches)
    if s <= 1 or m < 1:
        return 0.0
    return (s - 1) / (m + s - 1)


__all__ = ["CollectiveLedger", "summarize_ops", "step_anatomy", "pipeline_bubble_fraction"]
