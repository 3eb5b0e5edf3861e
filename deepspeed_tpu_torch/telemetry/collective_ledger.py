"""Step anatomy (the port of ``step_anatomy`` and ``pipeline_bubble_fraction``
from ``deepspeed_tpu/telemetry/collective_ledger.py``, which are pure
arithmetic).

``step_anatomy`` joins one program's ledger row, its measured wall time
and the platform peaks into the where-does-the-time-go record: modeled
compute and HBM times, and the comm fields. The port has no collectives
yet (the collective ledger and its HLO parsing come with parallelism), so
every row takes ``coll=None``: the comm fields are the labeled nulls the
JAX package gives a program without collectives, and no comm time is
made up.
"""

from __future__ import annotations

from typing import Optional


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


__all__ = ["step_anatomy", "pipeline_bubble_fraction"]
