"""Run-summary CLI over a telemetry JSONL event log (a copy of
``deepspeed_tpu/telemetry/report.py``: stdlib only, the same text from the
same JSONL).

    python -m deepspeed_tpu_torch.telemetry.report run.jsonl [--top 10]
        [--json] [--request UID] [--step-anatomy] [--perfetto out.json]
        [--watch N]

Pretty-prints, for CI logs and bench triage:

  * top spans by total time (count / total / mean / max per span path),
  * the recompile table (per watched path: compiles, compile seconds, the
    signatures that triggered them) with stable-path violations flagged,
  * the program roofline table (per watched program: flops, bytes
    accessed, arithmetic intensity, measured wall time, achieved TFLOPS vs
    the platform peak, MFU, compute-/hbm-bound verdict — CPU/unknown
    platforms stay labeled "unrated", never rated against a wrong peak),
  * the HBM memory ledger (device memory attributed to named pools —
    params / opt state / slot KV cache / prefix pool — next to the
    runtime's in-use/peak/limit watermarks, WARN-flagged past the
    configured threshold),
  * request latency percentiles (TTFT / per-output-token) from ``request``
    events,
  * the serving prefix-cache table (hit rate, tokens reused, pool occupancy,
    resident entries) when the run's snapshot carries one,
  * the resilience table (``resilience/*`` recovery/degradation counters,
    fault-injector fired/opportunity ratios, non-ok request statuses),
  * the chaos fault-site coverage table (``chaos/site/<name>/fired`` vs
    ``survived`` per site, fired > survived flagged TRIPPED) when a
    chaos search ran against the registry,
  * the serving-router table (per-replica health state and
    dispatched/failed-over/drained/completed counts plus the ``router/*``
    counters) when the snapshot came from a ``Router``,
  * the flight-recorder tables (docs/observability.md "Flight recorder &
    SLOs"): SLO attainment + multi-window burn rates with the fast-burn
    breach flagged, the telemetry rings' last cells, and the incident
    bundle index (inspect bundles with ``bin/dstpu_autopsy``),
  * the last registry ``snapshot`` event, if the run emitted one.

``--watch N`` re-renders the summary every N seconds (ANSI screen clear
between frames, ctrl-C exits) — live triage against a JSONL a serving
fleet is still appending to.

Query modes:

  * ``--request UID`` — print one request's lifecycle timeline (arrived ->
    admitted -> chunk k -> first_token -> terminal, plus quarantine/failover
    edges), merged across the router and every replica when the snapshot
    came from a fleet.
  * ``--step-anatomy`` — the collective X-ray's step anatomy: per watched
    program, modeled compute/HBM/comm-by-axis time, the exposed-comm
    estimate (wall beyond the slower roof), and the static overlap verdict
    read from the compiled HLO (telemetry/collective_ledger.py; unrated
    platforms keep labeled ``-`` times, never fabricated ones).
  * ``--perfetto out.json`` — export every request timeline in the last
    snapshot as Chrome-trace JSON (load in ui.perfetto.dev).
  * ``--json`` — machine-readable output: ``{snapshot, roofline, hbm,
    step_anatomy, comm_reconcile, requests[, request_timeline]}`` for CI
    and bench tooling.

The default summary additionally flags comm-reconcile mismatches (host
byte accounting vs the HLO-derived collective counts) as labeled warnings.

Pure stdlib + host-side: safe to run anywhere the JSONL landed (no jax
import, no device).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

from .request_trace import request_timeline, to_perfetto


def load_events(path: str) -> list[dict]:
    events = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                print(f"warning: {path}:{ln}: unparseable line skipped",
                      file=sys.stderr)
    return events


def _pct(sorted_xs: list[float], q: float) -> float:
    if not sorted_xs:
        return 0.0
    idx = min(int(q * (len(sorted_xs) - 1) + 0.5), len(sorted_xs) - 1)
    return sorted_xs[idx]


def _fmt_s(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.1f}ms"
    return f"{s * 1e6:.0f}us"


def _fmt_qty(x, suffix: str = "") -> str:
    if x is None:
        return "-"
    x = float(x)
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(x) < 1000:
            return f"{x:.2f}{unit}{suffix}"
        x /= 1000
    return f"{x:.2f}E{suffix}"


def last_snapshot(events: list[dict]):
    snap = None
    for ev in events:
        if ev.get("type") == "snapshot":
            snap = ev
    return snap


def ledger_rows(snap: dict | None) -> list[dict]:
    """Program-ledger rows from a snapshot — the engine's own plus, for a
    Router snapshot, every replica's (rows gain a ``replica`` key)."""
    if not snap:
        return []
    rows = [dict(r) for r in snap.get("program_ledger") or []]
    for rid, rep in (snap.get("replicas") or {}).items():
        for r in rep.get("program_ledger") or []:
            rows.append({"replica": rid, **r})
    return rows


def anatomy_rows(snap: dict | None) -> list[dict]:
    """Step-anatomy rows from a snapshot — the engine's own plus, for a
    Router snapshot, every replica's (rows gain a ``replica`` key)."""
    if not snap:
        return []
    rows = [dict(r) for r in snap.get("step_anatomy") or []]
    for rid, rep in (snap.get("replicas") or {}).items():
        for r in rep.get("step_anatomy") or []:
            rows.append({"replica": rid, **r})
    return rows


def reconcile_rows(snap: dict | None) -> list[dict]:
    """comm-reconcile rows (host byte accounting vs HLO-derived counts)."""
    if not snap:
        return []
    rows = [dict(r) for r in snap.get("comm_reconcile") or []]
    for rid, rep in (snap.get("replicas") or {}).items():
        for r in rep.get("comm_reconcile") or []:
            rows.append({"replica": rid, **r})
    return rows


def hbm_tables(snap: dict | None) -> list[dict]:
    """HBM-ledger dicts from a snapshot (engine's own + per replica)."""
    if not snap:
        return []
    out = []
    if snap.get("hbm"):
        out.append(dict(snap["hbm"]))
    for rid, rep in (snap.get("replicas") or {}).items():
        if rep.get("hbm"):
            out.append({"replica": rid, **rep["hbm"]})
    return out


def _platform_of(snap: dict | None) -> dict:
    if not snap:
        return {}
    if snap.get("platform"):
        return snap["platform"]
    for rep in (snap.get("replicas") or {}).values():
        if rep.get("platform"):
            return rep["platform"]
    return {}


def summarize(events: list[dict], top: int = 10) -> str:
    lines = []

    # -- spans ----------------------------------------------------------
    spans = defaultdict(lambda: {"count": 0, "total": 0.0, "max": 0.0})
    for ev in events:
        if ev.get("type") == "span":
            agg = spans[ev["path"]]
            agg["count"] += 1
            agg["total"] += ev["dur_s"]
            agg["max"] = max(agg["max"], ev["dur_s"])
    if spans:
        lines.append(f"top spans by total time ({len(spans)} distinct):")
        lines.append(f"  {'path':<40} {'count':>7} {'total':>10} {'mean':>10} {'max':>10}")
        ranked = sorted(spans.items(), key=lambda kv: -kv[1]["total"])[:top]
        for path, agg in ranked:
            lines.append(
                f"  {path:<40} {agg['count']:>7} {_fmt_s(agg['total']):>10} "
                f"{_fmt_s(agg['total'] / agg['count']):>10} {_fmt_s(agg['max']):>10}")
        lines.append("")

    # -- recompiles -----------------------------------------------------
    compiles = defaultdict(lambda: {"n": 0, "total_s": 0.0, "sigs": []})
    refusals = defaultdict(int)
    for ev in events:
        if ev.get("type") == "compile":
            agg = compiles[ev["name"]]
            agg["n"] += 1
            agg["total_s"] += ev.get("compile_s", 0.0)
            agg["sigs"].append(ev.get("signature", "?"))
        elif ev.get("type") == "refusal":
            refusals[ev["name"]] = max(refusals[ev["name"]], ev.get("n_refused", 1))
    if compiles or refusals:
        total_s = sum(a["total_s"] for a in compiles.values())
        lines.append(f"recompile table ({sum(a['n'] for a in compiles.values())} "
                     f"compilations, {_fmt_s(total_s)} total):")
        lines.append(f"  {'path':<40} {'compiles':>8} {'wall':>10}  signature(s)")
        for name in sorted(set(compiles) | set(refusals),
                           key=lambda n: -compiles[n]["total_s"]):
            agg = compiles[name]
            sig = agg["sigs"][-1] if agg["sigs"] else "?"
            if len(sig) > 60:
                sig = sig[:57] + "..."
            flag = "  <-- RECOMPILED" if agg["n"] > 1 else ""
            if refusals.get(name):
                flag += f"  [{refusals[name]} refused pre-exec]"
            lines.append(f"  {name:<40} {agg['n']:>8} {_fmt_s(agg['total_s']):>10}  {sig}{flag}")
        lines.append("")

    # -- last snapshot (feeds the roofline / hbm / router tables) -------
    snap = last_snapshot(events)

    # -- program roofline -----------------------------------------------
    # the ledger's static cost model joined with measured wall times
    # (telemetry/program_ledger.py): where step time and
    # headroom actually are, per compiled program
    lrows = ledger_rows(snap)
    if lrows:
        plat = _platform_of(snap)
        peak = plat.get("peak_tflops")
        head = (f"{plat.get('label', '?')}, peak {peak:g} TFLOPS / "
                f"{plat.get('peak_hbm_gbps'):g} GB/s" if peak
                else f"{plat.get('label', plat.get('platform', '?'))} — "
                     "MFU unrated")
        lines.append(f"program roofline ({head}):")
        lines.append(
            f"  {'program':<34} {'flops':>9} {'bytes':>9} {'inten':>6} "
            f"{'wall p50':>9} {'achieved':>9} {'mfu':>6}  verdict")
        for r in lrows[:top]:
            name = r.get("name", "?")
            if r.get("replica") is not None:
                name = f"[{r['replica']}] {name}"
            ach = r.get("achieved_tflops")
            mfu = r.get("mfu")
            inten = r.get("arith_intensity")
            row = (f"  {name:<34} {_fmt_qty(r.get('flops')):>9} "
                   f"{_fmt_qty(r.get('bytes_accessed'), 'B'):>9} ")
            row += f"{inten:>6.2f}" if inten is not None else f"{'-':>6}"
            row += (f" {_fmt_s(r['wall_p50_s']):>9}" if r.get("wall_p50_s")
                    else f" {'-':>9}")
            row += f" {ach:>8.3f}T" if ach is not None else f" {'-':>9}"
            row += f" {mfu:>6.1%}" if mfu is not None else f" {'-':>6}"
            row += f"  {r.get('roofline', '?')}"
            if r.get("error"):
                row += "  [unresolved]"
            lines.append(row)
        if len(lrows) > top:
            lines.append(f"  ... +{len(lrows) - top} more programs")
        lines.append("")

    # -- hbm memory ledger ------------------------------------------------
    hrows = hbm_tables(snap)
    if hrows:
        lines.append("hbm memory ledger:")
        for h in hrows:
            prefix = (f"  [{h['replica']}] " if h.get("replica") is not None
                      else "  ")
            pools = h.get("pools", {})
            body = " ".join(f"{k}={_fmt_qty(v, 'B')}"
                            for k, v in sorted(pools.items()))
            lines.append(prefix + (body or "(no pools)"))
            dev = h.get("device")
            if dev:
                warn = ""
                if h.get("warn"):
                    warn = (f"  <-- WARN: in-use past "
                            f"{h.get('warn_fraction', 0):.0%} of limit")
                lines.append(
                    f"{prefix}device: in-use {_fmt_qty(dev.get('bytes_in_use'), 'B')} "
                    f"peak {_fmt_qty(dev.get('peak_bytes_in_use'), 'B')} "
                    f"limit {_fmt_qty(dev.get('bytes_limit'), 'B')}{warn}")
            else:
                lines.append(
                    f"{prefix}pool total {_fmt_qty(h.get('pool_total_bytes'), 'B')} "
                    "(backend reports no memory stats)")
        lines.append("")

    # -- comm reconcile warnings ----------------------------------------
    # host byte accounting vs HLO-derived collectives (comm/logger.py
    # reconcile): a mismatch is SURFACED as a labeled warning, never
    # silently averaged away — an axis XLA collected over that the host
    # never logged is a collective that bypassed the comm/ wrappers
    rrows = reconcile_rows(snap)
    bad = [r for r in rrows if r.get("verdict") != "ok"]
    if bad:
        lines.append("comm reconcile WARNINGS (host accounting vs HLO):")
        for r in bad:
            prefix = (f"  [{r['replica']}] " if r.get("replica") is not None
                      else "  ")
            lines.append(
                f"{prefix}axis {r['axis']}: {r['verdict']} — host "
                f"{r['host_count']} ops / {_fmt_qty(r['host_bytes'], 'B')}, "
                f"hlo {r['hlo_count']} ops / {_fmt_qty(r['hlo_bytes'], 'B')}")
        lines.append("")

    # -- requests -------------------------------------------------------
    ttfts = sorted(ev["ttft_s"] for ev in events
                   if ev.get("type") == "request" and "ttft_s" in ev)
    tpots = sorted(ev["tpot_s"] for ev in events
                   if ev.get("type") == "request" and ev.get("tpot_s", 0) > 0)
    if ttfts:
        lines.append(f"request latency ({len(ttfts)} requests):")
        lines.append(
            f"  ttft     p50={_fmt_s(_pct(ttfts, .5))} p90={_fmt_s(_pct(ttfts, .9))} "
            f"p99={_fmt_s(_pct(ttfts, .99))}")
        if tpots:
            lines.append(
                f"  per-tok  p50={_fmt_s(_pct(tpots, .5))} p90={_fmt_s(_pct(tpots, .9))} "
                f"p99={_fmt_s(_pct(tpots, .99))}")
        lines.append("")

    # -- prefix cache ---------------------------------------------------
    pc = snap.get("prefix_cache") if snap is not None else None
    if pc:
        total = pc.get("hits", 0) + pc.get("misses", 0)
        lines.append(
            f"prefix cache ({pc.get('used_slots', 0)}/{pc.get('n_slots', 0)} "
            f"pool slots, block {pc.get('block', '?')}, "
            f"policy {pc.get('insert_policy', '?')}):")
        lines.append(
            f"  lookups={total} hit_rate={pc.get('hit_rate', 0.0):.1%} "
            f"tokens_reused={pc.get('tokens_reused', 0)} "
            f"inserts={pc.get('inserts', 0)} evictions={pc.get('evictions', 0)} "
            f"insert_skips={pc.get('insert_skips', 0)}")
        entries = pc.get("entries", [])
        if entries:
            lines.append(f"  {'length':>8} {'hits':>6} {'refs':>6} {'pool_slot':>10}")
            for e in entries[:top]:
                lines.append(
                    f"  {e['length']:>8} {e['hits']:>6} {e['refs']:>6} "
                    f"{e['pool_slot']:>10}")
            if len(entries) > top:
                lines.append(f"  ... +{len(entries) - top} more entries")
        lines.append("")

    # -- speculative decoding -------------------------------------------
    # acceptance economics (inference/serving.py spec_stats + the
    # serving/spec_* metrics): drafted vs accepted totals, the acceptance
    # rate, and the burst-size distribution — "is speculation paying for
    # its verify steps" is answerable from CI logs
    sp = snap.get("speculation") if snap is not None else None
    if sp:
        lines.append(
            f"speculative decoding (depth {sp.get('depth', '?')}, "
            f"source {sp.get('draft_source', '?')}):")
        lines.append(
            f"  verify_steps={sp.get('verify_steps', 0)} "
            f"drafted={sp.get('drafted', 0)} accepted={sp.get('accepted', 0)} "
            f"acceptance_rate={sp.get('acceptance_rate', 0.0):.1%}")
        hists = (snap.get("metrics", {}) or {}).get("histograms", {})
        burst = hists.get("serving/spec_burst_tokens")
        if burst:
            lines.append(
                f"  burst tokens/step: mean={burst.get('mean', 0.0):.2f} "
                f"p50={burst.get('p50', 0.0):.0f} p90={burst.get('p90', 0.0):.0f} "
                f"max={burst.get('max', 0.0):.0f} "
                f"({int(burst.get('count', 0))} verify steps)")
        lines.append("")

    # -- serving router -------------------------------------------------
    # per-replica fleet view (inference/router.py telemetry_snapshot):
    # health state + traffic counts, so a failed-over / drained replica is
    # visible at a glance in CI logs
    rt = snap.get("router") if snap is not None else None
    if rt:
        reps = rt.get("replicas", {})
        lines.append(
            f"serving router ({len(reps)} replicas, "
            f"{rt.get('steps', 0)} steps, "
            f"{rt.get('live_requests', 0)} in flight):")
        lines.append(
            f"  {'replica':>7} {'state':<10} {'dispatched':>10} "
            f"{'failed_over':>11} {'drained':>8} {'completed':>10} {'load':>6}")
        for rid in sorted(reps, key=str):
            d = reps[rid]
            lines.append(
                f"  {rid!s:>7} {d.get('state', '?'):<10} "
                f"{d.get('dispatched', 0):>10} {d.get('failed_over', 0):>11} "
                f"{d.get('drained', 0):>8} {d.get('completed', 0):>10} "
                f"{d.get('load', 0):>6}")
        cs = {k.split("/", 1)[1]: v
              for k, v in rt.get("metrics", {}).get("counters", {}).items()
              if k.startswith("router/")}
        if cs:
            lines.append("  " + " ".join(
                f"{k}={v:g}" for k, v in sorted(cs.items())))
        rsp = rt.get("speculation")
        if rsp:
            # fleet-summed acceptance (Router._spec_aggregate): the
            # per-replica blocks render in their own engine snapshots
            lines.append(
                f"  speculation: drafted={rsp.get('drafted', 0)} "
                f"accepted={rsp.get('accepted', 0)} "
                f"acceptance_rate={rsp.get('acceptance_rate', 0.0):.1%} "
                f"verify_steps={rsp.get('verify_steps', 0)}")
        lines.append("")

    # -- per-tenant isolation --------------------------------------------
    # policy vs accounting per tenant (docs/serving.md "Multi-tenant
    # isolation"): DWRR weight/quota and live load from router_stats,
    # counters and latency percentiles aggregated over the router registry
    # plus every replica engine registry (tenant/<id>/* names)
    tens = (rt.get("tenants") if rt else None) or {}
    tregs = [m for m in
             ([rt.get("metrics", {})] if rt else [])
             + [rep.get("metrics", {}) for rep in
                ((snap.get("replicas") or {}).values() if snap else ())]
             if m]
    tids = set(tens)
    for m in tregs:
        for kind in ("counters", "gauges", "histograms"):
            for name in m.get(kind, {}):
                if name.startswith("tenant/"):
                    tids.add(name.split("/", 2)[1])
    if tids:
        def _tsum(kind, tid, metric):
            return sum(m.get(kind, {}).get(f"tenant/{tid}/{metric}", 0)
                       for m in tregs)

        def _tp(tid, metric, q):
            # worst-replica percentile: exact cross-replica merge would
            # need the raw buckets, and the conservative bound is what an
            # isolation drill asserts against anyway
            return max((m.get("histograms", {})
                        .get(f"tenant/{tid}/{metric}", {}).get(q, 0.0)
                        for m in tregs), default=0.0)

        lines.append(f"per-tenant isolation ({len(tids)} tenants):")
        lines.append(
            f"  {'tenant':<12} {'weight':>6} {'quota':>5} {'live':>5} "
            f"{'req':>6} {'rej':>5} {'shed':>5} {'429':>5} "
            f"{'slo ok/miss':>12} {'ttft p50/p99':>17} {'q':>4} {'slots':>5}")
        for tid in sorted(tids):
            pol = tens.get(tid, {})
            flag = "  <-- over quota" if pol.get("over_quota") else ""
            slo_cell = (f"{_tsum('counters', tid, 'slo_ok'):g}/"
                        f"{_tsum('counters', tid, 'slo_miss'):g}")
            ttft_cell = (f"{_fmt_s(_tp(tid, 'ttft_sec', 'p50'))}/"
                         f"{_fmt_s(_tp(tid, 'ttft_sec', 'p99'))}")
            lines.append(
                f"  {tid:<12} {pol.get('weight', 1.0):>6g} "
                f"{pol.get('max_queued', 0):>5} {pol.get('live', 0):>5} "
                f"{_tsum('counters', tid, 'requests'):>6g} "
                f"{_tsum('counters', tid, 'rejected'):>5g} "
                f"{_tsum('counters', tid, 'sheds'):>5g} "
                f"{_tsum('counters', tid, 'rate_limited'):>5g} "
                f"{slo_cell:>12} {ttft_cell:>17} "
                f"{_tsum('gauges', tid, 'queued'):>4g} "
                f"{_tsum('gauges', tid, 'slots'):>5g}{flag}")
        lines.append("")

    # -- autoscaler -----------------------------------------------------
    # the elasticity loop's decision ring (inference/autoscaler.py):
    # target/brownout state plus the typed scale/respawn/brownout events,
    # so "why did the fleet grow at t=3.2s" is answerable from CI logs
    asc = rt.get("autoscale") if rt else None
    if asc:
        lines.append(
            f"autoscaler (target {asc.get('target', '?')} in "
            f"[{asc.get('min', '?')}, {asc.get('max', '?')}], brownout "
            f"{'ON' if asc.get('brownout') else 'off'}):")
        asc_events = asc.get("events", [])
        for ev in asc_events[-top:]:
            detail = " ".join(
                f"{k}={v}" for k, v in ev.items()
                if k not in ("t", "kind", "signals"))
            sig = ev.get("signals")
            if sig:
                detail += ("  [" + " ".join(
                    f"{k}={v}" for k, v in sig.items()
                    if v is not None) + "]")
            lines.append(f"  {_fmt_s(ev.get('t', 0.0)):>10} "
                         f"{ev.get('kind', '?'):<14} {detail}")
        if len(asc_events) > top:
            lines.append(f"  ... +{len(asc_events) - top} earlier events")
        lines.append("")

    # -- slo attainment / burn rates -------------------------------------
    # the tracker's last verdict (telemetry/slo.py, riding the router
    # snapshot): attainment vs target per dimension plus the multi-window
    # burn pair, with the fast-burn breach flagged loudly
    slo = rt.get("slo") if rt else None
    if slo:
        head = (f"slo (window {_fmt_s(slo.get('window_s', 0.0))}, burn "
                f"windows {_fmt_s(slo.get('fast_window_s', 0.0))}/"
                f"{_fmt_s(slo.get('slow_window_s', 0.0))})")
        if slo.get("breach"):
            head += ("  <-- FAST-BURN BREACH: "
                     + ",".join(slo.get("breach_dims", [])))
        lines.append(head + ":")
        lines.append(f"  {'dimension':<14} {'attainment':>10} {'target':>8} "
                     f"{'burn fast':>10} {'burn slow':>10}")
        att = slo.get("attainment", {})
        burn = slo.get("burn", {})
        targets = slo.get("targets", {})
        for dim in ("ttft", "tpot", "availability"):
            b = burn.get(dim, {})
            lines.append(
                f"  {dim:<14} {att.get(dim, 1.0):>10.4f} "
                f"{targets.get(dim, 0.0):>8.4f} {b.get('fast', 0.0):>10.2f} "
                f"{b.get('slow', 0.0):>10.2f}")
        lines.append("")

    # -- flight-recorder rings -------------------------------------------
    # one line per series: last raw cell + coverage, so "was the fleet
    # sampling" and "what did queue depth look like" answer from CI logs
    rings = rt.get("rings") if rt else None
    if rings:
        srcs = [("router", rings.get("router", {}))]
        srcs += sorted((f"replica {rid}", s)
                       for rid, s in (rings.get("replicas") or {}).items())
        n_series = sum(len(s.get("series", {})) for _, s in srcs)
        lines.append(f"flight recorder rings ({n_series} series):")
        for label, store in srcs:
            for name, tiers in sorted(store.get("series", {}).items()):
                raw = None
                for cells in tiers.values():
                    if cells:
                        raw = cells[-1] if raw is None or \
                            cells[-1][0] > raw[0] else raw
                if raw is None:
                    continue
                t, lo, hi, s, n = raw
                lines.append(
                    f"  {label:<11} {name:<34} last@{_fmt_s(t):>9} "
                    f"min={lo:g} max={hi:g} sum={s:g} n={int(n)}")
        lines.append("")

    # -- incident bundles ------------------------------------------------
    incs = rt.get("incidents") if rt else None
    if incs:
        lines.append(f"incident bundles ({len(incs)}, newest first — "
                     "inspect with bin/dstpu_autopsy):")
        for b in incs[:top]:
            lines.append(f"  #{b.get('seq', 0):>4} {b.get('kind', '?'):<18} "
                         f"{_fmt_qty(b.get('bytes'), 'B'):>10}  "
                         f"{b.get('file', '')}")
        if len(incs) > top:
            lines.append(f"  ... +{len(incs) - top} older bundles")
        lines.append("")

    # -- resilience -----------------------------------------------------
    # recovery/degradation events (resilience/* counters) + injector stats,
    # rendered as their own table so a faulted run's triage starts here
    res_counters = {}
    if snap is not None:
        for name, v in snap.get("metrics", {}).get("counters", {}).items():
            if name.startswith("resilience/"):
                res_counters[name.split("/", 1)[1]] = v
    fi = snap.get("fault_injection") if snap is not None else None
    res_hists = {}
    if snap is not None:
        for name, h in snap.get("metrics", {}).get("histograms", {}).items():
            if name.startswith("resilience/"):
                res_hists[name.split("/", 1)[1]] = h
    if res_counters or fi or res_hists:
        lines.append("resilience:")
        if res_counters:
            lines.append("  " + " ".join(
                f"{k}={v:g}" for k, v in sorted(res_counters.items())))
        for name, h in sorted(res_hists.items()):
            # jit_ckpt_sec (preemption checkpoint latency) / reshard_sec
            # (resume load+reshard) — the elastic loop's two wall-clock costs
            lines.append(
                f"  {name}: n={h['count']} p50={_fmt_s(h['p50'])} "
                f"p90={_fmt_s(h['p90'])} p99={_fmt_s(h['p99'])}")
        if fi:
            inj = fi.get("injected", {})
            opp = fi.get("opportunities", {})
            lines.append("  injected: " + (" ".join(
                f"{site}={inj[site]}/{opp.get(site, 0)}"
                for site in sorted(opp)) or "none"))
        statuses = defaultdict(int)
        for ev in events:
            if ev.get("type") == "request" and ev.get("status", "ok") != "ok":
                statuses[ev["status"]] += 1
        if statuses:
            lines.append("  degraded requests: " + " ".join(
                f"{k}={v}" for k, v in sorted(statuses.items())))
        lines.append("")

    # -- chaos fault-site coverage (docs/resilience.md "Chaos conductor"):
    # chaos/site/<name>/fired counts schedules where the site's fault
    # actually fired; /survived counts those that then passed every
    # invariant oracle. fired > survived means a schedule tripped — look
    # for a chaos-repro artifact.
    chaos = {}
    if snap is not None:
        for name, v in snap.get("metrics", {}).get("counters", {}).items():
            if name.startswith("chaos/site/"):
                parts = name.split("/")
                if len(parts) == 4:
                    chaos.setdefault(parts[2], {})[parts[3]] = v
    if chaos:
        lines.append(f"chaos fault-site coverage ({len(chaos)} sites):")
        lines.append(f"  {'site':<20} {'fired':>7} {'survived':>9}  verdict")
        for site in sorted(chaos):
            fired = chaos[site].get("fired", 0)
            survived = chaos[site].get("survived", 0)
            verdict = "green" if survived >= fired else "TRIPPED"
            lines.append(f"  {site:<20} {fired:>7g} {survived:>9g}  {verdict}")
        lines.append("")

    if snap is not None:
        metrics = snap.get("metrics", {})
        lines.append("last registry snapshot:")
        for name, v in metrics.get("counters", {}).items():
            lines.append(f"  {name:<44} {v:g}")
        for name, v in metrics.get("gauges", {}).items():
            lines.append(f"  {name:<44} {v:g}")
        for name, h in metrics.get("histograms", {}).items():
            # only time-suffixed metrics render with time units
            timed = name.endswith(("_sec", "_s")) or name.startswith("span/")
            fmt = _fmt_s if timed else (lambda v: f"{v:g}")
            lines.append(
                f"  {name:<44} n={h['count']} p50={fmt(h['p50'])} "
                f"p90={fmt(h['p90'])} p99={fmt(h['p99'])}")
        lines.append("")

    if not lines:
        lines.append("no telemetry events found")
    return "\n".join(lines).rstrip() + "\n"


def request_table(events: list[dict]) -> list[dict]:
    """Per-request rows from ``request`` events — the machine-readable
    twin of the latency-percentile section."""
    return [{k: ev[k] for k in ("uid", "slot", "prompt_len", "n_tokens",
                                "ttft_s", "tpot_s", "status", "arrival_s",
                                "finish_s", "prefix_hit_tokens") if k in ev}
            for ev in events if ev.get("type") == "request"]


def format_step_anatomy(snap: dict | None, top: int = 10) -> str:
    """Render the step-anatomy table (``--step-anatomy``): per watched
    program, where the milliseconds go — modeled compute/HBM/comm-by-axis
    time, the exposed-comm estimate, and the static overlap verdict read
    from the compiled HLO. Unrated platforms show labeled ``-`` times."""
    rows = anatomy_rows(snap)
    if not rows:
        return "no step-anatomy rows in the last snapshot\n"

    def _t(v):
        return _fmt_s(v) if v is not None else "-"

    lines = [f"step anatomy ({len(rows)} programs):",
             f"  {'program':<34} {'wall p50':>9} {'compute':>9} {'hbm':>9} "
             f"{'comm':>9} {'exposed':>9}  overlap"]
    for r in rows[:top]:
        name = r.get("name", "?")
        if r.get("replica") is not None:
            name = f"[{r['replica']}] {name}"
        lines.append(
            f"  {name:<34} {_t(r.get('wall_p50_s')):>9} "
            f"{_t(r.get('compute_time_s')):>9} {_t(r.get('hbm_time_s')):>9} "
            f"{_t(r.get('comm_time_s')):>9} "
            f"{_t(r.get('exposed_comm_estimate_s')):>9}  "
            f"{r.get('overlap_verdict', '?')}")
        ctba = r.get("comm_time_by_axis")
        cbba = r.get("comm_bytes_by_axis") or {}
        if ctba:
            lines.append("      comm by axis: " + " ".join(
                f"{ax}={_fmt_s(t)} ({_fmt_qty(cbba.get(ax), 'B')})"
                for ax, t in sorted(ctba.items())))
        elif cbba:
            lines.append("      comm bytes by axis (unrated, no time "
                         "model): " + " ".join(
                             f"{ax}={_fmt_qty(b, 'B')}"
                             for ax, b in sorted(cbba.items())))
        pipe = r.get("pipeline")
        if pipe:
            lines.append(
                f"      pipeline: {pipe.get('num_stages')} stages x "
                f"{pipe.get('micro_batches')} microbatches "
                f"({pipe.get('schedule')}), bubble "
                f"{pipe.get('bubble_fraction', 0.0):.1%}")
    if len(rows) > top:
        lines.append(f"  ... +{len(rows) - top} more programs")
    return "\n".join(lines) + "\n"


def format_timeline(timeline: list[dict]) -> str:
    """Render one request's merged lifecycle timeline."""
    if not timeline:
        return "no trace events for that request\n"
    uid = timeline[0].get("uid")
    lines = [f"request {uid} timeline ({len(timeline)} events):",
             f"  {'t':>10} {'replica':>8} {'event':<12} detail"]
    for ev in timeline:
        detail = " ".join(
            f"{k}={v}" for k, v in ev.items()
            if k not in ("uid", "event", "t", "replica_id"))
        lines.append(
            f"  {_fmt_s(ev.get('t', 0.0)):>10} "
            f"{str(ev.get('replica_id', '-')):>8} {ev['event']:<12} {detail}")
    return "\n".join(lines) + "\n"


_CLEAR = "\x1b[2J\x1b[H"  # ANSI: clear screen + cursor home


def watch_loop(render, interval_s: float, *, out=None, sleep=None,
               iterations=None) -> int:
    """``--watch`` driver: clear the screen and re-render every
    ``interval_s`` seconds until interrupted. ``render()`` returns the
    full text per frame (re-reading the JSONL — the file grows under us).
    ``out``/``sleep``/``iterations`` are injectable for tests (a fake
    clock and a frame budget make this host-only testable)."""
    out = out if out is not None else sys.stdout
    sleep = sleep if sleep is not None else time.sleep
    frames = 0
    try:
        while iterations is None or frames < iterations:
            out.write(_CLEAR)
            out.write(render())
            out.flush()
            frames += 1
            if iterations is not None and frames >= iterations:
                break
            sleep(interval_s)
    except KeyboardInterrupt:
        pass  # ctrl-C ends the watch cleanly, not with a traceback
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.telemetry.report",
        description="Pretty-print a telemetry JSONL run summary.")
    ap.add_argument("jsonl", help="path to the telemetry JSONL event log")
    ap.add_argument("--top", type=int, default=10, help="span rows to show")
    ap.add_argument("--watch", type=float, default=None, metavar="N",
                    help="re-render the summary every N seconds (screen "
                         "clears between frames; ctrl-C exits)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output: {snapshot, roofline, "
                         "hbm, requests[, request_timeline]}")
    ap.add_argument("--request", type=int, default=None, metavar="UID",
                    help="print one request's merged lifecycle timeline")
    ap.add_argument("--step-anatomy", action="store_true",
                    help="print the step-anatomy table (compute/hbm/comm "
                         "time split, exposed-comm estimate, HLO overlap "
                         "verdict per program)")
    ap.add_argument("--perfetto", metavar="PATH", default=None,
                    help="write the last snapshot's request timelines as "
                         "Chrome-trace JSON (ui.perfetto.dev)")
    args = ap.parse_args(argv)
    if args.watch is not None:
        if args.watch <= 0:
            ap.error("--watch interval must be > 0 seconds")
        return watch_loop(
            lambda: summarize(load_events(args.jsonl), top=args.top),
            args.watch)
    events = load_events(args.jsonl)
    snap = last_snapshot(events)

    if args.perfetto:
        timeline = request_timeline(snap or {})
        with open(args.perfetto, "w") as f:
            json.dump(to_perfetto(timeline), f)
        print(f"wrote {len(timeline)} trace events for "
              f"{len({e['uid'] for e in timeline})} requests to "
              f"{args.perfetto}", file=sys.stderr)

    if args.json:
        out = {
            "snapshot": snap,
            "roofline": ledger_rows(snap),
            "hbm": hbm_tables(snap),
            "step_anatomy": anatomy_rows(snap),
            "comm_reconcile": reconcile_rows(snap),
            "requests": request_table(events),
        }
        if args.request is not None:
            out["request_timeline"] = request_timeline(snap or {},
                                                       uid=args.request)
        json.dump(out, sys.stdout)
        sys.stdout.write("\n")
        return 0

    if args.request is not None:
        print(format_timeline(request_timeline(snap or {}, uid=args.request)),
              end="")
        return 0

    if args.step_anatomy:
        print(format_step_anatomy(snap, top=args.top), end="")
        return 0

    if args.perfetto:
        return 0
    print(summarize(events, top=args.top), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
