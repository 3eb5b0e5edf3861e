"""Incident-bundle autopsy: reconstruct a human-readable timeline (a copy
of ``deepspeed_tpu/telemetry/autopsy.py``; run it as ``python -m
deepspeed_tpu_torch.telemetry.autopsy BUNDLE``).

It loads a ``dstpu-incident/1`` bundle written by
``telemetry/incident.IncidentRecorder`` and renders the incident as one
merged timeline: the typed triggers, every request-trace event captured in
the window (admitted / first_token / failover / terminal edges, with
replica attribution), rolling-upgrade waves, autoscale decisions, and a
per-series summary of the flight-recorder ring window around the trigger —
so "what happened around the SIGKILL" is one command, not a JSONL dig.

CLI contract (shared with dstpu-lint/dstpu-audit, the dstpu-findings/1
conventions): exit 0 = bundle loaded and internally consistent, 1 =
bundle loaded but incomplete/inconsistent (problems are listed; the
partial timeline still prints), 2 = usage error / unreadable input.
``--format json`` emits the reconstruction machine-readably; ``--perfetto
OUT`` additionally writes the captured request events as Chrome-trace JSON
(ui.perfetto.dev); ``--list DIR`` tabulates a bundle directory.

Stdlib-only apart from the package's own ``request_trace``: an autopsy
needs no device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from .request_trace import sort_timeline, to_perfetto

SCHEMA = "dstpu-incident/1"
_FILE_RE = re.compile(r"^incident-(\d{6})-([a-z0-9_]+)\.json$")

# sections a complete bundle carries; a missing one is a finding (exit 1),
# not a crash — half a flight recording still beats none
_EXPECTED = ("triggers", "window", "rings")


def load_bundle(path: str) -> dict:
    """Parse and schema-check one bundle. Raises ValueError (bad JSON /
    wrong schema) or OSError (unreadable)."""
    with open(path, encoding="utf-8") as f:
        try:
            data = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: not valid JSON ({e})") from e
    if not isinstance(data, dict) or data.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a {SCHEMA} bundle")
    return data


def validate(bundle: dict) -> list[str]:
    """Consistency problems (empty list = clean)."""
    problems = []
    for key in _EXPECTED:
        if not bundle.get(key):
            problems.append(f"bundle has no {key!r} section")
    trig = bundle.get("triggers") or []
    if trig and bundle.get("kind") != trig[0].get("kind"):
        problems.append("bundle kind does not match its first trigger")
    win = bundle.get("window") or {}
    for ev in bundle.get("trace_events") or []:
        if not isinstance(ev, dict) or "uid" not in ev:
            problems.append("trace_events contains a non-event entry")
            break
    if win and win.get("t0", 0.0) > win.get("t1", 0.0):
        problems.append("ring window is inverted (t0 > t1)")
    return problems


def _ring_rows(bundle: dict) -> list[dict]:
    """Per-series min/mean/max over the captured ring window — flattened
    across the router/replica sub-blocks the Router context writes."""
    rings = bundle.get("rings") or {}
    sources: list[tuple[str, dict]] = []
    if "series" in rings:  # engine-level bundle: one flat store
        sources.append((bundle.get("source", "engine"), rings))
    else:
        for src, block in rings.items():
            if isinstance(block, dict) and "series" in block:
                sources.append((src, block))
            elif isinstance(block, dict):
                for rid, sub in block.items():
                    if isinstance(sub, dict) and "series" in sub:
                        sources.append((f"{src}[{rid}]", sub))
    rows = []
    for src, block in sources:
        for name, cells in sorted((block.get("series") or {}).items()):
            if not cells:
                continue
            n = sum(int(c[4]) for c in cells)
            total = sum(float(c[3]) for c in cells)
            rows.append({
                "source": src, "series": name, "cells": len(cells),
                "min": min(float(c[1]) for c in cells),
                "max": max(float(c[2]) for c in cells),
                "mean": (total / n) if n else 0.0,
                "sum": total,
            })
    return rows


def build_timeline(bundle: dict) -> list[dict]:
    """One merged, chronologically sorted event list: triggers + request
    trace + upgrade waves + autoscale decisions."""
    rows: list[dict] = []
    for ev in bundle.get("triggers") or []:
        rows.append({"t": float(ev.get("t", 0.0)), "source": "trigger",
                     "event": ev.get("kind", "?"),
                     **{k: v for k, v in ev.items()
                        if k not in ("t", "kind")}})
    for ev in bundle.get("trace_events") or []:
        if isinstance(ev, dict) and "event" in ev:
            rows.append({"t": float(ev.get("t", 0.0)),
                         "source": f"replica {ev['replica_id']}"
                         if "replica_id" in ev else "trace",
                         **{k: v for k, v in ev.items()
                            if k != "replica_id"}})
    upgrade = bundle.get("upgrade") or {}
    waves = list(upgrade.get("waves") or [])
    if upgrade.get("current"):
        waves.append(upgrade["current"])
    for i, w in enumerate(waves):
        if not isinstance(w, dict):
            continue
        rows.append({"t": float(w.get("t_start", w.get("t", 0.0)) or 0.0),
                     "source": "upgrade",
                     "event": f"wave[{i}] {w.get('phase', '?')}"
                              f" -> {w.get('outcome', 'in-progress')}",
                     "old_rid": w.get("old_rid"), "new_rid": w.get("new_rid")})
    auto = bundle.get("autoscale") or {}
    for ev in auto.get("events") or []:
        if isinstance(ev, dict):
            rows.append({"t": float(ev.get("t", 0.0)), "source": "autoscale",
                         "event": ev.get("kind", "?"),
                         **{k: v for k, v in ev.items()
                            if k not in ("t", "kind")}})
    return sort_timeline(rows)


def _fmt_row(row: dict) -> str:
    extra = " ".join(f"{k}={v}" for k, v in sorted(row.items())
                     if k not in ("t", "source", "event", "uid")
                     and v is not None)
    uid = f" uid={row['uid']}" if "uid" in row else ""
    return (f"  {row['t']:>10.3f}s  {row['source']:<12} "
            f"{row.get('event', '?')}{uid}{('  ' + extra) if extra else ''}")


def format_text(bundle: dict, problems: list[str]) -> str:
    out = []
    win = bundle.get("window") or {}
    out.append(f"incident: {bundle.get('kind')} @ "
               f"t={bundle.get('t_trigger', 0.0):.3f}s "
               f"(source {bundle.get('source', '?')}, "
               f"{len(bundle.get('triggers') or [])} trigger(s), window "
               f"[{win.get('t0', 0.0):.3f}s, {win.get('t1', 0.0):.3f}s])")
    slo = bundle.get("slo") or {}
    if slo:
        att = slo.get("attainment") or {}
        out.append("slo: " + "  ".join(
            f"{d}={att.get(d, 1.0):.4f}" for d in sorted(att))
            + (f"  FAST-BURN {','.join(slo.get('breach_dims') or [])}"
               if slo.get("breach") else ""))
    rows = _ring_rows(bundle)
    if rows:
        out.append("ring window:")
        for r in rows:
            out.append(f"  {r['source']:<12} {r['series']:<34} "
                       f"cells={r['cells']:<4} min={r['min']:.4g} "
                       f"mean={r['mean']:.4g} max={r['max']:.4g} "
                       f"sum={r['sum']:.4g}")
    timeline = build_timeline(bundle)
    out.append(f"timeline ({len(timeline)} events):")
    out.extend(_fmt_row(row) for row in timeline)
    fleet = bundle.get("fleet") or {}
    states = fleet.get("replicas") or {}
    if states:
        out.append("fleet at capture: " + "  ".join(
            f"replica {rid}={info.get('state', '?')}"
            f"(completed={info.get('completed', 0)},"
            f"failed_over={info.get('failed_over', 0)})"
            for rid, info in sorted(states.items(), key=lambda kv: str(kv[0]))))
    if bundle.get("journal"):
        j = bundle["journal"]
        out.append(f"journal: {j}")
    if bundle.get("context_error"):
        problems = problems + [f"context capture failed: "
                               f"{bundle['context_error']}"]
    if problems:
        out.append("problems:")
        out.extend(f"  - {p}" for p in problems)
    else:
        out.append("bundle consistent")
    return "\n".join(out)


def list_dir(dirpath: str) -> list[dict]:
    out = []
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return []
    for n in names:
        m = _FILE_RE.match(n)
        if not m:
            continue
        path = os.path.join(dirpath, n)
        try:
            size = os.stat(path).st_size
        except OSError:
            continue
        out.append({"seq": int(m.group(1)), "kind": m.group(2),
                    "file": n, "path": path, "bytes": size})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.telemetry.autopsy",
        description="Reconstruct an incident timeline from a "
                    "dstpu-incident/1 bundle (exit 0 consistent, "
                    "1 findings, 2 usage)")
    ap.add_argument("bundle", nargs="?", help="bundle JSON path")
    ap.add_argument("--list", metavar="DIR", dest="list_dir",
                    help="tabulate a bundle directory instead")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--perfetto", metavar="OUT",
                    help="also write captured request events as "
                         "Chrome-trace JSON")
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        return 2  # argparse's own exit is remapped onto the contract
    if args.list_dir:
        entries = list_dir(args.list_dir)
        if args.format == "json":
            print(json.dumps({"schema": SCHEMA, "bundles": entries},
                             indent=2))
        else:
            for e in entries:
                print(f"{e['file']}  kind={e['kind']}  {e['bytes']}B")
            print(f"{len(entries)} bundle(s) in {args.list_dir}")
        return 0
    if not args.bundle:
        ap.print_usage(sys.stderr)
        return 2
    try:
        bundle = load_bundle(args.bundle)
    except (OSError, ValueError) as e:
        print(f"autopsy: {e}", file=sys.stderr)
        return 2
    problems = validate(bundle)
    if args.perfetto:
        events = [ev for ev in bundle.get("trace_events") or []
                  if isinstance(ev, dict) and "uid" in ev and "event" in ev]
        with open(args.perfetto, "w", encoding="utf-8") as f:
            json.dump(to_perfetto(events), f)
    if args.format == "json":
        print(json.dumps({
            "schema": SCHEMA,
            "kind": bundle.get("kind"),
            "source": bundle.get("source"),
            "t_trigger": bundle.get("t_trigger"),
            "timeline": build_timeline(bundle),
            "rings": _ring_rows(bundle),
            "slo": bundle.get("slo"),
            "problems": problems,
        }, indent=2, default=str))
    else:
        print(format_text(bundle, problems))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
