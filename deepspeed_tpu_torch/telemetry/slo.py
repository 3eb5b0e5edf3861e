"""SLO attainment and multi-window burn rates over the telemetry rings (a
copy of ``deepspeed_tpu/telemetry/slo.py``, stdlib only).

Three objectives (the ``telemetry.slo`` config block, mirrored into
``serving.slo``): TTFT latency, TPOT latency, and availability. The serving
engine classifies every terminal request against the latency thresholds at
finish time — four plain counters (``slo/requests``, ``slo/failures``,
``slo/ttft_violations``, ``slo/tpot_violations``) whose per-interval deltas
the flight-recorder rings capture (telemetry/timeseries.py). This tracker
then computes, from window sums over those rings:

  * rolling attainment — ``1 - errors/requests`` over ``window_s``;
  * multi-window burn rates — the SRE-book method: the error budget is
    ``1 - target``, and ``burn = error_rate / budget`` over a FAST window
    (the pager: a burn of 14.4 over 5 minutes exhausts a 30-day budget in
    ~2 days) and a SLOW window (the confirmation: filters blips). The
    classic 5m/1h pair is the default, scaled to the fleet clock by config
    so drills and tests can use second-scale windows;
  * a fast-burn breach verdict — any dimension's fast burn at/over
    ``fast_burn_threshold`` — published as a gauge and consumed by the
    incident recorder as a typed trigger on the rising edge.

Everything is published as ``slo/*`` gauges into the owning registry, so
the report CLI and the gateway's ``/metrics`` export them with zero extra
plumbing. Stdlib-only, host-side, O(window/interval) per evaluation.
"""

from __future__ import annotations

# (dimension, error-counter series, attainment/burn gauge names) — the
# gauge names are spelled out literally at the publish sites below so the
# metric-doc-drift lint can pair them with the docs/observability.md rows.
_DIMS = ("ttft", "tpot", "availability")


class SLOTracker:
    """Rolling SLO evaluation over one or more ``TimeSeriesStore``s.

    ``stores`` is a zero-arg callable returning the stores to sum over —
    the Router passes its own rings plus every per-replica mirror, so a
    dead replica's last-flushed cells still count. ``cfg`` is an
    ``SLOConfig`` (runtime/config.py) or any object with the same fields.
    """

    def __init__(self, cfg, registry, stores):
        self.cfg = cfg
        self.registry = registry
        self._stores = stores
        self.last: dict = {}
        self._breach = False  # previous verdict, for rising-edge detection

    # -- window math -----------------------------------------------------

    def _sum(self, name: str, t0: float, t1: float) -> float:
        total = 0.0
        for store in self._stores():
            s, _ = store.window_sum(name, t0, t1)
            total += s
        return total

    def _error_rate(self, dim: str, t0: float, t1: float) -> float:
        """Errors / requests over a window (0 when no traffic — an idle
        fleet is not failing its SLO)."""
        errors = self._sum("slo/failures" if dim == "availability"
                           else f"slo/{dim}_violations", t0, t1)
        base = self._sum("slo/requests", t0, t1)
        return (errors / base) if base > 0 else 0.0

    # -- evaluation ------------------------------------------------------

    def evaluate(self, now: float) -> dict:
        """Compute attainment + burns, publish the ``slo/*`` gauges, and
        return the result dict. ``breach_rising`` is True exactly on the
        False->True transition of the fast-burn verdict — the incident
        trigger fires once per breach episode, not once per step."""
        cfg = self.cfg
        g = self.registry.gauge
        attainment: dict[str, float] = {}
        burn: dict[str, dict] = {}
        breach_dims: list[str] = []
        targets = {"ttft": cfg.ttft_target, "tpot": cfg.tpot_target,
                   "availability": cfg.availability_target}
        for dim in _DIMS:
            att = 1.0 - self._error_rate(dim, now - cfg.window_s, now)
            fast = self._error_rate(dim, now - cfg.fast_window_s, now)
            slow = self._error_rate(dim, now - cfg.slow_window_s, now)
            budget = max(1e-9, 1.0 - float(targets[dim]))
            burn[dim] = {"fast": fast / budget, "slow": slow / budget}
            attainment[dim] = att
            if burn[dim]["fast"] >= cfg.fast_burn_threshold:
                breach_dims.append(dim)
        # literal publish sites (one per gauge — machine-checked catalog)
        g("slo/ttft_attainment").set(attainment["ttft"])
        g("slo/tpot_attainment").set(attainment["tpot"])
        g("slo/availability").set(attainment["availability"])
        g("slo/ttft_burn_fast").set(burn["ttft"]["fast"])
        g("slo/ttft_burn_slow").set(burn["ttft"]["slow"])
        g("slo/tpot_burn_fast").set(burn["tpot"]["fast"])
        g("slo/tpot_burn_slow").set(burn["tpot"]["slow"])
        g("slo/availability_burn_fast").set(burn["availability"]["fast"])
        g("slo/availability_burn_slow").set(burn["availability"]["slow"])
        breach = bool(breach_dims)
        g("slo/fast_burn_breach").set(1.0 if breach else 0.0)
        rising = breach and not self._breach
        self._breach = breach
        self.last = {
            "t": now,
            "window_s": cfg.window_s,
            "fast_window_s": cfg.fast_window_s,
            "slow_window_s": cfg.slow_window_s,
            "targets": {d: float(targets[d]) for d in _DIMS},
            "objectives": {"ttft_s": cfg.ttft_s, "tpot_s": cfg.tpot_s},
            "attainment": attainment,
            "burn": burn,
            "breach": breach,
            "breach_dims": breach_dims,
            "breach_rising": rising,
        }
        return self.last


def classify_terminal(registry, cfg, status: str, ttft_s: float,
                      tpot_s: float | None) -> None:
    """Engine-side terminal classification: one call per finished request
    (ok or degraded) from ``ServingEngine``. Increments the four SLO
    counters the rings sample — plain counter incs, no locks, no device
    work. ``tpot_s`` is None for single-token/degraded completions (no TPOT
    verdict possible)."""
    c = registry.counter
    c("slo/requests").inc()
    if status != "ok":
        c("slo/failures").inc()
        return
    if ttft_s > cfg.ttft_s > 0:
        c("slo/ttft_violations").inc()
    if tpot_s is not None and tpot_s > cfg.tpot_s > 0:
        c("slo/tpot_violations").inc()


__all__ = ["SLOTracker", "classify_terminal"]
