"""Monitoring backends behind one ``MonitorMaster`` (the port of
``deepspeed_tpu/monitor/monitor.py``, its CSV backend).

Events are ``(tag, value, step)`` triples; each enabled backend receives
every event. The training engine writes ``Train/Samples/train_loss`` and
``Train/Samples/lr`` each step, and the telemetry bridge pushes the
registry at print boundaries. TensorBoard and W&B are not ported: their
blocks are refused by the config.
"""

from __future__ import annotations

import csv
import os
import weakref


def _close_handles(files: dict) -> None:
    """Close every (handle, writer) value and empty the dict in place."""
    for f, _ in files.values():
        if not f.closed:
            f.close()
    files.clear()


class CsvMonitor:
    """One CSV per tag (``<output_path or ./csv_logs>/<job_name>/<tag with
    / as _>.csv``, header ``step,<tag>``), written through handles opened
    at a tag's first event and kept open; one flush per ``write_events``
    batch keeps the files tail-able."""

    def __init__(self, cfg):
        self.dir = os.path.join(cfg.output_path or "./csv_logs", cfg.job_name)
        os.makedirs(self.dir, exist_ok=True)
        self.files = {}  # filename -> (file handle, csv writer)
        self.enabled = True
        # close the handles at GC or exit without keeping the monitor alive;
        # the finalizer holds the dict itself, so close() empties it in place
        self._finalizer = weakref.finalize(self, _close_handles, self.files)

    def _writer(self, tag):
        # keyed by file name: two tags that map to one file ('a/b', 'a_b')
        # share one handle, so their rows do not interleave with two headers
        fname = os.path.join(self.dir, tag.replace("/", "_") + ".csv")
        entry = self.files.get(fname)
        if entry is None:
            new = not os.path.exists(fname) or os.path.getsize(fname) == 0
            f = open(fname, "a", newline="")
            w = csv.writer(f)
            if new:
                w.writerow(["step", tag])
            entry = self.files[fname] = (f, w)
        return entry

    def write_events(self, events):
        touched = set()
        for tag, value, step in events:
            f, w = self._writer(tag)
            w.writerow([step, value])
            touched.add(f)
        for f in touched:
            f.flush()

    def close(self):
        _close_handles(self.files)


class MonitorMaster:
    """Fan-out of (tag, value, step) events to the enabled backends (one
    process, so no rank gating)."""

    def __init__(self, ds_config):
        self.backends = []
        if ds_config.csv_monitor.enabled:
            self.backends.append(CsvMonitor(ds_config.csv_monitor))

    @property
    def enabled(self):
        return bool(self.backends)

    def write_events(self, events):
        for b in self.backends:
            b.write_events(events)

    def close(self):
        for b in self.backends:
            b.close()
