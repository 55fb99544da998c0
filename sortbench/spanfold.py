"""Seconds and counts of the program's own spans in a ``torch.profiler`` trace.

The program marks the steps of its sort path with host spans whose names
start with :data:`PREFIX`, ``user_annotation`` events like the harness's
``tracefold.SPAN``. They are read here on the calls' thread, inside the
traced window that :mod:`sortbench.tracefold` reads (the first call's start
to the last call's end), the harness's own span left out: the seconds and the
count of each name, and the host's dispatch time, that is the seconds of the
outermost spans less what the :data:`READ` spans inside them cover (the host
waiting for the device).

The traced record holds no spans. Their readers find the run's trace where
``run.py`` exports it (``out/<cell>.trace.json``): the newest trace there
whose calls and window are the record's (:func:`of`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Optional

from . import tracefold

PREFIX = "rst."
READ = PREFIX + "read"
TRACES = Path(__file__).resolve().parent / "out"


def _covered(intervals, s: float, e: float) -> float:
    """The length of [s, e] that the union of ``intervals`` covers."""
    return sum(b - a for a, b in tracefold.union((max(a, s), min(b, e)) for a, b in intervals))


def fold(events: Iterable[dict], span: str = tracefold.SPAN) -> dict:
    """``calls`` and ``window_s`` as :func:`sortbench.tracefold.fold` gives
    them; ``seconds`` and ``counts`` of the program's spans by name; and
    ``dispatch_s``, the outermost spans' seconds less the reads they hold."""
    events = [e for e in events if e.get("ph") == "X" and "ts" in e]
    calls = sorted((e for e in events
                    if e["name"] == span and e.get("cat") in tracefold.HOST_CATEGORIES),
                   key=lambda e: e["ts"])
    if not calls:
        raise ValueError(f"no '{span}' spans in the trace")
    t0 = float(calls[0]["ts"])
    t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in calls)
    tid = calls[0].get("tid")
    mine = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in events
                   if e.get("cat") == "user_annotation" and e.get("tid") == tid
                   and e["name"].startswith(PREFIX) and t0 <= float(e["ts"]) <= t1),
                  key=lambda x: (x[0], -x[1]))
    seconds: dict = {}
    counts: dict = {}
    outermost, reads, edge = [], [], float("-inf")
    for s, e, name in mine:
        seconds[name] = seconds.get(name, 0.0) + (e - s) * 1e-6
        counts[name] = counts.get(name, 0) + 1
        if name == READ:
            reads.append((s, e))
        if s >= edge:                    # inside no earlier span of the program
            outermost.append((s, e))
            edge = e
    dispatch = sum(e - s - _covered(reads, s, e) for s, e in outermost)
    return {"calls": len(calls), "window_s": (t1 - t0) * 1e-6, "seconds": seconds,
            "counts": counts, "dispatch_s": dispatch * 1e-6}


def of(record: dict) -> Optional[dict]:
    """:func:`fold` of the trace whose calls and window are the traced
    ``record``'s, the newest such under :data:`TRACES`; None where none is."""
    paths = sorted(TRACES.glob("*.trace.json"), key=lambda p: p.stat().st_mtime,
                   reverse=True)
    for path in paths:
        try:
            folded = fold(json.loads(path.read_text())["traceEvents"])
        except (OSError, ValueError, KeyError):
            continue
        if folded["calls"] == record.get("calls") and \
                folded["window_s"] == record.get("window_s"):
            return folded
    return None


def per_call(record: dict, key: str, name: Optional[str] = None) -> Optional[float]:
    """``key`` of the run's spans (``dispatch_s``, or ``counts`` /
    ``seconds`` of ``name``) a call; None where the program recorded no span."""
    folded = of(record)
    if folded is None or not folded["counts"] or not folded["calls"]:
        return None
    value = folded[key] if name is None else folded[key].get(name, 0)
    return value / folded["calls"]
