"""Reduce a ``torch.profiler`` Chrome trace to what the per-layer metrics read.

The traced calls are the host spans named :data:`SPAN` that the harness
opens around each call. The window runs from the first span's start to the
last span's end. Device work is every kernel, copy and memset in it (the
categories that ``radix_sorting_tpu_torch.utils.timing.device_op_table``
sums, copied here so that the program cannot change the yardstick) that a
call launched: the trace ties each to the host's launch by a correlation
id, and a launch outside every span (the harness's copy of a sampled output
between calls) does not count. The device is busy where the union of their
intervals covers the window, and idle elsewhere. Each idle stretch is put
down to the innermost host operation on the calling thread that was running
through it.
"""

from __future__ import annotations

import bisect
import collections
from typing import Iterable, List, Tuple

SPAN = "sortbench.call"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NO_HOST_OP = "(no host op)"


def _complete(events: Iterable[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of half-open intervals, as sorted disjoint intervals."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _gaps(busy: List[Tuple[float, float]], t0: float, t1: float):
    edge = t0
    for s, e in busy:
        if s > edge:
            yield edge, s
        edge = max(edge, e)
    if t1 > edge:
        yield edge, t1


def _attribute(gaps, host: List[Tuple[float, float, str]]) -> collections.Counter:
    """Microseconds of idle device time by the innermost host operation
    running through each part of each gap."""
    host = sorted(host)
    starts = [h[0] for h in host]
    longest = max((e - s for s, e, _ in host), default=0.0)
    out: collections.Counter = collections.Counter()
    for a, b in gaps:
        lo = bisect.bisect_left(starts, a - longest)
        hi = bisect.bisect_left(starts, b)
        around = [h for h in host[lo:hi] if h[1] > a]
        cuts = sorted({a, b} | {x for s, e, _ in around for x in (s, e) if a < x < b})
        for p, q in zip(cuts, cuts[1:]):
            covering = [(e - s, name) for s, e, name in around if s <= p and e >= q]
            out[min(covering)[1] if covering else NO_HOST_OP] += q - p
    return out


def fold(events: Iterable[dict], span: str = SPAN) -> dict:
    """The record of one traced segment: ``calls``, ``window_s``,
    ``busy_s``, ``device_ops`` (device events that start in the window),
    ``op_seconds`` (device seconds in the window by name) and
    ``idle_seconds`` (idle seconds by host operation)."""
    events = _complete(events)
    spans = sorted((e for e in events
                    if e["name"] == span and e.get("cat") in HOST_CATEGORIES),
                   key=lambda e: e["ts"])
    if not spans:
        raise ValueError(f"no '{span}' spans in the trace")
    t0 = float(spans[0]["ts"])
    t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in spans)
    tid = spans[0].get("tid")
    starts = [float(e["ts"]) for e in spans]

    def in_a_call(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= starts[i] + float(spans[i].get("dur", 0.0))
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {}) and in_a_call(float(e["ts"]))}
    ops: collections.Counter = collections.Counter()
    intervals, count = [], 0
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        if launched and e.get("args", {}).get("correlation") not in launched:
            continue                 # launched outside every call
        s = float(e["ts"])
        f = s + float(e.get("dur", 0.0))
        if f <= t0 or s >= t1:
            continue
        count += t0 <= s
        s, f = max(s, t0), min(f, t1)
        ops[e["name"]] += f - s
        intervals.append((s, f))
    busy = union(intervals)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events
            if e.get("cat") in HOST_CATEGORIES and e.get("tid") == tid
            and e["name"] != span]
    idle = _attribute(list(_gaps(busy, t0, t1)), host)
    return {
        "calls": len(spans),
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_ops": count,
        "op_seconds": {k: v * 1e-6 for k, v in ops.items()},
        "idle_seconds": {k: v * 1e-6 for k, v in idle.items()},
    }


def top(seconds: dict, k: int = 10, width: int = 160) -> list:
    """The ``k`` largest entries of a {name: seconds} table as
    ``[[name, seconds], ...]``, names cut to ``width`` characters."""
    ranked = sorted(seconds.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:width], s] for name, s in ranked]
