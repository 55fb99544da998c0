"""One run of one cell: set-up, the measured window, the check.

The loop is closed with one caller: each call ends in
``torch.cuda.synchronize()``, as a caller that reads its result waits for
it. The caller cycles over a pool of inputs made on the device from the seed
(:mod:`sortbench.generator`), so no call finds its input in the L2. A call's
time runs between two CUDA events recorded on the stream around it, the
first while the device is idle: from the call's start to its output, on the
device's clock. Between two calls the loop does no more than read the
clock, count, and compare the call's number with the next one the sample
keeps.

A uniform sample of the window's outputs, drawn from the seed, is copied as
bytes into slots made in set-up, and the device is synchronized after each
copy, so that the next call again starts on an idle device. Once the window
has closed and the memory peak is read, the configuration's plain reference
works each sampled answer out again from the pool, and every element that
differs counts. The pool is made again from the seed and compared with the
one the calls read: a call must leave its input as it was.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import generator, roofline, tracefold
from .reference import mismatches

SLOT_ALIGN = 16     # bytes: each output's bytes start on this boundary in a slot


def outputs(out) -> tuple:
    """A call's result as a tuple of tensors."""
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


class Reservoir:
    """A uniform sample of ``k`` of the window's outputs, kept as bytes in
    slots allocated in set-up, so that keeping one allocates nothing in the
    window. The calls to keep are drawn from the seed by Algorithm L (Li,
    1994): a draw at each call kept, none between them, so the loop only
    compares a call's number with :attr:`next`."""

    def __init__(self, k: int, width: int, device, seed: int):
        width = -(-width // SLOT_ALIGN) * SLOT_ALIGN
        self.slots = torch.empty((k, width), dtype=torch.uint8, device=device)
        self.kept: list = [None] * k            # (pool index, [(dtype, shape, offset)])
        self.rng = np.random.default_rng([seed % 2**64, 1])
        self.w = math.exp(math.log(self._u()) / k)
        self.next = 0                           # the number of the next call to keep

    def _u(self) -> float:
        return float(self.rng.random()) or 1e-300

    def _advance(self, i: int) -> None:
        k = len(self.kept)
        if i + 1 < k:
            self.next = i + 1
            return
        if i >= k:
            self.w *= math.exp(math.log(self._u()) / k)
        self.next = i + 1 + int(math.floor(math.log(self._u()) / math.log1p(-self.w)))

    def store(self, j: int, out) -> list:
        """Copy ``out``'s bytes into slot ``j``; returns their layout."""
        layout, offset = [], 0
        for t in outputs(out):
            b = t.contiguous().reshape(-1).view(torch.uint8)
            self.slots[j, offset:offset + b.numel()].copy_(b)
            layout.append((t.dtype, tuple(t.shape), offset))
            offset += -(-b.numel() // SLOT_ALIGN) * SLOT_ALIGN
        return layout

    def keep(self, i: int, pool_index: int, out) -> None:
        """Call ``i`` (= :attr:`next`) produced ``out`` (None: it failed)."""
        k = len(self.kept)
        if out is not None:
            j = i if i < k else int(self.rng.integers(0, k))
            self.kept[j] = (pool_index, self.store(j, out))
            if self.slots.device.type == "cuda":
                torch.cuda.synchronize()
        self._advance(i)

    def output(self, j: int) -> tuple:
        """The outputs kept in slot ``j``, in their dtypes and shapes."""
        got = []
        for dtype, shape, offset in self.kept[j][1]:
            n = math.prod(shape) * torch.empty(0, dtype=dtype).element_size()
            got.append(self.slots[j, offset:offset + n].view(dtype).view(shape))
        return tuple(got)


class _Timer:
    """A call's milliseconds: CUDA events on the card (the call ends in a
    synchronize), ``time.perf_counter`` elsewhere (the CPU tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.b.record()
            torch.cuda.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


def _memory(device: torch.device, stat: str) -> int:
    """A statistic of the caching allocator (0 off the card).
    ``requested_bytes`` are the sizes the program asked for, before the
    allocator rounds them to its blocks, so they repeat from run to run."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get(stat, 0))


def _profile():
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _nbytes(out) -> int:
    return sum(-(-t.numel() * t.element_size() // SLOT_ALIGN) * SLOT_ALIGN
               for t in outputs(out))


def _wrong(got: Sequence[torch.Tensor], want) -> int:
    want = outputs(want)
    if len(got) != len(want):
        return sum(w.numel() for w in want)
    return sum(mismatches(g, w) for g, w in zip(got, want))


def run(config: dict, reference, mix: dict, seed: int, seconds: float, trace: bool,
        device, call: Callable[[dict], object], t0: float,
        trace_path: Optional[Path] = None) -> dict:
    """One run. ``call`` takes one input of the pool (a dict, see
    :mod:`sortbench.generator`) and returns what the call under test
    returns; ``reference`` is the module of the configuration's plain
    reference, ``t0`` the process's start on ``time.perf_counter``'s clock.
    Untraced, the window lasts ``seconds``; traced, it is the mix's
    ``trace_calls`` calls under ``torch.profiler``, whose trace goes to
    ``trace_path``. Returns the run's record."""
    device = torch.device(device)
    pool = generator.make_pool(mix, seed, device, config)
    cycle = generator.order(mix, seed)
    keys_of = [x["keys"].numel() for x in pool]
    timer = _Timer(device)
    width = 0
    for p in sorted(set(cycle)):  # set-up: every input, through the loop's own steps
        timer.start()
        out = call(pool[p])
        timer.stop()
        width = max(width, _nbytes(out))
        out = None
    keep = Reservoir(int(mix["sample_calls"]), width, device, seed)
    keep.store(0, call(pool[cycle[0]]))       # and the sample's copy
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_peak = _memory(device, "allocated_bytes.all.peak")
    base = _memory(device, "requested_bytes.all.current")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    inputs = [pool[p] for p in cycle]
    latencies, attempted, failed, failed_keys = [], 0, 0, 0
    limit = int(mix["trace_calls"]) if trace else None
    profiler = _profile() if trace else contextlib.nullcontext()
    span = (lambda: torch.profiler.record_function(tracefold.SPAN)) if trace \
        else contextlib.nullcontext
    gc.collect()
    gc.freeze()                  # set-up's objects are never scanned in the window
    setup_s = time.perf_counter() - t0
    with profiler:
        start = time.perf_counter()
        while True:
            i = attempted % len(inputs)
            with span():
                timer.start()
                try:
                    out = call(inputs[i])
                except Exception:            # the loop goes on; the call counts as failed
                    if not failed:
                        traceback.print_exc(file=sys.stderr)
                    failed += 1
                    failed_keys += keys_of[cycle[i]]
                    out = None
                latencies.append(timer.stop())
            if attempted == keep.next:
                keep.keep(attempted, cycle[i], out)
            out = None
            attempted += 1
            if trace and attempted >= limit or \
                    not trace and time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
    gc.unfreeze()
    window_peak = _memory(device, "allocated_bytes.all.peak")
    full, rest = divmod(attempted, len(cycle))
    keys = full * sum(keys_of) + sum(keys_of[p] for p in cycle[:rest]) - failed_keys
    record = {
        "calls": attempted, "keys": keys, "window_s": window_s, "setup_s": setup_s,
        "latencies_ms": latencies,
        "call_mem_bytes": _memory(device, "requested_bytes.all.peak") - base,
    }
    if trace:
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(trace_path))
        record = tracefold.fold(json.loads(trace_path.read_text())["traceEvents"])
        record["least_bytes"] = sum(roofline.least_bytes(config, keys_of[cycle[i % len(cycle)]])
                                    for i in range(attempted))
        record["peak_bytes_per_s"] = roofline.peak_bytes_per_s(
            torch.cuda.get_device_name(device)) if device.type == "cuda" else None
    wrong, checked = 0, 0
    for j, kept in enumerate(keep.kept):         # the check, after the window
        if kept is not None:
            wrong += _wrong(keep.output(j), reference.expected(pool[kept[0]]))
            checked += 1
    fresh = generator.make_pool(mix, seed, device, config)    # the inputs as they were made
    changed = sum(mismatches(x[k], y[k]) for x, y in zip(pool, fresh) for k in y)
    checks = {
        "failed_calls": {"value": failed, "limit": 0, "pass_if": "<="},
        "wrong_elements": {"value": wrong, "limit": 0, "pass_if": "<="},
        "changed_input_elements": {"value": changed, "limit": 0, "pass_if": "<="},
        "checked_calls": {"value": checked, "limit": 1, "pass_if": ">="},
    }
    return {
        "record": record,
        "attempted": attempted,
        "failed": failed,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "checks": checks,
        "correct": all(c["value"] <= c["limit"] if c["pass_if"] == "<=" else
                       c["value"] >= c["limit"] for c in checks.values()),
    }
