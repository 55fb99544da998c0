"""Timing, rate counters and device traces: the counterpart of
``radix_sorting_tpu.utils.timing``.

The reference times with ``CLOCK_MONOTONIC_RAW`` (`radix_experiment.cpp:200-206`)
and derives KeyRate / bytes-per-second counters (`radix_bench.cpp:72-77`).
Here:

* :func:`loop_ms` runs a body ``reps`` times between two CUDA events on a
  CUDA device (after one warm run, which also builds the kernels), or
  between two ``time.perf_counter`` reads on the CPU, and keeps the best of
  ``repeats`` runs;
* :func:`steady_state_ms` and :func:`steady_chain_ms` chain each iteration's
  input to the last output, as the JAX package's loops inside one jit do, so
  no iteration can be skipped or served from a cache of the last one;
* :func:`stream_gbps` is the same-process elementwise stream rate;
* :func:`counters` derives the reference's rate counters;
* :func:`trace` and :func:`device_op_table` capture a ``torch.profiler``
  trace and reduce it to device-side time by kernel;
* :func:`span` marks a step of the port's sort path in any
  ``torch.profiler`` capture, under one of the names of :data:`SPANS`.

A time taken on the CPU is the CPU's: nothing here writes it under a device's
name.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["loop_ms", "steady_state_ms", "steady_chain_ms", "stream_gbps",
           "stream_step", "STREAM_PASSES", "stream_bytes_per_iter", "counters",
           "trace", "device_op_table", "span", "SPANS"]

_MULTIPLIER = 2654435761          # odd: a bijection mod 2^bits at every width
# same-width integer views (torch computes on few unsigned dtypes)
_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def loop_ms(body: Callable[[], object], reps: int, repeats: int = 1,
            device=None) -> float:
    """Best over ``repeats`` runs of ms per call of ``body()`` in a run of
    ``reps`` calls, after one warm run. On a CUDA ``device`` the run lies
    between two CUDA events and ends in their synchronize; elsewhere between
    two ``time.perf_counter`` reads."""
    cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(reps):
        body()
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                body()
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                body()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / reps)
    return best


def _int_view(t: torch.Tensor) -> torch.Tensor:
    return t.view(_INT_VIEW[t.element_size()])


def _last_bit(r, like: torch.Tensor) -> torch.Tensor:
    """The lowest bit of the last element of ``r`` (its first leaf when a
    tuple) as a one-element tensor of ``like``'s dtype, on the device: the
    data dependence of a chain."""
    leaf = r[0] if isinstance(r, (tuple, list)) else r
    return (_int_view(leaf.reshape(-1)[-1:]) & 1).to(like.dtype)


def _multiplier(t: torch.Tensor) -> int:
    """The odd multiplier cut to ``t``'s width, as a value of its dtype."""
    bits = 8 * t.element_size()
    m = _MULTIPLIER & ((1 << bits) - 1)
    return m - (1 << bits) if t.is_signed() and m >= 1 << (bits - 1) else m


def steady_state_ms(fn: Callable, x: torch.Tensor, reps: int = 4) -> float:
    """Per-call steady-state ms of ``fn(x)``: each iteration's input is the
    last one XOR the last output's lowest bit (nearly the same data every
    iteration; for engines whose path depends on the data, use
    :func:`steady_chain_ms`)."""
    state = [_int_view(x)]

    def body():
        c = state[0]
        state[0] = c ^ _last_bit(fn(c.view(x.dtype)), c)
    return loop_ms(body, reps, 1, x.device)


def steady_chain_ms(fn: Callable, x: torch.Tensor, reps: int = 8, repeats: int = 2,
                    aux=None) -> float:
    """Per-call steady-state ms of ``fn(x)`` (``fn(x, aux)`` with ``aux``),
    best of ``repeats`` runs of ``reps`` calls.

    Iterations chain through the scramble ``c * 2654435761 + (r[-1] & 1)``
    (the multiplier cut to the key width): an odd multiplier is a bijection
    mod 2^bits, so every iteration sees fresh uniform data, and the ``& 1``
    term is a real dependence on the last output. Callers timing structured
    inputs (a narrow range, a mask) restore the structure inside ``fn``.
    """
    state = [_int_view(x)]
    m = _multiplier(state[0])
    args = () if aux is None else (aux,)

    def body():
        c = state[0]
        r = fn(c.view(x.dtype), *args)
        state[0] = c * m + _last_bit(r, c)
    return loop_ms(body, reps, repeats, x.device)


# The stream: one in-place multiply and one in-place add per iteration, two
# elementwise kernels in eager PyTorch, each reading and writing the array.
STREAM_PASSES = 2


def stream_step(c: torch.Tensor) -> torch.Tensor:
    """One iteration of the stream on an int32 plane, in place:
    ``c = c * 2654435761 + 1`` (mod 2^32)."""
    return c.mul_(_multiplier(c)).add_(1)


def stream_bytes_per_iter(n: int) -> int:
    """Bytes the stream's kernels move per iteration over n u32 words: each
    of its :data:`STREAM_PASSES` passes reads and writes every word. (The
    JAX package counts one read and one write, its loop being one fused XLA
    pass.)"""
    return STREAM_PASSES * 2 * 4 * n


def stream_gbps(n: int = 40_000_000, reps: int = 20, x=None, device=None) -> float:
    """Same-process elementwise stream rate in GB/s: the bytes the stream's
    kernels move (:func:`stream_bytes_per_iter`) over their time, best of
    two runs. ``x``: an int32 plane to stream over (a copy of it), else n
    random words made on ``device`` (the CUDA device by default)."""
    if x is None:
        dev = torch.device(device) if device is not None else torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, device=dev,
                          generator=gen)
    else:
        x = _int_view(x).clone()
        n = int(x.shape[0])
    ms = loop_ms(lambda: stream_step(x), reps, 2, x.device)
    return stream_bytes_per_iter(n) / (ms * 1e-3) / 1e9


def counters(n: int, ms: float, itemsize: int = 4) -> dict:
    """KeyRate / bytes-per-second counters (`radix_bench.cpp:72-77`)."""
    s = ms / 1e3
    return {
        "KeyRate": n / s,
        "bytes_per_second": n * itemsize / s,
        "ms": ms,
    }


@contextlib.contextmanager
def trace(logdir: str | os.PathLike):
    """Profile a block with ``torch.profiler`` (host and, where there is a
    card, device activity) and write its Chrome trace to
    ``logdir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / "trace.json"))


_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_op_table(logdir: str | os.PathLike) -> list:
    """The device-side events of ``logdir/trace.json`` (kernels, copies,
    memsets; an operator's host-side row would repeat its kernels' time) as
    rows ``{"op", "total_us", "calls"}``, longest first."""
    path = Path(logdir) / "trace.json"
    if not path.is_file():
        raise FileNotFoundError(f"no trace under {logdir}")
    events = json.loads(path.read_text())["traceEvents"]
    total, calls = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATEGORIES:
            total[e["name"]] += float(e.get("dur", 0.0))
            calls[e["name"]] += 1
    return [{"op": name, "total_us": round(us, 1), "calls": calls[name]}
            for name, us in total.most_common()]


# The spans of the sort path. Each is a ``user_annotation`` event of the
# profiler's Chrome trace, on the host's timeline beside the device's kernels,
# copies and memsets; the spans a thread opens inside another are its
# children. The names start with "rst.".
SORT, ARGSORT, SORT_PAIRS = "rst.sort", "rst.argsort", "rst.sort_pairs"  # a public call
ENCODE, DECODE = "rst.encode", "rst.decode"     # the key transform, each way
K0, TORCH_SORT = "rst.k0", "rst.torch_sort"     # the sorter a call took
GUARD = "rst.guard"                # the presorted guard's torch passes, enqueued (off K0)
LIVE_DIGITS = "rst.live_digits"    # the engines' live digits (and guard flag), enqueued
K0_PASS = "rst.k0_pass"            # one K0 sweep's enqueue: a call shows its live passes
PAYLOAD = "rst.payload"            # sort_pairs' host work on the payload tree, each way
READ = "rst.read"                  # a read of device data on the host: it waits for the device
LAUNCH = "rst.launch"              # a hand-written kernel's enqueue
SPANS = (SORT, ARGSORT, SORT_PAIRS, ENCODE, DECODE, K0, TORCH_SORT, GUARD, LIVE_DIGITS,
         K0_PASS, PAYLOAD, READ, LAUNCH)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` while a profiler records
    (:func:`trace`, or any ``torch.profiler.profile``), else one shared null
    context: with no profiler, a span costs one flag read. (A span carries
    no arguments: torch's Chrome trace drops a ``record_function``'s string
    argument, with ``record_shapes`` or without.)"""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
