"""The sweeps behind ``hw_engine.LSD_MIN_KEYS`` and
``hw_engine.K0_TWO_PLANE_MIN_KEYS``: K0 against torch.sort by size.

At each n (every power of two from 2^12 to 2^26, and 40,000,000 by
default) full-entropy keys from the seed, u32 (one plane) or with
``--planes 2`` u64 (two), are sorted keys-only and argsorted by K0
(``hw_engine.sort_words`` / ``argsort_words`` with the gates set to 0, so
one or two planes on the card always take K0), the argsort with int64
indices (``sets.py``'s) and with uint32 ones (the default), and by
``torch.sort`` of the same signed key, the int32 plane or the packed int64
key (``stable=True`` for the argsort, whose indices are int64), and by
``hw_engine``'s own torch.sort route (the gates set past every n: the key
packed, sorted and unpacked, the index cast), in turns (K0, torch.sort, the
route, then back; for the argsort K0 int64, K0 uint32, torch.sort, the route
in both index dtypes and back; CUDA events over ``--reps`` calls each, the
mean of the two turns). Each K0 output is checked bit for bit against
torch.sort's first. A gate is the smallest n of the sweep from which K0 was
no slower, at that n and every larger one (None if it never was): against
torch.sort, one for the keys-only sort, one for the argsort in each index
dtype, and one for all three; and one for all three against the route
(``gate_route``), the choice ``hw_engine.sorter_route`` makes.

Prints the card's name and power limit, one line an n, and one final JSON
line (``"exp": "k0_gate"``). ``chip_smoke.py`` phase 6 runs :func:`sweep`.
``--profile``: where a call's time goes at each n instead (:func:`profile`).
Needs a CUDA device.

Usage: python -m radix_sorting_tpu_torch.scripts.k0_gate
           [--seed S] [--reps R] [--planes 1|2] [--profile] [n ...]
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import json
import pstats
import subprocess

import numpy as np
import torch

from ..ops import _build, hw_engine

SIZES = tuple(1 << b for b in range(12, 27)) + (40_000_000,)


@contextlib.contextmanager
def k0_gate(n_min: int):
    """``hw_engine.LSD_MIN_KEYS`` and ``K0_TWO_PLANE_MIN_KEYS`` set to
    ``n_min`` inside the block."""
    old = hw_engine.LSD_MIN_KEYS, hw_engine.K0_TWO_PLANE_MIN_KEYS
    hw_engine.LSD_MIN_KEYS = hw_engine.K0_TWO_PLANE_MIN_KEYS = n_min
    try:
        yield
    finally:
        hw_engine.LSD_MIN_KEYS, hw_engine.K0_TWO_PLANE_MIN_KEYS = old


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _turns(fns: dict, reps: int) -> dict:
    got = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        got[k].append(_event_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in got.items()}


def _k0(fn, n_min: int = 0):
    """``fn`` run with the gates at ``n_min``: 0 takes K0."""
    def run():
        with k0_gate(n_min):
            return fn()
    return run


def _route(fn):
    """``fn`` on ``hw_engine``'s torch.sort route: the gates at K0's index
    limit, past every n of a sweep."""
    return _k0(fn, 1 << 31)


def _keys(rng, n: int, planes: int, device) -> tuple:
    """(word planes, the signed key torch.sort orders them by: the int32
    plane or the packed int64 key) of ``n`` full-entropy keys of ``planes``
    32-bit words, most significant first."""
    words = tuple(torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
                                   .view(np.int32)).to(device) for _ in range(planes))
    return words, hw_engine._key(words)


def sweep(device, sizes=SIZES, seed: int = 20240601, reps: int = 10, log=print,
          planes: int = 1) -> dict:
    """One row an n: K0 and torch.sort keys-only and argsort ms on keys of
    ``planes`` words, each K0 output checked against torch.sort's; and the
    gate the rows give."""
    rng = np.random.Generator(np.random.PCG64(seed))
    rows = []
    for n in sizes:
        w, key = _keys(rng, n, planes, device)
        ref = torch.sort(key, stable=True)
        got, _ = _k0(lambda: hw_engine.sort_words(w, stable=False))()
        _, perm = _k0(lambda: hw_engine.argsort_words(w, torch.int64))()
        _, perm32 = _k0(lambda: hw_engine.argsort_words(w, torch.uint32))()
        if not (torch.equal(hw_engine._key(got), ref.values) and torch.equal(perm, ref.indices)
                and torch.equal(perm32.view(torch.int32).long(), ref.indices)):
            raise RuntimeError(f"k0_gate: K0 differs from torch.sort at n={n}, "
                               f"{planes} plane(s)")
        del got, perm, perm32, ref
        sort = lambda: hw_engine.sort_words(w, stable=False)             # noqa: E731
        arg = lambda: hw_engine.argsort_words(w, torch.int64)            # noqa: E731
        arg32 = lambda: hw_engine.argsort_words(w, torch.uint32)         # noqa: E731
        sort_ms = _turns({"k0": _k0(sort), "torch.sort": lambda: torch.sort(key),
                          "route": _route(sort)}, reps)
        arg_ms = _turns({"k0": _k0(arg), "k0 u32": _k0(arg32),
                         "torch.sort": lambda: torch.sort(key, stable=True),
                         "route": _route(arg), "route u32": _route(arg32)}, reps)
        row = {"n": n, "sort_k0_ms": sort_ms["k0"], "sort_torch_ms": sort_ms["torch.sort"],
               "argsort_k0_ms": arg_ms["k0"], "argsort32_k0_ms": arg_ms["k0 u32"],
               "argsort_torch_ms": arg_ms["torch.sort"], "sort_route_ms": sort_ms["route"],
               "argsort_route_ms": arg_ms["route"], "argsort32_route_ms": arg_ms["route u32"]}
        rows.append(row)
        log(f"planes={planes} n={n}: sort K0 {row['sort_k0_ms']:.4f} ms, torch.sort "
            f"{row['sort_torch_ms']:.4f} ms, route {row['sort_route_ms']:.4f} ms; argsort K0 "
            f"int64 {row['argsort_k0_ms']:.4f} ms, uint32 {row['argsort32_k0_ms']:.4f} ms, "
            f"torch.sort(stable=True) {row['argsort_torch_ms']:.4f} ms, route int64 "
            f"{row['argsort_route_ms']:.4f} ms, uint32 {row['argsort32_route_ms']:.4f} ms")
        del w, key
    forms = {"sort": ("sort_k0_ms", "sort_torch_ms"),
             "argsort": ("argsort_k0_ms", "argsort_torch_ms"),
             "argsort32": ("argsort32_k0_ms", "argsort_torch_ms"),
             "sort route": ("sort_k0_ms", "sort_route_ms"),
             "argsort route": ("argsort_k0_ms", "argsort_route_ms"),
             "argsort32 route": ("argsort32_k0_ms", "argsort32_route_ms")}

    def gate(*names):
        n_min = None
        for row in sorted(rows, key=lambda r: -r["n"]):
            if any(row[forms[f][0]] > row[forms[f][1]] for f in names):
                break
            n_min = row["n"]
        return n_min
    current = hw_engine.LSD_MIN_KEYS if planes == 1 else hw_engine.K0_TWO_PLANE_MIN_KEYS
    return {"planes": planes, "rows": rows, "gate_sort": gate("sort"),
            "gate_argsort": gate("argsort"), "gate_argsort32": gate("argsort32"),
            "gate": gate("sort", "argsort", "argsort32"),
            "gate_route": gate("sort route", "argsort route", "argsort32 route"),
            "current": current}


def profile(device, n: int, seed: int = 20240601, reps: int = 10, calls: int = 5,
            log=print, planes: int = 1) -> dict:
    """Where the time of a call goes at ``n`` keys of ``planes`` words, for
    K0 keys-only, K0's argsort (int64 and uint32 indices) and torch.sort of
    the signed key (unstable and stable): the wall ms a call (CUDA events
    over ``reps`` calls), the device busy ms a call and the kernels by
    device time (torch.profiler over ``calls`` calls), and for K0 keys-only
    the host's own time by Python function (cProfile over 20 calls, each
    ending in its one sync)."""
    from torch.profiler import ProfilerActivity, profile as trace
    rng = np.random.Generator(np.random.PCG64(seed))
    w, key = _keys(rng, n, planes, device)
    cases = {"K0 keys-only": _k0(lambda: hw_engine.sort_words(w, stable=False)),
             "K0 argsort int64": _k0(lambda: hw_engine.argsort_words(w, torch.int64)),
             "K0 argsort uint32": _k0(lambda: hw_engine.argsort_words(w, torch.uint32)),
             "torch.sort": lambda: torch.sort(key),
             "torch.sort(stable=True)": lambda: torch.sort(key, stable=True)}
    out = {"n": n, "planes": planes}
    for label, fn in cases.items():
        wall = _event_ms(fn, reps)
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in rows) / calls / 1e3
        kernels = [(e.key[:60], e.self_device_time_total / calls / 1e3, e.count / calls)
                   for e in rows[:10]]
        out[label] = {"wall_ms": wall, "device_ms": busy, "kernels": kernels}
        log(f"profile planes={planes} n={n} {label}: wall {wall:.4f} ms, device busy "
            f"{busy:.4f} ms; " +
            "; ".join(f"{k} {ms:.4f} ms x{c:g}" for k, ms, c in kernels))
    fn = cases["K0 keys-only"]
    fn()
    torch.cuda.synchronize()
    host = cProfile.Profile()
    host.enable()
    for _ in range(20):
        fn()
    host.disable()
    st = pstats.Stats(host).stats
    top = sorted(st.items(), key=lambda kv: -kv[1][2])[:14]
    out["host"] = [(f"{k[2]} ({k[0].rsplit('/', 1)[-1]}:{k[1]})", v[2] / 20 * 1e3, v[1] / 20)
                   for k, v in top]
    total = sum(v[2] for v in st.values()) / 20 * 1e3
    log(f"profile planes={planes} n={n} K0 keys-only host: {total:.4f} ms of Python and "
        "native calls a call; own time by function: " +
        "; ".join(f"{name} {ms:.4f} ms x{c:g}" for name, ms, c in out["host"]))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20240601)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--planes", type=int, choices=(1, 2), default=1,
                    help="u32 keys (one word plane) or u64 keys (two)")
    ap.add_argument("--profile", action="store_true",
                    help="where a call's time goes at each n, in place of the sweep")
    ap.add_argument("n", type=int, nargs="*", default=list(SIZES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k0_gate: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()
    log = lambda line: print(f"[k0_gate] {line}", flush=True)
    dev = torch.device("cuda", 0)
    if args.profile:
        rec = {"profiles": [profile(dev, n, args.seed, args.reps, log=log, planes=args.planes)
                            for n in args.n]}
    else:
        rec = sweep(dev, args.n, args.seed, args.reps, log=log, planes=args.planes)
    rec = {"exp": "k0_gate", "device": smi, **rec}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
