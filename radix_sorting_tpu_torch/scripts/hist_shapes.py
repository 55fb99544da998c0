"""The histogram kernel's launch shapes side by side on one CUDA device.

For each row (K1 ``hist`` at r = 8, 16 and 18, uniform keys with the top
quarter dropped and keys of which 90% are one value; ``hist_multi`` at r = 8
and 11; K2 ``hist_pext`` at 256, 65,536 and 2^17 bins; K3 ``hist_pext2`` at
256 and 65,536 bins), at ``n`` keys from the seed: the wrapper (the shape
:func:`..ops.cuda_kernels.hist_shape` picks) timed with CUDA events and its
device time by ``torch.profiler``, beside ``torch.bincount`` of the
precomputed counter of every key (the yardstick; no part of the port), then
every candidate shape of ``cuda_kernels.hist_shape_candidates`` (its
fields: threads; up to 2^15 counters, sub-histogram copies of 32-bit
counters; past 2^13, 16-bit counters in one block or in grid rows of 2^16
counters), each checked bit for bit against the plain version, in turns (in
order, then in reverse; the mean of the two), with the device time of the
picked and the fastest shape. On a tree whose ``cuda_kernels`` has no
``hist_shape_candidates`` (the first version) only the wrappers and
``torch.bincount`` are timed, as with ``--wrappers``. Bound: the bytes the
call must move (each live plane read once, the counters written once) over
3.35 TB/s.

``--parent DIR`` times the wrappers of the tree in DIR (a checkout of
another commit, or a trial build) and of this one in turns, each in its own
process (DIR, this, this, DIR), and prints each row's mean per tree and their
ratio; :func:`in_turns` does the same for ``scripts/whist_shapes.py``. This
tree's scripts run in both trees: for the run they are copied into a package
``radix_sorting_tpu_torch/_turns`` of DIR, removed after.

Prints the card's name and power limit, the kernels' registers as ptxas
reported them, one line a (row, shape) and one final JSON line (``"exp":
"hist_shapes"``), also written to ``--out`` when given. Needs a CUDA device;
a failed row raises.

Usage: python -m radix_sorting_tpu_torch.scripts.hist_shapes
           [--n N] [--seed S] [--reps R] [--rows NAME ...] [--wrappers]
           [--parent DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, probes
from ..ops import cuda_kernels as ck

HBM_BYTES_PER_MS = 3.35e9   # H100 SXM device memory, bytes a millisecond
DROP_GE = 0xC0000000        # K1's uniform rows drop the top quarter of the keys


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def in_turns(script: str, args) -> dict:
    """``scripts/<script>.py --wrappers`` on the tree in ``args.parent`` and
    on this one, each in its own process: parent, this, this, parent. Each
    row's mean ms and device ms per tree, and this tree's over the parent's."""
    here = Path(__file__).resolve().parents[2]
    there = Path(args.parent).resolve()
    pkg = there / "radix_sorting_tpu_torch" / "_turns"
    flags = ["--wrappers", "--n", str(args.n), "--seed", str(args.seed), "--reps", str(args.reps)]
    flags += ["--rows", *args.rows] if args.rows else []
    got = {"parent": [], "this": []}
    shutil.rmtree(pkg, ignore_errors=True)
    pkg.mkdir()
    try:
        (pkg / "__init__.py").write_text("")
        for name in ("hist_shapes.py", "whist_shapes.py"):
            shutil.copy(Path(__file__).with_name(name), pkg / name)
        with tempfile.TemporaryDirectory() as tmp:
            for i, (tree, cwd, mod) in enumerate((("parent", there, "_turns"),
                                                  ("this", here, "scripts"),
                                                  ("this", here, "scripts"),
                                                  ("parent", there, "_turns"))):
                out = Path(tmp) / f"{i}.json"
                subprocess.run([sys.executable, "-m", f"radix_sorting_tpu_torch.{mod}.{script}",
                                *flags, "--out", str(out)], cwd=cwd, check=True)
                got[tree].append({r["row"]: r for r in json.loads(out.read_text())["records"]})
    finally:
        shutil.rmtree(pkg, ignore_errors=True)
    records = []
    for row in got["this"][0]:
        rec = {"row": row}
        for tree, runs in got.items():
            for key in ("ms", "device_ms"):
                seen = [r[row][key] for r in runs if r[row].get(key) is not None]
                rec[f"{tree}_{key}"] = sum(seen) / len(seen) if seen else None
        rec["ratio"] = rec["this_ms"] / rec["parent_ms"]
        rec["bound_ms"] = got["this"][0][row]["bound_ms"]
        records.append(rec)
        print(f"[{script} turns] {row}: parent {_ms(rec['parent_ms'])} (device "
              f"{_ms(rec['parent_device_ms'])}), this {_ms(rec['this_ms'])} (device "
              f"{_ms(rec['this_device_ms'])}), ratio {rec['ratio']:.3f}, bound "
              f"{rec['bound_ms']:.4f} ms", flush=True)
    return {"exp": script, "device": smi(), "n": args.n, "parent": str(there),
            "turns": records}


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


def _device_ms(fn, calls: int = 8) -> float:
    """Device time per call of everything fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # the tracer can drop a window's events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return sum(e.self_device_time_total for e in events) / calls / 1e3
    raise RuntimeError("hist_shapes: no device event traced in three windows")


def _rows(w, skewed, hi, lo, dev):
    """(name, total counters, bytes, wrapper, plain, launch(shape), counter
    of every key as int64 for torch.bincount, bins of that bincount)."""
    n = w.shape[0]
    rows = []
    for bits, keys, drop, label in ((8, w, DROP_GE, "uniform"), (16, w, DROP_GE, "uniform"),
                                    (18, w, DROP_GE, "uniform"), (8, skewed, None, "90% one value"),
                                    (16, skewed, None, "90% one value"),
                                    (18, skewed, None, "90% one value")):
        bins = 1 << bits
        bound = ck._drop_bound(drop)

        def counters(keys=keys, bins=bins, drop=drop):
            u = keys.long() & 0xFFFFFFFF
            return u & (bins - 1) if drop is None else torch.where(u < drop, u & (bins - 1), bins)
        rows.append((f"hist r={bits} {label}", bins, n * 4 + bins * 4,
                     lambda k=keys, b=bits, d=drop: ck.hist(k, 0, b, drop_ge=d),
                     lambda k=keys, b=bits, d=drop: ck.hist_plain(k, 0, b, d),
                     lambda s, k=keys, b=bits, bd=bound: ck._hist_launch(
                         "rst_hist", dev, 1 << b, s, k.data_ptr(), n, 0, 0, b, 1, bd),
                     counters, bins + 1))
    for bits in (8, 11):
        passes = -(-32 // bits)
        total = passes << bits

        def counters(bits=bits, passes=passes):
            u = w.long() & 0xFFFFFFFF
            return torch.cat([(p << bits) + ((u >> (p * bits)) & ((1 << bits) - 1))
                              for p in range(passes)])
        rows.append((f"hist_multi r={bits}", total, n * 4 + total * 4,
                     lambda b=bits: ck.hist_multi(w, b), lambda b=bits: ck.hist_multi_plain(w, b),
                     lambda s, b=bits, p=passes, t=total: ck._hist_launch(
                         "rst_hist", dev, t, s, w.data_ptr(), n, 0, 0, b, p, 1 << 32).view(p, -1),
                     counters, total))
    for mask in (0xF0F00000, 0xFFFF, 0x1FFFF):
        bins = 1 << bin(mask).count("1")
        rows.append((f"hist_pext mask=0x{mask:X}", bins, n * 4 + bins * 4,
                     lambda m=mask: ck.hist_pext(w, m), lambda m=mask: ck.hist_pext_plain(w, m),
                     lambda s, m=mask, b=bins: ck._hist_launch(
                         "rst_hist_pext", dev, b, s, w.data_ptr(), n, m),
                     lambda m=mask: probes.compact_live_bits(w, m).long(), bins))
    for m64 in (0xF000000000000F00, 0x00FF00000000FF00):
        mh, ml = m64 >> 32, m64 & 0xFFFFFFFF
        bins = 1 << bin(m64).count("1")
        rows.append((f"hist_pext2 mask=0x{m64:016X}", bins, n * 8 + bins * 4,
                     lambda a=mh, b=ml: ck.hist_pext2(hi, lo, a, b),
                     lambda a=mh, b=ml: ck.hist_pext2_plain(hi, lo, a, b),
                     lambda s, a=mh, b=ml, t=bins: ck._hist_launch(
                         "rst_hist_pext2", dev, t, s, hi.data_ptr(), lo.data_ptr(), n, a, b),
                     lambda a=mh, b=ml: probes.compact_word_planes((hi, lo), (a, b)).long(),
                     bins))
    return rows


def run(args) -> dict:
    card = smi()
    print(card, flush=True)
    _, log = _build.build()
    current = ""
    for line in log.splitlines():       # ptxas names a kernel, then its figures
        if "entry function" in line or "Function properties" in line:
            current = line
        if "hist" in current and "registers" in line:
            print(f"[ptxas] {current.strip()[:160]} | {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    shapes_of = None if args.wrappers else getattr(ck, "hist_shape_candidates", None)
    n = args.n
    rng = np.random.Generator(np.random.PCG64(args.seed))
    keys = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    keys64 = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    w = torch.from_numpy(keys.view(np.int32)).to(dev)
    skewed = w.clone()
    skewed[: n * 9 // 10] = 0x155
    hi = torch.from_numpy((keys64 >> np.uint64(32)).astype(np.uint32).view(np.int32)).to(dev)
    lo = torch.from_numpy(keys64.astype(np.uint32).view(np.int32)).to(dev)
    records = []
    for name, total, nbytes, wrapper, plain, launch, counters, lib_bins in _rows(
            w, skewed, hi, lo, dev):
        if args.rows and not name.startswith(tuple(args.rows)):
            continue
        bound = nbytes / HBM_BYTES_PER_MS
        want = plain()
        if not torch.equal(wrapper(), want):
            raise SystemExit(f"hist_shapes {name}: the wrapper differs from plain")
        picked = ck.hist_shape(total) if shapes_of else None
        rec = {"row": name, "n": n, "counters": total, "bound_ms": bound,
               "picked": picked.label() if picked else "wrapper"}
        c = counters()
        t = _turns({"wrapper": wrapper,
                    "bincount": lambda: torch.bincount(c, minlength=lib_bins)}, args.reps)
        del c
        rec.update(ms=t["wrapper"], device_ms=_device_ms(wrapper), bincount_ms=t["bincount"])
        print(f"[hist_shapes] {name}: wrapper ({rec['picked']}) {rec['ms']:.4f} ms, device "
              f"{rec['device_ms']:.4f} ms, torch.bincount {rec['bincount_ms']:.4f} ms, "
              f"bound {bound:.4f} ms", flush=True)
        if shapes_of:
            fns = {}
            for shape in shapes_of(total):
                got = launch(shape)
                if not torch.equal(got, want):
                    raise SystemExit(f"hist_shapes {name} {shape.label()}: differs from plain")
                fns[shape.label()] = lambda s=shape: launch(s)
            times = _turns(fns, args.reps)
            best = min(times, key=times.get)
            rec["shapes"] = times
            rec["fastest"] = best
            for label in dict.fromkeys((picked.label(), best)):
                rec.setdefault("shape_device_ms", {})[label] = _device_ms(fns[label])
            for label, ms in times.items():
                mark = (" (picked)" if label == picked.label() else "") + \
                       (" (fastest)" if label == best else "")
                dms = rec["shape_device_ms"].get(label)
                extra = f", device {dms:.4f} ms" if dms is not None else ""
                print(f"[hist_shapes] {name} {label}{mark}: {ms:.4f} ms{extra}", flush=True)
        records.append(rec)
    return {"exp": "hist_shapes", "device": card, "n": n, "records": records}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=40_000_000)
    ap.add_argument("--seed", type=int, default=20240601)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rows", nargs="*", default=None,
                    help="only the rows whose name starts with one of these")
    ap.add_argument("--wrappers", action="store_true", help="the wrappers alone")
    ap.add_argument("--parent", default=None,
                    help="a tree whose wrappers are timed in turns with this one's")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hist_shapes: needs a CUDA device")
    result = in_turns("hist_shapes", args) if args.parent else run(args)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
