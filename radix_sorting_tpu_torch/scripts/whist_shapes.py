"""The weighted-histogram kernel's launch shapes side by side on one CUDA device.

For each row (K10 ``whist`` and K11 ``whist_f32`` with counts and without, at
2^10, 2^15, 2^16 and 2^17 bins, keys uniform and 90% of them in one group;
K10 with u8 values, and with i32 values at 1,024 bins of which 1,000 are
kept), at ``n`` rows from the seed: the wrapper (the shape
:func:`..ops.cuda_kernels.whist_shape` picks) timed with CUDA events and its
device time by ``torch.profiler``, beside ``index_add_`` of the values into
the precomputed bins (the yardstick; no part of the port), then every
candidate shape of ``cuda_kernels.whist_shape_candidates`` (threads, loads a
chunk, 16-bit or 32-bit counts), each checked against the plain version
(counts and K10's sums bit for bit, K11's sums within sum|w| * 2^-14 + 1e-5
of a float64 sum), in turns (in order, then in reverse; the mean of the
two). Bound: the bytes the call must move (keys and values read once, the
outputs written once) over 3.35 TB/s.

``--wrappers`` times the wrappers alone (what a tree without
``whist_shape_candidates`` can run). ``--parent DIR`` runs the wrappers of
the tree in DIR (a checkout of another commit, or a trial build) and of this
one in turns (``hist_shapes.in_turns``: DIR, this, this, DIR, each in its own
process), and prints each row's mean per tree and their ratio. The
histogram kernels' rows, where the 16-bit hand-off also runs, are
``scripts/hist_shapes.py``'s.

Prints the card's name and power limit, one line a (row, shape) and one final
JSON line (``"exp": "whist_shapes"``), also written to ``--out`` when given.
Needs a CUDA device; a failed row raises.

Usage: python -m radix_sorting_tpu_torch.scripts.whist_shapes
           [--n N] [--seed S] [--reps R] [--rows NAME ...] [--wrappers]
           [--parent DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from . import hist_shapes
from .hist_shapes import HBM_BYTES_PER_MS, _ms, _turns, in_turns, smi

SKEW_GROUP = 7     # the group that holds 90% of the rows of a skewed row


def _device_ms(fn):
    """Device ms per call of everything fn launches (torch.profiler), None
    when the tracer kept no event in three tries of three windows."""
    for _ in range(3):
        try:
            return hist_shapes._device_ms(fn)
        except RuntimeError:
            pass
    return None


def _f32_ok(got, keys, weights, bins: int, drop_ge: int) -> bool:
    """K11's sums within sum|w| * 2^-14 + 1e-5 of a float64 sum, per bin."""
    k = keys.long() & 0xFFFFFFFF
    keep = k < drop_ge
    w = weights.double()[keep]
    ref = torch.zeros(bins, dtype=torch.float64, device=keys.device).index_add_(0, k[keep], w)
    bound = torch.zeros_like(ref).index_add_(0, k[keep], w.abs()) * 2.0 ** -14 + 1e-5
    return bool(((got.double() - ref).abs() <= bound).all())


def _rows(w, lo, weights):
    """(name, kernel, bits, sums, counts, keys, values, drop_ge, wrapper, plain)."""
    n = w.shape[0]
    rows = []
    for bits in (10, 15, 16, 17):
        bins = 1 << bits
        uniform = w & (bins - 1)
        skewed = uniform.clone()
        skewed[: n * 9 // 10] = SKEW_GROUP
        for keys, label in ((uniform, "uniform"), (skewed, "90% one group")):
            rows.append((f"whist bins={bins} u8 values {label}", "rst_whist", bits, "u32", True,
                         keys, lo & 0xFF, bins))
            rows.append((f"whist_f32 counts bins={bins} {label}", "rst_whist_f32", bits, "f32",
                         True, keys, weights, bins))
            rows.append((f"whist_f32 sums bins={bins} {label}", "rst_whist_f32", bits, "f32",
                         False, keys, weights, bins))
    rows.append(("whist bins=1024 i32 values, 1,000 kept", "rst_whist", 10, "u32", True,
                 w & 1023, lo, 1000))
    out = []
    for name, fn, bits, sums, counts, keys, vals, drop in rows:
        if fn == "rst_whist":
            wrapper = (lambda k=keys, v=vals, b=bits, d=drop: ck.whist(k, v, b, d))
            plain = (lambda k=keys, v=vals, b=bits, d=drop: ck.whist_plain(k, v, b, d))
        else:
            wrapper = (lambda k=keys, v=vals, b=bits, d=drop, c=counts:
                       ck.whist_f32(k, v, b, d, c))
            plain = (lambda k=keys, v=vals, b=bits, d=drop, c=counts:
                     ck.whist_f32_plain(k, v, b, d, c))
        out.append((name, fn, bits, sums, counts, keys, vals, drop, wrapper, plain))
    return out


def _agrees(got, want, fn, counts, keys, vals, bits, drop) -> bool:
    if fn == "rst_whist":
        return all(torch.equal(a, b) for a, b in zip(got, want))
    if counts:
        if not torch.equal(got[0], want[0]):
            return False
        got = got[1]
    return _f32_ok(got, keys, vals, 1 << bits, drop)


def run(args) -> dict:
    card = smi()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    n = args.n
    rng = np.random.Generator(np.random.PCG64(args.seed))
    w = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint32).view(np.int32)).to(dev)
    lo = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint32).view(np.int32)).to(dev)
    weights = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    shapes_of = None if args.wrappers else getattr(ck, "whist_shape_candidates", None)
    records = []
    for name, fn, bits, sums, counts, keys, vals, drop, wrapper, plain in _rows(w, lo, weights):
        if args.rows and not name.startswith(tuple(args.rows)):
            continue
        bins = 1 << bits
        nbytes = n * 8 + bins * (4 + 4 * counts)
        bound = nbytes / HBM_BYTES_PER_MS
        want = plain()
        if not _agrees(wrapper(), want, fn, counts, keys, vals, bits, drop):
            raise SystemExit(f"whist_shapes {name}: the wrapper differs from plain")
        picked = ck.whist_shape(bits, sums, counts) if shapes_of else None
        idx = torch.where((keys.long() & 0xFFFFFFFF) < drop, keys.long() & 0xFFFFFFFF, bins)
        lib = torch.zeros(bins + 1, dtype=vals.dtype, device=dev)
        t = _turns({"wrapper": wrapper, "index_add_": lambda: lib.index_add_(0, idx, vals)},
                   args.reps)
        del idx
        rec = {"row": name, "n": n, "bins": bins, "bound_ms": bound, "ms": t["wrapper"],
               "device_ms": _device_ms(wrapper), "index_add_ms": t["index_add_"],
               "picked": picked.label() if picked else "wrapper"}
        print(f"[whist_shapes] {name}: wrapper ({rec['picked']}) {rec['ms']:.4f} ms, device "
              f"{_ms(rec['device_ms'])}, index_add_ {rec['index_add_ms']:.4f} ms, bound "
              f"{bound:.4f} ms", flush=True)
        if shapes_of:
            fns = {}
            for shape in shapes_of(bits, sums, counts):
                got = ck._whist_launch(fn, keys, vals, bits, drop, counts, shape)
                if not _agrees(got, want, fn, counts, keys, vals, bits, drop):
                    raise SystemExit(f"whist_shapes {name} {shape.label()}: differs from plain")
                fns[shape.label()] = (lambda s=shape: ck._whist_launch(fn, keys, vals, bits, drop,
                                                                       counts, s))
            times = _turns(fns, args.reps)
            best = min(times, key=times.get)
            rec.update(shapes=times, fastest=best)
            for label, ms in times.items():
                mark = (" (picked)" if label == picked.label() else "") + \
                       (" (fastest)" if label == best else "")
                print(f"[whist_shapes] {name} {label}{mark}: {ms:.4f} ms", flush=True)
        records.append(rec)
    return {"exp": "whist_shapes", "device": card, "n": n, "records": records}


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
        raise SystemExit("whist_shapes: needs a CUDA device")
    result = in_turns("whist_shapes", args) if args.parent else run(args)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
