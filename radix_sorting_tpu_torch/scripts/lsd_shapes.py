"""L2's launch shapes side by side on one CUDA device, and L1 beside them.

For each digit width and each ``SortConfig.lsd_chunk`` a caller may set, at
``n`` full-entropy u32 keys from the seed and the LSD engine's tile
(``lsd_tile(chunk, bits)``), one pass of L2 goes through every staged shape
that fits a block (``cuda_kernels.lsd_stage_shapes``; past 12-bit digits the
direct form, the only one), with the key plane alone (the LSD sort's own
pass) and with the key and an index plane (argsort's). Each is checked bit
for bit against ``lsd_scatter_plain`` and timed with CUDA events over a
loop of launches, in turns (the shapes in order, then in reverse; the mean
of the two). The shape :func:`..ops.cuda_kernels.lsd_scatter_shape` picks is
marked. L1 is timed beside ``torch.bincount`` of the tile-major digits.
Bound: the bytes the pass must move (each plane read and written once, the
bases read once; L1: the keys read once, the counts written once) over
3.35 TB/s.

Prints the card's name and power limit, the kernels' registers as ptxas
reported them, one line a (bits, planes, shape) and one final JSON line
(``"exp": "lsd_shapes"``). Needs a CUDA device.

Usage: python -m radix_sorting_tpu_torch.scripts.lsd_shapes
           [--n N] [--seed S] [--reps R] [--chunks C ...] [bits ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops import _build, scan
from ..ops import cuda_kernels as ck
from ..ops.lsd_engine import lsd_tile

HBM_BYTES_PER_MS = 3.35e9   # H100 SXM device memory, bytes a millisecond


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


def _label(shape) -> str:
    return "direct" if shape is None else f"{shape.threads}x{shape.keys}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=40_000_000)
    ap.add_argument("--seed", type=int, default=20240601)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--chunks", type=int, nargs="+", default=[1000, 2048, 4096, 8192, 16384])
    ap.add_argument("bits", type=int, nargs="*", default=[8, 11, 12])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lsd_shapes: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _, log = _build.build()
    current = ""
    for line in log.splitlines():       # ptxas names a kernel, then its figures
        if "entry function" in line or "Function properties" in line:
            current = line
        if "lsd" in current and ("registers" in line or "spill" in line
                                 or "entry function" in line):
            print(f"[ptxas] {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    n = args.n
    keys = np.random.Generator(np.random.PCG64(args.seed)).integers(
        0, 1 << 32, size=n, dtype=np.uint32)
    w = torch.from_numpy(keys.view(np.int32)).to(dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    records = []
    cases = dict.fromkeys((bits, lsd_tile(c, bits)) for bits in args.bits for c in args.chunks)
    for bits, tile in cases:
        bins, tiles = 1 << bits, -(-n // tile)
        hist = ck.lsd_hist(w, 0, bits, tile)
        if not torch.equal(hist, ck.lsd_hist_plain(w, 0, bits, tile)):
            raise SystemExit(f"lsd_hist r={bits} tile={tile}: differs from plain")
        g = (torch.arange(n, device=dev) // tile) * bins + (w.long() & (bins - 1))
        t1 = _turns({"lsd_hist": lambda: ck.lsd_hist(w, 0, bits, tile),
                     "bincount": lambda: torch.bincount(g, minlength=tiles * bins)},
                    args.reps)
        del g
        hb = (n * 4 + tiles * bins * 4) / HBM_BYTES_PER_MS
        print(f"[lsd_shapes] L1 r={bits} tile={tile}: {t1['lsd_hist']:.4f} ms, "
              f"torch.bincount {t1['bincount']:.4f} ms, bound {hb:.4f} ms", flush=True)
        records.append({"kernel": "lsd_hist", "bits": bits, "tile": tile,
                        "ms": t1["lsd_hist"], "bincount_ms": t1["bincount"], "bound_ms": hb})
        bases = scan.scatter_bases(hist)
        picked = ck.lsd_scatter_shape(bits, tile)
        shapes = ck.lsd_stage_shapes(bits) or [None]
        for planes in ((w,), (w, idx)):
            want = ck.lsd_scatter_plain(w, planes, 0, bits, tile, bases)
            fns = {}
            for shape in shapes:
                got = ck._lsd_scatter_launch(w, planes, 0, bits, tile, bases, shape)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"lsd_scatter r={bits} tile={tile} {_label(shape)} planes="
                                     f"{len(planes)}: differs from plain")
                fns[_label(shape)] = (lambda s=shape, p=planes:
                                      ck._lsd_scatter_launch(w, p, 0, bits, tile, bases, s))
            del want, got
            times = _turns(fns, args.reps)
            bound = (n * 8 * len(planes) + tiles * bins * 4) / HBM_BYTES_PER_MS
            for label, ms in times.items():
                mark = " (picked)" if label == _label(picked) else ""
                print(f"[lsd_shapes] L2 r={bits} tile={tile} planes={len(planes)} "
                      f"{label}{mark}: {ms:.4f} ms, bound {bound:.4f} ms", flush=True)
                records.append({"kernel": "lsd_scatter", "bits": bits, "tile": tile,
                                "planes": len(planes), "shape": label,
                                "picked": label == _label(picked), "ms": ms,
                                "bound_ms": bound})
    result = {"exp": "lsd_shapes", "device": smi, "n": n, "records": records}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
