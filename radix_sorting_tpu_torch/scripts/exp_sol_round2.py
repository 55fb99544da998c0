"""Speed-of-light experiments of the multi-level sorts: the counterpart of
``scripts/exp_sol_round2.py``, on one CUDA device.

  1. kappa curve     the batched row-sort rate (``torch.sort(dim=-1)``)
                     against the row length m, with the cost model
                     t = kappa * n * log2(m)^2;
  2. monotone gather ``torch.gather`` of sorted per-row indices;
  3. msd pipeline    the two-level MSD sort: row sort, bucket starts by
                     ``torch.searchsorted``, the spread step (E2,
                     ``cuda_kernels.msd_spread``), the bucket sort and the
                     placement; checked bit for bit against ``np.sort``,
                     with the check that every cell fits its window, then
                     timed in all and by stage;
  4. pairs           the three pair sorts over :mod:`..ops.hw_engine` at 40M.

Each experiment prints JSON lines. Needs a CUDA device. Keys are
``utils.keyfile.generate_keys(40_000_000)``; the rows are u32 in int32
carriers, sorted unsigned (in sign-flipped space).

Usage: python -m radix_sorting_tpu_torch.scripts.exp_sol_round2 [--only EXP]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from ..ops import hw_engine, probes
from ..ops.kdf import INT32_MIN
from ..utils import keyfile, timing

SENT = -1                  # 0xFFFFFFFF, the largest key, in an int32 carrier


def _plane(keys: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(keys).view(np.int32)).to(device)


def _sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Every row of int32 carriers sorted as u32."""
    return torch.sort(x ^ INT32_MIN, dim=-1).values ^ INT32_MIN


def exp_kappa_curve(keys: np.ndarray, device) -> list:
    n = keys.size
    rows = []
    for m in (4096, 9766, 39062, 156250, 625000, 2500000, n):
        R = n // m
        x = _plane(keys[: R * m], device).view(R, m)
        ms = timing.steady_chain_ms(lambda c: torch.sort(c, dim=-1).values, x, reps=8)
        rows.append({"m": m, "R": R, "ms": ms, "Mkeys": R * m / ms / 1e3,
                     "kappa_ns_per_log2sq": ms * 1e6 / (R * m) / float(np.log2(m)) ** 2})
        print(json.dumps({"exp": "kappa", **rows[-1]}), flush=True)
    return rows


def exp_monotone_gather(keys: np.ndarray, device) -> dict:
    R, m, S = 128, 312500, 65536   # 8.4M of 40M elements, monotone within rows
    x = _plane(keys[: R * m], device).view(R, m)
    idx = torch.from_numpy(np.sort(np.random.default_rng(0).integers(0, m, size=(R, S)),
                                   axis=1)).to(device)
    ms = timing.steady_chain_ms(lambda c: torch.gather(c, 1, idx), x, reps=4)
    rec = {"exp": "monotone_gather", "gathered": R * S, "ms": ms,
           "Melem_per_s": R * S / ms / 1e3}
    print(json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# the two-level MSD pipeline


def build_msd(n: int, R: int, K: int, capr: int):
    """The keys-only ascending MSD sort of n u32 as R rows of m = n / R keys
    and K = 2^d buckets of the top d bits, windows of ``capr`` 128-key rows.

    Returns (pipeline, shapes, stages): ``pipeline(x)`` gives (the sorted
    keys, the largest cell as a 0-d tensor); ``stages`` are its steps, each
    a function of the last one's output."""
    m = n // R
    if R * m != n:
        raise ValueError(f"n = {n} is not R = {R} rows")
    d = K.bit_length() - 1
    if 1 << d != K:
        raise ValueError(f"K = {K} is not a power of two")
    m128 = -(-m // 128)
    W = m128 + capr          # a padded row, in 128-key rows
    L = R * capr * 128       # one bucket's keys, every row's window

    def row_sort(x):
        return _sort_rows(x.view(R, m))

    def starts_of(xs):
        # each row's first key of every bucket, by binary search of the
        # buckets of the sorted row
        b = probes.shift_right(xs, 32 - d)
        probe = torch.arange(K, dtype=torch.int32, device=xs.device).expand(R, K)
        return torch.searchsorted(b, probe.contiguous(), out_int32=True)

    def spread_inputs(xs, starts):
        # E2's operands: each bucket's first 128-key row, and the sorted rows
        # padded with all-ones to W rows of 128
        xp = torch.cat([xs, xs.new_full((R, W * 128 - m), SENT)], dim=1).view(R, W, 128)
        return (starts // 128).contiguous(), xp

    def spread(xs, starts):
        return ck.msd_spread(*spread_inputs(xs, starts), m, d, capr)

    def bucket_sort(cells):
        return _sort_rows(cells.view(K, L))

    def counts_of(starts):
        return torch.diff(starts, dim=1, append=starts.new_full((R, 1), m))

    def place(rows_sorted, starts):
        # the first gcounts[k] keys of bucket k's sorted row, bucket after bucket
        gcounts = counts_of(starts).sum(dim=0)
        keep = torch.arange(L, device=rows_sorted.device) < gcounts[:, None]
        return rows_sorted[keep]

    def pipeline(x):
        xs = row_sort(x)
        starts = starts_of(xs)
        out = place(bucket_sort(spread(xs, starts)), starts)
        # a cell past its window (less the worst alignment slack) loses keys
        return out, counts_of(starts).max()

    shapes = {"m": m, "W": W, "win": capr * 128, "d": d}
    stages = {"row_sort": row_sort, "starts": starts_of, "spread_inputs": spread_inputs,
              "spread": spread, "bucket_sort": bucket_sort, "place": place}
    return pipeline, shapes, stages


def check_msd(keys: np.ndarray, device, R: int = 128, K: int = 128, capr: int = 24) -> dict:
    """Run the pipeline once; raise unless it equals ``np.sort`` bit for bit
    and every cell fits its window."""
    pipeline, _, _ = build_msd(keys.size, R, K, capr)
    out, maxc = pipeline(_plane(keys, device))
    exact = np.array_equal(out.cpu().numpy().view(np.uint32), np.sort(keys))
    fits = int(maxc) <= capr * 128 - 127
    rec = {"exp": "msd_correct", "R": R, "K": K, "capr": capr, "bit_exact": exact,
           "max_cell": int(maxc), "cell_fits": fits}
    print(json.dumps(rec), flush=True)
    if not (exact and fits):
        raise RuntimeError(f"msd pipeline: {rec}")
    return rec


def exp_msd(keys: np.ndarray, device, R: int = 128, K: int = 128, capr: int = 24) -> dict:
    """:func:`check_msd`, then the pipeline's time in all (inputs chained
    through the scramble) and by stage (each on the last stage's output,
    unchained, since the scramble would break its structure)."""
    check_msd(keys, device, R, K, capr)
    n = keys.size
    pipeline, shapes, st = build_msd(n, R, K, capr)
    x = _plane(keys, device)
    ms = timing.steady_chain_ms(lambda c: pipeline(c)[0], x, reps=5)
    rec = {"exp": "msd_total", "ms": ms, "Mkeys": n / ms / 1e3, **shapes}
    print(json.dumps(rec), flush=True)
    xs = st["row_sort"](x)
    starts = st["starts"](xs)
    cells = st["spread"](xs, starts)
    rows_sorted = st["bucket_sort"](cells)
    stage_ms = {"row_sort": timing.steady_chain_ms(st["row_sort"], x, reps=8)}
    for name, fn in (("starts", lambda: st["starts"](xs)),
                     ("spread", lambda: st["spread"](xs, starts)),
                     ("bucket_sort", lambda: st["bucket_sort"](cells)),
                     ("place", lambda: st["place"](rows_sorted, starts))):
        stage_ms[name] = timing.loop_ms(fn, 8, 2, device)
    for name, v in stage_ms.items():
        print(json.dumps({"exp": "msd_stage", "stage": name, "ms": v}), flush=True)
    rec["stages"] = stage_ms
    return rec


def exp_pairs(keys: np.ndarray, device) -> dict:
    n = keys.size
    x = _plane(keys, device)
    aux = (torch.arange(n - 1, -1, -1, dtype=torch.int32, device=device),    # payload
           torch.arange(n, dtype=torch.int32, device=device))                # index

    def stable2(c, a):        # (key) carrying (payload), stable
        (k,), (po,) = hw_engine.sort_words((c,), (a[0],))
        return k ^ (po & 1)

    def unstable3(c, a):      # (key, index) carrying (payload): two packed key planes
        (k, _), (po,) = hw_engine.sort_words((c, a[1]), (a[0],))
        return k ^ (po & 1)

    def rank2(c, a):          # (key, index), keys only
        (k, io), _ = hw_engine.sort_words((c, a[1]), stable=False)
        return k ^ (io & 1)

    recs = {}
    for name, f in (("pairs_stable_2op", stable2), ("pairs_unstable_3op", unstable3),
                    ("rank_unstable_2op", rank2)):
        ms = timing.steady_chain_ms(f, x, reps=5, aux=aux)
        recs[name] = {"exp": name, "n": n, "ms": ms, "Mkeys": n / ms / 1e3}
        print(json.dumps(recs[name]), flush=True)
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-level sort experiments on one CUDA device")
    ap.add_argument("--only", choices=["kappa", "gather", "msd", "pairs"],
                    help="run a single experiment")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_sol_round2: needs a CUDA device")
    device = torch.device("cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(device)}), flush=True)
    keys = keyfile.generate_keys(40_000_000)
    todo = {"kappa": exp_kappa_curve, "gather": exp_monotone_gather,
            "msd": exp_msd, "pairs": exp_pairs}
    for name, exp in todo.items():
        if args.only in (None, name):
            exp(keys, device)


if __name__ == "__main__":
    main()
