"""K12's routes side by side on one CUDA device.

For each shape (n, planes, num_keys), as the kernel sees it (two or more
payload planes reach it as one index plane), the same stacked planes go
through ``rst_bitonic`` on the route :func:`..ops.cuda_kernels.bitonic_route`
picks and on the tile route (tiles in shared memory plus steps through
device memory), in turns (picked, tiles, tiles, picked). Each route is
checked bit for bit against ``bitonic_plain`` and timed two ways: CUDA
events over a loop of calls (host time included where it is the larger)
and the device time of its kernels per sort (``torch.profiler``). Where
the wrapper picks tiles, the resident route is asked for all the same and
reported as refused where the C entry refuses it (past 4 planes or 2^17
keys, or planes that do not fit). The first key plane holds 16 values, the
other planes are random words from the seed.

Prints one line a shape (with the card's name and power limit first) and
one final JSON line (``"exp": "k12_routes"``). Needs a CUDA device.

Usage: python -m radix_sorting_tpu_torch.scripts.k12_routes
           [--seed S] [--reps R] [n,planes,keys ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops import cuda_kernels as ck

SHAPES = ((1024, 35, 34), (4096, 14, 5), (1024, 5, 2), (1 << 16, 5, 1), (1 << 16, 7, 2),
          (1 << 17, 1, 1), (1 << 17, 3, 2))


def _run(src: torch.Tensor, keys: int, blocks: int) -> torch.Tensor:
    """One K12 launch on the stacked (planes, n) ``src`` on the route of
    ``blocks`` (0: tiles), trips as the wrapper makes them."""
    nplanes, n = src.shape
    words = None
    if blocks and nplanes <= ck.BITONIC_REGISTER_PLANES:
        size = ck.bitonic_pad_len(n)
        words = ck._bitonic_plan(size, nplanes)[1]
    out = torch.empty_like(src)
    ck._launch("rst_bitonic", src.device, src.data_ptr(), out.data_ptr(), nplanes, keys, n,
               blocks, words, len(words) if words is not None else 0)
    return out


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


def _device_ms(fn, calls: int = 8) -> tuple:
    """(device ms of the kernels per call, kernels per call) by torch.profiler;
    a window the tracer left empty is traced again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "bitonic" in e.key]
        us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                 for e in events)
        if events:
            return us / 1e3 / calls, sum(e.count for e in events) / calls
    return None, None


def compare(n: int, nplanes: int, keys: int, seed: int, reps: int) -> dict:
    rng = np.random.default_rng(seed + n + nplanes)
    words = rng.integers(0, 1 << 32, size=(nplanes, n), dtype=np.uint32)
    words[0] &= 15
    src = torch.from_numpy(words.view(np.int32)).to("cuda")
    want = torch.stack(ck.bitonic_plain(tuple(src.unbind(0)), keys))
    picked = ck.bitonic_route(n, nplanes)
    if not picked:
        picked = 8 if ck.bitonic_pad_len(n) >= 8 * 1024 else 1   # the resident route, forced
    routes = {"resident": picked, "tiles": 0}
    row = {"n": n, "planes": nplanes, "keys": keys, "picked": ck.bitonic_route(n, nplanes),
           "routes": {}}
    for name, blocks in routes.items():
        try:
            got = _run(src, keys, blocks)
            torch.cuda.synchronize()
        except RuntimeError as e:
            row["routes"][name] = {"refused": str(e)}
            continue
        if not torch.equal(got, want):
            raise AssertionError(f"k12 route {name} n={n} planes={nplanes}: differs from plain")
        row["routes"][name] = {"blocks": blocks}
    live = [k for k, v in row["routes"].items() if "blocks" in v]
    times = {k: [] for k in live}
    for k in live + live[::-1]:
        blocks = routes[k]
        times[k].append(_event_ms(lambda: _run(src, keys, blocks), reps))
    for k in live:
        blocks = routes[k]
        dev_ms, launches = _device_ms(lambda: _run(src, keys, blocks))
        row["routes"][k].update(event_ms=sum(times[k]) / len(times[k]), device_ms=dev_ms,
                                launches=launches)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("shapes", nargs="*", help="n,planes,keys")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k12_routes needs a CUDA device")
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shapes] or SHAPES
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip().splitlines()[0] if card.strip() else 'not read'}", flush=True)
    rows = []
    for n, nplanes, keys in shapes:
        row = compare(n, nplanes, keys, args.seed, args.reps)
        rows.append(row)
        cells = []
        for k, v in row["routes"].items():
            if "refused" in v:
                cells.append(f"{k}: refused")
            else:
                dev = "not traced" if v["device_ms"] is None else f"{v['device_ms']:.4f} ms"
                cells.append(f"{k} (blocks {v['blocks']}): events {v['event_ms']:.4f} ms, "
                             f"device {dev}, {v['launches']} launches")
        print(f"n={n} planes={nplanes} keys={keys} picked blocks={row['picked']}: "
              + "; ".join(cells), flush=True)
    result = {"exp": "k12_routes", "device": torch.cuda.get_device_name(0), "rows": rows}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
