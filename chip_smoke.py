#!/usr/bin/env python3
"""Time the PyTorch port's kernels and entry points on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py [--n N] [--seed S]
(defaults: 40,000,000 keys, the reference benchmark's size).

The port's correctness on the card lives in the card tests,
``python -m pytest tests/test_torch_cuda.py -q``: each kernel against its
plain version over many shapes, each entry point against numpy with its
launches, every launch counter, the distributed tier and the group mesh.
This script prints the times those tests leave out, and holds each timed
kernel call against its plain version once before timing it. By phase (the
numbers tag the output lines, as PERF.md cites them; numpy makes the
inputs, the entry-point slice being the card tests' own, _Slice and
ENTRY_CASES of tests/test_torch_cuda.py; nothing here imports JAX):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel)
     and print the build time;
  6. time each case and each kernel beside its plain version and, where one
     torch call computes the same function, beside that call (CUDA events,
     steady-state loops; in turns where a line says so; device times by
     torch.profiler): each case of the slice through the public entry
     points on CUDA tensors (n keys unless its name says otherwise; the
     script's own cases, then the card tests' ENTRY_CASES), with the
     launches of one call; then each kernel, first held against its plain
     version on the same inputs (equal; K11's f32 sums within its bound
     of the float64 sums); K1, K2 and K3 with the launch shape each ran beside
     torch.bincount, K1 also on keys of which 90% are one value;
     live_digits over one plane, two dense and two as a pair beside the
     read it replaces (one hist_multi a plane and probes.is_sorted_words); K4 and K7 beside
     torch.searchsorted, K5, K6, K8 and K9 beside torch.repeat_interleave;
     K10 and K11 at nine inputs (up to 2^17 bins, 90% and all rows in one
     group) with their launch shapes beside index_add_; the range probe's
     cost; torch.sort of int32 and int64 keys; the sorter composites and
     the sets beside torch's searchsorted (at five q around the TPU gate
     32 q >= n), topk, sort, cummax, bucketize, unique and isin
     ([6 slice]); K0 and each form of its k0_sweep pass beside their plain
     versions and torch.sort, the two-plane pass dense beside the pair read
     in and the pair written out, the AUTO sort, argsort and sort_pairs
     beside torch.sort in turns, the AUTO u64 sort's launches and device
     time, its keys held against torch.sort's ([6 k0]), scripts/k0_gate.py's sweeps and gates,
     one plane and two ([6 gate]); the LSD sort beside torch.sort and
     AUTO with its byte bound, L1 and L2 per pass; K12 at 2^10 to 2^17
     keys and at the gate's top plane count beside torch.sort of the
     packed key, with its route; E1 beside copy_ and
     utils.timing.stream_gbps (R4); E2 (R = K = 128, capr = 24); the probe
     script's figures and the MSD pipeline's stages; K13 at D = 4 ranks on
     cuda:0 and rows of 10,000,000 / 4 u32 beside the mesh's copy_
     all-to-all, with its one-card bound (2 * D^2 * row bytes);
     distributed_sort of the n keys on four ranks of cuda:0 with each
     exchange beside torch.sort; the measurement entry points, each timing
     itself: cli.main for "40000000 u32", "40000000 u32 0xF0F00000",
     "20000000 u64 0x0000F0F000000000" and "40000000 f32" (its sort
     checked by utils.verify: "verified" must be true) and
     parallel.dryrun.dryrun_multichip on those four ranks at n keys (each
     output against numpy). The distributed lines share one card among
     the D ranks and say nothing of NVLink.
  7. with --profile: device time by kernel (torch.profiler, three calls)
     of each case of the range probes, the dense tier, the group-by slice,
     the LSD sorts of u32 and u64, sort_planes_vmem and sort_batched, and of
     the four-rank distributed_sort with each exchange.
  8. the group mesh (parallel/ over torch.distributed; the workers load
     the kernels phase 2 built): scripts.mp_worker in (a) four processes of
     one rank each on cuda:0 over gloo, exchange="rdma": the balanced
     distributed_sort of the n keys (K13 across the processes through CUDA
     IPC handles) and K13 alone at rows of n / 16 u32, each beside phase
     6's one-process figure, the first call's handle-open cost, the rest of
     the surface at 2^20 keys; (b) one process of four ranks over NCCL.
Then the card's name and power limit, one JSON line of kernels (each with
its launches in one call of each phase 6 case, its largest |kernel - plain|
and its bound: bytes moved over the H100's 3.35 TB/s, or for K12 its
compare-exchanges over 67 T operations/s where that is larger; for K13 the
one-card bound of D ranks sharing cuda:0), and last
{"ok": true, "device": {...}}. A run that fails raises, so the exit code is
non-zero and no result is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def max_err(got, want) -> float:
    """Largest |got - want| over the tensors of two kernel results (nested
    tuples and lists; None holds none); inf where their shapes differ."""
    import torch

    def flat(x):
        if x is None:
            return []
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in flat(v)]
        return [torch.as_tensor(x)]
    a, b = flat(got), flat(want)
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        return float("inf")
    return max((float((x.double() - y.to(x.device).double()).abs().max())
                for x, y in zip(a, b) if x.numel()), default=0.0)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm call (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


PROFILED = ("device_probe", "dynamic_probe", "sort_word_counting",
            "bitmap_unique_sort", "bincount", "multi_digit_histogram",
            "group_reduce", "value_counts", "histogram", "LSD u32 full entropy",
            "LSD u64", "sort_planes_vmem", "sort_batched")
HBM_BYTES_PER_MS = 3.35e9    # the H100 SXM's published 3.35 TB/s
OPS_PER_MS = 67e9            # its published 67 T float32 operations/s, no tensor cores


def kernel_label(name: str) -> str:
    """A kernel's name from the profiler, without namespaces, cut short."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::",
                  "at_cuda_detail::"):
        name = name.replace(noise, "")
    return name[:56]


def k12_route(n: int, nplanes: int) -> str:
    """K12's route for n keys of nplanes planes (the wrapper's choice)."""
    from radix_sorting_tpu_torch.ops import cuda_kernels as ck
    return {0: "tiles", 1: "one block"}.get(ck.bitonic_route(n, nplanes), "cluster")


def hist_label(total: int) -> str:
    """The launch shape the histogram wrappers take for ``total`` counters."""
    from radix_sorting_tpu_torch.ops import cuda_kernels as ck
    return ck.hist_shape(total).label()


def bound_ms(nbytes: int) -> float:
    """Least time to move ``nbytes`` through device memory (every kernel
    here does a few integer operations per 4-byte key: bound by bytes)."""
    return nbytes / HBM_BYTES_PER_MS


def multiprocess_phase(n: int, single_sort_ms: float, single_k13_ms: float) -> None:
    """Phase 8 (the module's docstring): ``scripts.mp_worker`` in (a) four
    processes of one rank over gloo and (b) one of four ranks over NCCL, on
    cuda:0; a worker that fails or outlasts 600 s fails the run."""
    import tempfile

    from radix_sorting_tpu_torch.utils import mpharness

    def launch(nproc, local, backend, tmp, extra=()):
        port = mpharness.free_port()
        cmds = [[sys.executable, "-m", "radix_sorting_tpu_torch.scripts.mp_worker", str(pid),
                 str(nproc), str(port), "--backend", backend, "--device", "cuda",
                 "--exchange", "rdma", "--n", str(1 << 20),
                 "--out", os.path.join(tmp, f"{backend}{pid}.npz"), *extra]
                for pid in range(nproc)]
        t0 = time.perf_counter()
        try:
            res = mpharness.run_workers(cmds, env=mpharness.worker_env(local),
                                        cwd=os.path.dirname(os.path.abspath(__file__)),
                                        timeout_s=600)
        except TimeoutError as e:
            fail(f"phase 8 {backend}: {e}")
        for pid, (rc, text) in enumerate(res):
            if rc != 0:
                fail(f"phase 8 {backend} worker {pid}: exit {rc}\n{text[-6000:]}")
        wall = time.perf_counter() - t0
        lines = [ln for _, text in res for ln in text.splitlines() if ln.startswith("[")]
        stats = [json.loads(str(np.load(os.path.join(tmp, f"{backend}{pid}.npz"))["stats"]))
                 for pid in range(nproc)]
        return stats, lines, wall

    with tempfile.TemporaryDirectory(prefix="rst_phase8_") as tmp:
        a, a_lines, a_wall = launch(4, 1, "gloo", tmp, ("--main-n", str(n)))
        _, b_lines, b_wall = launch(1, 4, "nccl", tmp)
    for ln in [ln for ln in a_lines if ln.startswith("[0]")] + b_lines:
        print(f"[8 processes] {ln}", flush=True)
    print(f"[8 processes] (a) 4 processes x 1 rank on cuda:0, gloo (CUDA control tensors "
          f"through host copies), exchange=rdma: distributed_sort balanced of {n} u32 "
          f"({n // 4} a process): {max(st['sort_ms'] for st in a):.3f} ms a call (host "
          f"clock, the slowest process, {a[0]['D']} ranks) beside {single_sort_ms:.3f} ms on "
          f"4 ranks of one process (phase 6, this run); first call "
          f"{max(st['first_call_ms'] for st in a):.1f} ms, of which allocating, exchanging "
          f"and opening the IPC handles {max(st['open_ms'] for st in a):.1f} ms "
          f"({a[0]['opens']} opened a process); one host round trip (the slowest process): "
          f"a stream sync {max(st['sync_ms'] for st in a):.3f} ms, a gloo meet "
          f"{max(st['meet_ms'] for st in a):.3f} ms, one pivot-search sum of a CUDA "
          f"tensor (to the host, gloo, back) {max(st['sum_ms'] for st in a):.3f} ms; "
          f"launch wall {a_wall:.1f} s", flush=True)
    print(f"[8 processes] (a) K13 across 4 processes, rows of {a[0]['k13_rows']} u32: "
          f"{max(st['k13_ms'] for st in a):.4f} ms a call (barrier form: two stream syncs "
          f"and two gloo meets, then the copy out of the receive buffer; the slowest "
          f"process), beside {single_k13_ms:.4f} ms for one process's 4 launches (phase 6, "
          f"this run)", flush=True)
    print(f"[8 processes] (b) 1 process x 4 ranks on cuda:0 over NCCL (world size 1): "
          f"the surface at 2^20 keys, exchange=rdma and xla; launch wall {b_wall:.1f} s",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=40_000_000)
    ap.add_argument("--seed", type=int, default=20240601)
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel (torch.profiler) "
                         "for the range-probe and dense-tier cases")
    args = ap.parse_args()
    n = args.n

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    print(smi[0], flush=True)
    print(f"[1 device] {smi[0]} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {kind}", flush=True)

    import radix_sorting_tpu_torch as rt
    from radix_sorting_tpu_torch.ops import (_build, counting_engine, hw_engine, kdf,
                                             lsd_engine, probes, scan)
    from radix_sorting_tpu_torch.ops import cuda_kernels as ck
    from radix_sorting_tpu_torch.ops.vmem_sort import sort_planes_vmem
    from radix_sorting_tpu_torch.ops.histogram import multi_digit_histogram
    from radix_sorting_tpu_torch.ops.kdf import i32
    from radix_sorting_tpu_torch.ops.vmem_sort import vmem_sort_ok
    from radix_sorting_tpu_torch.scripts import exp_sol_probe, exp_sol_round2, k0_gate
    from radix_sorting_tpu_torch.utils import timing
    from radix_sorting_tpu_torch.parallel import _mesh, distributed_sort, make_sort_mesh
    from radix_sorting_tpu_torch.parallel.dryrun import dryrun_multichip
    from radix_sorting_tpu_torch import cli
    # the card tests' entry-point slice, by the file's path: an installed
    # package named "tests" would shadow the repository's directory
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_cuda import ENTRY_CASES, _Slice

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.1f} s -> {path.name}; "
          f"ptxas: {' | '.join(ptxas) or 'cached'}", flush=True)

    dev = torch.device("cuda", 0)
    d = _Slice(n, dev, args.seed)          # the card tests' entry-point inputs
    keys, keys64, dups = d.keys, d.keys64, d.dups
    rng = np.random.Generator(np.random.PCG64(args.seed + 1))
    w = torch.from_numpy(keys.view(np.int32)).to(dev)
    hi64 = torch.from_numpy((keys64 >> np.uint64(32)).astype(np.uint32).view(np.int32)).to(dev)
    lo64 = torch.from_numpy(keys64.astype(np.uint32).view(np.int32)).to(dev)
    keys64_t = torch.from_numpy(keys64.view(np.int64)).to(dev)

    # -- the kernels' inputs (phase 6 times each beside its plain version) --
    # K5 / K8 and K6 / K9 with dead bits in every plane; K1 drops the top
    # quarter of the keys (drop_ge), K4 / K7 add the range probe's offset
    regen_inputs = {}
    for mask, dead, name in ((0xF0F00000, 0x00010003, "regen_pdep"),
                             (0xFFFF, 0, "regen_pdep_windowed")):
        plane = (w & i32(mask)) | dead
        regen_inputs[name] = (torch.cumsum(ck.hist_pext(plane, mask), 0, dtype=torch.int32),
                              mask, plane)
    regen2_inputs = {}
    for m64, dead, name in ((0xF000000000000F00, 0x0001000300000005, "regen_pdep2"),
                            (0x00FF00000000FF00, 0x8000000100000003,
                             "regen_pdep2_windowed")):
        mh, ml = m64 >> 32, m64 & 0xFFFFFFFF
        phi = (hi64 & i32(mh)) | i32(dead >> 32)
        plo = (lo64 & i32(ml)) | i32(dead & 0xFFFFFFFF)
        regen2_inputs[name] = (torch.cumsum(ck.hist_pext2(phi, plo, mh, ml), 0,
                                            dtype=torch.int32), mh, ml, phi, plo)
    drop_ge, offset = 0xC0000000, 0x9E3779B9
    dense_inputs = {name: torch.cumsum(ck.hist(w & i32((1 << bits) - 1), 0, bits), 0,
                                       dtype=torch.int32)
                    for bits, name in ((10, "regen"), (16, "regen_windowed"))}
    # the group-by tier: K10 counts and wrapping sums, K11 f32 sums; past
    # 2^14 bins with counts 16-bit counts, whose hand-offs run under
    # contention where most rows are in one group
    vals_i32 = lo64                                     # full-range int32 values
    vals_u8 = lo64 & 0xFF                               # u8 values, u32-converted
    skewed_k = w & 1023
    skewed_k[: n * 9 // 10] = 7                         # 90% of the rows one group
    skewed_wide = w & 0x1FFFF
    skewed_wide[: n * 9 // 10] = 0x1ABCD
    one_k = torch.full_like(w, 0x2A55)                  # every row one group
    weights = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    whist_inputs = [(w & 1023, vals_i32, 10, 1000, "i32 values, 1,000 of 1,024 kept"),
                    (w & 0xFFFF, vals_u8, 16, 1 << 16, "u8 values"),
                    (skewed_k, vals_i32, 10, 1024, "90% one group"),
                    (w & 0x1FFFF, vals_i32, 17, 1 << 17, "i32 values"),
                    (one_k, vals_i32, 16, 1 << 16, "all rows one group"),
                    (skewed_wide, vals_u8, 17, 1 << 17, "u8 values, 90% one group")]
    whist_f32_inputs = [(w & 1023, 10, 1000, True), (w & 0x7FFF, 15, 1 << 15, False),
                        (w & 0xFFFF, 16, 1 << 16, True)]
    # the LSD passes: L1 and L2 for the lowest digit, at r = 8, 11 and 16
    idx32 = torch.arange(n, dtype=torch.int32, device=dev)
    lsd_inputs = {}
    for bits in (8, 11, 16):
        tile = lsd_engine.lsd_tile(8192, bits)
        lsd_inputs[bits] = (tile, scan.scatter_bases(ck.lsd_hist(w, 0, bits, tile)))

    def sweep_starts(keys_in, shift):
        """The exclusive scan of the 8-bit digit's histogram (K0's starts)."""
        h = torch.bincount(((keys_in >> shift) & 0xFF).long(), minlength=256)
        return (torch.cumsum(h, 0) - h).to(torch.int32)

    # K12 at the gate's top plane count at 1,024 keys: 16 values in the first
    # key plane, an index plane (the third), random words elsewhere
    top = max(p for p in range(1, 4096) if vmem_sort_ok(1024, p))
    words = rng.integers(0, 1 << 32, size=(top, 1024), dtype=np.uint32)
    words[0] &= 15
    words[2] = np.arange(1024)
    top_planes = tuple(torch.from_numpy(words.view(np.int32)).to(dev).unbind(0))
    # E2: the spread step on the keys as 128 sorted rows, 128 buckets
    n_msd = n // 128 * 128
    _, msd_shapes, msd = exp_sol_round2.build_msd(n_msd, 128, 128, 24)
    xs = msd["row_sort"](w[:n_msd])
    s128, xp = msd["spread_inputs"](xs, msd["starts"](xs))
    spread_args = (s128, xp, msd_shapes["m"], msd_shapes["d"], 24)
    del xs
    # K13: D ranks on cuda:0, each rank's sends its own random words
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def rank_sends(D, shape, dtype):
        lim = 1 << (15 if dtype == torch.int16 else 31)
        return [torch.randint(-lim, lim, shape, dtype=dtype, device=dev, generator=gen)
                for _ in range(D)]

    mesh4 = make_sort_mesh(devices=[dev] * 4)

    # -- the script's own cases through the public entry points (phase 6
    # times each and then the card tests' ENTRY_CASES; phase 7 traces some)
    bf16 = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    idx = rng.integers(0, n, size=4096)
    bf16[idx] = np.array([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC1, 0xFFC3],
                         np.uint16)[np.arange(idx.size) % 6]
    f8 = rng.integers(0, 256, size=n, dtype=np.uint8)
    mask = 0xF0F00000
    m_k6, m_k9, m_24 = 0xF000000000000F00, 0x00FF00000000FF00, 0x0FFF00000000FFF0
    keys_t, sorted_t, u16_t = d.cu(keys), d.cu(d.sorted_keys), d.cu(d.u16)
    f32_t, f64_t = d.cu(d.f32b.view(np.float32)), d.cu(d.f64b.view(np.float64))
    pay_f32_t = d.cu(d.pay_f32)
    payload = {"i64": d.cu(d.pay_i64), "f32": pay_f32_t}
    desc = rt.SortConfig(descending=True)
    # the LSD slice: configurations, a byte field, bench.py's 4,096-key rows
    lsd8 = rt.SortConfig(strategy=rt.Strategy.LSD)
    lsd11 = lsd8.replace(radix_bits=11)
    names6 = rng.integers(0, 256, size=(n, 6), dtype=np.uint8)
    payload_b = dict(payload, name=torch.from_numpy(names6).to(dev))
    n_rows = n // 4096
    m17 = 1 << 17
    iota17 = torch.arange(m17, dtype=torch.int32, device=dev)

    # the range probe's and the dense tier's inputs
    probe = rt.SortConfig(device_probe=True)
    r50k = (np.uint64(0x9E3779B9) + rng.integers(0, 50_000, size=n).astype(np.uint64)
            ).astype(np.uint32)
    r1k = (np.uint64(0x7FFFFE00) + rng.integers(0, 1000, size=200_000).astype(np.uint64)
           ).astype(np.uint32)                     # across 0x80000000
    ts_hi = np.uint64(0x0000018F00000000)          # ms timestamps in one 2^32 span
    ts_full = ts_hi | keys.astype(np.uint64)
    ts_60k = ts_hi | (np.uint64(0x7FFF8000) + rng.integers(0, 60_000, size=n).astype(np.uint64))
    m10 = 0x3FF << 12
    counts_in = rng.integers(0, 1000, size=n).astype(np.int32)
    out_of_range = rng.random(n) < 0.01
    counts_in[out_of_range] = 1000 + rng.integers(0, 1 << 20, size=int(out_of_range.sum()))

    # the group-by slice: bench.py's group-by case (k = x & 1023, v =
    # int32(x >> 10)), then 65,536 groups, f32 values and histograms
    v_bench_t = d.cu(d.v_bench)
    v_u8_t = torch.from_numpy((keys64 >> np.uint64(56)).astype(np.uint8)).to(dev)
    hist_w_t = torch.from_numpy(d.pay_f32[::-1].copy()).to(dev)
    edges64 = d.edges32.astype(np.float64)

    cases = [
        # name, input maker, entry point
        ("u32 full entropy (sorter)", lambda: d.cu(keys), rt.sort),
        ("argsort u32 full entropy (sorter)", lambda: d.cu(keys), rt.argsort),
        ("u32 presorted (guard)", lambda: sorted_t.clone(), rt.sort),
        ("u32 value_mask=0xF0F00000 (K2+K5)", lambda: d.cu(keys & np.uint32(mask)),
         lambda x: rt.sort(x, value_mask=mask)),
        ("u8 (K2+K5)", lambda: d.cu(keys.astype(np.uint8)), rt.sort),
        ("u16 (K2+K8)", lambda: u16_t.clone(), rt.sort),
        ("bf16 +-0 +-inf NaN (K2+K8)",
         lambda: torch.from_numpy(bf16.view(np.int16)).to(dev).view(torch.bfloat16), rt.sort),
        ("f32 +-0 +-inf NaN (sorter)", lambda: f32_t.clone(), rt.sort),
        ("u16 descending (K2+K8)", lambda: u16_t.clone(), lambda x: rt.sort(x, config=desc)),
        ("u64 full entropy (sorter)", lambda: d.cu(keys64), rt.sort),
        ("i64 (sorter)", lambda: d.cu(keys64.view(np.int64)), rt.sort),
        ("f64 +-0 +-inf NaN payloads (sorter)", lambda: f64_t.clone(), rt.sort),
        ("u64 value_mask=0xF000000000000F00 (K3+K6)",
         lambda: d.cu(keys64 & np.uint64(m_k6)), lambda x: rt.sort(x, value_mask=m_k6)),
        ("u64 value_mask=0x00FF00000000FF00 (K3+K9)",
         lambda: d.cu(keys64 & np.uint64(m_k9)), lambda x: rt.sort(x, value_mask=m_k9)),
        ("u64 descending value_mask=0xF000000000000F00 (K3+K6)",
         lambda: d.cu(keys64 & np.uint64(m_k6)),
         lambda x: rt.sort(x, value_mask=m_k6, config=desc)),
        ("u64 24 live bits 0x0FFF00000000FFF0 (compacted sorter)",
         lambda: d.cu(keys64 & np.uint64(m_24)), lambda x: rt.sort(x, value_mask=m_24)),
        ("float8_e4m3fn (K2+K5)",
         lambda: torch.from_numpy(f8).to(dev).view(torch.float8_e4m3fn), rt.sort),
        ("device_probe u32 in [0x9E3779B9, +50,000) (K1+K7)", lambda: d.cu(r50k),
         lambda x: rt.sort(x, config=probe)),
        ("device_probe u32, 200,000 keys in a range of 1,000 (K1+K4)",
         lambda: d.cu(r1k), lambda x: rt.sort(x, config=probe)),
        ("device_probe u32 full entropy (sorter)", lambda: d.cu(keys),
         lambda x: rt.sort(x, config=probe)),
        ("device_probe u64, constant hi, full lo (one int32 sorter operand)",
         lambda: d.cu(ts_full), lambda x: rt.sort(x, config=probe)),
        ("device_probe u64, constant hi, lo in a 60,000 range (K1+K7)",
         lambda: d.cu(ts_60k), lambda x: rt.sort(x, config=probe)),
        ("dynamic_probe u32, unpromised mask 0xF0F00000 (K2+K5)",
         lambda: d.cu(keys & np.uint32(mask)),
         lambda x: rt.sort(x, config=rt.SortConfig(dynamic_probe=True))),
        ("sort_word_counting 10-bit mask, descending (K1+K4)",
         lambda: d.cu(keys & np.uint32(m10)).view(torch.int32),
         lambda x: counting_engine.sort_word_counting(x, m10, descending=True)),
        ("LSD u32 full entropy, r=8 (L1+L2; the slice's main path)",
         lambda: d.cu(keys), lambda x: rt.sort(x, config=lsd8)),
        ("LSD u32 full entropy, r=11 (L1+L2)", lambda: d.cu(keys),
         lambda x: rt.sort(x, config=lsd11)),
        ("LSD u32 value_mask=0xF0F00000, 2 of 4 passes live (L1+L2)",
         lambda: d.cu(keys & np.uint32(mask)),
         lambda x: rt.sort(x, config=lsd8, value_mask=mask)),
        ("LSD u64 full entropy, 8 passes (L1+L2)", lambda: d.cu(keys64),
         lambda x: rt.sort(x, config=lsd8)),
        ("LSD f32 +-0 +-inf NaN (L1+L2)", lambda: f32_t.clone(),
         lambda x: rt.sort(x, config=lsd8)),
        ("LSD u16 descending (L1+L2)", lambda: u16_t.clone(),
         lambda x: rt.sort(x, config=lsd8.replace(descending=True))),
        ("LSD argsort u32 with duplicates (L1+L2, stable)", lambda: d.cu(dups),
         lambda x: rt.argsort(x, config=lsd8)),
        ("LSD sort_pairs u32 with duplicates, {i64, f32, 6-byte field} (L1+L2)",
         lambda: d.cu(dups), lambda x: rt.sort_pairs(x, payload_b, config=lsd8)),
        ("sort_planes_vmem 131,072 keys + index plane (K12)",
         lambda: w[:m17].clone(), lambda x: sort_planes_vmem((x, iota17), 2)),
        ("models.RadixSorterU32 with LSD (L1+L2)", lambda: d.cu(keys),
         rt.models.RadixSorterU32(lsd8)),
        ("models.GenericRadixSorter with LSD, f32 with specials (L1+L2)", lambda: f32_t.clone(),
         rt.models.GenericRadixSorter(lsd8)),
        ("bitmap_unique_sort u16 (K1)", lambda: u16_t.clone(), rt.bitmap_unique_sort),
        ("bincount length 1,000, 1% out of range (K1)",
         lambda: torch.from_numpy(counts_in).to(dev), lambda x: rt.bincount(x, length=1000)),
        ("multi_digit_histogram r=8 (K1)", lambda: d.cu(keys).view(torch.int32),
         lambda x: multi_digit_histogram([x], 8)),
        ("group_reduce sum of i32 values, 1,024 groups (bench.py group-by case; K10)",
         lambda: d.cu(d.k1024),
         lambda x: rt.group_reduce(x, v_bench_t, reduce="sum", groups=1024, size=1024)),
        ("group_reduce mean of f32 values, 1,024 groups (K11 with counts)",
         lambda: d.cu(d.k1024),
         lambda x: rt.group_reduce(x, pay_f32_t, reduce="mean", groups=1024)),
        ("group_reduce sum of u8 values, 65,536 groups (K10, two grid rows)",
         lambda: d.cu(dups),
         lambda x: rt.group_reduce(x, v_u8_t, reduce="sum", groups=1 << 16)),
        ("value_counts groups=1024 (K1)", lambda: d.cu(d.k1024),
         lambda x: rt.value_counts(x, groups=1024)),
        ("histogram of standard normal f32, 256 bins (K1)",
         lambda: pay_f32_t, lambda x: rt.histogram(x, bins=256)),
        ("histogram of standard normal f32, 256 bins, weighted (K11)",
         lambda: pay_f32_t, lambda x: rt.histogram(x, bins=256, weights=hist_w_t)),
        ("histogram f32 with 1,001 edges (K1)", lambda: pay_f32_t,
         lambda x: rt.histogram(x, bins=edges64)),
        ("histogram f32 with 1,001 edges, weighted (K11)", lambda: pay_f32_t,
         lambda x: rt.histogram(x, bins=edges64, weights=hist_w_t)),
        (f"top_k_batched ({n_rows}, 4096) u32 rows, k=16 (bench.py batched case)",
         lambda: d.cu(d.rows_u32), lambda x: rt.top_k_batched(x, 16)),
        ("unique u16, return_counts=True (K2+K8)", lambda: u16_t,
         lambda x: rt.unique(x, return_counts=True)),
    ]

    def timed_cases():
        """(name, args, call) of each case: the script's own, then the card
        tests' ENTRY_CASES on the same slice (inputs made a case at a time)."""
        for name, make, call in cases:
            yield name, (make(),), call
        for name, case in ENTRY_CASES.items():
            xs, call, _ = case(d)
            yield name, xs, call

    def profiled(label, run, top, calls=3):
        """Phase 7: device time by kernel of ``calls`` calls of run."""
        from torch.profiler import ProfilerActivity, profile
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        # device-side events only (kernels, copies, memsets): an aten op's
        # own row repeats the time of the kernels it launched
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in rows) / calls / 1e3
        print(f"[7 profile] {label}: device {total:.3f} ms per call; " + "; ".join(
            f"{kernel_label(e.key)} {e.self_device_time_total / calls / 1e3:.4f} ms "
            f"x{e.count // calls}" for e in rows[:top]), flush=True)

    # -- phase 6: times ----------------------------------------------------
    reps = 10
    launches = dict.fromkeys(ck.LAUNCHES, 0)       # in one call of each case
    for name, xs, call in timed_cases():
        rt.reset_launch_counts()
        call(*xs)
        counts = {k: c for k, c in rt.launch_counts().items() if c}
        for k, c in counts.items():
            launches[k] += c
        ms = time_ms(lambda: call(*xs), reps)
        m = xs[0].numel() if torch.is_tensor(xs[0]) else len(xs[0])
        print(f"[6 time] {name}: {ms:.3f} ms, {m / ms / 1e3:.1f} Mkeys/s; launches {counts}",
              flush=True)
        if args.profile and name.startswith(PROFILED):
            profiled(name, lambda: call(*xs), 8)
    del xs
    for label, t in (("int32", w), ("int64", keys64_t)):
        ms = time_ms(lambda: torch.sort(t), reps)
        print(f"[6 time] torch.sort {label} (reference point): {ms:.3f} ms, "
              f"{n / ms / 1e3:.1f} Mkeys/s", flush=True)

    # the sorter composites beside one torch call of the same function, in
    # turns; searchsorted by both methods around its TPU gate 32 * q = n
    def in_turns(fns, calls=reps):
        """Mean ms of each function timed in turns: the order, then back."""
        got = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            got[k].append(time_ms(fns[k], calls))
        return {k: sum(v) / len(v) for k, v in got.items()}

    def slice_line(name, fns):
        ms = in_turns(fns)
        print(f"[6 slice] {name}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()),
              flush=True)

    def flip32(t):
        return t.view(torch.int32) ^ i32(1 << 31)

    key_sorted = flip32(sorted_t)
    q_scan, q_cross = 100_000, -(-n // 32)
    qs_big = d.cu(d.hits(keys, min(16 * q_cross, n), d.rand32))
    for q in sorted({q_scan, q_cross // 4, q_cross, 4 * q_cross, 16 * q_cross}):
        qt = qs_big[:q]
        kq = flip32(qt)
        slice_line(f"searchsorted u32 n={n} q={q} (32q/n = {32 * q / n:.2f}; 'auto' takes "
                   f"{'sort' if 32 * q >= n else 'scan'})",
                   {"method='scan'": lambda: rt.searchsorted(sorted_t, qt, method="scan"),
                    "method='sort'": lambda: rt.searchsorted(sorted_t, qt, method="sort"),
                    "torch.searchsorted int32": lambda: torch.searchsorted(
                        key_sorted, kq, out_int32=True)})
    q64_t, sorted64_t = ENTRY_CASES["searchsorted u64, q = 4,000,000 (tagged union)"](d)[0]
    key64_sorted = sorted64_t.view(torch.int64) ^ (-(1 << 63))
    kq64 = q64_t.view(torch.int64) ^ (-(1 << 63))
    slice_line(f"searchsorted u64 n={n} q={q64_t.numel()} (tagged union)",
               {"searchsorted": lambda: rt.searchsorted(sorted64_t, q64_t),
                "torch.searchsorted int64": lambda: torch.searchsorted(
                    key64_sorted, kq64, out_int32=True)})
    kt32 = flip32(keys_t)
    slice_line("top_k u32 k=1000", {"top_k": lambda: rt.top_k(keys_t, 1000),
                                    "torch.topk int32": lambda: torch.topk(kt32, 1000)})
    slice_line("top_k f64 k=1000", {"top_k": lambda: rt.top_k(f64_t, 1000),
                                    "torch.topk float64": lambda: torch.topk(f64_t, 1000)})
    rows_t = d.cu(d.rows_u32)
    rows_t32 = flip32(rows_t)
    slice_line(f"top_k_batched ({n_rows}, 4096) u32 k=16",
               {"top_k_batched": lambda: rt.top_k_batched(rows_t, 16),
                "torch.topk(dim=-1) int32": lambda: torch.topk(rows_t32, 16, dim=-1)})
    lex8 = list(ENTRY_CASES["lexsort (u8, u8, u16): one packed plane"](d)[0])
    slice_line("lexsort (u8, u8, u16), one packed plane",
               {"lexsort": lambda: rt.lexsort(lex8),
                "torch.sort(stable=True) int32": lambda: torch.sort(kt32, stable=True)})
    dups_t32 = d.cu(dups)
    kd32 = flip32(dups_t32)
    slice_line("rankdata u32 with duplicates 'average'",
               {"rankdata": lambda: rt.rankdata(dups_t32),
                "torch.sort(stable=True) int32 (its argsort)": lambda: torch.sort(
                    kd32, stable=True),
                "torch.cummax int32 (not called: the JAX package's lax.cummax)":
                    lambda: torch.cummax(kd32, 0)})
    edges_t = d.cu(d.edges32)
    slice_line("digitize f32 against 1,001 edges",
               {"digitize": lambda: rt.digitize(pay_f32_t, edges_t),
                "torch.bucketize": lambda: torch.bucketize(pay_f32_t, edges_t, right=True,
                                                           out_int32=True)})
    # the sets slice beside torch.unique / torch.isin of the same keys (the
    # sign-flipped int32 key: the same order)
    slice_line("unique u32 values", {
        "unique": lambda: rt.unique(keys_t),
        "torch.unique(sorted=True) int32": lambda: torch.unique(kt32, sorted=True)})
    slice_line("unique u32 return_counts=True", {
        "unique": lambda: rt.unique(keys_t, return_counts=True),
        "torch.unique(sorted=True, return_counts=True) int32": lambda: torch.unique(
            kt32, sorted=True, return_counts=True)})
    slice_line("unique_all u32", {
        "unique_all": lambda: rt.unique_all(keys_t),
        "torch.unique(sorted=True, return_inverse=True, return_counts=True) int32 (no index)":
            lambda: torch.unique(kt32, sorted=True, return_inverse=True, return_counts=True)})
    rows8_t = d.cu(d.rows8)
    slice_line(f"unique(axis=0, every flag) of {tuple(d.rows8.shape)} int32 rows", {
        "unique": lambda: rt.unique(rows8_t, axis=0, return_index=True, return_inverse=True,
                                    return_counts=True),
        "torch.unique(dim=0, return_inverse=True, return_counts=True) (no index)":
            lambda: torch.unique(rows8_t, dim=0, return_inverse=True, return_counts=True)})
    tests_t, set_b_t = d.cu(d.tests), d.cu(d.set_b)
    tests32, set_b32 = flip32(tests_t), flip32(set_b_t)
    slice_line(f"isin of the n u32 keys against {d.tests.size:,} tests", {
        "isin": lambda: rt.isin(keys_t, tests_t),
        "torch.isin int32": lambda: torch.isin(kt32, tests32)})
    slice_line(f"union1d of two {n:,} u32 arrays", {
        "union1d": lambda: rt.union1d(keys_t, set_b_t),
        "torch.unique(torch.cat) int32": lambda: torch.unique(torch.cat([kt32, set_b32]))})
    del qs_big, q64_t, sorted64_t, rows_t, rows_t32, lex8, kt32, kd32, rows8_t, tests_t, \
        set_b_t, tests32, set_b32

    def turns3(kernel, plain, library=None):
        """Kernel, plain version and library call in turns (plain, library,
        kernel, kernel, library, plain); the library's ms is None without one."""
        p1, l1, k1, k2, l2, p2 = (time_ms(f, reps) if f else None for f in
                                  (plain, library, kernel, kernel, library, plain))
        return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2 if library else None

    shapes = {name: [] for name in ck.LAUNCHES}
    errs = dict.fromkeys(ck.LAUNCHES, 0.0)

    def row(name, bins, nbytes, kernel, plain, library=None, ops=0, check=None, **extra):
        """Time kernel beside plain (and library) after holding one call of
        each against the other: equal, or ``check(kernel's, plain's)``
        (which fails the run itself) where floats may differ."""
        got, want = kernel(), plain()
        err = check(got, want) if check else max_err(got, want)
        if err and not check:
            fail(f"{name} {extra}: max |kernel - plain| {err}")
        errs[name] = max(errs[name], err)
        del got, want
        k, p, lib = turns3(kernel, plain, library)
        by_ops = ops / OPS_PER_MS > bound_ms(nbytes)
        shapes[name].append({"bins": bins, **extra, "ms": k, "plain_ms": p,
                             "library_ms": lib, "bytes": nbytes,
                             "bound_ms": max(bound_ms(nbytes), ops / OPS_PER_MS),
                             "bound_by": "operations" if by_ops else "bytes"})

    def device_trace(fn, name=None, calls=8):
        """(kernels named ``name`` that one call of fn launches on the card,
        their device ms per call): torch.profiler over ``calls`` calls;
        name None takes every device event. The tracer can drop a window's
        events, so an empty window is traced again."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and (name is None or name in e.key)]
            if events:
                return (sum(e.count for e in events) / calls,
                        sum(e.self_device_time_total for e in events) / calls / 1e3)
        fail(f"no {name or 'device'} event traced in three windows of {calls} calls")

    # K2 / K3 beside torch.bincount of the precomputed PEXT values, each with
    # its launch shape and the device time of one call (memset and kernel)
    for mask in (0xF0F00000, 0xFFFF):
        bins = 1 << bin(mask).count("1")
        pext = probes.compact_live_bits(w, mask).long()
        kernel = lambda: ck.hist_pext(w, mask)
        row("hist_pext", bins, n * 4 + bins * 4, kernel, lambda: ck.hist_pext_plain(w, mask),
            lambda: torch.bincount(pext, minlength=bins), shape=hist_label(bins),
            device_ms=device_trace(kernel)[1])
        del pext
    # K5 / K8 and K6 / K9 beside torch.repeat_interleave of every bin's key
    # (its live bits PDEP'd, the dead bits of the first key; two planes packed
    # into one int64) by the bin's count, both made before the timing
    def bin_counts(cum):
        return torch.diff(cum, prepend=cum.new_zeros(1))

    for name, (cum, mask, plane) in regen_inputs.items():
        counts = bin_counts(cum)
        bin_keys = probes.expand_live_bits(
            torch.arange(cum.numel(), dtype=torch.int32, device=dev), mask) | (plane[0] & i32(~mask))
        row(name, cum.numel(), n * 4 + cum.numel() * 4 + 4,
            lambda: ck.regen_pdep(cum, n, mask, plane),
            lambda: ck.regen_pdep_plain(cum, n, mask, plane),
            lambda: torch.repeat_interleave(bin_keys, counts, output_size=n))
    for m64 in (0xF000000000000F00, 0x00FF00000000FF00):
        mh, ml = m64 >> 32, m64 & 0xFFFFFFFF
        bins = 1 << bin(m64).count("1")
        pext = probes.compact_word_planes((hi64, lo64), (mh, ml)).long()
        kernel = lambda: ck.hist_pext2(hi64, lo64, mh, ml)
        row("hist_pext2", bins, n * 8 + bins * 4, kernel,
            lambda: ck.hist_pext2_plain(hi64, lo64, mh, ml),
            lambda: torch.bincount(pext, minlength=bins), shape=hist_label(bins),
            device_ms=device_trace(kernel)[1])
        del pext
    for name, (cum, mh, ml, phi, plo) in regen2_inputs.items():
        counts = bin_counts(cum)
        khi, klo = probes.expand_word_planes(
            torch.arange(cum.numel(), dtype=torch.int32, device=dev), (phi, plo), (mh, ml))
        bin_keys = (khi.long() << 32) | (klo.long() & 0xFFFFFFFF)
        row(name, cum.numel(), n * 8 + cum.numel() * 4 + 8,
            lambda: ck.regen_pdep2(cum, n, mh, ml, phi, plo),
            lambda: ck.regen_pdep2_plain(cum, n, mh, ml, phi, plo),
            lambda: torch.repeat_interleave(bin_keys, counts, output_size=n))
    del counts, bin_keys

    # K1 beside torch.bincount of the same digits (dropped keys to a spill
    # bin, as the plain version does), computed before the timing
    u = w.long() & 0xFFFFFFFF
    skewed = w.clone()
    skewed[: n * 9 // 10] = 0x155                   # 90% of the keys one value
    for bits, keys_in, drop, label in ((8, w, drop_ge, "uniform"),
                                       (16, w, drop_ge, "uniform"),
                                       (18, w, drop_ge, "uniform"),
                                       (16, skewed, None, "90% one value")):
        bins = 1 << bits
        uk = keys_in.long() & 0xFFFFFFFF
        digits = uk & (bins - 1) if drop is None else torch.where(
            uk < drop, uk & (bins - 1), bins)
        kernel = lambda: ck.hist(keys_in, 0, bits, drop_ge=drop)
        row("hist", bins, n * 4 + bins * 4, kernel,
            lambda: ck.hist_plain(keys_in, 0, bits, drop),
            lambda: torch.bincount(digits, minlength=bins + 1),
            keys=label, drop_ge=drop, shape=hist_label(bins),
            device_ms=device_trace(kernel)[1])
        del digits, uk
    for bits in (8, 11):
        passes, bins = -(-32 // bits), 1 << bits
        flat = torch.cat([(p << bits) + ((u >> (p * bits)) & ((1 << bits) - 1))
                          for p in range(passes)])
        kernel = lambda: ck.hist_multi(w, bits)
        row("hist_multi", bins, n * 4 + passes * bins * 4,
            kernel, lambda: ck.hist_multi_plain(w, bits),
            lambda: torch.bincount(flat, minlength=passes * bins), passes=passes,
            shape=hist_label(passes * bins), device_ms=device_trace(kernel)[1])
        del flat
    # K1's live-digit read with the guard's flag, one plane, two dense and
    # two as a pair (the halves of the u64 keys, as the AUTO u64 sort reads
    # them), beside what it replaces: one hist_multi a dense plane and the
    # guard's torch passes
    for form, planes, dense in (("one plane", (w,), (w,)),
                                ("dense", (hi64, lo64), (hi64, lo64)),
                                ("pair", kdf.halves(keys64_t), (hi64, lo64))):
        total = len(planes) * 4 * 256
        kernel = lambda: ck.live_digits(planes, 8)
        row("live_digits", 256, n * 4 * len(planes) + total * 4 + 4,
            kernel, lambda: ck.live_digits_plain(planes, 8),
            lambda: ([ck.hist_multi(p, 8) for p in dense], probes.is_sorted_words(dense)),
            planes=len(planes), form=form, shape=hist_label(total),
            device_ms=device_trace(kernel)[1])
    del u, skewed
    # K4 / K7 beside torch.searchsorted(cum, arange(n), right=True)
    j = torch.arange(n, dtype=torch.int32, device=dev)
    for name, cum in dense_inputs.items():
        row(name, cum.numel(), n * 4 + cum.numel() * 4,
            lambda: ck.regen(cum, n, offset), lambda: ck.regen_plain(cum, n, offset),
            lambda: torch.searchsorted(cum, j, right=True))
    del j
    # K10 / K11 beside one torch call of their sums (index_add_ into a spill
    # bin, computed before the timing); the bound counts one read of keys and
    # values, the kernel reads them once per grid row of its launch shape
    for k, v, bits, drop, label in whist_inputs:
        bins = 1 << bits
        idx = torch.where((k.long() & 0xFFFFFFFF) < drop, k.long() & 0xFFFFFFFF, bins)
        shape = ck.whist_shape(bits, "u32", True)
        row("whist", bins, n * 8 + bins * 8, lambda: ck.whist(k, v, bits, drop),
            lambda: ck.whist_plain(k, v, bits, drop),
            lambda: torch.zeros(bins + 1, dtype=torch.int32, device=dev).index_add_(0, idx, v),
            keys=label, shape=shape.label(), reads=shape.ranges)
    def f32_sums(idx, bins, with_counts):
        """K11's check: the counts equal, the kernel's and the plain sums
        each within sum|w| * 2^-14 + 1e-5 of the float64 sums a bin."""
        w64 = weights.double()
        ref = torch.zeros(bins + 1, dtype=torch.float64, device=dev).index_add_(0, idx, w64)
        bound = torch.zeros_like(ref).index_add_(0, idx, w64.abs()) * 2.0 ** -14 + 1e-5

        def check(got, want):
            if with_counts and max_err(got[0], want[0]):
                fail(f"whist_f32_counts bins={bins}: the counts differ from plain")
            sums = (got[1], want[1]) if with_counts else (got, want)
            if any(bool(((s.double() - ref[:bins]).abs() > bound[:bins]).any()) for s in sums):
                fail(f"whist_f32 bins={bins}: sums past K11's bound")
            return max_err(*sums)
        return check

    for k, bits, drop, with_counts in whist_f32_inputs:
        bins, per_bin = 1 << bits, 8 if with_counts else 4
        idx = torch.where((k.long() & 0xFFFFFFFF) < drop, k.long() & 0xFFFFFFFF, bins)
        shape = ck.whist_shape(bits, "f32", with_counts)
        row("whist_f32_counts" if with_counts else "whist_f32", bins, n * 8 + bins * per_bin,
            lambda: ck.whist_f32(k, weights, bits, drop, with_counts),
            lambda: ck.whist_f32_plain(k, weights, bits, drop, with_counts),
            lambda: torch.zeros(bins + 1, dtype=torch.float32,
                                device=dev).index_add_(0, idx, weights),
            check=f32_sums(idx, bins, with_counts), shape=shape.label(), reads=shape.ranges)
    del idx
    # L1 beside torch.bincount of the precomputed tile-major digits; L2 with
    # keys and an index plane (as argsort carries) and with the key plane
    # alone (the LSD sort's own pass), no one torch call; each with the
    # device time of its kernel
    for bits, (tile, bases) in lsd_inputs.items():
        bins, tiles = 1 << bits, -(-n // tile)
        g = (torch.arange(n, device=dev) // tile) * bins + (w.long() & (bins - 1))
        kernel = lambda: ck.lsd_hist(w, 0, bits, tile)
        row("lsd_hist", bins, n * 4 + tiles * bins * 4, kernel,
            lambda: ck.lsd_hist_plain(w, 0, bits, tile),
            lambda: torch.bincount(g, minlength=tiles * bins), tile=tile,
            device_ms=device_trace(kernel, "lsd_hist")[1])
        del g
        for planes in ((w, idx32), (w,)):
            kernel = lambda: ck.lsd_scatter(w, planes, 0, bits, tile, bases)
            row("lsd_scatter", bins, n * 8 * len(planes) + tiles * bins * 4, kernel,
                lambda: ck.lsd_scatter_plain(w, planes, 0, bits, tile, bases),
                tile=tile, planes=len(planes),
                device_ms=device_trace(kernel, "lsd_scatter")[1])
    # L1 where 90% of the keys share one digit (one shared address a warp)
    skew90 = w.clone()
    skew90[: n * 9 // 10] = 0x5A5A5A5A
    for bits in (8, 16):
        tile = lsd_engine.lsd_tile(8192, bits)
        bins, tiles = 1 << bits, -(-n // tile)
        g = (torch.arange(n, device=dev) // tile) * bins + (skew90.long() & (bins - 1))
        kernel = lambda: ck.lsd_hist(skew90, 0, bits, tile)
        row("lsd_hist", bins, n * 4 + tiles * bins * 4, kernel,
            lambda: ck.lsd_hist_plain(skew90, 0, bits, tile),
            lambda: torch.bincount(g, minlength=tiles * bins), tile=tile,
            keys="90% one digit", device_ms=device_trace(kernel, "lsd_hist")[1])
        del g
    del skew90
    # K0 (keys-only, the AUTO sort's sorter) beside its plain version, the
    # torch.sort route of hw_engine (sign flip, torch.sort, flip back), and
    # torch.sort of the signed key; bound: the plane read and written once;
    # the device time of all its kernels (busy time a call)
    key32 = w ^ i32(1 << 31)

    def k0_plain():
        with k0_gate.k0_gate(1 << 31):
            return hw_engine.sort_words((w,), stable=False)
    kernel = lambda: hw_engine.sort_words((w,), stable=False)
    row("lsd_sort", None, n * 8, kernel, k0_plain, lambda: torch.sort(key32),
        digits=8, device_ms=device_trace(kernel)[1])
    # K0's sweep, one pass at n keys in each form the main path gives it (the
    # keys alone; the first pass of an argsort, the index born; its last
    # pass, the index read and written as int64), beside its plain version;
    # no one torch call computes a pass. One status buffer serves every
    # timed call, each its own epoch, as the passes of a call share it. The
    # bound: the planes read and written once, the index read by no first
    # pass and written 8 bytes a key by a wide last one.
    sweep_status, sweep_epoch = ck.k0_sweep_status(n, dev), [0]
    starts0 = sweep_starts(w, 0)

    def sweep_call(planes, position, index_dtype):
        def run():
            sweep_epoch[0] += 1
            return ck.k0_sweep(w, planes, 0, 8, ck.K0_SWEEP_TILE, starts0, sweep_status,
                               sweep_epoch[0], position=position, index_dtype=index_dtype)
        return run
    for form, planes, position, index_dtype, nbytes in (
            ("keys alone", (w,), False, torch.int32, n * 8),
            ("first argsort pass: index born", (w,), True, torch.int32, n * 12),
            ("last argsort pass: index to int64", (w, idx32), False, torch.int64, n * 20)):
        kernel = sweep_call(planes, position, index_dtype)
        row("k0_sweep", 256, nbytes + 1024, kernel,
            lambda: ck.k0_sweep_plain(w, planes, 0, 8, ck.K0_SWEEP_TILE, starts0,
                                      position, index_dtype),
            tile=ck.K0_SWEEP_TILE, form=form, device_ms=device_trace(kernel, "k0_sweep")[1])
    # the two-plane pass of the n u64 keys, in turns: a dense pass beside the
    # pair-in first pass (the digit in lo at shift 0, read where the keys
    # lie) and the pair-out last pass (the digit in hi at shift 24, both
    # halves written into one buffer), each held against its plain version
    # first; bound: 16 bytes a key
    hi_pair, lo_pair = kdf.halves(keys64_t)
    lo0, hi24 = sweep_starts(lo64, 0), sweep_starts(hi64, 24)
    pair_passes = {"dense first pass": (lo64, (hi64, lo64), 0, lo0, False),
                   "pair in (first pass)": (lo_pair, (hi_pair, lo_pair), 0, lo0, False),
                   "dense last pass": (hi64, (hi64, lo64), 24, hi24, False),
                   "pair out (last pass)": (hi64, (hi64, lo64), 24, hi24, True)}
    pair_fns, pair_device = {}, {}
    for label, (kw_, planes, shift, st, out_) in pair_passes.items():
        def run(kw_=kw_, planes=planes, shift=shift, st=st, out_=out_):
            sweep_epoch[0] += 1
            return ck.k0_sweep(kw_, planes, shift, 8, ck.K0_SWEEP_TILE, st, sweep_status,
                               sweep_epoch[0], pair_out=out_)
        err = max_err(run(), ck.k0_sweep_plain(kw_, planes, shift, 8, ck.K0_SWEEP_TILE, st,
                                               pair_out=out_))
        if err:
            fail(f"k0_sweep {label}: max |kernel - plain| {err}")
        pair_fns[label] = run
        pair_device[label] = device_trace(run, "k0_sweep")[1]
    ms = in_turns(pair_fns)
    print(f"[6 k0] two-plane pass of {n} u64 keys, in turns: " + ", ".join(
        f"{k} {v:.4f} ms (device {pair_device[k]:.4f})" for k, v in ms.items())
        + f"; bound {bound_ms(16 * n):.4f} ms", flush=True)
    del sweep_status, hi_pair, lo_pair
    def k12_trace(kernel, library):
        """K12's launches and device ms per sort, and torch.sort's device ms:
        the comparison free of host time and of the timer's noise."""
        launches, k_ms = device_trace(kernel, "bitonic")
        return {"launches_per_sort": launches, "device_ms": k_ms,
                "torch_sort_device_ms": device_trace(library)[1]}

    def network_ops(m):
        log_m = ck.bitonic_pad_len(m).bit_length() - 1
        return log_m * (log_m + 1) // 2 * (1 << (log_m - 1))

    # K12, one key plane, beside torch.sort of the same packed key; its
    # operations are the network's compare-exchanges; each row with its
    # route, the kernels one sort launches and both device times
    for m in (1 << 10, 1 << 14, 1 << 17):
        km = w[:m].clone()
        kernel, library = lambda: ck.bitonic((km,), 1), lambda: torch.sort(km ^ i32(1 << 31))
        row("bitonic", m, m * 8, kernel, lambda: ck.bitonic_plain((km,), 1), library,
            ops=network_ops(m), n=m, planes=1, route=k12_route(m, 1),
            **k12_trace(kernel, library))
    # K12 at 2^17 with (key, index) key planes, the stable rank, beside
    # torch.sort of the packed int64 key (key << 32 | index, made before)
    m = 1 << 17
    km, ki = w[:m].clone(), idx32[:m].clone()
    packed = ((km ^ i32(1 << 31)).long() << 32) | ki.long()
    kernel, library = lambda: ck.bitonic((km, ki), 2), lambda: torch.sort(packed)
    row("bitonic", m, m * 16, kernel, lambda: ck.bitonic_plain((km, ki), 2), library,
        ops=network_ops(m), n=m, planes=2, route=k12_route(m, 2),
        **k12_trace(kernel, library))
    del packed
    # K12 at the gate's top plane count (two key planes; the payloads ride an
    # index plane, so the kernel sees three); no one torch call
    row("bitonic", 1024, 1024 * 4 * len(top_planes) * 2, lambda: ck.bitonic(top_planes, 2),
        lambda: ck.bitonic_plain(top_planes, 2), ops=network_ops(1024), n=1024,
        planes=len(top_planes), route=k12_route(1024, 3),
        launches_per_sort=device_trace(lambda: ck.bitonic(top_planes, 2), "bitonic")[0])
    # E1 at the probe's 2^24 keys beside copy_; E2 beside its plain version
    # (the bound: xp read once, the cells written once; no one torch call)
    xd = w[: 1 << 24]
    copy_buf = torch.empty_like(xd)
    row("dma_copy", None, xd.numel() * 8, lambda: ck.dma_copy(xd),
        lambda: ck.dma_copy_plain(xd), lambda: copy_buf.copy_(xd), n=xd.numel())
    copy_buf = torch.empty_like(w)
    row("dma_copy", None, n * 8, lambda: ck.dma_copy(w), lambda: ck.dma_copy_plain(w),
        lambda: copy_buf.copy_(w), n=n)
    del copy_buf
    row("msd_spread", 128, xp.numel() * 4 + 128 * 128 * 24 * 128 * 4,
        lambda: ck.msd_spread(*spread_args), lambda: ck.msd_spread_plain(*spread_args),
        n=n_msd, capr=24)
    # K13 at D = 4 ranks on cuda:0, rows of 10,000,000 / 4 u32 words, beside
    # its plain version and the mesh's copy_ all-to-all; one-card bound: every
    # rank reads and writes D rows, 2 * D^2 * row bytes in all
    c4 = 10_000_000 // 4
    sends4 = rank_sends(4, (4, c4), torch.int32)
    row("rdma_exchange", None, 2 * 4 * 4 * c4 * 4, lambda: ck.rdma_exchange(sends4),
        lambda: ck.rdma_exchange_plain(sends4), lambda: _mesh.all_to_all(sends4, mesh4),
        n=4 * 4 * c4, ranks="4 on one card (one card, 4 ranks share it)")
    for name, rows in shapes.items():
        for r in rows:
            extra = "".join(f" {k}={r[k]}" for k in ("keys", "drop_ge", "passes", "shape", "reads",
                                                     "tile", "planes", "form", "capr", "ranks",
                                                     "route", "launches_per_sort",
                                                     "device_ms", "torch_sort_device_ms")
                            if k in r)
            bins = "" if r["bins"] is None else f" bins={r['bins']}"
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            print(f"[6 time] {name} n={r.get('n', n)}{bins}{extra}: kernel "
                  f"{r['ms']:.4f} ms ({r['bytes'] / r['ms'] / 1e6:.0f} GB/s moved), "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"plain {r['plain_ms']:.4f} ms, "
                  f"torch call {lib}", flush=True)

    # what the range probe costs where it finds a wide range
    xf = d.cu(keys)
    ms = in_turns({"default": lambda: rt.sort(xf), "probe": lambda: rt.sort(xf, config=probe)})
    default_ms, probe_ms = ms["default"], ms["probe"]
    print(f"[6 time] device_probe cost on full-entropy u32: default {default_ms:.3f} ms, "
          f"device_probe {probe_ms:.3f} ms ({100 * (probe_ms / default_ms - 1):+.1f}%)",
          flush=True)

    # the LSD sort against torch.sort of the same int32 keys and the AUTO
    # sort, in turns; bound: 12 bytes a key for each live pass
    # (and at r = 8 without the live-digit read, skip_trivial_digits=False:
    # the passes alone)
    mean = in_turns({"AUTO": lambda: rt.sort(xf), "LSD r=8": lambda: rt.sort(xf, config=lsd8),
                     "LSD r=8 passes alone": lambda: rt.sort(
                         xf, config=lsd8.replace(skip_trivial_digits=False)),
                     "LSD r=11": lambda: rt.sort(xf, config=lsd11),
                     "torch.sort int32": lambda: torch.sort(w)})
    print(f"[6 time] LSD sort of u32, in turns: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in mean.items())
        + f"; bound r=8 {bound_ms(4 * 12 * n):.3f} ms (4 passes x 12 B/key), "
        f"r=11 {bound_ms(3 * 12 * n):.3f} ms (3 passes)", flush=True)
    # K0 through the public entry points beside torch.sort of the same signed
    # key, in turns: the AUTO sort, argsort, sort_pairs with a 4-byte payload
    # (beside torch.sort(stable=True) and a gather); the LSD sort of u64 beside
    # the AUTO sort (two planes: K0 from K0_TWO_PLANE_MIN_KEYS keys)
    x64 = d.cu(keys64)
    k0_rows = {
        "sort": {"AUTO (K0)": lambda: rt.sort(xf),
                 "torch.sort int32": lambda: torch.sort(key32)},
        "argsort": {"AUTO (K0) uint32": lambda: rt.argsort(xf),
                    "AUTO (K0) int64": lambda: rt.argsort(xf, index_dtype=torch.int64),
                    "torch.sort(stable=True) int32": lambda: torch.sort(key32, stable=True)},
        "sort_pairs, f32 payload": {
            "AUTO (K0)": lambda: rt.sort_pairs(xf, pay_f32_t),
            "torch.sort(stable=True) int32 + gather": lambda: pay_f32_t[
                torch.sort(key32, stable=True).indices]},
        "u64": {"LSD r=8": lambda: rt.sort(x64, config=lsd8),
                "AUTO (K0)": lambda: rt.sort(x64),
                "torch.sort int64": lambda: torch.sort(keys64_t)}}
    for label, fns in k0_rows.items():
        ms = in_turns(fns)
        print(f"[6 k0] {label} of {n} keys, in turns: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
    # the AUTO u64 sort: its launches (the pair read in, the pair written
    # out) and its device time by kernel; its keys equal torch.sort's of the
    # keys as signed words with the top bit flipped, the input unchanged
    rt.reset_launch_counts()
    got64 = rt.sort(x64)
    counts = {k: c for k, c in rt.launch_counts().items() if c}
    top = -(1 << 63)
    if not torch.equal(got64.view(torch.int64), torch.sort(keys64_t ^ top).values ^ top):
        fail("u64 AUTO sort: keys differ from torch.sort's")
    if not torch.equal(x64.view(torch.int64), keys64_t):
        fail("u64 AUTO sort: the input changed")
    del got64
    ops, dev_ms = device_trace(lambda: rt.sort(x64))
    print(f"[6 k0] u64 AUTO sort of {n} keys: launches {counts}; {ops:.0f} device ops, "
          f"device {dev_ms:.3f} ms a call", flush=True)
    del x64
    # the sweeps behind the gates: K0 against torch.sort by n, one plane and two
    for planes in (1, 2):
        gate = k0_gate.sweep(dev, seed=args.seed, reps=reps, planes=planes,
                             log=lambda line: print(f"[6 gate] {line}", flush=True))
        print(f"[6 gate] {planes} plane(s): K0 no slower than torch.sort from "
              f"n={gate['gate_sort']} on keys-only, from n={gate['gate_argsort']} on in the "
              f"int64 argsort, from n={gate['gate_argsort32']} on in the uint32 argsort, "
              f"from n={gate['gate']} on in all three, from n={gate['gate_route']} on in all "
              f"three against hw_engine's torch.sort route; the gate {gate['current']}",
              flush=True)
    # R4: what the stream's traffic model counts, beside E1 and copy_ on the
    # same n keys, E1 and copy_ in turns
    out_buf = torch.empty_like(w)
    ms = in_turns({"E1": lambda: ck.dma_copy(w), "copy_": lambda: out_buf.copy_(w)})
    e1_ms, copy_ms = ms["E1"], ms["copy_"]
    stream = timing.stream_gbps(x=w)
    per_key = timing.stream_bytes_per_iter(n) // n
    print(f"[6 time] R4 at n={n}: dma_copy (E1) {e1_ms:.4f} ms, {8 * n / e1_ms / 1e6:.1f} "
          f"GB/s (8 B/key); copy_ {copy_ms:.4f} ms, {8 * n / copy_ms / 1e6:.1f} GB/s (8 "
          f"B/key); stream_gbps {stream:.1f} GB/s counting {per_key} B/key an iteration "
          f"({timing.STREAM_PASSES} kernels), {stream * 8 / per_key:.1f} GB/s if one pass "
          "of 8 B/key is counted", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sol = exp_sol_probe.main([])
    print(f"[6 time] exp_sol_probe: {json.dumps(sol)}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        msd_rec = exp_sol_round2.exp_msd(keys[:n_msd], dev)
    print(f"[6 time] exp_sol_round2 msd pipeline, {n_msd} keys: total "
          f"{msd_rec['ms']:.3f} ms; stages " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in msd_rec["stages"].items()), flush=True)
    # the distributed sort of the n keys on four ranks of cuda:0, each
    # exchange, beside torch.sort of the same keys, in turns
    x40 = d.cu(keys)
    dist_turns = {"xla": lambda: distributed_sort(x40, mesh4, exchange="xla"),
                  "rdma": lambda: distributed_sort(x40, mesh4, exchange="rdma"),
                  "torch.sort int32": lambda: torch.sort(w)}
    dist_ms = in_turns(dist_turns, 3)
    print(f"[6 time] distributed_sort balanced of {n} u32 on 4 ranks of cuda:0 (one card, "
          f"4 ranks share it; nothing of NVLink), in turns: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in dist_ms.items()), flush=True)
    rows_t = d.cu(d.rows_u32).view(torch.int32)
    ms = time_ms(lambda: torch.sort(rows_t, dim=-1), reps)
    print(f"[6 time] torch.sort(dim=-1) of ({n_rows}, 4096) int32 (reference point): "
          f"{ms:.3f} ms; bound {bound_ms(n_rows * 4096 * 8):.3f} ms", flush=True)

    if args.profile:
        for exchange in ("xla", "rdma"):
            profiled(f"distributed_sort 4 ranks on cuda:0 exchange={exchange}",
                     dist_turns[exchange], 10)

    # the measurement entry points, each timing itself: the CLI (its sort
    # checked by utils.verify) and the distributed tier's dry run on the
    # four ranks (each output against numpy; it raises on a difference)
    for argv in (["40000000", "u32"], ["40000000", "u32", "0xF0F00000"],
                 ["20000000", "u64", "0x0000F0F000000000"], ["40000000", "f32"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        lines = buf.getvalue().strip().splitlines()
        if rc != 0 or json.loads(lines[-1])["verified"] is not True:
            fail(f"cli {' '.join(argv)}: exit {rc}, {lines}")
        print(f"[6 entry] cli {' '.join(argv)}: {lines[-1]}", flush=True)
    dryrun_multichip(mesh4, n=n, seed=args.seed,
                     log=lambda line: print(f"[6 dist] {line} (one card: its D ranks share it)",
                                            flush=True))

    # -- phase 8: the group mesh, one process a rank group -----------------
    del x40
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    multiprocess_phase(n, dist_ms["rdma"], shapes["rdma_exchange"][0]["ms"])

    pk = "radix_sorting_tpu/ops/pallas_kernels.py"
    csrc = "radix_sorting_tpu_torch/csrc"
    replaces = {
        "hist": (f"{csrc}/hist.cu", f"{pk}:100"),
        "hist_multi": (f"{csrc}/hist.cu", f"{pk}:100"),
        "live_digits": (f"{csrc}/hist.cu", f"{pk}:100 (every digit of one or two planes, "
                        "with the presorted guard's flag)"),
        "regen": (f"{csrc}/regen.cu", f"{pk}:219"),
        "regen_windowed": (f"{csrc}/regen.cu", f"{pk}:602"),
        "hist_pext": (f"{csrc}/hist.cu", f"{pk}:299"),
        "regen_pdep": (f"{csrc}/regen.cu", f"{pk}:475"),
        "regen_pdep_windowed": (f"{csrc}/regen.cu", f"{pk}:714"),
        "hist_pext2": (f"{csrc}/hist.cu", f"{pk}:355"),
        "regen_pdep2": (f"{csrc}/regen.cu", f"{pk}:414"),
        "regen_pdep2_windowed": (f"{csrc}/regen.cu", f"{pk}:775"),
        "whist": (f"{csrc}/whist.cu", f"{pk}:862"),
        "whist_f32": (f"{csrc}/whist.cu", f"{pk}:957"),
        "whist_f32_counts": (f"{csrc}/whist.cu", f"{pk}:957"),
        "bitonic": (f"{csrc}/bitonic.cu", "radix_sorting_tpu/ops/vmem_sort.py:95"),
        "lsd_hist": (f"{csrc}/lsd.cu", "none: radix_sorting_tpu/ops/lsd_engine.py:63 "
                     "(XLA, no Pallas kernel)"),
        "lsd_scatter": (f"{csrc}/lsd.cu", "none: radix_sorting_tpu/ops/lsd_engine.py:63 "
                        "(XLA, no Pallas kernel)"),
        "dma_copy": (f"{csrc}/sol.cu", "scripts/exp_sol_probe.py:117"),
        "msd_spread": (f"{csrc}/sol.cu", "scripts/exp_sol_round2.py:128"),
        "rdma_exchange": (f"{csrc}/exchange.cu", "radix_sorting_tpu/parallel/rdma.py:90"),
        "k0_sweep": (f"{csrc}/lsd.cu", "none: radix_sorting_tpu/ops/hw_engine.py:56 "
                     "(lax.sort, no Pallas kernel; :75 for the argsort): K0's pass"),
        "lsd_sort": (f"{csrc}/lsd.cu", "none: radix_sorting_tpu/ops/hw_engine.py:56 "
                     "(lax.sort, no Pallas kernel; K0 runs K1 live_digits, hist.cu, and "
                     "k0_sweep)"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": shapes[name][0]["ms"], "plain_ms": shapes[name][0]["plain_ms"],
                "bound_ms": shapes[name][0]["bound_ms"],
                "bound_by": shapes[name][0]["bound_by"],
                "library_ms": shapes[name][0]["library_ms"], "shapes": shapes[name]}
               for name, (src, rep) in replaces.items()]
    print(smi[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
