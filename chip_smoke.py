#!/usr/bin/env python3
"""Drive the PyTorch port's sorts on one CUDA GPU and check them.

Run from the repository root:  python3 chip_smoke.py [--n N] [--seed S]
(defaults: 40,000,000 keys, the reference benchmark's size).

Phases, one line each (numpy is the only oracle; nothing here imports JAX):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel)
     and print the build time;
  3. hold each kernel against its plain PyTorch version on the card, bit for
     bit, at n keys: hist_pext (K2) at masks 0xF0F00000, 0xFF, 0xFFFF and
     0x1FFFF;
     regen_pdep at 256 bins (K5 contract) and 65,536 bins (K8 contract);
     hist_pext2 (K3) at the 64-bit masks 0xF000000000000F00,
     0x00FF00000000FF00, 0x0000000000FFFF00 and 0x01FF00000000FF00;
     regen_pdep2 at 256 bins (K6 contract) and 65,536 bins (K9 contract),
     with dead bits in both planes; hist (K1) at r = 8, 16, 17 and 18 and
     hist_multi at r = 8, 11, 16 and 18 (so every form the launch-shape
     rule picks runs once: 32-bit sub-histograms, 16-bit counters in one
     block and in 2, 4 and 8 grid rows; its shape printed), live_digits
     (K1 over one plane and two, with the descent flag) at r = 8 and 16 on
     uniform, sorted and once-swapped keys, and K1 r = 16
     and 18, K2 0xFFFF and K3 at 16 bits on keys of which 90% or all are
     one value (each block hands a 16-bit counter to the output several
     times); regen (K4, K7); whist (K10) at 1,024 bins with i32 values,
     65,536 bins with u8 values (16-bit counts, two grid rows), 1,024 bins
     with 90% of the rows in one group, 131,072 bins with i32 values (four
     rows), 65,536 bins with every row in one group and 131,072 bins with
     90% in one (16-bit counts handed off under contention); whist_f32
     (K11) with counts at 1,024 and 65,536 bins and without at 32,768 bins
     (f32 sums to the bound sum|w| * 2^-14 + 1e-5 of a float64 sum,
     printing the largest relative error); each with the launch shape
     cuda_kernels.whist_shape gives it; the LSD passes lsd_hist (L1) and lsd_scatter (L2) for one pass
     at r = 8, 11 and 16 (key and index planes; the pass must be stable),
     and at the other shapes a caller may give them: tiles of 1,000 (r =
     8), 4,096 and 8,191 (r = 11; with 1,000 each of L2's three staged
     shapes), 3 keys (r = 1) and 65,536 keys (r = 12: eight stages of L2's
     largest shape a tile), keys of which 90% share one
     digit (r = 8 and 16), all keys one digit (r = 16: whole tiles of
     65,536 keys in one bin), and three planes 1, 2 and 3 words off the
     16-byte grid (r = 8 and 11);
     k0_sweep (K0's pass: L2's staged form with a decoupled look-back) against
     its plain version at n keys: the keys alone, the index born as the
     position (int32, and int64 as a last pass), an index plane written as
     int64 behind a payload, keys of which 90% or all share the digit;
     lsd_sort (K0: live_digits, then one k0_sweep a live digit) against
     torch.sort(stable=True) of the signed key, at LSD_MIN_KEYS and n keys:
     keys-only, argsort (int64 and uint32 indices), sort_pairs with a 4- and
     an 8-byte payload;
     bitonic (K12) at 1,024, 4,097 and 131,072 keys: one key plane, (hi, lo)
     keys, (key, index) keys with a payload, and 16 key values with a
     payload and num_keys=1, whose records must stay a permutation (R1);
     sort_planes_vmem (K12) past 32 planes: (n, planes, num_keys) of (100,
     33, 1), (1,024, 40, 34) and the gate's top plane count at 1,024 keys,
     16 values in the first key plane and an index plane, whose records
     must stay a permutation; bitonic at 2^17 keys with 3 planes (the last
     count one cluster holds) and 4 (the first past it: tiles), keys of 4
     values; dma_copy (E1) at 2^24 and 2^24 + 12,345 keys and on views 1,
     2, 3 and 4 words in (1-3 not 16 bytes aligned: word by word);
     msd_spread (E2) on the n keys as 128 sorted rows, 128 buckets;
     rdma_exchange (K13) at D = 2, 4 and 8 ranks on cuda:0: stacked (3, D,
     c) u32 sends with c = 1, 37 and 10,000,000 / D (16-byte, word and
     single-word rows) and (D, 37) int16 sends (74-byte rows: byte copies);
  4. run each case through the public entry points on CUDA tensors (byte
     strings: numpy) and compare with a numpy oracle: sort of full-entropy
     u32 (sorter), presorted u32 (guard), masked u32, u8, u16, bf16 and f32
     with signed zeros, infinities and NaNs, descending u16; sort of u64
     (sorter), i64, f64 with specials, masked u64 (K3+K6, K3+K9, descending),
     u64 with 24 live bits (one compacted operand), float8_e4m3fn, S12 byte
     strings (n/10 keys); argsort and sort_pairs of u32 keys with duplicates;
     counting_sort of u16 with a payload; sort_u64_multipass;
     SortConfig(device_probe=True) sorts of u32 in a 50,000 range (K1+K7),
     of 200,000 u32 in a range of 1,000 (K1+K4), of full-entropy u32
     (sorter), of u64 with a constant hi word and a full lo word (one int32
     sorter operand) or a lo word in a 60,000 range (K1+K7);
     SortConfig(dynamic_probe=True) of unpromised 0xF0F00000-masked u32
     (K2+K5); counting_engine.sort_word_counting with a 10-bit mask,
     descending (K1+K4); bitmap_unique_sort of u16, bincount with length
     1,000 and 1% of the values out of range, multi_digit_histogram at r = 8
     (all K1); the group-by slice: bench.py's group-by case (group_reduce
     sum of i32 values over k = x & 1023, 1,024 groups; K10), group_reduce
     mean of f32 values at 1,024 groups (K11 with counts), sum of u8 values
     at 65,536 groups (K10), sort-native sum, min and max with no groups,
     value_counts with groups=1024 (K1) and without (sorter), and
     stats.histogram of standard normal f32 at 256 bins, unweighted (K1) and
     weighted (K11); the sorter composites of extras and stats: searchsorted
     of the sorted u32 keys with q = 100,000 ('auto': scan) and q = n / 32
     (1,250,000 at 40M: the tagged union), each side, of u64 keys with q =
     4,000,000 (tagged union), of f32 with specials, of descending u32 and
     with sorter=; lexsort of (u8, u8, u16) (one packed plane) and of
     (u32, u32, u32) (chained sorts); segmented_sort and segmented_argsort
     of u16 keys in 1,024 u16 segments, ascending and descending;
     merge_sorted of two sorted halves; nth_element; top_k with k = 1,000
     of u32 and of f64 with specials; top_k_batched of bench.py's rows of
     4,096 with k = 16; stable_partition with an f32 payload; rankdata of
     u32 with duplicates, 'average' and 'dense' (against
     scipy.stats.rankdata); quantile at 5 probabilities of f32 and of u16
     (K2 + K8), bit for bit against numpy's order statistics interpolated
     in numpy float32, and within 2^-20 of np.quantile; partition,
     argpartition; digitize against 1,001 increasing and decreasing edges;
     histogram with 1,001 edges, unweighted (K1) and weighted (K11, to the
     bound above); sort_complex of 4,000,000 complex128; the sets slice:
     unique of the n keys (values, counts, unique_all, descending), of u16
     with counts (K2 + K8), of f32 with signed zeros and NaN payloads
     (equal_nan False and True), unique_inverse of the u64 keys as numpy,
     unique(axis=0) with every flag of n / 4 rows of 4 int32 in [0, 8), the
     four set operations and intersect1d(return_indices=True) of two halves
     of n u32 sharing about half their values (and of two u64 halves as
     numpy), isin (and invert, in1d) of the n keys against n / 4 tests,
     half of them keys; each against numpy, and torch.cummax must not be
     called in the slice; the LSD slice (L1 + L2): SortConfig(strategy=LSD) sort
     of full-entropy u32 at r = 8 (the slice's main path) and r = 11, of
     u32 with value_mask=0xF0F00000 (two of four passes live: the launch
     counts must show it), of u64 (8 passes), f32 with specials and
     descending u16, argsort of u32 with duplicates, sort_pairs with {i64,
     f32} and a 6-byte field; sort_planes_vmem of 131,072 keys with an index
     plane (K12); sort_batched, argsort_batched and sort_pairs_batched of the
     keys as rows of 4,096 (bench.py's batched case; torch.sort); the
     configured sorters models.RadixSorterU32 and GenericRadixSorter with
     LSD; integers exact, f32 sums and means to the bound above; the launches
     of each case are printed beside it; then the measurement entry points:
     cli.main for "40000000 u32", "40000000 u32 0xF0F00000", "20000000 u64
     0x0000F0F000000000" and "40000000 f32" (each must print "verified":
     true), utils.verify on the card's sort, argsort and LSD rank outputs
     (and a broken permutation, which must fail), the probe script's
     probe_dma (E1) and the MSD pipeline of exp_sol_round2 (E2) on the n
     keys against np.sort; then the distributed tier on a mesh of four
     ranks on cuda:0 (parallel.dryrun.dryrun_multichip): distributed_sort
     with the default method="balanced" of the n keys with exchange="xla"
     and "rdma" (K13; the tier's main path), then the rest of the surface
     at 2^20 keys (shuffle with each exchange, skewed balanced sorts
     overlapped or not, argsort, record sorts with a payload tree and an S8
     field, select, quantile, top_k, unique, group_reduce sort-backed and
     dense (K10), distributed_bincount (K1), the overflow flag and
     exact=True, a many-round exchange) and one sort on make_sort_mesh(),
     the default mesh over the visible cards; each against numpy, with its
     size, time, peak device memory and launches;
     the headline case (full-entropy u32, AUTO) must run K0 alone (live_digits
     1, k0_sweep 4, lsd_sort 1; no hist_multi, lsd_hist, lsd_scatter or
     torch.sort), the sorter cases of u64, i64 and f64 too from
     K0_TWO_PLANE_MIN_KEYS keys (live_digits 1, k0_sweep 8, lsd_sort 1), and
     each LSD case one live_digits launch; each case prints its torch.sort
     calls;
  5. require every kernel's launch count from phase 4 to be non-zero (K0's
     lsd_sort among them), and print the torch.sort calls of phase 4 (three
     or more planes, fewer than LSD_MIN_KEYS keys of one plane or
     K0_TWO_PLANE_MIN_KEYS of two, the batched sorts);
  6. time each case and each kernel beside its plain version and, where one
     torch call computes the same function, beside that call (CUDA events,
     steady-state loops); K1, K2 and K3 with the launch shape each ran, the
     device time of one call (torch.profiler) and torch.bincount of the
     precomputed digits or PEXT values; K1 on keys of which 90% are one
     value; live_digits over one plane and two beside the read it replaces
     (one hist_multi a plane and probes.is_sorted_words); K5, K6, K8 and K9 beside torch.repeat_interleave of each bin's
     key by its count; K10 and K11 at each phase-3 input with their launch
     shape and the reads of the rows it takes, beside index_add_; the range
     probe's cost on full-entropy u32; torch.sort of int32 and int64 keys;
     the sorter composites beside one torch call of the same function, in
     turns: searchsorted of u32 by both methods at q = n / 128, 100,000,
     n / 32, n / 8 and n / 2 (the TPU gate 32 * q >= n among them) beside
     torch.searchsorted of the int32 key, of u64 beside that of the int64
     key; top_k beside torch.topk, top_k_batched beside torch.topk(dim=-1);
     lexsort of one packed plane and rankdata beside
     torch.sort(stable=True); digitize beside torch.bucketize; unique
     (values, counts, unique_all) beside torch.unique, unique(axis=0)
     beside torch.unique(dim=0), isin beside torch.isin, union1d beside
     torch.unique(torch.cat);
     K0 (keys-only) beside its plain version (hw_engine's torch.sort route)
     and torch.sort of the signed key, with the device time of all its
     kernels; k0_sweep one pass in each form the main path gives it (keys
     alone, an argsort's first and last pass) beside its plain version, with
     its device time; the AUTO sort, argsort (uint32 and int64 indices) and
     sort_pairs (f32 payload) of the n u32 keys (K0) beside torch.sort of
     the same signed key (stable, and a gather, where they carry an index or
     payload), and the LSD sort of the u64 keys beside the AUTO sort (K0 over
     two planes) and torch.sort int64, in turns; the sweeps of
     scripts/k0_gate.py (K0 against torch.sort, keys-only and argsort with
     int64 and uint32 indices, at n = 2^12 to 2^26 and 40M, of u32 and of
     u64 keys, beside torch.sort of the signed key and hw_engine's torch.sort
     route) and the gates they give;
     the LSD sort of u32 at r = 8 (also without the live-digit read) and 11
     beside torch.sort of the same int32 keys and the AUTO sort, in turns,
     with its byte bound (12 bytes a key for each live pass: L1 reads the
     plane, L2 reads and writes it); L1 and
     L2 per pass, L2 with key and index planes and with the key plane
     alone (the LSD sort's own pass), L1 also on keys of which 90% share
     one digit, each with its kernel's device time (torch.profiler); K12
     at 2^10, 2^14 and 2^17 keys beside torch.sort of the
     same packed key, and at 2^17 with (key, index) key planes beside
     torch.sort of the packed int64 key, each with its route, the kernels
     one sort launches and the device time of K12 and of torch.sort
     (torch.profiler); torch.sort(dim=-1) of the batched
     rows; E1 at 2^24 and n keys beside copy_, in turns, (8 bytes a key
     each) and beside utils.timing.stream_gbps (16 bytes
     a key an iteration: two kernels) on the n keys, the evidence for R4; E2
     beside its plain version; K12 at the gate's top plane count; the probe
     script's stream, copy, sorter, gather and DMA figures; the MSD
     pipeline's time in all and by stage; K13 at D = 4 ranks on cuda:0 and
     rows of 10,000,000 / 4 u32 words beside its plain version and the
     mesh's copy_ all-to-all (the "xla" exchange), with its one-card bound
     (2 * D^2 * row bytes); distributed_sort of the n keys on four ranks of
     cuda:0 with each exchange beside torch.sort of the same keys. The
     distributed lines share one card among the D ranks and say nothing of
     NVLink.
  7. with --profile: device time by kernel (torch.profiler, three calls)
     of each case of the range probes, the dense tier, the group-by slice,
     the LSD sorts of u32 and u64, sort_planes_vmem and sort_batched, and of
     the four-rank distributed_sort with each exchange.
  8. the group mesh (parallel/ over torch.distributed, from the kernels
     phase 2 built; the workers only load them): scripts.mp_worker in (a)
     four processes of one rank each on cuda:0 over gloo, exchange="rdma",
     the balanced distributed_sort of the n keys (n / 4 a process) with K13
     across the processes through CUDA IPC handles, on every process's
     shards against np.sort and timed beside phase 6's four ranks of one
     process, K13 alone at rows of n / 16 u32 against its plain version and
     timed beside phase 6's row, the first call's handle-open cost, then the
     rest of the surface at 2^20 keys (the nine surfaces of the JAX
     package's scripts/mp_worker.py, exchange="xla" of CUDA tensors over
     gloo refused, unequal slices refused, a second mesh opening its own
     handles); (b) one process of four ranks on cuda:0 over NCCL (world
     size 1) at 2^20 keys, exchange="rdma" and "xla"; every worker killed
     when one fails or past 600 s; the main path's launches in (a), each
     process's counts set to 0 just before its checked sort and read just
     after, join the kernels line (the rest of the workers' launches are
     printed apart).
Then the card's name and power limit, one JSON line of kernels (each with
its bound: bytes moved over the H100's 3.35 TB/s, or for K12 its
compare-exchanges over 67 T operations/s where that is larger; for K13 the
one-card bound of D ranks sharing cuda:0; launches: phase 4's and phase
8's main path's), and last {"ok": true, "device": {...}}.
Any failure raises, so the exit code is non-zero and no result is printed.
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


def float_order_np(bits: np.ndarray, width: int) -> np.ndarray:
    """Sort raw float bit patterns by the reference's float KDF, in numpy:
    -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN."""
    ut = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}[width]
    b = bits.astype(ut)
    top = ut(1) << ut(width - 1)
    key = np.sort(np.where(b & top, ~b, b | top))
    return np.where(key & top, key ^ top, ~key)


def gpu_bits(t, np_dtype) -> np.ndarray:
    """A CUDA tensor's raw bits as a host numpy array of ``np_dtype``."""
    import torch
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[np.dtype(np_dtype).itemsize]
    return t.contiguous().view(width).cpu().numpy().view(np_dtype)


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


def max_err(got, ref) -> int:
    """Largest difference of two int32 tensors read as u32 bit patterns."""
    return int(((got.long() & 0xFFFFFFFF) - (ref.long() & 0xFFFFFFFF)).abs().max())


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


def f32_sum_check(got, keys, weights, bins: int, drop_ge: int):
    """(max relative error, within bound) of f32 per-bin sums against a
    float64 sum on the card; bound: sum|w| * 2^-14 + 1e-5 per bin."""
    import torch
    k = keys.long() & 0xFFFFFFFF
    keep = k < drop_ge
    w = weights.double()[keep]
    ref = torch.zeros(bins, dtype=torch.float64, device=keys.device).index_add_(0, k[keep], w)
    absum = torch.zeros_like(ref).index_add_(0, k[keep], w.abs())
    err = (got.double() - ref).abs()
    rel = float((err / absum.clamp(min=1e-30)).max())
    return rel, bool((err <= absum * 2.0 ** -14 + 1e-5).all())


def bin_index_np(x: np.ndarray, edges: np.ndarray, nb: int) -> np.ndarray:
    """stats.histogram's bin of each value, in numpy float32 arithmetic; nb
    for values outside the edges."""
    lo, hi = np.float32(edges[0]), np.float32(edges[-1])
    idx = np.floor((x - lo) * np.float32(nb / (edges[-1] - edges[0])))
    return np.where((x >= lo) & (x <= hi), np.minimum(idx, nb - 1), nb).astype(np.int64)


def k12_route(n: int, nplanes: int) -> str:
    """K12's route for n keys of nplanes planes (the wrapper's choice)."""
    from radix_sorting_tpu_torch.ops import cuda_kernels as ck
    return {0: "tiles", 1: "one block"}.get(ck.bitonic_route(n, nplanes), "cluster")


def hist_label(total: int) -> str:
    """The launch shape the histogram wrappers take for ``total`` counters."""
    from radix_sorting_tpu_torch.ops import cuda_kernels as ck
    return ck.hist_shape(total).label()


def case_size(x) -> int:
    """The keys a case's input holds: a tensor's elements, the length of a
    numpy array, or of the first of several inputs."""
    import torch
    if isinstance(x, (list, tuple)):
        return case_size(x[0])
    return x.numel() if torch.is_tensor(x) else len(x)


def bound_ms(nbytes: int) -> float:
    """Least time to move ``nbytes`` through device memory (every kernel
    here does a few integer operations per 4-byte key: bound by bytes)."""
    return nbytes / HBM_BYTES_PER_MS


def multiprocess_phase(n: int, single_sort_ms: float, single_k13_ms: float):
    """Phase 8: ``scripts.mp_worker`` in processes on cuda:0 over
    torch.distributed, from the kernels phase 2 built. (a) four processes of
    one rank, gloo (CUDA control tensors in host copies), exchange="rdma":
    the balanced ``distributed_sort`` of the n keys (n / 4 a process) on
    every process's shards against np.sort, timed, and K13 across the
    processes at rows of n / 16 u32 against its plain version, timed; the
    rest of the surface at 2^20 keys. (b) one process of four ranks over
    NCCL, exchange="rdma" (and "xla" in its comparison case), at 2^20 keys.
    Each launch is killed whole past its timeout or when a worker fails, and
    every failure fails the run. Returns the main path's kernel launches
    (each process's counts, set to 0 just before its checked sort of the n
    keys and read just after, summed over the processes) and K13's largest
    error across processes. The launches of everything else the workers run
    (the timing loops, the surface at 2^20, part b) are printed on a line of
    their own."""
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
            if rc != 0 or f"MP_OK {pid}" not in text:
                fail(f"phase 8 {backend} worker {pid}: exit {rc}\n{text[-6000:]}")
        wall = time.perf_counter() - t0
        lines = [ln for _, text in res for ln in text.splitlines() if ln.startswith("[")]
        stats = [json.loads(str(np.load(os.path.join(tmp, f"{backend}{pid}.npz"))["stats"]))
                 for pid in range(nproc)]
        return stats, lines, wall

    with tempfile.TemporaryDirectory(prefix="rst_phase8_") as tmp:
        a, a_lines, a_wall = launch(4, 1, "gloo", tmp, ("--main-n", str(n)))
        b, b_lines, b_wall = launch(1, 4, "nccl", tmp)
    for ln in [ln for ln in a_lines if ln.startswith("[0]")] + b_lines:
        print(f"[8 processes] {ln}", flush=True)
    def summed(key, runs):
        total = {}
        for st in runs:
            for k, c in st[key].items():
                total[k] = total.get(k, 0) + c
        return total
    main = summed("main_launches", a)
    rest = summed("launches", a + b)
    if not main.get("rdma_exchange"):
        fail("phase 8: the main path did not launch K13 across the processes")
    for name in ("rdma_exchange", "hist", "whist"):
        if not rest.get(name):
            fail(f"phase 8: kernel {name} was not launched on the surface")
    sort_ms = max(st["sort_ms"] for st in a)
    k13_ms = max(st["k13_ms"] for st in a)
    err = max(st["k13_max_abs_err"] for st in a)
    print(f"[8 processes] (a) 4 processes x 1 rank on cuda:0, gloo (CUDA control tensors "
          f"through host copies), exchange=rdma: distributed_sort balanced of {n} u32 "
          f"({n // 4} a process) equal to np.sort on every process's shards; "
          f"{sort_ms:.3f} ms a call (host clock, the slowest process, "
          f"{a[0]['D']} ranks) beside {single_sort_ms:.3f} ms on 4 ranks of one process "
          f"(phase 6, this run); first call {max(st['first_call_ms'] for st in a):.1f} ms, "
          f"of which allocating, exchanging and opening the IPC handles "
          f"{max(st['open_ms'] for st in a):.1f} ms ({a[0]['opens']} opened a process); "
          f"one host round trip (the slowest process): a stream sync "
          f"{max(st['sync_ms'] for st in a):.3f} ms, a gloo meet "
          f"{max(st['meet_ms'] for st in a):.3f} ms, one pivot-search sum of a CUDA "
          f"tensor (to the host, gloo, back) {max(st['sum_ms'] for st in a):.3f} ms; "
          f"launch wall {a_wall:.1f} s", flush=True)
    print(f"[8 processes] (a) K13 across 4 processes, rows of {a[0]['k13_rows']} u32: "
          f"{k13_ms:.4f} ms a call (barrier form: two stream syncs and two gloo meets, "
          f"then the copy out of the receive buffer; the slowest process), max |err| {err} "
          f"against the plain version, beside {single_k13_ms:.4f} ms for one process's 4 "
          f"launches (phase 6, this run)", flush=True)
    print(f"[8 processes] (b) 1 process x 4 ranks on cuda:0 over NCCL (world size 1): "
          f"the surface at 2^20 keys, exchange=rdma and xla; launches "
          f"{b[0]['launches']}; launch wall {b_wall:.1f} s", flush=True)
    print(f"[8 processes] (a) main path's launches (the checked sort of {n} keys, summed "
          f"over the processes) {json.dumps({k: c for k, c in main.items() if c})}; the "
          f"surface at 2^20 keys in (a) and (b), apart from the kernels line "
          f"{json.dumps({k: c for k, c in rest.items() if c})}", flush=True)
    return main, err


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
    from radix_sorting_tpu_torch.ops import (_build, counting_engine, hw_engine, lsd_engine,
                                             probes, scan)
    from radix_sorting_tpu_torch.ops import cuda_kernels as ck
    from radix_sorting_tpu_torch.ops.vmem_sort import sort_planes_vmem
    from radix_sorting_tpu_torch.ops.histogram import multi_digit_histogram
    from radix_sorting_tpu_torch.ops.kdf import i32
    from radix_sorting_tpu_torch.ops.vmem_sort import vmem_sort_ok
    from radix_sorting_tpu_torch import cli
    from radix_sorting_tpu_torch.scripts import exp_sol_probe, exp_sol_round2, k0_gate
    from radix_sorting_tpu_torch.utils import timing, verify
    from radix_sorting_tpu_torch.parallel import _mesh, distributed_sort, make_sort_mesh
    from radix_sorting_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.1f} s -> {path.name}; "
          f"ptxas: {' | '.join(ptxas) or 'cached'}", flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.Generator(np.random.PCG64(args.seed))
    keys = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    w = torch.from_numpy(keys.view(np.int32)).to(dev)
    keys64 = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    hi64 = torch.from_numpy((keys64 >> np.uint64(32)).astype(np.uint32).view(np.int32)).to(dev)
    lo64 = torch.from_numpy(keys64.astype(np.uint32).view(np.int32)).to(dev)
    keys64_t = torch.from_numpy(keys64.view(np.int64)).to(dev)

    # -- phase 3: kernels against their plain versions ----------------------
    errs = {name: 0 for name in ck.LAUNCHES}
    for mask in (0xF0F00000, 0xFF, 0xFFFF, 0x1FFFF):
        got, ref = ck.hist_pext(w, mask), ck.hist_pext_plain(w, mask)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        errs["hist_pext"] = max(errs["hist_pext"], err)
        if err or int(got.long().sum()) != n:
            fail(f"hist_pext mask 0x{mask:X}: max |err| {err}")
        print(f"[3 kernel] hist_pext mask=0x{mask:08X} bins={got.numel()} shape "
              f"{hist_label(got.numel())} equal to plain (max |err| 0)", flush=True)
    regen_inputs = {}
    for mask, dead, name in ((0xF0F00000, 0x00010003, "regen_pdep"),
                             (0xFFFF, 0, "regen_pdep_windowed")):
        plane = (w & i32(mask)) | dead
        cum = torch.cumsum(ck.hist_pext(plane, mask), 0, dtype=torch.int32)
        got, ref = ck.regen_pdep(cum, n, mask, plane), ck.regen_pdep_plain(cum, n, mask, plane)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        errs[name] = err
        if err:
            fail(f"{name} bins={cum.numel()}: max |err| {err}")
        regen_inputs[name] = (cum, mask, plane)
        print(f"[3 kernel] {name} bins={cum.numel()} dead=0x{dead:X} equal to "
              "plain (max |err| 0)", flush=True)
    for m64 in (0xF000000000000F00, 0x00FF00000000FF00, 0x0000000000FFFF00,
                0x01FF00000000FF00):
        mh, ml = m64 >> 32, m64 & 0xFFFFFFFF
        got, ref = ck.hist_pext2(hi64, lo64, mh, ml), ck.hist_pext2_plain(hi64, lo64, mh, ml)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        errs["hist_pext2"] = max(errs["hist_pext2"], err)
        if err or int(got.long().sum()) != n:
            fail(f"hist_pext2 mask 0x{m64:016X}: max |err| {err}")
        print(f"[3 kernel] hist_pext2 mask=0x{m64:016X} bins={got.numel()} shape "
              f"{hist_label(got.numel())} equal to plain (max |err| 0)", flush=True)
    regen2_inputs = {}
    for m64, dead, name in ((0xF000000000000F00, 0x0001000300000005, "regen_pdep2"),
                            (0x00FF00000000FF00, 0x8000000100000003,
                             "regen_pdep2_windowed")):
        mh, ml = m64 >> 32, m64 & 0xFFFFFFFF
        phi = (hi64 & i32(mh)) | i32(dead >> 32)
        plo = (lo64 & i32(ml)) | i32(dead & 0xFFFFFFFF)
        cum = torch.cumsum(ck.hist_pext2(phi, plo, mh, ml), 0, dtype=torch.int32)
        ghi, glo = ck.regen_pdep2(cum, n, mh, ml, phi, plo)
        rhi, rlo = ck.regen_pdep2_plain(cum, n, mh, ml, phi, plo)
        torch.cuda.synchronize()
        err = max(max_err(ghi, rhi), max_err(glo, rlo))
        errs[name] = err
        if err:
            fail(f"{name} bins={cum.numel()}: max |err| {err}")
        regen2_inputs[name] = (cum, mh, ml, phi, plo)
        print(f"[3 kernel] {name} bins={cum.numel()} dead=0x{dead:016X} equal "
              "to plain (max |err| 0)", flush=True)
    # the dense tier: K1 drops the top quarter of the keys (drop_ge); K4/K7
    # add the range probe's offset on the store
    drop_ge, offset = 0xC0000000, 0x9E3779B9
    for bits in (8, 16, 17, 18):
        got, ref = ck.hist(w, 0, bits, drop_ge=drop_ge), ck.hist_plain(w, 0, bits, drop_ge)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        errs["hist"] = max(errs["hist"], err)
        if err or int(got.long().sum()) != int((w.long() & 0xFFFFFFFF).lt(drop_ge).sum()):
            fail(f"hist r={bits}: max |err| {err}")
        print(f"[3 kernel] hist r={bits} drop_ge=0x{drop_ge:X} shape {hist_label(1 << bits)} "
              "equal to plain (max |err| 0)", flush=True)
    for bits in (8, 11, 16, 18):
        got, ref = ck.hist_multi(w, bits), ck.hist_multi_plain(w, bits)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        errs["hist_multi"] = max(errs["hist_multi"], err)
        if err or got.shape != (-(-32 // bits), 1 << bits):
            fail(f"hist_multi r={bits}: max |err| {err}, shape {tuple(got.shape)}")
        print(f"[3 kernel] hist_multi r={bits} passes={got.shape[0]} shape "
              f"{hist_label(got.numel())} equal to plain (max |err| 0)", flush=True)
    # K1's live-digit read: every plane's digits and the descent flag in one
    # launch, one plane and two, uniform keys (a descent), the keys sorted
    # (none) and sorted with one pair swapped at the middle (one)
    for planes in ((w,), (hi64, lo64)):
        order = torch.sort(planes[0] ^ i32(1 << 31)).values ^ i32(1 << 31)
        swapped = order.clone()
        swapped[n // 2 - 1], swapped[n // 2] = order[n // 2], order[n // 2 - 1]
        rest = tuple(torch.arange(n, device=dev, dtype=torch.int32) for _ in planes[1:])
        for label, ws, want in (("uniform", planes, n > 2), ("sorted", (order,) + rest, 0),
                                ("one swap", (swapped,) + rest, None)):
            for bits in (8, 16):
                got, flag = ck.live_digits(ws, bits)
                ref, ref_flag = ck.live_digits_plain(ws, bits)
                torch.cuda.synchronize()
                err = max(int((got.long() - ref.long()).abs().max()), abs(int(flag) - int(ref_flag)))
                errs["live_digits"] = max(errs["live_digits"], err)
                if err or (want is not None and int(flag) != int(want)):
                    fail(f"live_digits {len(ws)} planes r={bits} {label}: max |err| {err}, "
                         f"flag {int(flag)}")
            print(f"[3 kernel] live_digits {len(ws)} plane(s) {label}: r = 8 and 16 equal "
                  f"to plain, descent flag {int(flag)} (max |err| 0)", flush=True)
        del order, swapped, rest, got, ref
    # 16-bit counters on skewed keys: every block's counter of the common
    # value crosses 2^15 several times, so each hand-off to the output runs
    # under contention
    for label, share in (("90% one value", 9), ("all one value", 10)):
        same = w.clone()
        same[: n * share // 10] = 0x155
        same_hi = hi64.clone()
        same_hi[: n * share // 10] = 0x1C0
        for name, got, ref in (
                ("hist r=16", ck.hist(same, 0, 16), ck.hist_plain(same, 0, 16)),
                ("hist r=18", ck.hist(same, 0, 18), ck.hist_plain(same, 0, 18)),
                ("hist_pext mask=0xFFFF", ck.hist_pext(same, 0xFFFF),
                 ck.hist_pext_plain(same, 0xFFFF)),
                ("hist_pext2 masks=0xC0,0x3FFF", ck.hist_pext2(same_hi, same, 0xC0, 0x3FFF),
                 ck.hist_pext2_plain(same_hi, same, 0xC0, 0x3FFF))):
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            kernel = name.split()[0]
            errs[kernel] = max(errs[kernel], err)
            if err or int(got.long().sum()) != n:
                fail(f"{name} on {label}: max |err| {err}")
            print(f"[3 kernel] {name} {label} shape {hist_label(got.numel())} equal to plain "
                  "(max |err| 0)", flush=True)
        del same, same_hi
    dense_inputs = {}
    for bits, name in ((10, "regen"), (16, "regen_windowed")):
        c = w & i32((1 << bits) - 1)
        cum = torch.cumsum(ck.hist(c, 0, bits), 0, dtype=torch.int32)
        got, ref = ck.regen(cum, n, offset), ck.regen_plain(cum, n, offset)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        errs[name] = err
        if err:
            fail(f"{name} bins={cum.numel()}: max |err| {err}")
        dense_inputs[name] = cum
        print(f"[3 kernel] {name} bins={cum.numel()} offset=0x{offset:X} equal to "
              "plain (max |err| 0)", flush=True)
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
    for k, v, bits, drop, label in whist_inputs:
        (gc, gs), (pc, ps) = ck.whist(k, v, bits, drop), ck.whist_plain(k, v, bits, drop)
        torch.cuda.synchronize()
        err = max(max_err(gc, pc), max_err(gs, ps))
        errs["whist"] = max(errs["whist"], err)
        if err or int(gc.long().sum()) != int(((k.long() & 0xFFFFFFFF) < drop).sum()):
            fail(f"whist bins={1 << bits} {label}: max |err| {err}")
        print(f"[3 kernel] whist bins={1 << bits} drop_ge={drop} {label} shape "
              f"{ck.whist_shape(bits, 'u32', True).label()}: counts and sums equal to plain "
              "(max |err| 0)", flush=True)
    whist_f32_inputs = [(w & 1023, 10, 1000, True), (w & 0x7FFF, 15, 1 << 15, False),
                        (w & 0xFFFF, 16, 1 << 16, True)]
    for k, bits, drop, with_counts in whist_f32_inputs:
        name = "whist_f32_counts" if with_counts else "whist_f32"
        got = ck.whist_f32(k, weights, bits, drop, with_counts)
        plain = ck.whist_f32_plain(k, weights, bits, drop, with_counts)
        torch.cuda.synchronize()
        if with_counts:
            if max_err(got[0], plain[0]):
                fail(f"{name} bins={1 << bits}: counts differ from plain")
            got, plain = got[1], plain[1]
        rel, ok = f32_sum_check(got, k, weights, 1 << bits, drop)
        rel_plain, ok_plain = f32_sum_check(plain, k, weights, 1 << bits, drop)
        errs[name] = float((got.double() - plain.double()).abs().max())
        if not (ok and ok_plain):
            fail(f"{name} bins={1 << bits}: sums past the bound (max rel err {rel:.3g}, "
                 f"plain {rel_plain:.3g})")
        print(f"[3 kernel] {name} bins={1 << bits} drop_ge={drop} shape "
              f"{ck.whist_shape(bits, 'f32', with_counts).label()}: "
              f"{'counts equal to plain, ' if with_counts else ''}sums within "
              f"sum|w| * 2^-14 + 1e-5 of float64 (max rel err {rel:.3g}, plain "
              f"{rel_plain:.3g}; max |kernel - plain| {errs[name]:.3g})", flush=True)
    # the LSD passes: L1 and L2 for the lowest digit of the keys, carrying an
    # index plane as argsort does; the pass must be stable
    idx32 = torch.arange(n, dtype=torch.int32, device=dev)
    lsd_inputs = {}
    for bits in (8, 11, 16):
        tile = lsd_engine.lsd_tile(8192, bits)
        got, ref = ck.lsd_hist(w, 0, bits, tile), ck.lsd_hist_plain(w, 0, bits, tile)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        errs["lsd_hist"] = max(errs["lsd_hist"], err)
        if err or int(got.long().sum()) != n:
            fail(f"lsd_hist r={bits}: max |err| {err}")
        bases = scan.scatter_bases(got)
        gk, gi = ck.lsd_scatter(w, (w, idx32), 0, bits, tile, bases)
        rk, ri = ck.lsd_scatter_plain(w, (w, idx32), 0, bits, tile, bases)
        torch.cuda.synchronize()
        err = max(max_err(gk, rk), max_err(gi, ri))
        errs["lsd_scatter"] = max(errs["lsd_scatter"], err)
        d = gk & ((1 << bits) - 1)
        stable = bool(((d[1:] > d[:-1]) | ((d[1:] == d[:-1]) & (gi[1:] > gi[:-1]))).all())
        if err or not stable:
            fail(f"lsd_scatter r={bits}: max |err| {err}, stable {stable}")
        lsd_inputs[bits] = (tile, bases)
        del got, ref, gk, gi, rk, ri, d
        print(f"[3 kernel] lsd_hist and lsd_scatter r={bits} tile={tile}: equal to plain "
              "(max |err| 0), one stable pass", flush=True)
    # L1 and L2 at the other shapes a caller may give them, at n keys: short
    # and odd tiles, skewed keys (at r = 16 whole tiles of 65,536 keys in one
    # bin), and key and payload planes 1, 2 and 3 words off the 16-byte grid
    skew90 = w.clone()
    skew90[: n * 9 // 10] = 0x5A5A5A5A
    one_digit = torch.full_like(w, 0x5A5A5A5A)
    grid = torch.empty(4 * (n + 4), dtype=torch.int32, device=dev)
    views = [grid[k * (n + 4) + k: k * (n + 4) + k + n] for k in (1, 2, 3)]
    for v, src in zip(views, (w, idx32, lo64)):
        v.copy_(src)
    lsd_cases = [("short tile", w, 8, 1000, (w, idx32)),
                 ("mid tile", w, 11, 4096, (w, idx32)),
                 ("odd tile", w, 11, 8191, (w, idx32)),
                 ("tiny tile", w, 1, 3, (w, idx32)),
                 ("several stages a tile", w, 12, 65_536, (w, idx32)),
                 ("90% one digit", skew90, 8, lsd_engine.lsd_tile(8192, 8), (skew90, idx32)),
                 ("90% one digit", skew90, 16, lsd_engine.lsd_tile(8192, 16), (skew90, idx32)),
                 ("all one digit", one_digit, 16, lsd_engine.lsd_tile(8192, 16),
                  (one_digit, idx32)),
                 ("planes 1-3 words off the grid", views[0], 8, lsd_engine.lsd_tile(8192, 8),
                  tuple(views)),
                 ("planes 1-3 words off the grid", views[0], 11,
                  lsd_engine.lsd_tile(8192, 11), tuple(views))]
    for label, keys_in, bits, tile, planes in lsd_cases:
        got, ref = ck.lsd_hist(keys_in, 0, bits, tile), ck.lsd_hist_plain(keys_in, 0, bits, tile)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        errs["lsd_hist"] = max(errs["lsd_hist"], err)
        if err or int(got.long().sum()) != n:
            fail(f"lsd_hist r={bits} tile={tile} {label}: max |err| {err}")
        bases = scan.scatter_bases(got)
        del got, ref
        gp = ck.lsd_scatter(keys_in, planes, 0, bits, tile, bases)
        rp = ck.lsd_scatter_plain(keys_in, planes, 0, bits, tile, bases)
        torch.cuda.synchronize()
        err = max(max_err(a, b) for a, b in zip(gp, rp))
        errs["lsd_scatter"] = max(errs["lsd_scatter"], err)
        if err:
            fail(f"lsd_scatter r={bits} tile={tile} {label}: max |err| {err}")
        del gp, rp, bases
        print(f"[3 kernel] lsd_hist and lsd_scatter r={bits} tile={tile} {label}, "
              f"{len(planes)} planes: equal to plain (max |err| 0)", flush=True)
    del grid, views
    # K0's sweep (one launch a live digit: L2's staged form with the
    # look-back) against its plain version at n keys, one pass each: the keys
    # alone, the index born as the position (int32, and int64 where it is
    # also the last pass), an index plane written as int64 behind a payload,
    # and keys of which 90% or all share the digit (every look-back on one
    # column); the starts the exclusive scan of the digit's histogram
    def sweep_starts(keys_in, shift):
        h = torch.bincount(((keys_in >> shift) & 0xFF).long(), minlength=256)
        return (torch.cumsum(h, 0) - h).to(torch.int32)

    sweep_cases = [("keys alone", w, 0, (w,), False, torch.int32),
                   ("index born, int32", w, 8, (w,), True, torch.int32),
                   ("index born, int64", w, 16, (w, lo64), True, torch.int64),
                   ("index plane to int64", w, 24, (lo64, w, idx32), False, torch.int64),
                   ("90% one digit", skew90, 8, (skew90,), True, torch.int64),
                   ("all one digit", one_digit, 0, (one_digit,), True, torch.int32)]
    for label, keys_in, shift, planes, position, index_dtype in sweep_cases:
        starts = sweep_starts(keys_in, shift)
        got = ck.k0_sweep(keys_in, planes, shift, 8, ck.K0_SWEEP_TILE, starts,
                          ck.k0_sweep_status(n, dev), 1, position=position,
                          index_dtype=index_dtype)
        ref = ck.k0_sweep_plain(keys_in, planes, shift, 8, ck.K0_SWEEP_TILE, starts,
                                position=position, index_dtype=index_dtype)
        torch.cuda.synchronize()
        if [g.dtype for g in got] != [r.dtype for r in ref]:
            fail(f"k0_sweep {label}: dtypes {[g.dtype for g in got]}")
        err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
        errs["k0_sweep"] = max(errs["k0_sweep"], err)
        if err:
            fail(f"k0_sweep {label}: max |err| {err}")
        del got, ref
        print(f"[3 kernel] k0_sweep {label} (shift {shift}, {len(planes) + position} planes, "
              f"index {index_dtype}): equal to plain (max |err| 0)", flush=True)
    # K0, the sorter of one plane (live_digits, then one k0_sweep a live
    # digit), against torch.sort(stable=True), at the gate and at n keys:
    # keys-only, argsort with int64 and uint32 indices, and sort_pairs with a
    # 4-byte payload (it rides the sweep) and an 8-byte one (gathered through
    # the index)
    pay4 = lo64.view(torch.float32)
    for m in [m for m in sorted({hw_engine.LSD_MIN_KEYS, n}) if m <= n]:
        km = w[:m]
        ref = torch.sort(km ^ i32(1 << 31), stable=True)
        before = ck.LAUNCHES["lsd_sort"]
        (got,), _ = hw_engine.sort_words((km,), stable=False)
        _, perm = hw_engine.argsort_words((km,), torch.int64)
        _, perm32 = hw_engine.argsort_words((km,), torch.uint32)
        (pk,), (p4, p8) = hw_engine.sort_words((km,), (pay4[:m], keys64_t[:m]))
        torch.cuda.synchronize()
        if ck.LAUNCHES["lsd_sort"] != before + 4:
            fail(f"K0 n={m}: {ck.LAUNCHES['lsd_sort'] - before} of 4 calls took K0")
        if perm.dtype != torch.int64 or perm32.dtype != torch.uint32:
            fail(f"K0 n={m}: argsort dtypes {perm.dtype}, {perm32.dtype}")
        want_keys = ref.values ^ i32(1 << 31)
        err = max(max_err(got, want_keys), max_err(pk, want_keys),
                  int((perm - ref.indices).abs().max()),
                  int((perm32.view(torch.int32).long() - ref.indices).abs().max()),
                  max_err(p4.view(torch.int32), lo64[:m][ref.indices]),
                  int((p8 - keys64_t[:m][ref.indices]).abs().max()))
        errs["lsd_sort"] = max(errs["lsd_sort"], err)
        if err:
            fail(f"K0 n={m}: max |err| {err} against torch.sort")
        del ref, got, perm, perm32, pk, p4, p8, want_keys
        print(f"[3 kernel] lsd_sort (K0) n={m}: keys-only, argsort (int64 and uint32) and "
              "sort_pairs (4- and 8-byte payloads) equal to torch.sort(stable=True) "
              "(max |err| 0)", flush=True)
    del skew90, one_digit
    # K12: the records of equal key tuples must stay a permutation (R1)
    for m in (1024, 4097, 131_072):
        dup, iota = w[:m] & 15, idx32[:m]
        for label, planes, nk in (("one key plane", (w[:m],), 1),
                                  ("(hi, lo) keys", (hi64[:m], lo64[:m]), 2),
                                  ("(key, index) keys + payload", (dup, iota, lo64[:m]), 2),
                                  ("16 key values + payload, num_keys=1", (dup, iota), 1)):
            got, ref = ck.bitonic(planes, nk), ck.bitonic_plain(planes, nk)
            torch.cuda.synchronize()
            err = max(max_err(a, b) for a, b in zip(got, ref))
            errs["bitonic"] = max(errs["bitonic"], err)
            ok = bool(probes.is_sorted_words(got[:nk]))
            if nk == 1 and len(planes) == 2:    # the payload is the index
                ok &= torch.equal(torch.sort(got[1]).values, iota)
                ok &= torch.equal(dup[got[1].long()], got[0])
            if err or not ok:
                fail(f"bitonic n={m} {label}: max |err| {err}, sorted and permuted {ok}")
            print(f"[3 kernel] bitonic n={m} {label}: equal to plain (max |err| 0), "
                  f"sorted{', every record once' if len(planes) == 2 and nk == 1 else ''}",
                  flush=True)
    # K12 past 32 planes, up to the gate's top plane count (F1): 16 values in
    # the first key plane, an index plane, random words elsewhere
    top = max(p for p in range(1, 4096) if vmem_sort_ok(1024, p))
    for m, nplanes, nk in ((100, 33, 1), (1024, 40, 34), (1024, top, 2)):
        if not vmem_sort_ok(m, nplanes):
            fail(f"sort_planes_vmem ({m}, {nplanes}): not admitted by the gate")
        words = rng.integers(0, 1 << 32, size=(nplanes, m), dtype=np.uint32)
        words[0] &= 15
        words[nk] = np.arange(m)
        planes = tuple(torch.from_numpy(words.view(np.int32)).to(dev).unbind(0))
        got, ref = sort_planes_vmem(planes, nk), ck.bitonic_plain(planes, nk)
        torch.cuda.synchronize()
        err = max(max_err(a, b) for a, b in zip(got, ref))
        errs["bitonic"] = max(errs["bitonic"], err)
        perm = got[nk].long()
        ok = bool(probes.is_sorted_words(got[:nk])) and torch.equal(
            torch.sort(perm).values, torch.arange(m, device=dev))
        ok &= all(torch.equal(p[perm], g) for p, g in zip(planes, got))
        if err or not ok:
            fail(f"sort_planes_vmem ({m}, {nplanes}, {nk}): max |err| {err}, "
                 f"sorted and permuted {ok}")
        print(f"[3 kernel] sort_planes_vmem n={m} planes={nplanes} num_keys={nk}: equal "
              "to plain (max |err| 0), sorted, every record once", flush=True)
    top_planes = planes
    # K12's route edges at 2^17: the last plane count one cluster holds (3)
    # and the first past it (4: tiles and device-memory steps), keys of 4
    # values so that ties decide where the payloads go
    m = 1 << 17
    for nplanes, nk in ((3, 2), (4, 3)):
        words = rng.integers(0, 1 << 32, size=(nplanes, m), dtype=np.uint32)
        words[:nk] &= 3
        planes = tuple(torch.from_numpy(words.view(np.int32)).to(dev).unbind(0))
        got, ref = ck.bitonic(planes, nk), ck.bitonic_plain(planes, nk)
        torch.cuda.synchronize()
        err = max(max_err(a, b) for a, b in zip(got, ref))
        errs["bitonic"] = max(errs["bitonic"], err)
        if err or not probes.is_sorted_words(got[:nk]):
            fail(f"bitonic n={m} planes={nplanes} num_keys={nk}: max |err| {err}")
        print(f"[3 kernel] bitonic n={m} planes={nplanes} num_keys={nk} route "
              f"{k12_route(m, nplanes)}: equal to plain (max |err| 0), sorted", flush=True)
    # E1: the staged copy, a whole number of chunks, a ragged tail, and
    # views 1 to 4 words in (1-3: not 16 bytes aligned, word by word)
    for m, off in ((1 << 24, 0), ((1 << 24) + 12_345, 0), (1_000_003, 1), (1_000_003, 2),
                   (1_000_003, 3), (1_000_003, 4)):
        x = w[off:off + m]
        got, ref = ck.dma_copy(x), ck.dma_copy_plain(x)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        errs["dma_copy"] = max(errs["dma_copy"], err)
        if err or not torch.equal(got, x):
            fail(f"dma_copy n={m} offset {off}: max |err| {err}")
        route = "bulk copies" if x.data_ptr() % 16 == 0 else "word by word"
        print(f"[3 kernel] dma_copy n={m} offset {off} words ({route}): equal to plain "
              "(max |err| 0)", flush=True)
    # E2: the spread step on the keys as 128 sorted rows, 128 buckets
    n_msd = n // 128 * 128
    _, msd_shapes, msd = exp_sol_round2.build_msd(n_msd, 128, 128, 24)
    xs = msd["row_sort"](w[:n_msd])
    s128, xp = msd["spread_inputs"](xs, msd["starts"](xs))
    spread_args = (s128, xp, msd_shapes["m"], msd_shapes["d"], 24)
    got, ref = ck.msd_spread(*spread_args), ck.msd_spread_plain(*spread_args)
    torch.cuda.synchronize()
    errs["msd_spread"] = max_err(got, ref)
    kept = int((got != -1).sum())
    if errs["msd_spread"] or kept != n_msd - int((xs == -1).sum()):
        fail(f"msd_spread: max |err| {errs['msd_spread']}, {kept} keys kept of {n_msd}")
    print(f"[3 kernel] msd_spread R=K=128 capr=24 m={msd_shapes['m']} W={xp.shape[1]}: "
          f"equal to plain (max |err| 0), {kept} keys kept", flush=True)
    del got, ref, xs
    # K13: D ranks on cuda:0, each rank's sends its own random words
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def rank_sends(D, shape, dtype):
        lim = 1 << (15 if dtype == torch.int16 else 31)
        return [torch.randint(-lim, lim, shape, dtype=dtype, device=dev, generator=gen)
                for _ in range(D)]

    for D in (2, 4, 8):
        for c, dtype, label in ((1, torch.int32, "(3, D, 1) u32"),
                                (37, torch.int32, "(3, D, 37) u32"),
                                (10_000_000 // D, torch.int32, f"(3, D, {10_000_000 // D}) u32"),
                                (37, torch.int16, "(D, 37) int16")):
            if dtype == torch.int16:
                sends = rank_sends(D, (D, c), dtype)
            else:   # a rank's (3, D, c) send as rdma_all_to_all lays it out
                sends = [s.movedim(1, 0).reshape(D, 3 * c).contiguous()
                         for s in rank_sends(D, (3, D, c), dtype)]
            got, ref = ck.rdma_exchange(sends), ck.rdma_exchange_plain(sends)
            torch.cuda.synchronize()
            err = max(max_err(g.int(), r.int()) for g, r in zip(got, ref))
            errs["rdma_exchange"] = max(errs["rdma_exchange"], err)
            if err or any(not torch.equal(got[d][s], sends[s][d])
                          for d in range(D) for s in range(D)):
                fail(f"rdma_exchange D={D} {label}: max |err| {err}")
            print(f"[3 kernel] rdma_exchange D={D} ranks on cuda:0, {label} sends "
                  f"({sends[0].shape[1] * sends[0].element_size()} bytes a row): equal "
                  "to plain (max |err| 0)", flush=True)
            del got, ref, sends

    # -- phase 4: the slice through the public entry points -----------------
    def u32_tensor(a):
        return torch.from_numpy(a.view(np.int32)).to(dev).view(torch.uint32)

    def u64_tensor(a, dtype=torch.uint64):
        return torch.from_numpy(a.view(np.int64)).to(dev).view(dtype)

    def bits_of(np_dtype):
        return lambda out: gpu_bits(out, np_dtype)

    bf16 = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    f32 = rng.standard_normal(n).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    idx = rng.integers(0, n, size=4096)
    f32[idx] = specials[np.arange(idx.size) % specials.size]
    f32b = f32.view(np.uint32).copy()
    f32b[idx[:64]] = np.uint32(0xFFC00001)        # negative NaN with payload
    f32b[idx[64:128]] = np.uint32(0x7F800123)     # signalling NaN payload
    bf16[idx] = np.array([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC1, 0xFFC3],
                         np.uint16)[np.arange(idx.size) % 6]
    f64b = rng.standard_normal(n).view(np.uint64).copy()
    f64b[idx] = np.array([0x0, 0x8000000000000000, 0x7FF0000000000000,
                          0xFFF0000000000000, 0x7FF8000000000000,
                          0xFFF8000000000007, 0x7FF0000000000123],
                         np.uint64)[np.arange(idx.size) % 7]
    f8 = rng.integers(0, 256, size=n, dtype=np.uint8)
    nb = n // 10
    s12 = rng.integers(0, 4, size=(nb, 12), dtype=np.uint8) * np.uint8(60)
    s12 = np.ascontiguousarray(s12).view("S12").reshape(-1)
    mask = 0xF0F00000
    m_k6, m_k9, m_24 = 0xF000000000000F00, 0x00FF00000000FF00, 0x0FFF00000000FFF0
    u16 = (keys & np.uint32(0xFFFF)).astype(np.uint16)
    dups = keys & np.uint32(0xFFFF)
    pay_i64 = rng.integers(-2**62, 2**62, size=n, dtype=np.int64)
    pay_f32 = rng.standard_normal(n).astype(np.float32)
    payload = {"i64": torch.from_numpy(pay_i64).to(dev),
               "f32": torch.from_numpy(pay_f32).to(dev)}
    sorted_keys = np.sort(keys)
    sorted64 = np.sort(keys64)
    desc = rt.SortConfig(descending=True)
    # the LSD slice: configurations, a byte field, bench.py's 4,096-key rows
    lsd8 = rt.SortConfig(strategy=rt.Strategy.LSD)
    lsd11 = lsd8.replace(radix_bits=11)
    names6 = rng.integers(0, 256, size=(n, 6), dtype=np.uint8)
    payload_b = dict(payload, name=torch.from_numpy(names6).to(dev))
    n_rows = n // 4096
    rows_u32 = keys[: n_rows * 4096].reshape(n_rows, 4096)
    rows_dups = dups[: n_rows * 4096].reshape(n_rows, 4096)
    rows_f32 = pay_f32[: n_rows * 4096].reshape(n_rows, 4096)
    rows_f32_t = torch.from_numpy(rows_f32).to(dev)
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
    u16_unique = np.unique(u16)

    # the group-by slice: bench.py's group-by case (k = x & 1023, v =
    # int32(x >> 10)), then 65,536 groups, f32 values and histograms
    k1024 = keys & np.uint32(1023)
    v_bench = (keys >> np.uint32(10)).astype(np.int32)
    k64k = keys & np.uint32(0xFFFF)
    v_u8 = (keys64 >> np.uint64(56)).astype(np.uint8)
    hist_w = pay_f32[::-1].copy()
    v_bench_t, v_u8_t = (torch.from_numpy(a).to(dev) for a in (v_bench, v_u8))
    pay_f32_t, hist_w_t = (torch.from_numpy(a).to(dev) for a in (pay_f32, hist_w))
    groups1024 = np.arange(1024, dtype=np.uint32)
    groups64k = np.arange(1 << 16, dtype=np.uint32)
    cnt1024, cnt64k = np.bincount(k1024, minlength=1024), np.bincount(k64k, minlength=1 << 16)

    def wrapped_sums(k, v, bins):
        """Exact per-group sums mod 2^32 (float64 is exact below 2^53)."""
        s = np.bincount(k, weights=v.astype(np.float64), minlength=bins)
        return s.astype(np.int64).astype(np.uint32)

    def grouped(np_dtype):
        return lambda out: (gpu_bits(out[0], np.uint32), gpu_bits(out[1], np_dtype),
                            np.array([int(out[2])]))

    def sorted_runs_extremes():
        """min and max of v_bench per 16-bit group, by a stable sort."""
        perm = np.argsort(k64k, kind="stable")
        vs, starts = v_bench[perm], np.searchsorted(k64k[perm], groups64k)
        return np.minimum.reduceat(vs, starts), np.maximum.reduceat(vs, starts)

    extremes = []

    def extreme(i):
        if not extremes:
            extremes.extend(sorted_runs_extremes())
        return extremes[i]

    def mean_check(out):
        """group_reduce mean of f32 values: within the K11 bound over the
        group's size, plus 2^-22 of the mean for the division."""
        if not np.array_equal(gpu_bits(out[0], np.uint32), groups1024) or int(out[2]) != 1024:
            return "groups differ"
        ref = np.bincount(k1024, weights=pay_f32.astype(np.float64), minlength=1024) / cnt1024
        absum = np.bincount(k1024, weights=np.abs(pay_f32.astype(np.float64)), minlength=1024)
        err = np.abs(out[1].cpu().numpy().astype(np.float64) - ref)
        if not np.all(err <= (absum * 2**-14 + 1e-5) / cnt1024 + np.abs(ref) * 2**-22):
            return f"mean past the bound: max |err| {err.max():.3g}"
        return None

    def histogram_check(weighted):
        def check(out):
            counts, edges = out
            want_edges = np.linspace(float(pay_f32.min()), float(pay_f32.max()), 257)
            if not np.array_equal(edges, want_edges):
                return "edges differ"
            idx = bin_index_np(pay_f32, edges, 256)
            got = counts.cpu().numpy()
            if not weighted:
                want = np.bincount(idx, minlength=257)[:256].astype(np.int32)
                return None if np.array_equal(got, want) else "counts differ"
            w64 = hist_w.astype(np.float64)
            ref = np.bincount(idx, weights=w64, minlength=257)[:256]
            absum = np.bincount(idx, weights=np.abs(w64), minlength=257)[:256]
            err = np.abs(got.astype(np.float64) - ref)
            ok = np.all(err <= absum * 2**-14 + 1e-5)
            return None if ok else f"weighted sums past the bound: max |err| {err.max():.3g}"
        return check

    def bitmap_oracle():
        padded = np.full(1 << 16, 0xFFFF, np.uint16)
        padded[:u16_unique.size] = u16_unique
        return padded, np.array([u16_unique.size], np.int64)

    def stable_perm(a):
        """np.argsort(a, kind="stable") along the last axis; unsigned keys
        of 32 or 64 bits by 16-bit digits from the least significant, each a
        stable (radix) sort in numpy: the same permutation, twice as fast at
        40M keys."""
        if a.dtype.kind != "u" or a.dtype.itemsize <= 2:
            return np.argsort(a, axis=-1, kind="stable")
        perm = None
        for shift in range(0, 8 * a.dtype.itemsize, 16):
            d = (a >> a.dtype.type(shift)).astype(np.uint16)
            if perm is not None:
                d = np.take_along_axis(d, perm, -1)
            p = np.argsort(d, axis=-1, kind="stable")
            perm = p if perm is None else np.take_along_axis(perm, p, -1)
        return perm

    def pairs_host(out):
        k, v = out
        return (gpu_bits(k, np.uint32), v["i64"].cpu().numpy(), v["f32"].cpu().numpy())

    def pairs_oracle(a):
        p = stable_perm(a)
        return (a[p], pay_i64[p], pay_f32[p])

    # the sorter composites of extras and stats: sorted keys and queries with
    # exact hits (half of each batch keys of the array), 'auto' taking the
    # scan below 32 * q = n and the tagged union from it
    memo = {}

    def once(key, fn):
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    def hits(src, q, random):
        return np.concatenate([src[: q // 2], random(q - q // 2)])

    def rand32(m):
        return rng.integers(0, 1 << 32, size=m, dtype=np.uint32)

    q_scan, q_cross, q64 = 100_000, -(-n // 32), min(4_000_000, n)
    qs_scan, qs_cross = hits(keys, q_scan, rand32), hits(keys, q_cross, rand32)
    qs64 = hits(keys64, q64, lambda m: rng.integers(0, 1 << 64, size=m, dtype=np.uint64))
    qf32b = hits(f32b, 1_000_000, lambda m: np.concatenate(
        [specials.view(np.uint32), rng.standard_normal(m - 5).astype(np.float32).view(np.uint32)]))
    sorted_t, sorted64_t = u32_tensor(sorted_keys), u64_tensor(sorted64)
    sorted_desc_t = u32_tensor(sorted_keys[::-1].copy())
    keys_t = u32_tensor(keys)
    sorter_t = rt.argsort(keys_t)                  # any sorting permutation
    f32b_sorted = float_order_np(f32b, 32)
    f32_sorted_t = torch.from_numpy(f32b_sorted.view(np.float32)).to(dev)

    def order32(bits):
        """The total order of f32 bit patterns as u32 keys (the KDF)."""
        b = bits.astype(np.uint32)
        return np.where(b & np.uint32(1 << 31), ~b, b | np.uint32(1 << 31))

    def order64(bits):
        b = bits.astype(np.uint64)
        return np.where(b >> np.uint64(63), ~b, b | np.uint64(1 << 63))

    def searched(a, q, side):
        return lambda: np.searchsorted(a, q, side=side).astype(np.int32)

    lex8 = [torch.from_numpy(a).to(dev) for a in (keys.astype(np.uint8),
                                                 (keys >> np.uint32(8)).astype(np.uint8))]
    lex8.append(torch.from_numpy((keys >> np.uint32(16)).astype(np.uint16).view(np.int16))
                .to(dev).view(torch.uint16))       # (u8, u8, u16): the keys, one plane
    lex32 = [keys_t, u32_tensor(dups), u32_tensor(k1024)]      # three planes: chained sorts
    seg16 = (keys >> np.uint32(22)).astype(np.uint16)        # 1,024 segments
    seg16_t = torch.from_numpy(seg16.view(np.int16)).to(dev).view(torch.uint16)
    u16_t = torch.from_numpy(u16.view(np.int16)).to(dev).view(torch.uint16)
    halves = (rt.sort(u32_tensor(keys[: n // 2])), rt.sort(u32_tensor(keys[n // 2:])))
    ranks = [0, 1, n // 4, n // 2, n - 1]
    pred_t = torch.from_numpy((keys & np.uint32(1)).astype(bool)).to(dev)
    qs5 = [0.01, 0.25, 0.5, 0.75, 0.99]
    edges32 = np.sort(rng.standard_normal(1001).astype(np.float32))
    edges_t, edges64 = torch.from_numpy(edges32).to(dev), edges32.astype(np.float64)
    re = rng.integers(-1000, 1000, size=4_000_000).astype(np.float64)     # real-part ties
    z128 = re + 1j * rng.standard_normal(re.size)
    f64_t = u64_tensor(f64b, torch.float64)

    def stable_keys():
        return once("stable keys", lambda: stable_perm(keys))

    def seg_perm(descending):
        """The stable order of (segment, key), the key complemented when
        descending (one stable argsort of the u32 composite)."""
        k = np.uint32(0xFFFF) - u16 if descending else u16
        return once(("seg", descending), lambda: stable_perm(
            (seg16.astype(np.uint32) << np.uint32(16)) | k))

    def segmented_oracle(descending):
        return lambda: (u16[seg_perm(descending)], seg16[seg_perm(descending)])

    def top_k_np(order_key, k):
        """Indices of the k largest order keys, ties to the lower index."""
        key = ~order_key.astype(np.uint64)
        kth = np.partition(key, k - 1)[k - 1]
        cand = np.flatnonzero(key <= kth)
        return cand[np.lexsort((cand, key[cand]))][:k]

    def quantile_oracle(a):
        """The port's float32 interpolation of numpy's order statistics (in
        numpy float32 arithmetic: the same operations), after checking it
        within 2^-20 of np.quantile."""
        def check(got):
            h = np.asarray(qs5) * (n - 1)
            lo, hi = np.floor(h).astype(np.int64), np.ceil(h).astype(np.int64)
            part = np.partition(a, np.unique(np.concatenate([lo, hi])))
            f = (h - lo).astype(np.float32)
            want = (part[lo].astype(np.float32) * (np.float32(1) - f)
                    + part[hi].astype(np.float32) * f)
            ref = np.quantile(a, qs5)
            if not np.allclose(want, ref, rtol=2**-20, atol=1e-12):
                return f"the oracle is {want}, np.quantile {ref}"
            got = got.cpu().numpy()
            return None if got.dtype == np.float32 and np.array_equal(got, want) \
                else f"got {got}, want {want}"
        return check

    def rank_oracle(method):
        import scipy.stats
        # the same values as uint16: numpy sorts them faster
        want = scipy.stats.rankdata(dups.astype(np.uint16), method=method)
        return want.astype(np.float32 if method == "average" else np.int32)

    def histogram_edges_check(weighted):
        def check(out):
            counts, edges = out
            if not np.array_equal(edges, edges64):
                return "edges differ"
            got = counts.cpu().numpy()
            if not weighted:
                want = np.histogram(pay_f32, bins=edges64)[0].astype(np.int32)
                return None if np.array_equal(got, want) else "counts differ"
            w64 = hist_w.astype(np.float64)
            ref = np.histogram(pay_f32, bins=edges64, weights=w64)[0]
            absum = np.histogram(pay_f32, bins=edges64, weights=np.abs(w64))[0]
            err = np.abs(got.astype(np.float64) - ref)
            ok = got.dtype == np.float32 and np.all(err <= absum * 2**-14 + 1e-5)
            return None if ok else f"weighted sums past the bound: max |err| {err.max():.3g}"
        return check

    # the sets slice: unique of the n keys (few duplicates), of u16, of f32
    # with specials and of 64-bit numpy keys; 10M rows of 4 int32 in [0, 8);
    # two halves of n sharing about half their values; isin of the n keys
    # against n / 4 tests, half drawn from them. Each numpy oracle is built
    # once; the padding is the KDF-order-last value (all-ones planes).
    def padded(a, size, fill):
        out = np.full((size,) + a.shape[1:], fill, a.dtype)
        out[: min(len(a), size)] = a[:size]
        return out

    def runs_np(s, perm=None):
        """(firsts, starts, run lengths, run of each sorted position) of a
        sorted array (rows: equal along the last axis)."""
        neq = s[1:] != s[:-1]
        is_new = np.concatenate([[True], neq.any(axis=-1) if neq.ndim > 1 else neq])
        starts = np.flatnonzero(is_new)
        return s[starts], starts, np.diff(np.append(starts, len(s))), np.cumsum(is_new) - 1

    def unique_all_np(a, perm, fill):
        """np.unique(a, all flags) from a stable sorting permutation, padded
        to len(a) as unique() returns it: (values, index, inverse, counts,
        [count])."""
        vals, starts, lens, run = runs_np(a[perm])
        inverse = np.empty(len(a), np.int32)
        inverse[perm] = run
        m = len(a)
        return (padded(vals, m, fill), padded(perm[starts].astype(np.uint32), m, 0), inverse,
                padded(lens.astype(np.int32), m, 0), np.array([len(vals)]))

    def fields(*names, dtype=np.uint32):
        """The named fields of a set routine's result on the host: values by
        their bits as ``dtype``, uint32 indices by theirs, the count as a
        1-element array."""
        def one(f, v):
            if f == "num_unique":
                return np.array([int(v)])
            if not torch.is_tensor(v):
                return v
            if f == "values" or v.dtype == torch.uint32:
                return gpu_bits(v, dtype if f == "values" else np.uint32)
            return v.cpu().numpy()
        return lambda out: tuple(one(f, getattr(out, f)) for f in names)

    def keys_unique():
        return once("unique keys", lambda: unique_all_np(keys, stable_keys(), 0xFFFFFFFF))

    def u16_counts():
        cnt = np.bincount(u16, minlength=1 << 16)
        uq = np.flatnonzero(cnt)
        return (padded(uq.astype(np.uint16), n, 0xFFFF), padded(cnt[uq].astype(np.int32), n, 0),
                np.array([uq.size]))

    def u64_inverse():
        vals, _, _, _ = runs_np(sorted64)
        return (padded(vals, n, np.uint64(0xFFFFFFFFFFFFFFFF)),
                np.searchsorted(vals, keys64).astype(np.int32), np.array([vals.size]))

    def f32_counts(equal_nan):
        def oracle():
            bits = f32b
            if equal_nan:
                bits = np.where(np.isnan(f32b.view(np.float32)), np.uint32(0x7FC00000), f32b)
            vals, _, lens, _ = runs_np(float_order_np(bits, 32) if equal_nan else f32b_sorted)
            return (padded(vals, n, np.uint32(0x7FFFFFFF)),      # all-ones planes: a NaN
                    padded(lens.astype(np.int32), n, 0), np.array([vals.size]))
        return oracle

    rows8 = rng.integers(0, 8, size=(n // 4, 4)).astype(np.int32)

    def rows_oracle():
        code = (rows8[:, 0] << 9) | (rows8[:, 1] << 6) | (rows8[:, 2] << 3) | rows8[:, 3]
        perm = np.argsort(code.astype(np.uint16), kind="stable")
        vals, index, inverse, counts, num = unique_all_np(code, perm, 0)
        return (padded(rows8[perm[runs_np(code[perm])[1]]], n // 4, np.int32(0x7FFFFFFF)),
                index, inverse, counts, num)

    half = n // 2
    set_a = keys[:half]
    set_b = np.concatenate([set_a[rng.integers(0, half, size=half // 2)], rand32(half - half // 2)])
    set_a64 = keys64[:half]
    set_b64 = np.concatenate([set_a64[rng.integers(0, half, size=half // 2)],
                              rng.integers(0, 1 << 64, size=half - half // 2, dtype=np.uint64)])
    tests_in = np.concatenate([keys[rng.integers(0, n, size=n // 8)], rand32(n // 4 - n // 8)])
    set_a_t, set_b_t, tests_t = u32_tensor(set_a), u32_tensor(set_b), u32_tensor(tests_in)
    sets_ops = {"union1d": (np.union1d, n), "intersect1d": (np.intersect1d, half),
                "setdiff1d": (np.setdiff1d, half), "setxor1d": (np.setxor1d, n)}

    def uniq_halves():
        return once("unique halves", lambda: (np.unique(set_a), np.unique(set_b)))

    def set_oracle(op):
        ref, size = sets_ops[op]
        def oracle():
            ua, ub = uniq_halves()
            v = ref(ua, ub, assume_unique=True) if op != "union1d" else ref(ua, ub)
            return padded(v, size, 0xFFFFFFFF), np.array([v.size])
        return oracle

    def intersect_indices(a, b, ones):
        def oracle():
            v, c1, c2 = np.intersect1d(a, b, return_indices=True)
            return (padded(v, half, ones), padded(c1.astype(np.int32), half, len(a)),
                    padded(c2.astype(np.int32), half, len(b)), np.array([v.size]))
        return oracle

    def isin_np():
        return once("isin", lambda: np.isin(keys, tests_in))

    def set_values(dtype=np.uint32):
        return lambda out: (gpu_bits(out[0], dtype) if torch.is_tensor(out[0]) else out[0],
                            *(o.cpu().numpy() if torch.is_tensor(o) else o for o in out[1:-1]),
                            np.array([int(out[-1])]))

    cases = [
        # name, input maker, entry point, host result, numpy oracle
        ("u32 full entropy (sorter)", lambda: u32_tensor(keys), rt.sort,
         bits_of(np.uint32), lambda: sorted_keys),
        ("u32 presorted (guard)", lambda: u32_tensor(sorted_keys), rt.sort,
         bits_of(np.uint32), lambda: sorted_keys),
        ("u32 value_mask=0xF0F00000 (K2+K5)",
         lambda: u32_tensor(keys & np.uint32(mask)),
         lambda x: rt.sort(x, value_mask=mask), bits_of(np.uint32),
         lambda: np.sort(keys & np.uint32(mask))),
        ("u8 (K2+K5)", lambda: torch.from_numpy(keys.astype(np.uint8)).to(dev),
         rt.sort, bits_of(np.uint8), lambda: np.sort(keys.astype(np.uint8))),
        ("u16 (K2+K8)", lambda: torch.from_numpy(u16.view(np.int16)).to(dev).view(torch.uint16),
         rt.sort, bits_of(np.uint16), lambda: np.sort(u16)),
        ("bf16 +-0 +-inf NaN (K2+K8)",
         lambda: torch.from_numpy(bf16.view(np.int16)).to(dev).view(torch.bfloat16),
         rt.sort, bits_of(np.uint16), lambda: float_order_np(bf16, 16)),
        ("f32 +-0 +-inf NaN (sorter)",
         lambda: torch.from_numpy(f32b.view(np.float32)).to(dev), rt.sort,
         bits_of(np.uint32), lambda: float_order_np(f32b, 32)),
        ("u16 descending (K2+K8)",
         lambda: torch.from_numpy(u16.view(np.int16)).to(dev).view(torch.uint16),
         lambda x: rt.sort(x, config=desc), bits_of(np.uint16),
         lambda: np.sort(u16)[::-1]),
        ("u64 full entropy (sorter)", lambda: u64_tensor(keys64), rt.sort,
         bits_of(np.uint64), lambda: sorted64),
        ("i64 (sorter)", lambda: u64_tensor(keys64, torch.int64), rt.sort,
         bits_of(np.int64), lambda: np.sort(keys64.view(np.int64))),
        ("f64 +-0 +-inf NaN payloads (sorter)",
         lambda: u64_tensor(f64b, torch.float64), rt.sort, bits_of(np.uint64),
         lambda: float_order_np(f64b, 64)),
        ("u64 value_mask=0xF000000000000F00 (K3+K6)",
         lambda: u64_tensor(keys64 & np.uint64(m_k6)),
         lambda x: rt.sort(x, value_mask=m_k6), bits_of(np.uint64),
         lambda: np.sort(keys64 & np.uint64(m_k6))),
        ("u64 value_mask=0x00FF00000000FF00 (K3+K9)",
         lambda: u64_tensor(keys64 & np.uint64(m_k9)),
         lambda x: rt.sort(x, value_mask=m_k9), bits_of(np.uint64),
         lambda: np.sort(keys64 & np.uint64(m_k9))),
        ("u64 descending value_mask=0xF000000000000F00 (K3+K6)",
         lambda: u64_tensor(keys64 & np.uint64(m_k6)),
         lambda x: rt.sort(x, value_mask=m_k6, config=desc), bits_of(np.uint64),
         lambda: np.sort(keys64 & np.uint64(m_k6))[::-1]),
        ("u64 24 live bits 0x0FFF00000000FFF0 (compacted sorter)",
         lambda: u64_tensor(keys64 & np.uint64(m_24)),
         lambda x: rt.sort(x, value_mask=m_24), bits_of(np.uint64),
         lambda: np.sort(keys64 & np.uint64(m_24))),
        ("float8_e4m3fn (K2+K5)",
         lambda: torch.from_numpy(f8).to(dev).view(torch.float8_e4m3fn), rt.sort,
         bits_of(np.uint8), lambda: float_order_np(f8, 8)),
        (f"S12 byte strings, {nb} keys (sorter)", lambda: s12,
         lambda x: rt.sort(x, device=dev), lambda out: out, lambda: np.sort(s12)),
        ("argsort u32 with duplicates", lambda: u32_tensor(dups), rt.argsort,
         bits_of(np.uint32), lambda: stable_perm(dups).astype(np.uint32)),
        ("sort_pairs u32 with duplicates, {i64, f32}", lambda: u32_tensor(dups),
         lambda x: rt.sort_pairs(x, payload),
         pairs_host, lambda: pairs_oracle(dups)),
        ("counting_sort u16 with a payload",
         lambda: torch.from_numpy(u16.view(np.int16)).to(dev).view(torch.uint16),
         lambda x: rt.counting_sort(x, payload),
         lambda out: (gpu_bits(out[0], np.uint16), out[1]["i64"].cpu().numpy(),
                      out[1]["f32"].cpu().numpy()),
         lambda: pairs_oracle(u16)),
        ("sort_u64_multipass", lambda: u64_tensor(keys64), rt.sort_u64_multipass,
         bits_of(np.uint64), lambda: sorted64),
        ("device_probe u32 in [0x9E3779B9, +50,000) (K1+K7)", lambda: u32_tensor(r50k),
         lambda x: rt.sort(x, config=probe), bits_of(np.uint32), lambda: np.sort(r50k)),
        ("device_probe u32, 200,000 keys in a range of 1,000 (K1+K4)",
         lambda: u32_tensor(r1k), lambda x: rt.sort(x, config=probe),
         bits_of(np.uint32), lambda: np.sort(r1k)),
        ("device_probe u32 full entropy (sorter)", lambda: u32_tensor(keys),
         lambda x: rt.sort(x, config=probe), bits_of(np.uint32), lambda: sorted_keys),
        ("device_probe u64, constant hi, full lo (one int32 sorter operand)",
         lambda: u64_tensor(ts_full), lambda x: rt.sort(x, config=probe),
         bits_of(np.uint64), lambda: ts_hi | sorted_keys.astype(np.uint64)),
        ("device_probe u64, constant hi, lo in a 60,000 range (K1+K7)",
         lambda: u64_tensor(ts_60k), lambda x: rt.sort(x, config=probe),
         bits_of(np.uint64), lambda: np.sort(ts_60k)),
        ("dynamic_probe u32, unpromised mask 0xF0F00000 (K2+K5)",
         lambda: u32_tensor(keys & np.uint32(mask)),
         lambda x: rt.sort(x, config=rt.SortConfig(dynamic_probe=True)),
         bits_of(np.uint32), lambda: np.sort(keys & np.uint32(mask))),
        ("sort_word_counting 10-bit mask, descending (K1+K4)",
         lambda: u32_tensor(keys & np.uint32(m10)).view(torch.int32),
         lambda x: counting_engine.sort_word_counting(x, m10, descending=True),
         bits_of(np.uint32), lambda: np.sort(keys & np.uint32(m10))[::-1]),
        ("LSD u32 full entropy, r=8 (L1+L2; the slice's main path)",
         lambda: u32_tensor(keys), lambda x: rt.sort(x, config=lsd8),
         bits_of(np.uint32), lambda: sorted_keys),
        ("LSD u32 full entropy, r=11 (L1+L2)", lambda: u32_tensor(keys),
         lambda x: rt.sort(x, config=lsd11), bits_of(np.uint32), lambda: sorted_keys),
        ("LSD u32 value_mask=0xF0F00000, 2 of 4 passes live (L1+L2)",
         lambda: u32_tensor(keys & np.uint32(mask)),
         lambda x: rt.sort(x, config=lsd8, value_mask=mask), bits_of(np.uint32),
         lambda: np.sort(keys & np.uint32(mask))),
        ("LSD u64 full entropy, 8 passes (L1+L2)", lambda: u64_tensor(keys64),
         lambda x: rt.sort(x, config=lsd8), bits_of(np.uint64), lambda: sorted64),
        ("LSD f32 +-0 +-inf NaN (L1+L2)",
         lambda: torch.from_numpy(f32b.view(np.float32)).to(dev),
         lambda x: rt.sort(x, config=lsd8), bits_of(np.uint32),
         lambda: float_order_np(f32b, 32)),
        ("LSD u16 descending (L1+L2)",
         lambda: torch.from_numpy(u16.view(np.int16)).to(dev).view(torch.uint16),
         lambda x: rt.sort(x, config=lsd8.replace(descending=True)), bits_of(np.uint16),
         lambda: np.sort(u16)[::-1]),
        ("LSD argsort u32 with duplicates (L1+L2, stable)", lambda: u32_tensor(dups),
         lambda x: rt.argsort(x, config=lsd8), bits_of(np.uint32),
         lambda: stable_perm(dups).astype(np.uint32)),
        ("LSD sort_pairs u32 with duplicates, {i64, f32, 6-byte field} (L1+L2)",
         lambda: u32_tensor(dups), lambda x: rt.sort_pairs(x, payload_b, config=lsd8),
         lambda out: pairs_host(out) + (out[1]["name"].cpu().numpy(),),
         lambda: pairs_oracle(dups) + (names6[stable_perm(dups)],)),
        ("sort_planes_vmem 131,072 keys + index plane (K12)",
         lambda: w[:m17].clone(), lambda x: sort_planes_vmem((x, iota17), 2),
         lambda out: (gpu_bits(out[0], np.uint32), gpu_bits(out[1], np.uint32)),
         lambda: (np.sort(keys[:m17]), stable_perm(keys[:m17]).astype(np.uint32))),
        (f"sort_batched ({n_rows}, 4096) u32 rows (bench.py batched case)",
         lambda: u32_tensor(rows_u32), rt.sort_batched, bits_of(np.uint32),
         lambda: np.sort(rows_u32, axis=-1)),
        (f"argsort_batched ({n_rows}, 4096) u32 rows with duplicates",
         lambda: u32_tensor(rows_dups), rt.argsort_batched, bits_of(np.uint32),
         lambda: np.argsort(rows_dups, axis=-1, kind="stable").astype(np.uint32)),
        (f"sort_pairs_batched ({n_rows}, 4096) u32 rows with duplicates, f32 payload",
         lambda: u32_tensor(rows_dups), lambda x: rt.sort_pairs_batched(x, rows_f32_t),
         lambda out: (gpu_bits(out[0], np.uint32), out[1].cpu().numpy()),
         lambda: (np.sort(rows_dups, axis=-1), np.take_along_axis(
             rows_f32, np.argsort(rows_dups, axis=-1, kind="stable"), -1))),
        ("models.RadixSorterU32 with LSD (L1+L2)", lambda: u32_tensor(keys),
         rt.models.RadixSorterU32(lsd8), bits_of(np.uint32), lambda: sorted_keys),
        ("models.GenericRadixSorter with LSD, f32 with specials (L1+L2)",
         lambda: torch.from_numpy(f32b.view(np.float32)).to(dev),
         rt.models.GenericRadixSorter(lsd8), bits_of(np.uint32),
         lambda: float_order_np(f32b, 32)),
        ("bitmap_unique_sort u16 (K1)",
         lambda: torch.from_numpy(u16.view(np.int16)).to(dev).view(torch.uint16),
         rt.bitmap_unique_sort,
         lambda out: (gpu_bits(out[0], np.uint16), np.array([int(out[1])], np.int64)),
         bitmap_oracle),
        ("bincount length 1,000, 1% out of range (K1)",
         lambda: torch.from_numpy(counts_in).to(dev),
         lambda x: rt.bincount(x, length=1000), lambda out: out.cpu().numpy(),
         lambda: np.bincount(counts_in[counts_in < 1000], minlength=1000).astype(np.int32)),
        ("multi_digit_histogram r=8 (K1)", lambda: u32_tensor(keys).view(torch.int32),
         lambda x: multi_digit_histogram([x], 8), lambda out: out.cpu().numpy(),
         lambda: np.stack([np.bincount((keys >> np.uint32(8 * p)) & np.uint32(0xFF),
                                       minlength=256) for p in range(4)]).astype(np.int32)),
        ("group_reduce sum of i32 values, 1,024 groups (bench.py group-by case; K10)",
         lambda: u32_tensor(k1024),
         lambda x: rt.group_reduce(x, v_bench_t, reduce="sum", groups=1024, size=1024),
         grouped(np.int32),
         lambda: (groups1024, wrapped_sums(k1024, v_bench, 1024), np.array([1024]))),
        ("group_reduce mean of f32 values, 1,024 groups (K11 with counts)",
         lambda: u32_tensor(k1024),
         lambda x: rt.group_reduce(x, pay_f32_t, reduce="mean", groups=1024),
         lambda out: out, lambda: mean_check),
        ("group_reduce sum of u8 values, 65,536 groups (K10, two grid rows)",
         lambda: u32_tensor(k64k),
         lambda x: rt.group_reduce(x, v_u8_t, reduce="sum", groups=1 << 16),
         grouped(np.uint32),
         lambda: (groups64k, wrapped_sums(k64k, v_u8, 1 << 16), np.array([1 << 16]))),
        ("group_reduce sum, no groups (sort-native)", lambda: u32_tensor(k64k),
         lambda x: rt.group_reduce(x, v_bench_t, reduce="sum", size=1 << 16),
         grouped(np.int32),
         lambda: (groups64k, wrapped_sums(k64k, v_bench, 1 << 16), np.array([1 << 16]))),
        ("group_reduce min, no groups (sort-native)", lambda: u32_tensor(k64k),
         lambda x: rt.group_reduce(x, v_bench_t, reduce="min", size=1 << 16),
         grouped(np.int32), lambda: (groups64k, extreme(0), np.array([1 << 16]))),
        ("group_reduce max, no groups (sort-native)", lambda: u32_tensor(k64k),
         lambda x: rt.group_reduce(x, v_bench_t, reduce="max", size=1 << 16),
         grouped(np.int32), lambda: (groups64k, extreme(1), np.array([1 << 16]))),
        ("value_counts groups=1024 (K1)", lambda: u32_tensor(k1024),
         lambda x: rt.value_counts(x, groups=1024), grouped(np.int32),
         lambda: (groups1024, cnt1024.astype(np.int32), np.array([1024]))),
        ("value_counts, no groups (sorter)", lambda: u32_tensor(k1024),
         lambda x: rt.value_counts(x, size=1024), grouped(np.int32),
         lambda: (groups1024, cnt1024.astype(np.int32), np.array([1024]))),
        ("histogram of standard normal f32, 256 bins (K1)",
         lambda: pay_f32_t, lambda x: rt.histogram(x, bins=256),
         lambda out: out, lambda: histogram_check(False)),
        ("histogram of standard normal f32, 256 bins, weighted (K11)",
         lambda: pay_f32_t, lambda x: rt.histogram(x, bins=256, weights=hist_w_t),
         lambda out: out, lambda: histogram_check(True)),
        # the sorter composites of extras and stats
        *[(f"searchsorted u32, q={q:,} ('auto': {route}), side={side}",
           lambda qs=qs: u32_tensor(qs),
           lambda x, side=side: rt.searchsorted(sorted_t, x, side=side),
           bits_of(np.int32), searched(sorted_keys, qs, side))
          for q, qs, route in ((q_scan, qs_scan, "scan"), (q_cross, qs_cross, "sort"))
          for side in ("left", "right")],
        (f"searchsorted u64, q={q64:,} (tagged union)", lambda: u64_tensor(qs64),
         lambda x: rt.searchsorted(sorted64_t, x), bits_of(np.int32),
         searched(sorted64, qs64, "left")),
        ("searchsorted f32 +-0 +-inf NaN, q=1,000,000, side=right",
         lambda: torch.from_numpy(qf32b.view(np.float32)).to(dev),
         lambda x: rt.searchsorted(f32_sorted_t, x, side="right"), bits_of(np.int32),
         lambda: np.searchsorted(order32(f32b_sorted), order32(qf32b),
                                 side="right").astype(np.int32)),
        (f"searchsorted u32 descending, q={q_cross:,}", lambda: u32_tensor(qs_cross),
         lambda x: rt.searchsorted(sorted_desc_t, x, config=desc), bits_of(np.int32),
         searched(~sorted_keys[::-1], ~qs_cross, "left")),
        (f"searchsorted u32 with sorter=, q={q_cross:,}", lambda: u32_tensor(qs_cross),
         lambda x: rt.searchsorted(keys_t, x, sorter=sorter_t), bits_of(np.int32),
         searched(sorted_keys, qs_cross, "left")),
        ("lexsort (u8, u8, u16): one packed plane", lambda: lex8, rt.lexsort,
         bits_of(np.uint32), lambda: stable_keys().astype(np.uint32)),
        ("lexsort (u32, u32, u32): chained sorts", lambda: lex32, rt.lexsort,
         bits_of(np.uint32), lambda: stable_perm(
             (k1024.astype(np.uint64) << np.uint64(48)) | (dups.astype(np.uint64) << np.uint64(32))
             | keys.astype(np.uint64)).astype(np.uint32)),
        *[(f"segmented_sort u16 keys, 1,024 u16 segments{label}", lambda: u16_t,
           lambda x, cfg=cfg: rt.segmented_sort(x, seg16_t, config=cfg),
           lambda out: (gpu_bits(out[0], np.uint16), gpu_bits(out[1], np.uint16)),
           segmented_oracle(cfg.descending))
          for label, cfg in (("", rt.SortConfig()), (", descending", desc))],
        *[(f"segmented_argsort u16 keys, 1,024 u16 segments{label}", lambda: u16_t,
           lambda x, cfg=cfg: rt.segmented_argsort(x, seg16_t, config=cfg), bits_of(np.uint32),
           lambda d=cfg.descending: seg_perm(d).astype(np.uint32))
          for label, cfg in (("", rt.SortConfig()), (", descending", desc))],
        (f"merge_sorted of two sorted halves of {n // 2:,}", lambda: halves,
         lambda x: rt.merge_sorted(*x), bits_of(np.uint32), lambda: sorted_keys),
        ("nth_element u32 at 5 ranks", lambda: keys_t, lambda x: rt.nth_element(x, ranks),
         bits_of(np.uint32), lambda: sorted_keys[ranks]),
        ("top_k u32, k=1,000", lambda: keys_t, lambda x: rt.top_k(x, 1000),
         lambda out: (gpu_bits(out[0], np.uint32), gpu_bits(out[1], np.uint32)),
         lambda: (lambda i: (keys[i], i.astype(np.uint32)))(top_k_np(keys, 1000))),
        ("top_k f64 +-0 +-inf NaN payloads, k=1,000", lambda: f64_t,
         lambda x: rt.top_k(x, 1000),
         lambda out: (gpu_bits(out[0], np.uint64), gpu_bits(out[1], np.uint32)),
         lambda: (lambda i: (f64b[i], i.astype(np.uint32)))(top_k_np(order64(f64b), 1000))),
        (f"top_k_batched ({n_rows}, 4096) u32 rows, k=16 (bench.py batched case)",
         lambda: u32_tensor(rows_u32), lambda x: rt.top_k_batched(x, 16),
         lambda out: (gpu_bits(out[0], np.uint32), gpu_bits(out[1], np.uint32)),
         lambda: (lambda o: (np.take_along_axis(rows_u32, o, -1), o.astype(np.uint32)))(
             stable_perm(~rows_u32)[:, :16])),
        ("stable_partition by u32 & 1, f32 payload", lambda: pred_t,
         lambda x: rt.stable_partition(x, pay_f32_t),
         lambda out: (out[0].cpu().numpy(), np.array([int(out[1])])),
         lambda: (pay_f32[stable_perm((keys & np.uint32(1)).astype(bool))],
                  np.array([int(np.count_nonzero((keys & np.uint32(1)) == 0))]))),
        *[(f"rankdata u32 with duplicates, '{method}'", lambda: u32_tensor(dups),
           lambda x, method=method: rt.rankdata(x, method=method),
           lambda out: out.cpu().numpy(), lambda method=method: rank_oracle(method))
          for method in ("average", "dense")],
        ("quantile f32 at 5 probabilities", lambda: pay_f32_t, lambda x: rt.quantile(x, qs5),
         lambda out: out, lambda: quantile_oracle(pay_f32)),
        ("quantile u16 at 5 probabilities (K2+K8)", lambda: u16_t,
         lambda x: rt.quantile(x, qs5), lambda out: out, lambda: quantile_oracle(u16)),
        ("partition u32", lambda: keys_t, lambda x: rt.partition(x, n // 2),
         bits_of(np.uint32), lambda: sorted_keys),
        ("argpartition u32", lambda: keys_t, lambda x: rt.argpartition(x, [7, n // 2]),
         bits_of(np.uint32), lambda: stable_keys().astype(np.uint32)),
        ("digitize f32 against 1,001 increasing edges", lambda: pay_f32_t,
         lambda x: rt.digitize(x, edges_t), lambda out: out.cpu().numpy().astype(np.int64),
         lambda: np.digitize(pay_f32, edges32)),
        ("digitize f32 against 1,001 decreasing edges, right=True", lambda: pay_f32_t,
         lambda x: rt.digitize(x, edges_t.flip(0), right=True),
         lambda out: out.cpu().numpy().astype(np.int64),
         lambda: np.digitize(pay_f32, edges32[::-1], right=True)),
        ("histogram f32 with 1,001 edges (K1)", lambda: pay_f32_t,
         lambda x: rt.histogram(x, bins=edges64), lambda out: out,
         lambda: histogram_edges_check(False)),
        ("histogram f32 with 1,001 edges, weighted (K11)", lambda: pay_f32_t,
         lambda x: rt.histogram(x, bins=edges64, weights=hist_w_t), lambda out: out,
         lambda: histogram_edges_check(True)),
        (f"sort_complex of {z128.size:,} complex128 (numpy)", lambda: z128,
         lambda x: rt.sort_complex(x, device=dev), lambda out: out,
         lambda: np.sort_complex(z128)),
        # the sets slice
        ("unique u32 full entropy (sorter)", lambda: keys_t, rt.unique,
         fields("values", "num_unique"), lambda: keys_unique()[::4]),
        ("unique u32 full entropy, return_counts=True", lambda: keys_t,
         lambda x: rt.unique(x, return_counts=True), fields("values", "counts", "num_unique"),
         lambda: tuple(keys_unique()[i] for i in (0, 3, 4))),
        ("unique_all u32 full entropy", lambda: keys_t, rt.unique_all,
         fields("values", "indices", "inverse_indices", "counts", "num_unique"), keys_unique),
        ("unique u16, return_counts=True (K2+K8)", lambda: u16_t,
         lambda x: rt.unique(x, return_counts=True),
         fields("values", "counts", "num_unique", dtype=np.uint16), u16_counts),
        ("unique_inverse u64 (numpy)", lambda: keys64,
         lambda x: rt.unique_inverse(x, device=dev),
         fields("values", "inverse_indices", "num_unique"), u64_inverse),
        *[(f"unique f32 +-0 +-inf NaN payloads, return_counts=True, equal_nan={eq}",
           lambda: torch.from_numpy(f32b.view(np.float32)).to(dev),
           lambda x, eq=eq: rt.unique(x, return_counts=True, equal_nan=eq),
           fields("values", "counts", "num_unique"), f32_counts(eq))
          for eq in (False, True)],
        ("unique u32 full entropy, descending", lambda: keys_t,
         lambda x: rt.unique(x, config=desc), fields("values", "num_unique"),
         lambda: (padded(keys_unique()[0][: int(keys_unique()[4][0])][::-1], n, 0),
                  keys_unique()[4])),
        (f"unique(axis=0, every flag) of ({n // 4}, 4) int32 rows in [0, 8)",
         lambda: torch.from_numpy(rows8).to(dev),
         lambda x: rt.unique(x, axis=0, return_index=True, return_inverse=True,
                             return_counts=True),
         lambda out: (out.values.cpu().numpy(), gpu_bits(out.index, np.uint32),
                      out.inverse.cpu().numpy(), out.counts.cpu().numpy(),
                      np.array([int(out.num_unique)])), rows_oracle),
        *[(f"{op} of two {half:,} u32 arrays sharing about half their values", lambda: set_a_t,
           lambda x, op=op: getattr(rt, op)(x, set_b_t), set_values(), set_oracle(op))
          for op in sets_ops],
        (f"intersect1d(return_indices=True) of the two {half:,} u32 arrays", lambda: set_a_t,
         lambda x: rt.intersect1d(x, set_b_t, return_indices=True), set_values(),
         intersect_indices(set_a, set_b, 0xFFFFFFFF)),
        (f"intersect1d(return_indices=True) of two {half:,} u64 arrays (numpy)",
         lambda: set_a64, lambda x: rt.intersect1d(x, set_b64, return_indices=True, device=dev),
         set_values(np.uint64), intersect_indices(set_a64, set_b64, np.uint64(2**64 - 1))),
        *[(f"{label} of the n u32 keys against {n // 4:,} tests, half of them keys",
           lambda: keys_t, lambda x, f=f: f(x, tests_t),
           lambda out: out.cpu().numpy(), lambda inv=inv: ~isin_np() if inv else isin_np())
          for label, f, inv in (("isin", rt.isin, False),
                                ("isin(invert=True)", lambda x, t: rt.isin(x, t, invert=True), True),
                                ("in1d", rt.in1d, False))],
    ]
    sets_cases = {name for name, *_ in cases[next(i for i, c in enumerate(cases)
                                                  if c[0].startswith("unique u32")):]}
    # outputs that are not the keys reordered: from bitmap_unique_sort on
    first_other = next(i for i, c in enumerate(cases) if c[0].startswith("bitmap"))
    other_shape = {name for name, *_ in cases[first_other:]}
    inputs = [(name, make(), run, host, oracle)
              for name, make, run, host, oracle in cases]
    torch.cuda.synchronize()
    rt.reset_launch_counts()
    # torch.sort sorts what K0 does not (two or more planes, short planes,
    # the batched sorts): count its calls in each case and in all (restored
    # after phase 4)
    real_sort, sort_calls = torch.sort, [0]

    def counted_sort(*a, **k):
        sort_calls[0] += 1
        return real_sort(*a, **k)
    torch.sort = counted_sort
    # the sets slice must not call torch.cummax (one block for a 1-D tensor:
    # 110.8 ms at 40M, PERF.md run BX): count its calls in each case
    real_cummax, cummax_calls = (torch.cummax, torch.Tensor.cummax), [0]

    def counted_cummax(*a, **k):
        cummax_calls[0] += 1
        return real_cummax[0](*a, **k)

    def counted_cummax_method(self, *a, **k):
        cummax_calls[0] += 1
        return real_cummax[1](self, *a, **k)
    torch.cummax, torch.Tensor.cummax = counted_cummax, counted_cummax_method
    outputs, case_launches, case_sorts = [], [], []
    for name, x, run, _, _ in inputs:
        before, cummax_before, sorts_before = rt.launch_counts(), cummax_calls[0], sort_calls[0]
        outputs.append(run(x))
        case_launches.append({k: c - before[k] for k, c in rt.launch_counts().items()
                              if c != before[k]})
        case_sorts.append(sort_calls[0] - sorts_before)
        if name in sets_cases and cummax_calls[0] != cummax_before:
            fail(f"{name}: torch.cummax was called")
    torch.cummax, torch.Tensor.cummax = real_cummax
    # the measurement entry points: the CLI, the oracles on the card's
    # outputs, the probe script's E1 and the MSD pipeline's E2
    def entry(run):
        """run()'s result and the launches it made."""
        before = rt.launch_counts()
        result = run()
        counts = {k: c - before[k] for k, c in rt.launch_counts().items() if c != before[k]}
        return result, counts

    for argv in (["40000000", "u32"], ["40000000", "u32", "0xF0F00000"],
                 ["20000000", "u64", "0x0000F0F000000000"], ["40000000", "f32"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, counts = entry(lambda: cli.main(argv))
        lines = buf.getvalue().strip().splitlines()
        rec = json.loads(lines[-1])
        if rc != 0 or rec["verified"] is not True:
            fail(f"cli {' '.join(argv)}: exit {rc}, {lines}")
        print(f"[4 entry] cli {' '.join(argv)}: {' | '.join(lines)}; launches {counts}",
              flush=True)
    by_name = {name: out for (name, *_), out in zip(inputs, outputs)}
    dups_t = u32_tensor(dups)
    perm = by_name["argsort u32 with duplicates"]
    lsd_perm = by_name["LSD argsort u32 with duplicates (L1+L2, stable)"]
    swapped = perm.view(torch.int32).clone()
    swapped[[0, 1]] = swapped[[1, 0]]
    doubled = perm.view(torch.int32).clone()
    doubled[1] = doubled[0]
    oracle_checks = (
        ("is_sorted(sort)", lambda: verify.is_sorted(by_name["u32 full entropy (sorter)"]), True),
        ("same_multiset(sort, keys)",
         lambda: verify.same_multiset(by_name["u32 full entropy (sorter)"], keys), True),
        ("is_sorted(keys)", lambda: verify.is_sorted(u32_tensor(keys)), False),
        ("is_permutation(argsort)", lambda: verify.is_permutation(perm), True),
        ("is_permutation(one index twice)", lambda: verify.is_permutation(doubled), False),
        ("rank_is_stable_sort(argsort)", lambda: verify.rank_is_stable_sort(dups_t, perm), True),
        ("rank_is_stable_sort(LSD argsort)",
         lambda: verify.rank_is_stable_sort(dups_t, lsd_perm), True),
        ("rank_is_stable_sort(two indices swapped)",
         lambda: verify.rank_is_stable_sort(dups_t, swapped), False))
    for label, check, want in oracle_checks:
        if check() is not want:
            fail(f"utils.verify {label}: not {want}")
    print(f"[4 entry] utils.verify on the card: " + ", ".join(
        f"{label} {want}" for label, _, want in oracle_checks), flush=True)
    gbps, counts = entry(lambda: exp_sol_probe.probe_dma(dev))
    print(f"[4 entry] exp_sol_probe.probe_dma (E1) 2^24 keys: {gbps:.1f} GB/s; "
          f"launches {counts}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, counts = entry(lambda: exp_sol_round2.check_msd(keys[:n_msd], dev))
    print(f"[4 entry] exp_sol_round2.check_msd (E2) {n_msd} keys: "
          f"{buf.getvalue().strip()}; equal to np.sort; launches {counts}", flush=True)
    # the distributed tier: four ranks on cuda:0, the main path at n keys
    mesh4 = make_sort_mesh(devices=[dev] * 4)
    dryrun_multichip(mesh4, n=n, seed=args.seed,
                     log=lambda line: print(f"[4 dist] {line} (one card: its D ranks share it)",
                                            flush=True))
    torch.cuda.synchronize()
    launches = rt.launch_counts()
    torch.sort = real_sort
    # column skipping shows in the LSD cases' passes: one L1 and one L2 each
    lsd_passes = {"LSD u32 full entropy, r=8": 4, "LSD u32 full entropy, r=11": 3,
                  "LSD u32 value_mask=0xF0F00000": 2, "LSD u64 full entropy": 8}
    for (name, *_), counts in zip(inputs, case_launches):
        for prefix, want in lsd_passes.items():
            if name.startswith(prefix) and not (
                    counts.get("lsd_hist") == counts.get("lsd_scatter") == want):
                fail(f"{name}: launches {counts}, {want} passes expected")
        # the live digits: one live_digits launch over every plane on the LSD path
        if name.startswith("LSD u") and "value_mask" not in name and \
                (counts.get("live_digits") != 1 or "hist_multi" in counts):
            fail(f"{name}: launches {counts}, one live_digits launch expected")
    # the headline runs K0: the live digits, the guard's flag and the starts
    # from one K1 read, one sweep a live digit (no L1, no L2), no torch.sort
    k0_want = {"u32 full entropy (sorter)": {"live_digits": 1, "k0_sweep": 4, "lsd_sort": 1}}
    if n >= hw_engine.K0_TWO_PLANE_MIN_KEYS:     # two planes: K0 from its own gate
        k0_want.update({name: {"live_digits": 1, "k0_sweep": 8, "lsd_sort": 1}
                        for name in ("u64 full entropy (sorter)", "i64 (sorter)",
                                     "f64 +-0 +-inf NaN payloads (sorter)")})
    for (name, *_), counts, sorts in zip(inputs, case_launches, case_sorts):
        if name in k0_want and (sorts or counts != k0_want[name]):
            fail(f"{name}: launches {counts} and {sorts} torch.sort calls; K0 alone, "
                 f"{k0_want[name]}, expected")
    for (name, x, run, host, oracle), out, counts, sorts in zip(inputs, outputs, case_launches,
                                                                 case_sorts):
        size = case_size(x)
        first = out[0] if isinstance(out, tuple) else out
        if torch.is_tensor(x) and (first.device != x.device or (
                name not in other_shape and first.shape != x.shape)):
            fail(f"{name}: got {first.dtype} {first.device} {tuple(first.shape)}")
        if run is rt.sort and first.dtype != x.dtype:
            fail(f"{name}: got dtype {first.dtype}, keys are {x.dtype}")
        got, want = host(out), oracle()
        if callable(want):           # float results: a check to the bound
            bad = want(got)
            if bad:
                fail(f"{name}: {bad}")
            print(f"[4 sort] {name}: n={size} within the bound of the numpy oracle; "
                  f"launches {counts}; torch.sort calls {sorts}", flush=True)
            continue
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, wv in zip(got, want):
            if g.dtype != wv.dtype and g.dtype.itemsize == wv.dtype.itemsize:
                wv = wv.view(g.dtype)
            if not np.array_equal(g, wv):
                bad = int(np.flatnonzero(g != wv)[0])
                fail(f"{name}: differs from the numpy oracle first at {bad}")
        print(f"[4 sort] {name}: n={size} equal to the numpy oracle; launches {counts}; "
              f"torch.sort calls {sorts}", flush=True)

    # -- phase 5: the main path went through every kernel -------------------
    print(f"[5 launches] {json.dumps(launches)}; torch.sort calls {sort_calls[0]} (three "
          f"or more planes, fewer than {hw_engine.LSD_MIN_KEYS} keys of one plane or "
          f"{hw_engine.K0_TWO_PLANE_MIN_KEYS} of two, the batched sorts)", flush=True)
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched by the main path")

    # -- phase 6: times ----------------------------------------------------
    reps = 10
    for name, x, run, _, _ in inputs:
        ms = time_ms(lambda: run(x), reps)
        m = case_size(x)
        print(f"[6 time] {name}: {ms:.3f} ms, {m / ms / 1e3:.1f} Mkeys/s",
              flush=True)
    for label, t in (("int32", w), ("int64", keys64_t)):
        ms = time_ms(lambda: torch.sort(t), reps)
        print(f"[6 time] torch.sort {label} (reference point): {ms:.3f} ms, "
              f"{n / ms / 1e3:.1f} Mkeys/s", flush=True)

    # the sorter composites beside one torch call of the same function, in
    # turns; searchsorted by both methods around its TPU gate 32 * q = n
    def in_turns(fns):
        got = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            got[k].append(time_ms(fns[k], reps))
        return {k: sum(v) / len(v) for k, v in got.items()}

    def slice_line(name, fns):
        ms = in_turns(fns)
        print(f"[6 slice] {name}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()),
              flush=True)

    def flip32(t):
        return t.view(torch.int32) ^ i32(1 << 31)

    key_sorted = flip32(sorted_t)
    qs_big = u32_tensor(hits(keys, min(16 * q_cross, n), rand32))
    for q in sorted({q_scan, q_cross // 4, q_cross, 4 * q_cross, 16 * q_cross}):
        qt = qs_big[:q]
        kq = flip32(qt)
        slice_line(f"searchsorted u32 n={n} q={q} (32q/n = {32 * q / n:.2f}; 'auto' takes "
                   f"{'sort' if 32 * q >= n else 'scan'})",
                   {"method='scan'": lambda: rt.searchsorted(sorted_t, qt, method="scan"),
                    "method='sort'": lambda: rt.searchsorted(sorted_t, qt, method="sort"),
                    "torch.searchsorted int32": lambda: torch.searchsorted(
                        key_sorted, kq, out_int32=True)})
    key64_sorted = sorted64_t.view(torch.int64) ^ (-(1 << 63))
    q64_t = u64_tensor(qs64)
    kq64 = q64_t.view(torch.int64) ^ (-(1 << 63))
    slice_line(f"searchsorted u64 n={n} q={q64} (tagged union)",
               {"searchsorted": lambda: rt.searchsorted(sorted64_t, q64_t),
                "torch.searchsorted int64": lambda: torch.searchsorted(
                    key64_sorted, kq64, out_int32=True)})
    kt32 = flip32(keys_t)
    slice_line("top_k u32 k=1000", {"top_k": lambda: rt.top_k(keys_t, 1000),
                                    "torch.topk int32": lambda: torch.topk(kt32, 1000)})
    slice_line("top_k f64 k=1000", {"top_k": lambda: rt.top_k(f64_t, 1000),
                                    "torch.topk float64": lambda: torch.topk(f64_t, 1000)})
    rows_t = u32_tensor(rows_u32)
    rows_t32 = flip32(rows_t)
    slice_line(f"top_k_batched ({n_rows}, 4096) u32 k=16",
               {"top_k_batched": lambda: rt.top_k_batched(rows_t, 16),
                "torch.topk(dim=-1) int32": lambda: torch.topk(rows_t32, 16, dim=-1)})
    slice_line("lexsort (u8, u8, u16), one packed plane",
               {"lexsort": lambda: rt.lexsort(lex8),
                "torch.sort(stable=True) int32": lambda: torch.sort(kt32, stable=True)})
    dups_t32 = u32_tensor(dups)
    kd32 = flip32(dups_t32)
    slice_line("rankdata u32 with duplicates 'average'",
               {"rankdata": lambda: rt.rankdata(dups_t32),
                "torch.sort(stable=True) int32 (its argsort)": lambda: torch.sort(
                    kd32, stable=True),
                "torch.cummax int32 (not called: the JAX package's lax.cummax)":
                    lambda: torch.cummax(kd32, 0)})
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
    rows8_t = torch.from_numpy(rows8).to(dev)
    slice_line(f"unique(axis=0, every flag) of ({n // 4}, 4) int32 rows", {
        "unique": lambda: rt.unique(rows8_t, axis=0, return_index=True, return_inverse=True,
                                    return_counts=True),
        "torch.unique(dim=0, return_inverse=True, return_counts=True) (no index)":
            lambda: torch.unique(rows8_t, dim=0, return_inverse=True, return_counts=True)})
    tests32 = flip32(tests_t)
    slice_line(f"isin of the n u32 keys against {n // 4:,} tests", {
        "isin": lambda: rt.isin(keys_t, tests_t),
        "torch.isin int32": lambda: torch.isin(kt32, tests32)})
    set_a32, set_b32 = flip32(set_a_t), flip32(set_b_t)
    slice_line(f"union1d of two {half:,} u32 arrays", {
        "union1d": lambda: rt.union1d(set_a_t, set_b_t),
        "torch.unique(torch.cat) int32": lambda: torch.unique(torch.cat([set_a32, set_b32]))})
    del qs_big, rows_t, rows_t32, kt32, kd32, rows8_t, tests32, set_a32, set_b32

    def turns3(kernel, plain, library=None):
        """Kernel, plain version and library call in turns (plain, library,
        kernel, kernel, library, plain); the library's ms is None without one."""
        p1, l1, k1, k2, l2, p2 = (time_ms(f, reps) if f else None for f in
                                  (plain, library, kernel, kernel, library, plain))
        return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2 if library else None

    shapes = {name: [] for name in ck.LAUNCHES}

    def row(name, bins, nbytes, kernel, plain, library=None, ops=0, **extra):
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
    # K1's live-digit read with the guard's flag, one plane and two, beside
    # what it replaces: one hist_multi a plane and the guard's torch passes
    for planes in ((w,), (hi64, lo64)):
        total = len(planes) * 4 * 256
        kernel = lambda: ck.live_digits(planes, 8)
        row("live_digits", 256, n * 4 * len(planes) + total * 4 + 4,
            kernel, lambda: ck.live_digits_plain(planes, 8),
            lambda: ([ck.hist_multi(p, 8) for p in planes], probes.is_sorted_words(planes)),
            planes=len(planes), shape=hist_label(total), device_ms=device_trace(kernel)[1])
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
    for k, bits, drop, with_counts in whist_f32_inputs:
        bins, per_bin = 1 << bits, 8 if with_counts else 4
        idx = torch.where((k.long() & 0xFFFFFFFF) < drop, k.long() & 0xFFFFFFFF, bins)
        shape = ck.whist_shape(bits, "f32", with_counts)
        row("whist_f32_counts" if with_counts else "whist_f32", bins, n * 8 + bins * per_bin,
            lambda: ck.whist_f32(k, weights, bits, drop, with_counts),
            lambda: ck.whist_f32_plain(k, weights, bits, drop, with_counts),
            lambda: torch.zeros(bins + 1, dtype=torch.float32,
                                device=dev).index_add_(0, idx, weights),
            shape=shape.label(), reads=shape.ranges)
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
    del sweep_status
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
                                                     "tile", "planes", "capr", "ranks",
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
    xf = u32_tensor(keys)
    d1, p1, p2, d2 = (time_ms(f, reps) for f in (
        lambda: rt.sort(xf), lambda: rt.sort(xf, config=probe),
        lambda: rt.sort(xf, config=probe), lambda: rt.sort(xf)))
    default_ms, probe_ms = (d1 + d2) / 2, (p1 + p2) / 2
    print(f"[6 time] device_probe cost on full-entropy u32: default {default_ms:.3f} ms, "
          f"device_probe {probe_ms:.3f} ms ({100 * (probe_ms / default_ms - 1):+.1f}%)",
          flush=True)

    # the LSD sort against torch.sort of the same int32 keys and the AUTO
    # sort, in turns; bound: 12 bytes a key for each live pass
    # (and at r = 8 without the live-digit read, skip_trivial_digits=False:
    # the passes alone)
    turns = {"AUTO": lambda: rt.sort(xf), "LSD r=8": lambda: rt.sort(xf, config=lsd8),
             "LSD r=8 passes alone": lambda: rt.sort(
                 xf, config=lsd8.replace(skip_trivial_digits=False)),
             "LSD r=11": lambda: rt.sort(xf, config=lsd11),
             "torch.sort int32": lambda: torch.sort(w)}
    got_ms = {k: [] for k in turns}
    for k in list(turns) + list(turns)[::-1]:
        got_ms[k].append(time_ms(turns[k], reps))
    mean = {k: sum(v) / len(v) for k, v in got_ms.items()}
    print(f"[6 time] LSD sort of u32, in turns: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in mean.items())
        + f"; bound r=8 {bound_ms(4 * 12 * n):.3f} ms (4 passes x 12 B/key), "
        f"r=11 {bound_ms(3 * 12 * n):.3f} ms (3 passes)", flush=True)
    # K0 through the public entry points beside torch.sort of the same signed
    # key, in turns: the AUTO sort, argsort, sort_pairs with a 4-byte payload
    # (beside torch.sort(stable=True) and a gather); the LSD sort of u64 beside
    # the AUTO sort (two planes: K0 from K0_TWO_PLANE_MIN_KEYS keys)
    x64 = u64_tensor(keys64)
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
    e1, c1, c2, e2 = (time_ms(f, reps) for f in (
        lambda: ck.dma_copy(w), lambda: out_buf.copy_(w),
        lambda: out_buf.copy_(w), lambda: ck.dma_copy(w)))
    e1_ms, copy_ms = (e1 + e2) / 2, (c1 + c2) / 2
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
    x40 = u32_tensor(keys)
    dist_turns = {"xla": lambda: distributed_sort(x40, mesh4, exchange="xla"),
                  "rdma": lambda: distributed_sort(x40, mesh4, exchange="rdma"),
                  "torch.sort int32": lambda: torch.sort(w)}
    dist_ms = {k: [] for k in dist_turns}
    for k in list(dist_turns) + list(dist_turns)[::-1]:
        dist_ms[k].append(time_ms(dist_turns[k], 3))
    print(f"[6 time] distributed_sort balanced of {n} u32 on 4 ranks of cuda:0 (one card, "
          f"4 ranks share it; nothing of NVLink), in turns: " + ", ".join(
              f"{k} {sum(v) / len(v):.3f} ms" for k, v in dist_ms.items()), flush=True)
    rows_t = u32_tensor(rows_u32).view(torch.int32)
    ms = time_ms(lambda: torch.sort(rows_t, dim=-1), reps)
    print(f"[6 time] torch.sort(dim=-1) of ({n_rows}, 4096) int32 (reference point): "
          f"{ms:.3f} ms; bound {bound_ms(n_rows * 4096 * 8):.3f} ms", flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        calls = 3
        for name, x, run, _, _ in inputs:
            if not name.startswith(PROFILED):
                continue
            run(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    run(x)
                torch.cuda.synchronize()
            # device-side events only (kernels, copies, memsets): an aten op's
            # own row repeats the time of the kernels it launched
            rows = sorted((e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA),
                          key=lambda e: -e.self_device_time_total)
            total = sum(e.self_device_time_total for e in rows) / calls / 1e3
            print(f"[7 profile] {name}: device {total:.3f} ms per call; " + "; ".join(
                f"{kernel_label(e.key)} {e.self_device_time_total / calls / 1e3:.4f} ms "
                f"x{e.count // calls}" for e in rows[:8]), flush=True)
        for exchange in ("xla", "rdma"):
            run = dist_turns[exchange]
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    run()
                torch.cuda.synchronize()
            rows = sorted((e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA),
                          key=lambda e: -e.self_device_time_total)
            total = sum(e.self_device_time_total for e in rows) / calls / 1e3
            print(f"[7 profile] distributed_sort 4 ranks on cuda:0 exchange={exchange}: "
                  f"device {total:.3f} ms per call; " + "; ".join(
                      f"{kernel_label(e.key)} {e.self_device_time_total / calls / 1e3:.4f} ms "
                      f"x{e.count // calls}" for e in rows[:10]), flush=True)

    # -- phase 8: the group mesh, one process a rank group -----------------
    del x40
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mp_launches, mp_err = multiprocess_phase(
        n, sum(dist_ms["rdma"]) / len(dist_ms["rdma"]), shapes["rdma_exchange"][0]["ms"])
    for name, count in mp_launches.items():
        launches[name] += count
    errs["rdma_exchange"] = max(errs["rdma_exchange"], mp_err)

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
