"""One process of a group mesh: the distributed surface across real processes.

The counterpart of the repository's ``scripts/mp_worker.py``, which runs the
JAX package's distributed surface across processes with
``jax.distributed``. Here each process joins a ``torch.distributed`` group
(:mod:`..utils.mpharness`: gloo on the CPU, NCCL between cards), builds the
same seeded global input as every other process, passes its own slice to
the entry points on a group mesh (:mod:`..parallel._mesh`), and checks each
result against numpy, reading only its own ranks' shards or replicated
values (the counts, gathered over the group, locate its shards in the
global order). What single-controller code cannot show shows here: a read
of another process's shard, a host copy of a global array, a local length
taken for the global one.

    python -m radix_sorting_tpu_torch.scripts.mp_worker <pid> <nproc> <port> \\
        [--backend gloo|nccl] [--device cpu|cuda] [--exchange xla|rdma] \\
        [--n N] [--main-n M] [--out F.npz]

``RST_MP_LOCAL_DEVICES`` (default 4) is the number of ranks a process
drives: on ``--device cuda`` all on the process's card, ``cuda:{pid % cards}``.
A worker on the card loads the kernels that a parent built
(``ops._build.require_built``); it never builds them itself. ``--main-n M``
adds the main path at M keys, the balanced ``distributed_sort`` of u32, timed,
and on the card K13 across the processes at rows of M / D^2 u32. ``--out``
writes this process's outputs by name, the kernel launches and the times
(``stats``, JSON: ``main_launches`` counts the main path's checked call,
``launches`` everything after the main path). Prints ``MP_OK <pid>``; exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..parallel.shuffle import _host   # shards or a tensor as one numpy array

SEED = 0xD15C0
REPS = 3              # timed calls of the main path and of K13
TIMEOUT_S = 60.0      # the rendezvous and each collective


def wire_note(mesh) -> str:
    """How the mesh's collectives travel, for a log line."""
    import torch.distributed as dist
    backend = dist.get_backend(mesh.group)
    host = (" (CUDA control tensors through host copies)"
            if backend == "gloo" and mesh.devices[0].type == "cuda" else "")
    return f"{backend}, {mesh.num_processes} processes x {len(mesh.devices)} ranks{host}"


def slice_of(mesh, a: np.ndarray) -> np.ndarray:
    """This process's slice of a global array: equal slices in process
    order (all of it without a group)."""
    s = len(a) // mesh.num_processes
    return a[mesh.process_index * s: (mesh.process_index + 1) * s]


def global_counts(mesh, counts) -> np.ndarray:
    """Every rank's count, in global rank order: a replicated read (one
    all_gather over the group)."""
    from ..parallel import _mesh
    return _host(_mesh.all_gather(list(counts), mesh, tiled=True)[0]).astype(np.int64)


def shards_hold(mesh, shards, counts, want: np.ndarray) -> bool:
    """This process's shards hold their part of ``want``, the whole sorted
    sequence: rank g's first counts[g] rows are ``want`` from the sum of the
    counts before g."""
    c = global_counts(mesh, counts)
    if c.sum() != len(want):
        return False
    starts = np.concatenate([[0], np.cumsum(c)])
    return all(np.array_equal(_host(sh)[: c[g]], want[starts[g]: starts[g + 1]])
               for sh, g in zip(shards, mesh.ranks))


def inputs(n: int) -> Dict[str, np.ndarray]:
    """The global inputs of :func:`surfaces`, the same on every process:
    full-entropy u32 keys ``x``, half of them one value (``skew``), 5,000
    values (``small``), and group keys and values made from those."""
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    skew = np.concatenate([np.full(n // 2, 0x0000BEEF, np.uint32),
                           rng.integers(0, 1 << 32, size=n - n // 2, dtype=np.uint32)])
    rng.shuffle(skew)
    small = rng.integers(0, 5000, size=n, dtype=np.uint32)
    return {"x": x, "skew": skew, "small": small, "gk": (small % 97).astype(np.uint32),
            "gv": (small >> 5).astype(np.int32)}


def surfaces(mesh, n: int, exchange: str, log: Callable[[str], None] = print
             ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """The nine surfaces of the JAX worker on ``mesh`` at ``n`` keys, each
    process passing its slice. Returns this process's outputs by name (its
    shards concatenated; replicated values as they are) and the names of the
    checks that failed."""
    from .. import parallel as tpar

    inp = inputs(n)
    x, skew, small, gk, gv = (inp[k] for k in ("x", "skew", "small", "gk", "gv"))
    out: Dict[str, np.ndarray] = {}
    failures: List[str] = []

    def check(name, ok):
        log(f"{name}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)

    def keep(name, **parts):
        for k, v in parts.items():
            out[f"{name}.{k}"] = _host(v)

    oracle = np.sort(x)
    xl = slice_of(mesh, x)

    # 1) balanced sort, without and with overlap
    for overlap in (False, True):
        sp, counts, ovf = tpar.distributed_sort_balanced_u32(xl, mesh, overlap=overlap,
                                                             exchange=exchange)
        keep(f"balanced overlap={overlap}", keys=sp, counts=counts, overflow=ovf)
        check(f"balanced overlap={overlap}",
              shards_hold(mesh, sp, counts, oracle) and not _host(ovf).any())

    # 2) sharded consumption: each process reads only its own ranks' shards;
    #    the counts are static, so rank g holds global ranks [g * cap, ...)
    sp, counts, _ = tpar.distributed_sort_balanced_u32(xl, mesh, exchange=exchange)
    cap = int(sp[0].shape[0])
    ok = len(sp) == len(mesh.devices)
    for sh, c, g in zip(sp, counts, mesh.ranks):
        c = int(c[0])
        ok = ok and np.array_equal(_host(sh)[:c], oracle[g * cap: g * cap + c])
    check("addressable-shard consumption", ok)

    # 3) the shuffle, uniform (gathered over the group) and skewed with exact=True
    sp, counts, ovf = tpar.distributed_sort_u32(xl, mesh, exchange=exchange)
    keep("shuffle uniform", keys=sp, counts=counts, overflow=ovf)
    check("shuffle uniform",
          np.array_equal(tpar.gather_sorted(sp, counts, ovf, mesh=mesh), oracle))
    sp, counts, ovf = tpar.distributed_sort_u32(slice_of(mesh, skew), mesh, exact=True,
                                                exchange=exchange)
    keep("shuffle skewed exact", keys=sp, counts=counts, overflow=ovf)
    check("shuffle skewed exact", shards_hold(mesh, sp, counts, np.sort(skew)))

    # 4) balanced argsort: the stable global permutation
    sk, perm, counts, _ = tpar.distributed_argsort_balanced_u32(xl, mesh, exchange=exchange)
    keep("balanced argsort", keys=sk, perm=perm, counts=counts)
    check("balanced argsort", shards_hold(mesh, perm, counts,
                                          np.argsort(x, kind="stable").astype(np.uint32)))

    # 5) exact selection: a replicated result, no exchange
    ranks = [0, 1, n // 2, n - 1]
    sel = _host(tpar.distributed_select(xl, ranks, mesh))
    out["select"] = sel
    check("select", np.array_equal(sel, oracle[ranks]))

    # 6) uniques
    sl = slice_of(mesh, small)
    vals, counts, _ = tpar.distributed_unique_sorted(sl, mesh, exchange=exchange)
    keep("unique_sorted", values=vals, counts=counts)
    check("unique_sorted", shards_hold(mesh, vals, counts, np.unique(small)))

    # 7) group-by: edge summaries gathered across processes and the carry
    #    scan (sort-backed), and the dense tier (K10 on the card)
    uq, inv = np.unique(gk, return_inverse=True)
    want = np.zeros(len(uq), np.int64)
    np.add.at(want, inv, gv.astype(np.int64))
    for groups in (None, 97):
        uk, red, counts, _ = tpar.distributed_group_reduce(
            slice_of(mesh, gk), slice_of(mesh, gv), mesh, reduce="sum", groups=groups,
            exchange=exchange)
        name = f"group_reduce groups={groups}"
        keep(name, keys=uk, sums=red, counts=counts)
        check(name, shards_hold(mesh, uk, counts, uq)
              and shards_hold(mesh, red, counts, want.astype(np.int32)))

    # 8) quantiles (selection sums across processes) and the dense bincount
    #    (local histograms, K1 on the card, and one sum over the group)
    qv = _host(tpar.distributed_quantile(xl, [0.25, 0.75], mesh, method="lower"))
    bc = _host(tpar.distributed_bincount(sl, mesh, 5000))
    out["quantile"], out["bincount"] = qv, bc
    check("quantile+bincount",
          np.array_equal(qv, np.quantile(x, [0.25, 0.75], method="lower").astype(np.uint32))
          and np.array_equal(bc, np.bincount(small, minlength=5000)))

    # 9) top-k: the local candidates gathered across processes
    tv, ti = tpar.distributed_top_k(xl, 32, mesh)
    order = np.argsort(-x.astype(np.int64), kind="stable")[:32]
    out["top_k.values"], out["top_k.indices"] = _host(tv), _host(ti)
    check("top_k", np.array_equal(_host(tv), x[order])
          and np.array_equal(_host(ti), order.astype(np.uint32)))
    return out, failures


def rest_of_surface(mesh, n: int, exchange: str) -> Dict[str, np.ndarray]:
    """Every other public function of ``parallel/`` once on ``mesh`` at ``n``
    keys, each process passing its slice: the dtype-generic sorts either
    method (f32 descending, i32 with ties, a payload tree), the shuffle's
    rank and record sorts, the balanced record sort, the median, the global
    histograms, the sort-backed group-by's other reductions and the dense
    count, and ``rdma_all_to_all`` itself. Returns this process's outputs
    by name, for comparison with the single-controller form's (a
    replicated output has the single-controller shape, a sharded one this
    process's part of it)."""
    import torch
    from .. import parallel as tpar

    r = np.random.default_rng(SEED + 3)
    f = r.standard_normal(n).astype(np.float32)
    ties = r.integers(-50, 50, size=n).astype(np.int32)
    u = r.integers(0, 1 << 32, size=n, dtype=np.uint32)
    g = r.integers(0, 97, size=n).astype(np.uint32)
    tree = {"tag": np.arange(n, dtype=np.uint32), "val": f}
    fl, tl, ul, gl = (slice_of(mesh, a) for a in (f, ties, u, g))
    treel = {k: slice_of(mesh, v) for k, v in tree.items()}
    runs = {
        "sort f32 descending": lambda: tpar.distributed_sort(fl, mesh, descending=True,
                                                             exchange=exchange),
        "sort f32 shuffle": lambda: tpar.distributed_sort(fl, mesh, method="shuffle",
                                                          exchange=exchange),
        "argsort i32": lambda: tpar.distributed_argsort(tl, mesh, exchange=exchange),
        "argsort i32 shuffle": lambda: tpar.distributed_argsort(
            tl, mesh, method="shuffle", exact=True, exchange=exchange),
        "argsort_u32 shuffle": lambda: tpar.distributed_argsort_u32(ul, mesh,
                                                                   exchange=exchange),
        "sort_pairs f32 tree": lambda: tpar.distributed_sort_pairs(fl, treel, mesh,
                                                                   exchange=exchange),
        "sort_pairs_u32 shuffle": lambda: tpar.distributed_sort_pairs_u32(
            ul, gl, mesh, exchange=exchange),
        "sort_pairs_balanced_u32": lambda: tpar.distributed_sort_pairs_balanced_u32(
            ul, gl, mesh, exchange=exchange),
        "median f32": lambda: (tpar.distributed_median(fl, mesh),),
        "global_digit_histogram": lambda: (tpar.global_digit_histogram(ul, mesh, 3),),
        "global_live_bit_mask": lambda: (tpar.global_live_bit_mask(gl, mesh),),
        "rdma_all_to_all": lambda: (torch.cat(tpar.rdma_all_to_all(
            [torch.from_numpy(u[:mesh.size * 8].reshape(mesh.size, 8).view(np.int32))
             .to(d) + g for g, d in zip(mesh.ranks, mesh.devices)], mesh)),),
    }
    for reduce in ("min", "max", "mean", "count"):
        runs[f"group_reduce {reduce}"] = (
            lambda reduce=reduce: tpar.distributed_group_reduce(
                gl, None if reduce == "count" else fl, mesh, reduce=reduce,
                exchange=exchange))
    runs["group_reduce count groups=97"] = lambda: tpar.distributed_group_reduce(
        gl, None, mesh, reduce="count", groups=97)
    out = {}
    for name, run in runs.items():
        for i, part in enumerate(run()):
            if isinstance(part, dict):
                for k, v in part.items():
                    out[f"{name}.{i}.{k}"] = _host(v)
            else:
                out[f"{name}.{i}"] = _host(part)
    return out


def group_cases(mesh, n: int, log: Callable[[str], None]) -> List[str]:
    """What only a group mesh has: its size, the two exchanges alike (or
    the bulk over gloo refused), unequal slices refused on every process,
    and on the card a second mesh opening its own IPC handles."""
    import torch.distributed as dist
    from .. import parallel as tpar
    from ..parallel import rdma

    failures: List[str] = []

    def check(name, ok):
        log(f"{name}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)

    L, P = len(mesh.devices), mesh.num_processes
    check(f"mesh.size is the global D ({P} x {L})",
          mesh.size == P * L == dist.get_world_size() * L and mesh.shape == {"shards": P * L})
    x = np.random.default_rng(SEED + 1).integers(0, 1 << 32, size=n, dtype=np.uint32)
    xl = slice_of(mesh, x)
    on_card = mesh.devices[0].type == "cuda"
    if on_card and dist.get_backend() == "gloo":
        try:
            tpar.distributed_sort_balanced_u32(xl, mesh, exchange="xla")
            refused = False
        except ValueError as e:
            refused = "rdma" in str(e)
        check("exchange='xla' of CUDA tensors over gloo refused", refused)
    else:
        same = True
        for fn in (tpar.distributed_sort_balanced_u32, tpar.distributed_sort_u32):
            a = fn(xl, mesh, exchange="xla")
            b = fn(xl, mesh, exchange="rdma")
            same = same and all(np.array_equal(_host(u), _host(v)) for u, v in zip(a, b))
        check("exchange='rdma' equals 'xla'", same)
    if P > 1:
        try:
            tpar.distributed_sort_balanced_u32(x[: n // P + mesh.process_index], mesh)
            refused = False
        except ValueError as e:
            refused = "same length" in str(e)
        check("unequal slices refused on every process", refused)
        # the shards are this process's part: gather_sorted gathers them over
        # the group with mesh=, and refuses without it
        out = tpar.distributed_sort_u32(xl, mesh, exchange="rdma" if on_card else "xla")
        try:
            tpar.gather_sorted(*out)
            refused = False
        except ValueError as e:
            refused = "mesh=" in str(e)
        check("gather_sorted without mesh= refused",
              refused and np.array_equal(tpar.gather_sorted(*out, mesh=mesh), np.sort(x)))
    if on_card and P > 1:
        # the mesh's handles closed; a second mesh over the group opens fresh
        # ones and sorts through them
        first = rdma.peers(mesh)
        rdma.close_peers(mesh)
        second = tpar.make_sort_mesh(devices=mesh.devices, group=mesh.group)
        try:
            got = tpar.gather_sorted(*tpar.distributed_sort_balanced_u32(
                xl, second, exchange="rdma"), mesh=second)
            peers = rdma.peers(second)
            fresh = (peers is not first and first.capacity == 0
                     and peers.opens == (P - 1) * L and peers.capacity > 0)
        finally:
            rdma.close_peers(second)
        check("a second mesh opens fresh handles, closed with it",
              fresh and peers.capacity == 0 and np.array_equal(got, np.sort(x)))
    return failures


def main_path(mesh, m: int, log: Callable[[str], None]) -> Tuple[dict, List[str]]:
    """The balanced ``distributed_sort`` of ``m`` u32 keys with K13 (on the
    card) or the ``"xla"`` exchange, each process passing its slice as a
    tensor on its card, checked on its shards (its kernel launches counted
    from zero, in ``main_launches``), then timed; on the card with several
    processes, K13 alone at rows of m / D^2 u32 a rank, against its plain
    version, timed."""
    import torch
    import torch.distributed as dist
    from .. import parallel as tpar
    from ..ops import cuda_kernels as ck
    from ..parallel import _mesh, rdma

    D, dev = mesh.size, mesh.devices[0]
    on_card = dev.type == "cuda"
    exchange = "rdma" if on_card else "xla"
    x = np.random.default_rng(SEED + 2).integers(0, 1 << 32, size=m, dtype=np.uint32)
    xt = torch.from_numpy(slice_of(mesh, x).view(np.int32)).to(dev).view(torch.uint32)
    stats, failures = {"m": m, "D": D, "exchange": exchange}, []

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)
        dist.barrier()

    sync()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sp, counts, _ = tpar.distributed_sort(xt, mesh, exchange=exchange)
    sync()
    stats["first_call_ms"] = (time.perf_counter() - t0) * 1e3
    stats["main_launches"] = ck.launch_counts()
    peers = rdma.peers(mesh) if on_card and mesh.num_processes > 1 else None
    if peers is not None:
        stats["open_ms"], stats["opens"] = peers.open_ms, peers.opens
    ok = shards_hold(mesh, sp, counts, np.sort(x))
    log(f"main path: distributed_sort balanced of {m} u32, exchange={exchange}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("main path")
    del sp, counts
    sync()
    t0 = time.perf_counter()
    for _ in range(REPS):
        tpar.distributed_sort(xt, mesh, exchange=exchange)
    sync()
    stats["sort_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
    # what one host round trip costs: a stream sync, a meet of the group, and
    # one sum of the pivot search (on a card over gloo: a copy to the host,
    # the all_reduce, a copy back)
    tiny = torch.zeros(3, dtype=torch.int64, device=dev)

    def mean_ms(fn, calls=20):
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls
    stats["sync_ms"] = mean_ms(lambda: (tiny.add_(1), torch.cuda.synchronize(dev)
                                        if on_card else None))
    stats["meet_ms"] = mean_ms(lambda: _mesh._gather_ints([0], mesh))
    stats["sum_ms"] = mean_ms(lambda: _mesh.total([tiny], mesh).cpu())
    if peers is None:
        return stats, failures
    # K13 across the processes: every rank's sends from a seeded generator,
    # so that each process rebuilds every rank's sends for the oracle
    rows = m // (D * D)

    def sends_of(g):
        gen = torch.Generator(device=dev).manual_seed(SEED + g)
        return torch.randint(-2**31, 2**31, (D, rows), dtype=torch.int32, device=dev,
                             generator=gen)
    sends = [sends_of(g) for g in mesh.ranks]
    got = ck.rdma_exchange(sends, peers)
    every = ck.rdma_exchange_plain([sends_of(g) for g in range(D)])
    err = max(int((a.long() - every[g].long()).abs().max()) for a, g in zip(got, mesh.ranks))
    stats["k13_rows"], stats["k13_max_abs_err"] = rows, err
    log(f"K13 across processes, rows of {rows} u32: max |err| {err} against the plain "
        "version: " + ("ok" if err == 0 else "FAIL"))
    if err:
        failures.append("K13 across processes")
    del got, every
    sync()
    t0 = time.perf_counter()
    for _ in range(REPS):
        ck.rdma_exchange(sends, peers)
    sync()
    stats["k13_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
    return stats, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--exchange", choices=("xla", "rdma"), default="xla")
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--main-n", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    local = int(os.environ.get("RST_MP_LOCAL_DEVICES", "4"))

    import torch
    from .. import parallel as tpar
    from ..ops import cuda_kernels as ck
    from ..parallel import rdma
    from ..utils.mpharness import init_worker

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device")
        from ..ops import _build
        _build.require_built()
        dev = torch.device("cuda", args.pid % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    group = init_worker(args.pid, args.nproc, f"127.0.0.1:{args.port}",
                        backend=args.backend, timeout_s=TIMEOUT_S)
    mesh = tpar.make_sort_mesh(devices=[dev] * local, group=group)

    def log(line):
        print(f"[{args.pid}] {line} ({wire_note(mesh)})", flush=True)

    stats, failures = {}, []
    if args.main_n:
        stats, failures = main_path(mesh, args.main_n, log)
    ck.reset_launch_counts()
    out, more = surfaces(mesh, args.n, args.exchange, log)
    out.update(rest_of_surface(mesh, args.n, args.exchange))
    failures += more + group_cases(mesh, args.n, log)
    stats["launches"] = ck.launch_counts()
    rdma.close_peers(mesh)
    if args.out:
        np.savez(args.out, stats=np.array(json.dumps(stats)), **out)
    import torch.distributed as dist
    dist.destroy_process_group()
    if failures:
        print(f"[{args.pid}] FAILURES: {failures}", flush=True)
        return 1
    print(f"MP_OK {args.pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
