"""Run the whole distributed surface once on a mesh, each output against numpy.

The port's counterpart of ``__graft_entry__.dryrun_multichip``: the shuffle
(deal, splitter histogram, skew-aware partition, padded exchange, merges),
the balanced sorts (exact-quantile selection, multi-round chunked exchange,
sequential and overlapped), both exchanges (``"xla"``: the mesh's
``copy_`` all-to-all; ``"rdma"``: K13), the stable rank and record sorts,
order statistics, unique values, the group-by (sort-backed and dense),
``distributed_bincount``, ``distributed_top_k``, the overflow contract and a
byte-string payload. The main path, ``distributed_sort`` with the default
``method="balanced"``, runs at ``n`` keys with each exchange; the rest at
``n_rest`` keys (the JAX dry run's 2^20 multi-round case among them).

    python -m radix_sorting_tpu_torch.parallel.dryrun [--ranks 4] [--n N]

builds a mesh of ``--ranks`` ranks on ``cuda:0`` (``--device cpu`` for the
CPU) and prints one line a case.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops import cuda_kernels
from . import (distributed_argsort, distributed_bincount, distributed_group_reduce,
               distributed_quantile, distributed_select, distributed_sort,
               distributed_sort_balanced_u32, distributed_sort_pairs, distributed_sort_u32,
               distributed_top_k, distributed_unique_sorted, gather_sorted, make_sort_mesh)
from ._mesh import SortMesh

__all__ = ["dryrun_multichip"]


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _sync(mesh: SortMesh) -> None:
    for dev in {d for d in mesh.devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def dryrun_multichip(mesh: SortMesh, n: int = 40_000_000, n_rest: int = 1 << 20,
                     seed: int = 7, log: Optional[Callable[[str], None]] = print,
                     default_mesh: bool = True) -> List[dict]:
    """Run every distributed entry point on ``mesh`` and hold each output
    against numpy; raise AssertionError on the first that disagrees (not an
    ``assert``: the checks hold under ``python -O`` too).

    Returns one record a case: ``{"name", "n", "ms", "launches",
    "peak_mb"}``: the kernel launches the case made (``cuda_kernels.LAUNCHES``
    differences), its time on the host clock, synchronised, and on a card
    the peak of allocated device memory during the case (None on the CPU).
    ``default_mesh`` adds one call on ``make_sort_mesh()``, the mesh over
    the visible cards.
    """
    if mesh.group is not None:
        raise ValueError("dryrun_multichip drives one process's global arrays; on a group "
                         "mesh each process runs radix_sorting_tpu_torch.scripts.mp_worker")
    D = mesh.size
    rng = np.random.Generator(np.random.PCG64(seed))
    m = max(n_rest, D * D * 8)
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    xr = x[:m]
    records: List[dict] = []

    on_card = any(d.type == "cuda" for d in mesh.devices)

    def case(name: str, size: int, run: Callable[[], None], ranks: int = D) -> None:
        _sync(mesh)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        before = cuda_kernels.launch_counts()
        t0 = time.perf_counter()
        run()
        _sync(mesh)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: c - before[k] for k, c in cuda_kernels.launch_counts().items()
                    if c != before[k]}
        peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
        records.append({"name": name, "n": size, "ms": ms, "launches": launches,
                        "peak_mb": peak})
        if log:
            mem = "" if peak is None else f", peak device memory {peak:.0f} MiB"
            log(f"dryrun {name}: n={size} D={ranks} equal to numpy, {ms:.1f} ms "
                f"(host clock, with the numpy check){mem}, launches {launches}")

    # the main path: the balanced distributed sort, each exchange
    sorted_x = np.sort(x)
    dev0 = mesh.devices[0]
    xt = torch.from_numpy(x.view(np.int32)).to(dev0).view(torch.uint32)
    for exchange in ("xla", "rdma"):
        def main(exchange=exchange):
            out = gather_sorted(*distributed_sort(xt, mesh, exchange=exchange))
            _require(np.array_equal(out, sorted_x), f"distributed_sort ({exchange}) wrong")
        case(f"distributed_sort balanced exchange={exchange}", n, main)
    del xt

    # the shuffle, each exchange
    sorted_r = np.sort(xr)
    for exchange in ("xla", "rdma"):
        def shuffle(exchange=exchange):
            out = gather_sorted(*distributed_sort_u32(xr, mesh, exchange=exchange))
            _require(np.array_equal(out, sorted_r), f"shuffle ({exchange}) wrong")
        case(f"distributed_sort_u32 shuffle exchange={exchange}", m, shuffle)

    # the balanced path on a skewed input, sequential and overlapped, K13
    xs = np.concatenate([np.full(m // 2, 0xBEEF, np.uint32), xr[m // 2:]])
    sorted_s = np.sort(xs)
    for overlap in (False, True):
        def skewed(overlap=overlap):
            out = gather_sorted(*distributed_sort_balanced_u32(
                xs, mesh, overlap=overlap, exchange="rdma", chunk=m // (4 * D)))
            _require(np.array_equal(out, sorted_s), f"balanced overlap={overlap} wrong")
        case(f"distributed_sort_balanced_u32 half one value overlap={overlap} rdma",
             m, skewed)

    # the stable rank sort: the unique stable permutation
    xt_ties = rng.integers(0, 64, size=m, dtype=np.uint32)

    def argsort():
        _, perm, counts, ovf = distributed_argsort(xt_ties, mesh, exchange="rdma")
        want = np.argsort(xt_ties, kind="stable").astype(np.uint32)
        _require(np.array_equal(gather_sorted(perm, counts, ovf), want),
                 "distributed_argsort is not the stable permutation")
    case("distributed_argsort 64 values", m, argsort)

    # the record sort with a payload tree, and a byte-string field
    keys_f = rng.standard_normal(m).astype(np.float32)
    payload = {"tag": np.arange(m, dtype=np.uint32),
               "val": rng.standard_normal(m).astype(np.float32)}

    def pairs():
        order = np.argsort(keys_f, kind="stable")
        sk, pv, counts, ovf = distributed_sort_pairs(keys_f, payload, mesh)
        _require(np.array_equal(gather_sorted(sk, counts, ovf), keys_f[order])
                 and np.array_equal(gather_sorted(pv["tag"], counts), payload["tag"][order])
                 and np.array_equal(gather_sorted(pv["val"], counts), payload["val"][order]),
                 "distributed_sort_pairs scrambled the payload")
    case("distributed_sort_pairs f32 keys, {tag, val}", m, pairs)
    nb = min(m, 1 << 16)
    names = np.array([b"k%06d" % i for i in range(nb)], dtype="S8")
    kties = rng.integers(0, 50, size=nb, dtype=np.uint32)

    def bytes_payload():
        _, pv, counts, ovf = distributed_sort_pairs(kties, {"name": names}, mesh,
                                                    method="shuffle", exact=True)
        got = gather_sorted(pv["name"], counts, ovf).view("S8").reshape(-1)
        _require(np.array_equal(got, names[np.argsort(kties, kind="stable")]),
                 "byte-string payload scrambled")
    case("distributed_sort_pairs shuffle, S8 payload", nb, bytes_payload)

    # order statistics: no exchange at all
    def select():
        ranks = [0, m // 2, m - 1]
        sel = distributed_select(xr, ranks, mesh).cpu().numpy()
        _require(np.array_equal(sel, sorted_r[ranks]), "distributed_select wrong")
        qs = [0.25, 0.5, 0.75]
        qv = distributed_quantile(xr, qs, mesh, method="lower").cpu().numpy()
        _require(np.array_equal(qv, np.quantile(xr, qs, method="lower").astype(np.uint32)),
                 "distributed_quantile wrong")
    case("distributed_select and distributed_quantile", m, select)

    def top_k():
        vals, idx = distributed_top_k(xr, 16, mesh)
        order = np.argsort(~xr, kind="stable")[:16]
        _require(np.array_equal(vals.cpu().numpy(), xr[order])
                 and np.array_equal(idx.cpu().numpy(), order.astype(np.uint32)),
                 "distributed_top_k wrong")
    case("distributed_top_k k=16", m, top_k)

    # unique values, the group-by and bincount over 97 values
    xu = rng.integers(0, 97, size=m, dtype=np.uint32)
    gv = (xu >> 2).astype(np.int32) + rng.integers(-5, 5, size=m).astype(np.int32)
    uq, inv = np.unique(xu, return_inverse=True)
    want = np.zeros(len(uq), np.int64)
    np.add.at(want, inv, gv.astype(np.int64))

    def unique():
        vals, counts, ovf = distributed_unique_sorted(xu, mesh)
        _require(np.array_equal(gather_sorted(vals, counts, ovf), uq), "uniques wrong")
    case("distributed_unique_sorted 97 values", m, unique)

    for groups in (None, 97):
        def group(groups=groups):
            uk, red, counts, ovf = distributed_group_reduce(xu, gv, mesh, reduce="sum",
                                                            groups=groups)
            _require(np.array_equal(gather_sorted(uk, counts, ovf), uq)
                     and np.array_equal(gather_sorted(red, counts).astype(np.int64), want),
                     f"distributed_group_reduce groups={groups} wrong")
        case(f"distributed_group_reduce sum groups={groups}"
             + (" (dense: K10)" if groups else " (sort-backed)"), m, group)

    def bincount():
        bc = distributed_bincount(xu, mesh, 97).cpu().numpy()
        _require(np.array_equal(bc, np.bincount(xu, minlength=97)), "bincount wrong")
    case("distributed_bincount 97 bins (K1)", m, bincount)

    # the overflow contract: two values trip the shuffle's capacity flag,
    # the gather refuses the result, exact=True recovers it
    xsk = rng.integers(0, 2, size=m, dtype=np.uint32)

    def overflow():
        sp, counts, ovf = distributed_sort_u32(xsk, mesh)
        _require(int(ovf[0][0]) != 0, "capacity overflow flag lost")
        try:
            gather_sorted(sp, counts, ovf)
            raise AssertionError("gather_sorted accepted an overflowed shuffle")
        except RuntimeError:
            pass
        out = gather_sorted(*distributed_sort_u32(xsk, mesh, exact=True,
                                                  exchange="rdma"))
        _require(np.array_equal(out, np.sort(xsk)), "exact=True recovery wrong")
    case("distributed_sort_u32 two values: overflow, then exact=True", m, overflow)

    # many real rounds of the chunked exchange
    def rounds():
        out = gather_sorted(*distributed_sort_balanced_u32(xr, mesh, chunk=1 << 14,
                                                           exchange="rdma"))
        _require(np.array_equal(out, sorted_r), "multi-round exchange wrong")
    case("distributed_sort_balanced_u32 chunk=2^14 rdma", m, rounds)

    if default_mesh:
        def default():
            mesh1 = make_sort_mesh()
            out = gather_sorted(*distributed_sort(xr, mesh1))
            _require(np.array_equal(out, sorted_r), "default mesh sort wrong")
        case(f"distributed_sort on make_sort_mesh() ({torch.cuda.device_count()} "
             "card(s))", m, default, ranks=torch.cuda.device_count())
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, default=40_000_000)
    ap.add_argument("--n-rest", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    mesh = make_sort_mesh(devices=[args.device] * args.ranks)
    dryrun_multichip(mesh, n=args.n, n_rest=args.n_rest,
                     default_mesh=torch.device(args.device).type == "cuda")


if __name__ == "__main__":
    main()
