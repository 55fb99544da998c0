"""Balanced distributed sort: exact-quantile partition, bounded-memory exchange.

The counterpart of ``radix_sorting_tpu.parallel.balanced``, restructured
from one ``shard_map`` body into steps over the ranks of a
:class:`._mesh.SortMesh` (see :mod:`.shuffle` for the conventions: int32
word planes, per-rank results, the local sorts). The design is the JAX
package's:

1. **Strict composite order.** Partitioning is on the key planes followed
   by a tiebreak plane: the global index for rank and record sorts, a
   synthetic global-slot plane (never shipped) for keys-only sorts. Equal
   keys are split by count across the boundary ranks.
2. **Exact quantile selection**: the splitter of rank d is the composite of
   global rank d * n_local, found MSB-first two bits a round; each round
   counts ``#{x < trial}`` on every rank's sorted shard (a binary search)
   and sums the counts over ranks. The counts are summed on the first
   local rank's device (then over the group, :func:`._mesh.total`) and the
   pivot bits stay tensors: no host read per bit.
3. **Multi-round chunked all-to-all** of ``chunk`` keys a peer a round, each
   round's chunks placed at precomputed offsets of an accumulator, then one
   local sort. The number of rounds, a ``pmax`` of the run lengths, is the
   one value of the body that comes to the host (it steers the loop).

``counts`` are static (rank d holds global ranks [d * ceil(n/D), ...)) and
``overflow`` is identically zero. The rest of the module is the
distributed surface built on the same machinery: ``distributed_unique_sorted``,
``distributed_group_reduce`` (with a dense tier over K1 / K10 / K11),
``distributed_select`` / ``quantile`` / ``median`` and ``distributed_top_k``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import extras
from ..ops import cuda_kernels, hw_engine, kdf
from ..ops.bitmap import nonzero_static
from ..ops.probes import word_lt
from . import _mesh
from ._mesh import SortMesh, axis_size
from ._payload import decode_payload_tree, encode_payload_tree
from .shuffle import (_SENTINEL, _as_input, _as_u32, _as_words, _decode, _exchange,
                      _gindex, _ints, _iota, _layout, _local_sort, _pad, _payload_u32,
                      _shard_planes, _u32_plane)

__all__ = [
    "distributed_sort_balanced",
    "distributed_argsort_balanced",
    "distributed_sort_pairs_balanced",
    "distributed_sort_balanced_u32",
    "distributed_argsort_balanced_u32",
    "distributed_sort_pairs_balanced_u32",
    "distributed_select",
    "distributed_quantile",
    "distributed_median",
    "distributed_top_k",
    "distributed_unique_sorted",
    "distributed_group_reduce",
]


def _search_key(planes):
    """One signed key for a sorted shard of one or two planes (the sorter's
    packed key, :func:`..ops.hw_engine._key`), or None for more planes."""
    return hw_engine._key(tuple(planes)) if len(planes) <= 2 else None


def _lower_bound(sorted_planes, piv_planes, n_local: int) -> torch.Tensor:
    """#{elements < pivot} for each pivot, (Q,) int64 in [0, n_local], by a
    vectorized binary search over the planes of the sorted shard."""
    q = piv_planes[0].shape[0]
    dev = piv_planes[0].device
    lo = torch.zeros(q, dtype=torch.int64, device=dev)
    hi = torch.full((q,), n_local, dtype=torch.int64, device=dev)
    for _ in range(max(1, int(n_local).bit_length())):
        mid = (lo + hi) // 2
        elem = tuple(p[mid.clamp(0, n_local - 1)] for p in sorted_planes)
        less = word_lt(elem, piv_planes)      # element < pivot: answer right of mid
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def _counts_below(parts, keys, piv, n_local: int) -> list:
    """#{elements < pivot} on every rank's sorted shard ``parts[r]``: one
    ``searchsorted`` of the packed pivots where the shard has a packed key
    ``keys[r]`` (<= 2 planes; the pivots packed once), else
    :func:`_lower_bound`. Each rank's (Q,) int64 counts on its device."""
    pkey = hw_engine._key(tuple(piv)) if keys[0] is not None else None
    out = []
    for part, key in zip(parts, keys):
        dev = part[0].device
        out.append(torch.searchsorted(key, pkey.to(dev)) if key is not None
                   else _lower_bound(part, tuple(t.to(dev) for t in piv), n_local))
    return out


def _select_pivots(parts, keys, targets: torch.Tensor, mesh: SortMesh, n_local: int):
    """Exact global-rank selection over the ranks' sorted shards ``parts``
    (``keys``: their :func:`_search_key`): pivot[q] = the composite of
    global rank targets[q] (targets on the first rank's device).

    Greedy MSB-first over the concatenated planes, two bits a round: the
    count below a trial value is monotone in it, so the passing candidates
    among {acc | 1 << p, acc | 2 << p, acc | 3 << p} form a prefix and one
    batched count per rank plus one sum decides both bits. The composites
    are strict, so the greedy maximum IS the element at that rank. Returns
    the pivot planes (int32) on the first local rank's device."""
    dev0 = mesh.devices[0]
    npp = len(parts[0])
    q = targets.shape[0]
    targets3 = targets.long().repeat(3)
    cand = torch.arange(1, 4, device=dev0).repeat_interleave(q)     # (3q,)
    fixed = []
    for plane_i in range(npp):
        zeros_after = tuple(torch.zeros(3 * q, dtype=torch.int32, device=dev0)
                            for _ in range(npp - plane_i - 1))
        fixed3 = tuple(f.repeat(3) for f in fixed)
        acc = torch.zeros(q, dtype=torch.int64, device=dev0)
        for i in range(16):
            pos = 30 - 2 * i
            trial_pl = cuda_kernels.low32(acc.repeat(3) | (cand << pos))
            trial = fixed3 + (trial_pl,) + zeros_after
            gcnt = _mesh.total(_counts_below(parts, keys, trial, n_local), mesh)
            # the number of passing candidates = the largest passing value
            m = (gcnt <= targets3).reshape(3, q).sum(0)
            acc = acc | (m << pos)
        fixed.append(cuda_kernels.low32(acc))
    return tuple(fixed)


def _balanced_body(shards, mesh: SortMesh, num_key_planes: int, strict: bool, chunk: int,
                   n_local: int, overlap: bool = False, exchange: str = "xla", slots=None):
    """The SPMD body over this process's ranks; ``shards[i]`` = local rank
    i's key planes (most significant first) and payload planes.

    strict=True: the key planes alone are a strict order (rank and record
    sorts carry the global index); else a synthetic global-slot plane
    (``slots[i]``, local rank i's rows' global indices) joins the local sort
    and the partition but is not shipped.

    overlap=True: round r+1's exchange is issued before round r is placed
    (one extra, all-sentinel round of traffic). Each exchange returns fresh
    receive buffers, so a rank holds two, and neither is reused before its
    placement is done; on the card the copies of a placement follow the
    exchange that filled the buffer on the same stream.

    exchange="rdma" swaps each round's :func:`._mesh.all_to_all` for K13
    (:func:`.rdma.rdma_all_to_all`). Result-identical.
    """
    D = mesh.size
    c = chunk

    # 1. local sort by the strict composite; payload rides along
    part_sorted, shipped = [], []
    for r, planes in enumerate(shards):
        if strict:
            sorted_all = _local_sort(planes, num_key_planes)
            part_sorted.append(sorted_all[:num_key_planes])
            shipped.append(sorted_all)
        else:
            ops = planes[:num_key_planes] + (slots[r],) + planes[num_key_planes:]
            sorted_all = _local_sort(ops, num_key_planes + 1)
            part_sorted.append(sorted_all[: num_key_planes + 1])
            shipped.append(sorted_all[:num_key_planes] + sorted_all[num_key_planes + 1:])
    nship = len(shipped[0])

    # 2. exact quantile pivots at global ranks d * n_local, d = 1..D-1
    targets = torch.arange(1, D, device=mesh.devices[0]) * n_local
    keys = [_search_key(p) for p in part_sorted]
    piv = _select_pivots(part_sorted, keys, targets, mesh, n_local)

    # 3. contiguous outgoing runs per destination
    out_starts, out_counts = [], []
    for mid in _counts_below(part_sorted, keys, piv, n_local):
        starts = torch.cat([mid.new_zeros(1), mid, mid.new_full((1,), n_local)])
        out_starts.append(starts[:-1])
        out_counts.append(starts[1:] - starts[:-1])     # (D,), sums to n_local

    # 4. receive bookkeeping: one counts all-to-all tells every rank how much
    # arrives from each source. The composite is strict everywhere (pad rows
    # included), so sum(recv_total) == n_local; rounding each source up to
    # whole chunks gives sum(padded) <= n_local + D*(c-1), and the
    # accumulator A = n_local + (D+1)*c puts the dustbin at A - c, past them.
    recv_total = _mesh.all_to_all(out_counts, mesh)
    rounds_from, acc_start = [], []
    for rt in recv_total:
        rf = (rt + c - 1) // c
        padded = rf * c
        rounds_from.append(rf)
        acc_start.append(torch.cumsum(padded, 0) - padded)
    A = n_local + (D + 1) * c
    dustbin = A - c
    acc = [tuple(torch.full((A,), _SENTINEL, dtype=torch.int32, device=p[0].device)
                 for _ in range(nship)) for p in shipped]
    # the loop bound: the one host read of the body
    gmax = int(_mesh.pmax([oc.max() for oc in out_counts], mesh)[0])
    num_rounds = (gmax + c - 1) // c

    def exchange_round(r):
        """Gather and exchange round r's chunks. Depends only on the sorted
        shards and r, never on the accumulators."""
        sends = []
        for planes, starts, counts in zip(shipped, out_starts, out_counts):
            j = torch.arange(c, device=planes[0].device)
            this_count = (counts - r * c).clamp(0, c)                  # (D,)
            idx = (starts[:, None] + r * c + j[None, :]).clamp(0, n_local - 1)
            valid = j[None, :] < this_count[:, None]
            sends.append(torch.stack([torch.where(valid, p[idx], _SENTINEL)
                                      for p in planes]))               # (P, D, c)
        return _exchange(sends, mesh, 1, exchange)

    def place(r, recv):
        """Each source's chunk to its reserved offset, or to the dustbin
        once the source has no rounds left (its chunk is all sentinels).
        In place: the accumulators belong to this call."""
        for me in range(len(recv)):
            j = torch.arange(c, device=recv[me].device)
            off = torch.where(r < rounds_from[me], acc_start[me] + r * c, dustbin)
            pos = (off[:, None] + j[None, :]).reshape(-1)               # (D * c,)
            for pi in range(nship):
                acc[me][pi].index_copy_(0, pos, recv[me][pi].reshape(-1))

    if overlap:
        # software pipeline: round r's receive in hand, round r+1's exchange
        # issued before placing r (round num_rounds prefetches an all-empty
        # sentinel exchange that is never placed)
        recv_r = exchange_round(0)
        for r in range(num_rounds):
            recv_next = exchange_round(r + 1)
            place(r, recv_r)
            recv_r = recv_next
    else:
        for r in range(num_rounds):
            place(r, exchange_round(r))

    # 5. final local order; the sentinel filler sorts to the tail, and
    # exactly n_local received rows are valid, so the head is the shard
    return [tuple(m[:n_local] for m in _local_sort(a, num_key_planes)) for a in acc]


def _check_selection_width(n_padded: int) -> None:
    """Ranks are counted in int32 planes: targets, counts and the slot plane
    all need n < 2^31. Fail loudly instead of wrapping."""
    if n_padded >= 1 << 31:
        raise ValueError(
            f"balanced partition supports n < 2^31 keys (got {n_padded}); "
            "rank arithmetic is int32 — shard the problem or use the "
            "bucket-shuffle path for larger arrays")


def _run_balanced(planes, mesh: SortMesh, axis_name, num_key_planes, strict, chunk,
                  overlap=False, exchange="xla"):
    """Pad to D shards, run the balanced body, return (per-rank planes,
    static counts, zero overflow).

    Strict-mode convention: the LAST key plane is the global-index tiebreak.
    """
    # non-strict mode is keys-only: the final merge sorts by the key planes
    # unstably, which would scramble payload rows among equal keys
    assert strict or len(planes) == num_key_planes, \
        "payload planes require strict=True (index tiebreak)"
    D = axis_size(mesh, axis_name)
    lay = _layout(mesh, int(planes[0].shape[0]), D)
    n, n_local = lay.n, lay.n_local
    if n < 1:
        raise ValueError("balanced distributed sort needs n >= 1")
    if exchange not in ("xla", "rdma"):
        raise ValueError(f"exchange must be 'xla' or 'rdma', got {exchange!r}")
    _check_selection_width(D * n_local)
    # pad rows must sort after every real row AND keep the composite strict:
    # in strict mode the tiebreak plane pads with distinct indices >= n
    gidx = _gindex(lay, planes[0])
    fills = None
    if strict and lay.pad:
        fills = [None] * len(planes)
        fills[num_key_planes - 1] = gidx[lay.s:]
    planes = _pad(planes, lay.pad, fills)
    counts = _ints(np.clip(n - np.asarray(mesh.ranks) * n_local, 0, n_local), mesh)
    overflow = _ints([0] * len(mesh.devices), mesh)
    shards = _shard_planes(planes, mesh)

    if D == 1:
        # unstable in both modes: strict key sets are total orders, and
        # keys-only stability is vacuous
        return [_local_sort(shards[0], num_key_planes)], counts, overflow

    if chunk is None:
        chunk = -(-n_local // D)
    chunk = max(1, min(int(chunk), n_local))
    return (_balanced_body(shards, mesh, num_key_planes, strict, chunk, n_local,
                           overlap, exchange, None if strict else _mesh.shard(gidx, mesh)),
            counts, overflow)


def distributed_sort_balanced_u32(x, mesh: SortMesh, axis_name: str = "shards",
                                  chunk: Optional[int] = None, overlap: bool = False,
                                  exchange: str = "xla"):
    """Keys-only balanced distributed sort of a u32 array over a 1-D mesh:
    every shard holds exactly ceil(n/D) keys of the sorted order, transient
    memory is bounded by D * chunk, and there is no overflow. Returns
    (sorted_padded, counts, overflow), per-rank tuples."""
    sp, counts, overflow = _run_balanced((_u32_plane(x, mesh),), mesh, axis_name,
                                         num_key_planes=1, strict=False, chunk=chunk,
                                         overlap=overlap, exchange=exchange)
    return _as_u32(sp, 0), counts, overflow


def distributed_argsort_balanced_u32(x, mesh: SortMesh, axis_name: str = "shards",
                                     chunk: Optional[int] = None, overlap: bool = False,
                                     exchange: str = "xla"):
    """Balanced distributed stable rank sort of a u32 array (global-index
    tiebreak). Returns (sorted_keys_padded, perm_padded, counts, overflow)."""
    w = _u32_plane(x, mesh)
    sp, counts, overflow = _run_balanced((w, _iota(w, mesh)), mesh, axis_name,
                                         num_key_planes=2, strict=True, chunk=chunk,
                                         overlap=overlap, exchange=exchange)
    return _as_u32(sp, 0), _as_u32(sp, 1), counts, overflow


def distributed_sort_pairs_balanced_u32(x, payload, mesh: SortMesh,
                                        axis_name: str = "shards",
                                        chunk: Optional[int] = None,
                                        overlap: bool = False, exchange: str = "xla"):
    """Balanced distributed stable record sort: u32 keys and one u32
    payload plane. Returns (sorted_keys_padded, payload_padded, counts,
    overflow)."""
    w = _u32_plane(x, mesh)
    sp, counts, overflow = _run_balanced(
        (w, _iota(w, mesh), _payload_u32(payload, w)), mesh, axis_name,
        num_key_planes=2, strict=True, chunk=chunk, overlap=overlap, exchange=exchange)
    return _as_u32(sp, 0), _as_u32(sp, 2), counts, overflow


def distributed_sort_balanced(x, mesh: SortMesh, axis_name: str = "shards",
                              descending: bool = False, chunk: Optional[int] = None,
                              overlap: bool = False, exchange: str = "xla"):
    """Dtype-generic balanced distributed sort, either order. 64-bit keys
    partition on both word planes, so balance is exact for every input.
    Returns (sorted_padded_values, counts, overflow[=0])."""
    words, dtype = _as_words(x, descending, mesh)
    out, counts, overflow = _run_balanced(words, mesh, axis_name,
                                          num_key_planes=len(words), strict=False,
                                          chunk=chunk, overlap=overlap, exchange=exchange)
    return _decode(out, dtype, descending), counts, overflow


def distributed_argsort_balanced(x, mesh: SortMesh, axis_name: str = "shards",
                                 descending: bool = False, chunk: Optional[int] = None,
                                 overlap: bool = False, exchange: str = "xla"):
    """Dtype-generic balanced distributed stable rank sort. Returns
    (sorted_values_padded, perm_padded, counts, overflow[=0]); the
    permutation (uint32 shards) is the unique stable one."""
    words, dtype = _as_words(x, descending, mesh)
    nw = len(words)
    out, counts, overflow = _run_balanced(
        words + (_iota(words[0], mesh),), mesh, axis_name,
        num_key_planes=nw + 1, strict=True, chunk=chunk, overlap=overlap,
        exchange=exchange)
    return _decode([o[:nw] for o in out], dtype, descending), _as_u32(out, nw), \
        counts, overflow


def distributed_sort_pairs_balanced(keys, values, mesh: SortMesh, axis_name: str = "shards",
                                    descending: bool = False, chunk: Optional[int] = None,
                                    overlap: bool = False, exchange: str = "xla"):
    """Dtype-generic balanced distributed stable record sort. ``values`` is a
    payload tree (:mod:`._payload`). Returns (sorted_keys_padded,
    permuted_values_padded, counts, overflow[=0]); every payload leaf is a
    tuple of per-rank shards."""
    words, dtype = _as_words(keys, descending, mesh)
    n = int(words[0].shape[0])
    payload_planes, ctx = encode_payload_tree(values, n, words[0].device)
    nk = len(words) + 1
    out, counts, overflow = _run_balanced(
        words + (_iota(words[0], mesh),) + payload_planes, mesh, axis_name,
        num_key_planes=nk, strict=True, chunk=chunk, overlap=overlap, exchange=exchange)
    return (_decode([o[:len(words)] for o in out], dtype, descending),
            decode_payload_tree([o[nk:] for o in out], ctx), counts, overflow)


# ---------------------------------------------------------------------------
# exact distributed order statistics, unique values and group-by


def distributed_unique_sorted(x, mesh: SortMesh, axis_name: str = "shards",
                              chunk: Optional[int] = None, exchange: str = "xla"):
    """Sorted unique values of a mesh-sharded array, fixed-shape contract.

    A balanced distributed sort, then per-shard boundary dedup: each shard
    compares its first element with its left neighbour's last valid one
    (one :func:`._mesh.ppermute`) and compacts its new-value boundaries to
    the front. Returns (values_padded, counts, overflow[=0]): shard d's
    first ``counts[d]`` entries are its slice of the global sorted uniques.
    ``exchange`` is the sort's (the port's keyword: a gloo group of CUDA
    ranks needs ``"rdma"``).
    """
    words, dtype = _as_words(x, False, mesh)
    out, sort_counts, overflow = _run_balanced(words, mesh, axis_name,
                                               num_key_planes=len(words), strict=False,
                                               chunk=chunk, exchange=exchange)
    n_local = int(out[0][0].shape[0])
    # the left neighbour's last valid row (rank 0's incoming row is unused)
    last = [torch.stack([p[(nv - 1).clamp(min=0)][0] for p in planes])
            for planes, nv in zip(out, sort_counts)]
    prev = _mesh.ppermute(last, mesh)
    uniq, counts = [], []
    for me, (planes, nv) in enumerate(zip(out, sort_counts)):
        dev = planes[0].device
        slot = torch.arange(n_local, device=dev)
        in_valid = slot < nv
        differs_prev_row = torch.zeros(n_local, dtype=torch.bool, device=dev)
        differs_left = torch.zeros((), dtype=torch.bool, device=dev)
        for i, p in enumerate(planes):
            differs_prev_row |= torch.cat([differs_prev_row.new_zeros(1), p[1:] != p[:-1]])
            differs_left = differs_left | (p[0] != prev[me][i])
        first_is_new = (differs_left if mesh.ranks[me]
                        else torch.ones((), dtype=torch.bool, device=dev)) & (nv[0] > 0)
        is_new = torch.where(slot == 0, first_is_new, differs_prev_row) & in_valid
        count = is_new.sum(dtype=torch.int32)
        idx = nonzero_static(is_new, n_local, n_local - 1)
        live = slot < count
        uniq.append(tuple(torch.where(live, p[idx], _SENTINEL) for p in planes))
        counts.append(count.reshape(1))
    return _decode(uniq, dtype, False), tuple(counts), overflow


def _distributed_group_reduce_dense(keys, values, mesh: SortMesh, reduce: str, groups: int):
    """Dense-key group-by: no distributed sort at all.

    With keys promised in [0, G), sum / mean / count are one local
    histogram per shard (K1 :func:`..ops.cuda_kernels.hist` for counts, K10
    :func:`..ops.cuda_kernels.whist` for integer sums mod 2^32, K11
    :func:`..ops.cuda_kernels.whist_f32` for float sums with counts) and
    one sum over ranks of O(G) words. The summed tables are replicated, so
    every rank compacts the same present mask and emits its static
    ``ceil(G/D)`` slice of the sorted unique keys. Signed values ride a
    +2^(bits-1) bias corrected by ``count * bias`` after the sum, all mod
    2^32; float sums are f32 (each group within sum|v| * 2^-14 + 1e-5 of a
    float64 sum).
    """
    kt, kdtype = _as_input(keys, mesh)
    G = int(groups)
    D = mesh.size
    lay = _layout(mesh, int(kt.shape[0]), D)
    w = extras._u32_values(kt, kdtype)
    bins = 1 << max(2, (G - 1).bit_length())
    rbits = bins.bit_length() - 1
    S = -(-G // D)                                 # static per-shard output rows
    fmode = False
    if reduce == "count":
        va, bias, acc = None, None, torch.int32
    else:
        vt, vdtype = _as_input(values, mesh)
        vt = vt.to(kt.device)
        if vt.shape != kt.shape:
            raise ValueError("values must match the keys' length")
        fmode = kdf.kind(vdtype) == "f"
        if fmode:
            va, bias, acc = vt.to(torch.float32), None, torch.float32
        else:
            vbits = kdf.key_bits(vdtype)
            bias = (1 << (vbits - 1)) if kdf.kind(vdtype) == "i" else None
            acc = extras._accum_dtype(vdtype)
            va = extras._u32_values(vt, vdtype)
            if bias is not None:
                va = cuda_kernels.low32(va.long() + bias)
    pad = lay.pad
    if pad:
        w = torch.cat([w, w.new_full((pad,), bins)])            # dropped
        if va is not None:
            va = torch.cat([va, va.new_zeros(pad)])
    wl = _mesh.shard(w, mesh)
    vl = _mesh.shard(va, mesh) if va is not None else [None] * len(wl)

    # per-rank tables, then one sum over ranks (integer sums wrap mod 2^32)
    counts_l, tot_l = [], []
    for a, b in zip(wl, vl):
        if reduce == "count":
            counts_l.append(cuda_kernels.hist(a, 0, rbits, drop_ge=G)[:G])
        elif fmode:
            cnt, tot = cuda_kernels.whist_f32(a, b, rbits, G, with_counts=True)
            counts_l.append(cnt[:G])
            tot_l.append(tot[:G])
        else:
            cnt, tot = cuda_kernels.whist(a, b, rbits, G)
            counts_l.append(cnt[:G])
            tot_l.append(tot[:G].long())
    counts = _mesh.psum(counts_l, mesh)
    tots = _mesh.psum(tot_l, mesh) if tot_l else [None] * D
    ukeys, red, emits = [], [], []
    for me, (cnt, tot) in enumerate(zip(counts, tots)):
        dev = cnt.device
        if tot is not None and not fmode:
            if bias is not None:
                tot = tot - cnt.long() * bias
            tot = cuda_kernels.low32(tot)
            if acc == torch.uint32:
                tot = tot.view(torch.uint32)
        present = cnt > 0
        R = present.sum()
        # sized D*S so that no shard's (start, S) window runs past the end
        ids_full = nonzero_static(present, D * S, G)
        q = (R + D - 1) // D                      # rows per shard (last may be short)
        start = mesh.ranks[me] * q
        ids = ids_full.clamp(0, G - 1)[start + torch.arange(S, device=dev)]
        emit = torch.minimum((R - start).clamp(min=0), q).to(torch.int32)
        live = torch.arange(S, device=dev) < emit
        keys_out = torch.where(live, extras._int_word(ids, kdtype, False), _SENTINEL)
        ukeys.append((keys_out,))
        if reduce == "count":
            red.append(torch.where(live, cnt[ids], 0))
        elif reduce == "mean":
            mean = extras._to_float(hw_engine.gather(tot, ids), torch.float32) \
                / cnt[ids].clamp(min=1).to(torch.float32)
            red.append(torch.where(live, mean, 0.0))
        else:
            red.append(extras._where_live(live, hw_engine.gather(tot, ids)))
        emits.append(emit.reshape(1))
    return (_decode(ukeys, kdtype, False), tuple(red), tuple(emits),
            _ints([0] * len(mesh.devices), mesh))


def _dense_planes(reduce: str, values) -> Optional[int]:
    """The dense tier's table planes (count 1; integer values add their
    bytes; f32 values two, as the JAX package counts them), or None."""
    if reduce == "count":
        return 1
    if reduce in ("sum", "mean") and extras._dense_ok(values):
        return extras._dense_value_bytes(extras._dtype_of(values)) + 1
    if reduce in ("sum", "mean") and extras._dense_f32_ok(values):
        return 3
    return None


def distributed_group_reduce(keys, values, mesh: SortMesh, axis_name: str = "shards",
                             reduce: str = "sum", chunk: Optional[int] = None,
                             groups: Optional[int] = None, validate: bool = False,
                             exchange: str = "xla"):
    """Mesh-scale group-by: sum / mean / min / max / count per unique key.

    One balanced distributed sort of the (key, value) composite, then
    per-shard boundary algebra and a cross-shard merge of the runs that span
    shard edges: each shard publishes an edge summary (first / last key, its
    last run's partial, whether it is one run), one all-gather, and a carry
    scan over the D summaries on the first rank's device; a run is emitted
    once, by the shard where it ends.

    Returns ``(keys_padded, reduced_padded, counts, overflow[=0])``, per-rank
    tuples. ``reduce='count'`` takes ``values=None``. ``sum`` / ``mean``
    accumulate like :func:`..extras.group_reduce` (sub-32-bit values in 32
    bits; ``mean`` float32) and need values of <= 32 bits; ``min`` / ``max``
    take any value dtype and follow the KDF total order.

    Dense tier (``groups=G``): ``sum`` / ``mean`` / ``count`` skip the sort
    (:func:`_distributed_group_reduce_dense`), gated as the local tier
    (``planes * bins <= 2^17``); shards then hold ``ceil(G/D)`` rows, and
    keys outside [0, G) are dropped (``validate=True`` raises instead).
    ``exchange`` is the sort's (the port's keyword: a gloo group of CUDA
    ranks needs ``"rdma"``).
    """
    if reduce not in ("sum", "mean", "min", "max", "count"):
        raise ValueError(f"reduce must be sum|mean|min|max|count, got {reduce!r}")
    D = axis_size(mesh, axis_name)
    if groups is not None:
        groups = int(groups)
        if groups < 1:
            raise ValueError(f"groups must be >= 1, got {groups}")
        if not extras._dense_ok(keys):
            raise TypeError("groups promises non-negative integer keys < groups; "
                            f"got key dtype {extras._dtype_of(keys)}")
        if validate and int(keys.shape[0] if torch.is_tensor(keys) else len(keys)):
            kt, kd = _as_input(keys, mesh)
            hi = extras._max_u32(extras._u32_values(kt, kd))
            if mesh.group is not None:      # every process raises alike
                hi = max(_mesh._gather_ints([hi], mesh))
            if hi >= groups:
                raise ValueError(f"group keys outside [0, {groups}): max raw bits 0x{hi:X}")
        planes = _dense_planes(reduce, values)
        if planes is not None and planes * (1 << max(2, (groups - 1).bit_length())) \
                <= extras._DENSE_BUDGET:
            return _distributed_group_reduce_dense(keys, values, mesh, reduce, groups)
    kw, kdtype = _as_words(keys, False, mesh)
    if reduce == "count":
        if values is not None:
            raise ValueError("reduce='count' takes values=None")
        vw, vdtype = (), None
    else:
        vw, vdtype = _as_words(values, False, mesh)
        vw = tuple(v.to(kw[0].device) for v in vw)
        if kw[0].shape != vw[0].shape:
            raise ValueError("values must match the keys' length")
        if reduce in ("sum", "mean") and len(vw) > 1:
            raise ValueError(
                "distributed sum/mean needs single-plane (<= 32-bit) values; "
                "64-bit sums would need 64-bit cross-shard arithmetic — reduce "
                "min/max, or pre-scale to 32 bits")
    nk, nv = len(kw), len(vw)
    out, sort_counts, overflow = _run_balanced(kw + vw, mesh, axis_name,
                                               num_key_planes=nk + nv, strict=False,
                                               chunk=chunk, exchange=exchange)
    n_local = int(out[0][0].shape[0])
    acc = extras._accum_dtype(vdtype) if reduce in ("sum", "mean") else None

    # per-rank runs and edge summaries
    ranks = []
    for planes, nvalid in zip(out, sort_counts):
        kp, vp = planes[:nk], planes[nk:]
        dev = kp[0].device
        nvalid = nvalid[0].long()
        slot = torch.arange(n_local, device=dev)
        valid = slot < nvalid
        neq = slot == 0
        for p in kp:
            neq = neq | (p != torch.roll(p, 1))
        is_new = neq & valid
        r = is_new.sum()
        starts = nonzero_static(is_new, n_local, n_local)
        live = slot < r
        at = starts.clamp(0, n_local - 1)
        nxt = torch.minimum(torch.where(slot == n_local - 1, n_local,
                                        torch.roll(starts, -1)), nvalid)
        ends = (nxt - 1).clamp(0, n_local - 1)
        lens = torch.where(live, nxt - starts, 0)
        keys_out = tuple(torch.where(live, p[at], _SENTINEL) for p in kp)
        rk = {"r": r, "nvalid": nvalid, "keys_out": keys_out, "lens": lens,
              "rl": (r - 1).clamp(0, n_local - 1), "first": [p[0] for p in kp],
              "last": [p[(nvalid - 1).clamp(0, n_local - 1)] for p in kp]}
        if reduce in ("sum", "mean"):
            v = kdf.decode((vp[0],), vdtype)
            if acc.is_floating_point:
                cs = torch.cumsum(torch.where(valid, v.to(acc), 0), 0)
            else:   # exact in int64; the low 32 bits are the wrapping sums
                cs = torch.cumsum(torch.where(valid, extras._int64_values(v, vdtype), 0), 0)
            c0 = torch.cat([cs.new_zeros(1), cs])
            rk["sums"] = torch.where(live, c0[ends + 1] - c0[at], 0)
        elif reduce == "min":
            rk["red_w"] = tuple(torch.where(live, p[at], 0) for p in vp)
        elif reduce == "max":
            rk["red_w"] = tuple(torch.where(live, p[ends], 0) for p in vp)
        ranks.append(rk)

    # one all-gather of the edge summaries; the carry scan on the first
    # local rank's device (replicated in the JAX package; on every process of
    # a group)
    def gath(f):
        return _mesh.all_gather([f(rk) for rk in ranks], mesh)[0]

    g_nonempty = gath(lambda rk: rk["nvalid"] > 0)
    g_single = gath(lambda rk: rk["r"] <= 1)
    link = g_nonempty[1:] & g_nonempty[:-1]                 # (D-1,)
    for i in range(nk):
        f, l = gath(lambda rk: rk["first"][i]), gath(lambda rk: rk["last"][i])
        link = link & (l[:-1] == f[1:])
    dev0 = mesh.devices[0]
    inc = None
    if reduce in ("sum", "mean", "count"):
        trails = ([gath(lambda rk: rk["sums"][rk["rl"]])] if reduce != "count" else []) \
            + [gath(lambda rk: rk["lens"][rk["rl"]])]
        carry = [torch.zeros((), dtype=t.dtype, device=dev0) for t in trails]
        incs = [[c] for c in carry]                          # rank 0 receives nothing
        for d in range(D - 1):
            carry = [torch.where(link[d], t[d] + torch.where(g_single[d], c, 0), 0)
                     for t, c in zip(trails, carry)]
            for lst, c in zip(incs, carry):
                lst.append(c)
        inc = [torch.stack(lst) for lst in incs]            # (D,) each
    elif reduce == "min":
        g_tw = [gath(lambda rk: rk["red_w"][i][rk["rl"]]) for i in range(nv)]
        has = torch.zeros((), dtype=torch.bool, device=dev0)
        cw = [torch.zeros((), dtype=torch.int32, device=dev0) for _ in range(nv)]
        has_l, cw_l = [has], [[c] for c in cw]
        for d in range(D - 1):
            cw = [torch.where(g_single[d] & has, c, t[d]) for t, c in zip(g_tw, cw)]
            has = link[d]
            has_l.append(has)
            for lst, c in zip(cw_l, cw):
                lst.append(c)
        inc = [torch.stack(has_l)] + [torch.stack(lst) for lst in cw_l]
    inc = [_mesh.replicate(t, mesh) for t in inc] if inc is not None else None
    link_out = _mesh.replicate(torch.cat([link, link.new_zeros(1)]), mesh)

    keys_sh, red_sh, emits = [], [], []
    for me, rk in enumerate(ranks):
        g = mesh.ranks[me]
        dev = rk["lens"].device
        slot = torch.arange(n_local, device=dev)
        # emit each run exactly once: the shard where it ends keeps it
        emit = (rk["r"] - link_out[me][g].long()).clamp(min=0)
        live2 = slot < emit
        keys_sh.append(tuple(torch.where(live2, w, _SENTINEL) for w in rk["keys_out"]))
        emits.append(emit.to(torch.int32).reshape(1))
        lens = rk["lens"].clone()
        if reduce in ("sum", "mean"):
            sums = rk["sums"].clone()
            sums[0] += inc[0][me][g]
            lens[0] += inc[1][me][g]
            if not acc.is_floating_point:
                sums = cuda_kernels.low32(sums)
                if acc == torch.uint32:
                    sums = sums.view(torch.uint32)
            if reduce == "mean":
                red_sh.append(torch.where(
                    live2, extras._to_float(sums, torch.float32)
                    / lens.clamp(min=1).to(torch.float32), 0.0))
            else:
                red_sh.append(extras._where_live(live2, sums))
        elif reduce == "count":
            lens[0] += inc[0][me][g]
            red_sh.append(torch.where(live2, lens, 0).to(torch.int32))
        else:
            red_w = list(rk["red_w"])
            if reduce == "min":
                has_inc = inc[0][me][g]
                red_w = [torch.cat([torch.where(has_inc, iw[me][g], w[0]).reshape(1), w[1:]])
                         for w, iw in zip(red_w, inc[1:])]
            red_sh.append(tuple(torch.where(live2, w, 0) for w in red_w))
    ukeys = _decode(keys_sh, kdtype, False)
    reduced = _decode(red_sh, vdtype, False) if reduce in ("min", "max") else tuple(red_sh)
    return ukeys, reduced, tuple(emits), overflow



def distributed_select(x, ranks, mesh: SortMesh, axis_name: str = "shards",
                       descending: bool = False):
    """Exact order statistics of a mesh-sharded array, without a full sort.

    The values at the given global ``ranks`` (0-based positions of the
    stably sorted sequence in the requested order): one local sort of each
    shard with a global-slot tiebreak, then the bitwise selection of
    :func:`_select_pivots`, no exchange. Returns a (len(ranks),) tensor of
    x's dtype on the first rank's device.
    """
    ranks = [int(r) for r in ranks]
    D = axis_size(mesh, axis_name)
    words, dtype = _as_words(x, descending, mesh)
    lay = _layout(mesh, int(words[0].shape[0]), D)
    n, n_local = lay.n, lay.n_local
    if not ranks:
        raise ValueError("ranks must be non-empty")
    if not all(0 <= r < n for r in ranks):
        raise ValueError(f"ranks must be in [0, {n})")
    _check_selection_width(D * n_local)
    planes = _pad(words, lay.pad)
    targets = torch.tensor(ranks, dtype=torch.int64, device=mesh.devices[0])
    if D == 1:
        s = _local_sort(_shard_planes(planes, mesh)[0], len(planes))
        return kdf.decode(tuple(p[targets] for p in s), dtype, descending)
    slots = _mesh.shard(_gindex(lay, planes[0]), mesh)
    parts = [_local_sort(ps + (slot,), len(ps) + 1)
             for ps, slot in zip(_shard_planes(planes, mesh), slots)]
    piv = _select_pivots(parts, [_search_key(p) for p in parts], targets, mesh, n_local)
    # drop the slot plane: the key planes ARE the values at the ranks
    return kdf.decode(piv[: len(planes)], dtype, descending)


def distributed_quantile(x, q, mesh: SortMesh, axis_name: str = "shards",
                         method: str = "linear"):
    """Exact quantiles of a mesh-sharded array, without a full sort.

    The order statistics come from ONE :func:`distributed_select` over the
    distinct take ranks, and the interpolation (numpy's five methods) runs
    on the O(#quantiles) result: in float32 on the device, or, for 64-bit
    keys, in float64 on the host with numpy's own rounding (as the JAX
    package does with x64 off; the result is then numpy). ``q`` is a float
    or a sequence in [0, 1].
    """
    from ..stats import _Q_METHODS, _quantile_combine, _quantile_positions

    if method not in _Q_METHODS:
        raise ValueError(f"method must be one of {_Q_METHODS}, got {method!r}")
    scalar = np.ndim(q) == 0
    qs = np.atleast_1d(np.asarray(q, np.float64))
    if qs.ndim != 1:
        raise ValueError(f"q must be a scalar or 1-D sequence, got shape {qs.shape}")
    if qs.size and (np.min(qs) < 0.0 or np.max(qs) > 1.0):
        raise ValueError("quantile probabilities must lie in [0, 1]")
    shape = tuple(x.shape) if torch.is_tensor(x) else np.shape(x)
    if len(shape) != 1:
        raise ValueError(f"keys must be 1-D, got shape {shape}")
    n = shape[0] * mesh.num_processes      # a group mesh: equal slices
    if n == 0:
        raise ValueError("quantile of an empty array is undefined")
    lo_i, hi_i, frac = _quantile_positions(qs, n, method)
    ranks = sorted({*lo_i.tolist(), *hi_i.tolist()})
    sel = distributed_select(x, ranks, mesh, axis_name=axis_name)
    pos = {r: i for i, r in enumerate(ranks)}
    li = [pos[int(r)] for r in lo_i]
    hi_ = [pos[int(r)] for r in hi_i]
    if sel.element_size() == 8:
        sel = kdf.to_numpy(sel)
        out = _quantile_combine(sel[li], sel[hi_], frac, method)
    else:
        def take(i):
            return hw_engine.gather(sel, torch.tensor(i, device=sel.device))
        out = _quantile_combine(take(li), take(hi_), frac, method)
    return out[0] if scalar else out


def distributed_median(x, mesh: SortMesh, axis_name: str = "shards"):
    """Exact median: :func:`distributed_quantile` at 0.5."""
    return distributed_quantile(x, 0.5, mesh, axis_name=axis_name)


def distributed_top_k(x, k: int, mesh: SortMesh, axis_name: str = "shards",
                      largest: bool = True, index_dtype=torch.uint32):
    """Global top-k of a mesh-sharded array, on the first rank's device.

    Best-first values with their stable original indices (ties to the lower
    global index), from the union-of-local-top-k identity: every global
    top-k element has local rank < k in its shard, so one local composite
    sort per shard, one all-gather of D * k candidate rows and one sort of
    those select the exact result. ``k`` must be in [1, n/D]. Returns
    ``(values, indices)`` of length k, the indices as ``index_dtype``.
    """
    from .. import api

    words, dtype = _as_words(x, largest, mesh)
    D = axis_size(mesh, axis_name)
    lay = _layout(mesh, int(words[0].shape[0]), D)
    n, n_local = lay.n, lay.n_local
    pad_total = D * n_local - n
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if k > n_local:
        raise ValueError(
            f"k={k} exceeds the shard size {n_local}: each shard holds only "
            f"n/D candidates — use distributed_sort_balanced and slice")
    idt = api._index_dtype(index_dtype)
    api._check_index_width(n + pad_total, idt)
    # pad with the KDF-order maximum: pads sort last and never displace a
    # real candidate (k <= n); real elements keep slot == original index
    planes = _pad(words, lay.pad)
    nw = len(planes)
    gidx = _gindex(lay, planes[0])
    if D == 1:
        out = _local_sort(planes + (gidx,), nw + 1)
    else:
        local = [_local_sort(ps + (slot,), nw + 1)
                 for ps, slot in zip(_shard_planes(planes, mesh), _mesh.shard(gidx, mesh))]
        cand = [_mesh.all_gather([loc[i][:k] for loc in local], mesh, tiled=True)[0]
                for i in range(nw + 1)]
        out = _local_sort(cand, nw + 1)
    return (kdf.decode(tuple(w[:k] for w in out[:nw]), dtype, largest),
            out[nw][:k].long().to(idt))
