"""Distributed sort: skew-aware top-digit shuffle across a mesh of ranks.

The counterpart of ``radix_sorting_tpu.parallel.shuffle``: every rank keeps
a shard of the keys, and one exchange re-shards them by key range so that
local sorts finish the job. The JAX package maps one SPMD body over its mesh
with ``shard_map``; here the body is a sequence of steps, each a loop over
the ranks of a :class:`._mesh.SortMesh`, with the collectives of
:mod:`._mesh` between them. The steps keep the JAX body's numbering:

  0. optional deal: a fixed all-to-all that interleaves the shards;
  1. local sort of the shard by the full derived key;
  2. global splitter histogram of the top ``splitter_bits`` of each key
     (adaptive: left-aligned at the highest live bit), summed over ranks;
  3. skew-aware bucket -> rank assignment from the exact global histogram;
  4. one all-to-all of fixed-capacity, sentinel-padded runs (``"xla"``:
     :func:`._mesh.all_to_all`; ``"rdma"``: K13 through
     :func:`.rdma.rdma_all_to_all`), with overflow detected, never silent;
  5. local merge of the received runs.

Words are int32 planes carrying u32 bit patterns (:mod:`..ops.kdf`): the
sentinel 0xFFFFFFFF is -1, order is unsigned (sign-flipped) and every right
shift is masked. The local sorts are :func:`..ops.hw_engine.sort_words`, the
port's ``torch.sort`` stand-in for ``lax.sort``; keys-only sorts may be
unstable, and every sort that carries a payload has a strict key (an index
plane), so its order does not depend on stability.

Results are per-rank: each sharded output is a tuple of one tensor a local
rank, shard ``i`` on local rank ``i``'s device (``torch.cat`` gathers them);
``counts`` and ``overflow`` are tuples of (1,) int32 tensors. A numpy input
is placed on the mesh's first device and sharded from there; a tensor is
sharded from its own device. Decoded values are tensors of the key dtype
(carriers for the numpy-only dtypes, :mod:`..ops.kdf`).

On a group mesh (:mod:`._mesh`) every process passes its own slice of the
keys, the counterpart of ``jax.make_array_from_process_local_data``: the
slices are equal (a process whose slice differs raises ValueError on every
process, after one all_gather of the lengths), the global array is their
concatenation in process order, and a sharded output holds this process's
ranks only. Where the global length needs pad rows, each process appends
the same number to its slice (the single-controller form appends them all
at the global tail); they are maximal rows either way, so every output is
the same. ``gather_sorted(..., mesh=)`` gathers a sharded output over the
group (without ``mesh=`` it raises there).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import api
from ..ops import hw_engine, kdf
from ..ops.histogram import digit_histogram
from ..ops.probes import and_reduce, or_reduce
from . import _mesh
from ._mesh import SortMesh, axis_size

__all__ = [
    "distributed_sort",
    "distributed_argsort",
    "distributed_sort_pairs",
    "distributed_sort_u32",
    "distributed_argsort_u32",
    "distributed_sort_pairs_u32",
    "gather_sorted",
    "make_sort_mesh",
]

_SENTINEL = -1      # 0xFFFFFFFF in an int32 plane


def make_sort_mesh(num_devices: Optional[int] = None, axis_name: str = "shards", *,
                   devices=None, group=None) -> SortMesh:
    """1-D mesh over ``devices`` (which may name one device more than once),
    or by default over every CUDA device, ``cuda:0`` to ``cuda:k-1``; the
    first ``num_devices`` of them when given. Without a card and without
    ``devices=`` it raises RuntimeError: no path falls back to the CPU.

    With ``group`` (a ``torch.distributed`` process group; every process of
    it calls this together) the devices are this process's ranks, the
    counterpart of the JAX worker's global mesh after
    ``jax.distributed.initialize``: the visible CUDA devices by default,
    which a launcher scopes per process (one card a process), or
    ``devices=`` (e.g. ``["cpu"] * 4`` for four ranks a process over
    gloo); every process must drive the same number (one all_gather of the
    numbers checks it)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_sort_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * 8) to build a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if num_devices is not None:
        if num_devices > len(devs):
            # a silent devs[:n] clip would report results for a smaller mesh
            # than the caller believes it measured
            raise ValueError(f"make_sort_mesh: requested {num_devices} devices, only "
                             f"{len(devs)} available")
        devs = devs[:num_devices]
    mesh = SortMesh(devs, axis_name, group)
    if group is not None:
        local = _mesh._gather_ints([len(devs)], mesh)
        if len(set(local)) != 1:
            raise ValueError(f"make_sort_mesh: every process of a group mesh drives the "
                             f"same number of ranks; the processes drive {local}")
    return mesh


# ---------------------------------------------------------------------------
# helpers shared with .balanced


def _as_input(x, mesh: SortMesh):
    """(dense 1-D tensor, key dtype) of a global array: a tensor as it is,
    numpy on the mesh's first device."""
    t, dtype, _ = api._as_input(x, None if torch.is_tensor(x) else mesh.devices[0])
    return t, dtype


def _as_words(x, descending: bool, mesh: SortMesh):
    """KDF-encode a global key array: (int32 word planes, key dtype). A
    numpy input goes to the mesh's first device."""
    words, dtype, _ = api._as_words(x, descending,
                                    None if torch.is_tensor(x) else mesh.devices[0])
    return tuple(words), dtype


def _decode(planes_by_rank, dtype, descending: bool) -> tuple:
    """Each rank's word planes decoded to its shard of keys."""
    return tuple(kdf.decode(tuple(p), dtype, descending) for p in planes_by_rank)


class _Layout(NamedTuple):
    """Where a call's rows lie. ``n`` keys in all, ``s`` of them this
    process's (all of them without a group); ``n_local`` rows a rank, pad
    rows included; this process appends ``pad`` pad rows to its slice (the
    same number on every process). Global index ``first + j`` is key ``j``
    of the slice, ``pad_first + j`` its pad row ``j``."""
    n: int
    s: int
    n_local: int
    pad: int
    first: int
    pad_first: int


def _layout(mesh: SortMesh, s: int, multiple: int) -> _Layout:
    """The layout of ``s`` keys a process, padded to the least multiple of
    ``multiple`` (a multiple of D). On a group mesh the slices must be equal:
    one all_gather of their lengths, and every process raises if they
    differ."""
    P, me = mesh.num_processes, mesh.process_index
    if P > 1:
        lens = _mesh._gather_ints([s], mesh)
        if len(set(lens)) != 1:
            raise ValueError(f"every process passes a slice of the same length; the "
                             f"processes pass {lens} keys")
    n = s * P
    pad_total = (-n) % multiple
    return _Layout(n, s, (n + pad_total) // mesh.size, pad_total // P, me * s,
                   n + me * (pad_total // P))


def _gindex(lay: _Layout, like: torch.Tensor) -> torch.Tensor:
    """The global index of each of this process's padded rows, an int32
    plane: ``0..n + pad_total - 1`` without a group, pad rows after every
    key."""
    idx = torch.arange(lay.s + lay.pad, dtype=torch.int32, device=like.device)
    return torch.where(idx < lay.s, idx + lay.first, idx - lay.s + lay.pad_first)


def _pad(planes, total: int, fills=None) -> tuple:
    """Append ``total`` rows to each of this process's planes: the sentinel,
    or ``fills[i]`` (a tensor) for plane i where given."""
    if not total:
        return tuple(planes)
    return tuple(torch.cat([p, p.new_full((total,), _SENTINEL)
                            if fills is None or fills[i] is None else fills[i]])
                 for i, p in enumerate(planes))


def _shard_planes(planes, mesh: SortMesh):
    """This process's planes -> per-rank tuples of planes."""
    cols = [_mesh.shard(p, mesh) for p in planes]
    return [tuple(c[r] for c in cols) for r in range(len(mesh.devices))]


def _local_sort(planes, num_keys: int) -> tuple:
    """``lax.sort(planes, num_keys=num_keys, is_stable=False)``: keys-only
    sorts unstable; with payload planes a stable sort (the callers' keys
    are strict there, so the order is the same)."""
    planes = tuple(planes)
    keys, rest = planes[:num_keys], planes[num_keys:]
    sw, sp = hw_engine.sort_words(keys, rest, stable=bool(rest))
    return tuple(sw) + tuple(sp)


def _ints(values, mesh: SortMesh):
    """Host ints, one a local rank, as per-rank (1,) int32 tensors."""
    return tuple(torch.tensor([int(v)], dtype=torch.int32, device=dev)
                 for v, dev in zip(values, mesh.devices))


def _exchange(sends, mesh: SortMesh, axis: int, exchange: str):
    """The bulk all-to-all of per-rank sends along ``axis``. Never over gloo
    for CUDA tensors (:func:`._mesh._check_bulk`)."""
    if exchange == "rdma":
        from .rdma import rdma_all_to_all
        return rdma_all_to_all(sends, mesh, axis=axis)
    _mesh._check_bulk(mesh, sends, "exchange='xla'")
    return _mesh.all_to_all(sends, mesh, axis=axis)


def _clz(m: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the u32 bit pattern of the 0-d int32 ``m`` (32 for
    0), on the device."""
    shifts = torch.arange(32, device=m.device)
    return 32 - ((m.long() & 0xFFFFFFFF) >> shifts).ne(0).sum()


# ---------------------------------------------------------------------------
# the shuffle


def _device_of_bucket(global_hist: torch.Tensor, num_devices: int) -> torch.Tensor:
    """Assign each splitter bucket to a rank, balancing exact global mass.

    Bucket b goes to rank floor(excl_cum[b] * D / total), computed exactly
    as the number of thresholds t_d = ceil(total * d / D), d = 1..D-1, that
    excl_cum[b] reaches, with total = q * D + rem and t_d = q * d +
    ceil(rem * d / D) (the JAX package's exact int32 form; int64 here).
    Contiguous, monotone in b, every rank within one bucket's mass of n/D.
    """
    counts = global_hist.long()
    excl = torch.cumsum(counts, 0) - counts
    total = counts.sum().clamp(min=1)
    d = torch.arange(1, num_devices, device=counts.device)
    q, rem = total // num_devices, total % num_devices
    thresh = q * d + (rem * d + num_devices - 1) // num_devices
    return (excl[:, None] >= thresh[None, :]).sum(1)


def _shard_body(shards, mesh: SortMesh, splitter_bits: int, capacity_per_peer: int,
                deal: bool, num_key_planes: int, valid_rows: int, exchange: str = "xla"):
    """The SPMD body over this process's ranks. ``shards[i]`` is local rank
    i's tuple of (n_local,) planes: the first ``num_key_planes`` are key
    planes (plane 0 drives the partition), the rest payload. With an index
    key plane the order is strict. n_local % D == 0. The first
    ``valid_rows`` rows of the process's shards are keys, the rest pads.
    Returns each local rank's (merged planes, count (1,), overflow (1,))."""
    D, L = mesh.size, len(shards)
    n_local = int(shards[0][0].shape[0])
    nbuckets = 1 << splitter_bits
    nplanes = len(shards[0])

    # Live-bit reduction over *valid* keys only, before the deal, where each
    # rank knows which of its slots are ragged-n pads: pads would force the
    # adaptive splitter domain to full scale.
    local_or, local_and = [], []
    for r, planes in enumerate(shards):
        w = planes[0]
        slot = r * n_local + torch.arange(n_local, device=w.device)
        is_valid = slot < valid_rows
        local_or.append(or_reduce(torch.where(is_valid, w, 0)))
        local_and.append(and_reduce(torch.where(is_valid, w, _SENTINEL)))
    gor = or_reduce(_mesh.all_gather(local_or, mesh)[0])
    gand = and_reduce(_mesh.all_gather(local_and, mesh)[0])
    gmask = gor ^ gand
    all_equal = _mesh.replicate(gmask == 0, mesh)
    lshift = _mesh.replicate(_clz(gmask).clamp(max=31), mesh)

    # 0. optional deal: a fixed all-to-all that re-interleaves the shards so
    # that every rank holds an even sample of the global array (without it a
    # presorted input sends each source's whole shard to one peer). Under
    # exchange="rdma" it rides K13 too, all planes stacked in one call.
    if deal:
        sends = [torch.stack([p.reshape(D, n_local // D) for p in planes])
                 for planes in shards]                    # (P, D, n_local / D)
        dealt = _exchange(sends, mesh, 1, exchange)
        shards = [tuple(t[i].reshape(-1) for i in range(nplanes)) for t in dealt]

    # 1. local sort. Keys-only: unstable is exact; with an index tiebreak
    # plane the order is strict.
    sorted_planes = [_local_sort(planes, num_key_planes) for planes in shards]

    # 2. adaptive splitter domain: buckets left-aligned at the globally
    # highest live bit; exact global splitter histogram by psum. Sentinel
    # pads saturate to the top bucket and route to rank D-1 like any
    # maximal key.
    buckets, local_hist = [], []
    for r, planes in enumerate(sorted_planes):
        ws = planes[0].long() & 0xFFFFFFFF
        b = ((ws << lshift[r]) & 0xFFFFFFFF) >> (32 - splitter_bits)
        buckets.append(b)
        local_hist.append(digit_histogram(b, nbuckets))
    global_hist = _mesh.psum(local_hist, mesh)

    out_counts, sends = [], []
    C = capacity_per_peer
    for r in range(L):
        # 3. skew-aware bucket -> rank assignment (identical on every rank)
        dev_of_bucket = _device_of_bucket(global_hist[r], D)
        # destination rank per local key; non-decreasing because ws is sorted
        out_counts.append(digit_histogram(dev_of_bucket[buckets[r]], D))
    # 4. pack runs into (planes, D, C) slots, sentinel-padded, and exchange
    # in ONE collective. A run larger than C cannot ship this round: that is
    # detected and reported through the overflow flag.
    overflow = _mesh.psum([(c > C).sum(dtype=torch.int32) for c in out_counts], mesh)
    for r, planes in enumerate(sorted_planes):
        dev = planes[0].device
        starts = torch.cumsum(out_counts[r], 0) - out_counts[r]
        out_counts[r] = out_counts[r].clamp(max=C)
        j = torch.arange(C, device=dev)
        flat_idx = (starts[:, None] + j[None, :]).clamp(0, n_local - 1)
        valid = j[None, :] < out_counts[r][:, None]
        sends.append(torch.stack([torch.where(valid, p[flat_idx], _SENTINEL)
                                  for p in planes]))        # (planes, D, C)
    recv = _exchange(sends, mesh, 1, exchange)
    recv_counts = _mesh.all_to_all(out_counts, mesh)

    # 5. local merge of the received runs; sentinels sort to the tail (the
    # sentinel index plane is maximal too, so key ties keep real rows ahead)
    outs = []
    bypass_ok = (num_key_planes == 1 and nplanes == 1
                 and valid_rows == L * n_local)
    for r in range(L):
        merged = _local_sort(tuple(recv[r][i].reshape(-1) for i in range(nplanes)),
                             num_key_planes)
        count = recv_counts[r].sum(dtype=torch.int32)
        ovf = overflow[r]
        # all-equal bypass (keys-only, no ragged pads): every shard already
        # holds a sorted run of the one value; no movement, no hotspot
        if bypass_ok:
            ws = sorted_planes[r][0]
            bypass = (torch.cat([ws, ws.new_full((D * C - n_local,), _SENTINEL)])
                      if D * C > n_local else ws[: D * C])
            merged = (torch.where(all_equal[r], bypass, merged[0]),)
            count = torch.where(all_equal[r], n_local, count).to(torch.int32)
            ovf = torch.where(all_equal[r], 0, ovf).to(torch.int32)
        outs.append((merged, count.reshape(1), ovf.reshape(1)))
    return outs


def _run_shuffle(planes, mesh: SortMesh, axis_name, splitter_bits, slack, exact,
                 num_key_planes, exchange="xla"):
    """Pad, run the shuffle body over the mesh, adjust counts. Returns
    (per-rank planes, counts, overflow)."""
    if exchange not in ("xla", "rdma"):
        raise ValueError(f"exchange must be 'xla' or 'rdma', got {exchange!r}")
    D = axis_size(mesh, axis_name)
    lay = _layout(mesh, int(planes[0].shape[0]), D * D)
    n = lay.n
    if n < D * D:
        raise ValueError(f"n={n} too small for a {D}-device shuffle (need n >= D^2)")
    # pad to a multiple of D^2 with maximal sentinel rows: they sort to the
    # global tail, so the count adjustment below is exact
    pad_total = D * lay.n_local - n
    planes = _pad(planes, lay.pad)
    n_local = lay.n_local
    if exact:
        cap = n_local
    else:
        expect = -(-n_local // D)
        cap = min(n_local,
                  int(expect * (1.0 + slack)) + -(-n_local // (1 << splitter_bits)) + 8)
    outs = _shard_body(_shard_planes(planes, mesh), mesh, splitter_bits, cap,
                       deal=not exact, num_key_planes=num_key_planes, valid_rows=lay.s,
                       exchange=exchange)
    sorted_planes = [o[0] for o in outs]
    counts = tuple(o[1] for o in outs)
    overflow = tuple(o[2] for o in outs)
    if pad_total:
        # pad rows are globally maximal, so they occupy the TAIL of the
        # valid sequence, usually all on rank D-1 but possibly on an earlier
        # rank for a degenerate input: rank d sheds clip(pad_total - (# shed
        # by the ranks after d), 0, counts[d])
        c = _mesh.all_gather(counts, mesh, tiled=True)[0]
        suffix_after = torch.flip(torch.cumsum(torch.flip(c, (0,)), 0), (0,)) - c
        shed = torch.minimum((pad_total - suffix_after).clamp(min=0), c)
        c = (c - shed).to(torch.int32)
        counts = tuple(c[r:r + 1].to(dev) for r, dev in zip(mesh.ranks, mesh.devices))
    return sorted_planes, counts, overflow


def _u32_plane(x, mesh: SortMesh) -> torch.Tensor:
    """A global u32 array (tensor or numpy) as its int32 plane."""
    t, _ = _as_input(x, mesh)
    if t.element_size() != 4:
        raise ValueError(f"expected a 1-D 32-bit array, got {t.dtype} {tuple(t.shape)}")
    return t.contiguous().view(torch.int32)


def _iota(like: torch.Tensor, mesh: SortMesh) -> torch.Tensor:
    """The global index of each of this process's keys ``like`` (all of
    them: 0..n-1 without a group), int32 carriers of u32."""
    s = int(like.shape[0])
    return torch.arange(s, dtype=torch.int32, device=like.device) + mesh.process_index * s


def _as_u32(planes_by_rank, i: int) -> tuple:
    return tuple(p[i].view(torch.uint32) for p in planes_by_rank)


def distributed_sort_u32(x, mesh: SortMesh, axis_name: str = "shards",
                         splitter_bits: int = 12, slack: float = 0.5,
                         exact: bool = False, exchange: str = "xla"):
    """Sort a u32 array sharded over a 1-D mesh (keys only).

    ``x``: (n,) uint32, n >= D^2 (any remainder is padded internally).
    ``splitter_bits``: top bits used for range partitioning. ``slack``:
    per-peer capacity headroom over the uniform expectation n/D^2; a run
    that exceeds capacity is detected and reported, never dropped silently.
    ``exact``: capacity = the full local shard (always correct, D-fold
    exchange memory): the escape hatch when the overflow flag is set.

    Returns (sorted_padded, counts, overflow), each a per-rank tuple: shard
    d's first ``counts[d]`` keys (uint32) are its range of the sorted
    sequence, the tail is sentinel-padded; ``overflow`` non-zero means the
    capacity was exceeded and the result is incomplete.
    """
    sp, counts, overflow = _run_shuffle((_u32_plane(x, mesh),), mesh, axis_name,
                                        splitter_bits, slack, exact, num_key_planes=1,
                                        exchange=exchange)
    return _as_u32(sp, 0), counts, overflow


def distributed_argsort_u32(x, mesh: SortMesh, axis_name: str = "shards",
                            splitter_bits: int = 12, slack: float = 0.5,
                            exact: bool = False, exchange: str = "xla"):
    """Distributed stable rank sort of a mesh-sharded u32 array: the global
    index rides as a second key plane, so the order is strict and the
    permutation is the unique stable one. Returns (sorted_keys_padded,
    perm_padded, counts, overflow); perm shards are uint32 global indices."""
    w = _u32_plane(x, mesh)
    sp, counts, overflow = _run_shuffle((w, _iota(w, mesh)), mesh, axis_name,
                                        splitter_bits, slack, exact, num_key_planes=2,
                                        exchange=exchange)
    return _as_u32(sp, 0), _as_u32(sp, 1), counts, overflow


def distributed_sort_pairs_u32(x, payload, mesh: SortMesh, axis_name: str = "shards",
                               splitter_bits: int = 12, slack: float = 0.5,
                               exact: bool = False, exchange: str = "xla"):
    """Distributed stable record sort: u32 keys and one u32 payload plane
    (stability by the global-index tiebreak). Returns (sorted_keys_padded,
    payload_padded, counts, overflow)."""
    w = _u32_plane(x, mesh)
    p = _payload_u32(payload, w)
    sp, counts, overflow = _run_shuffle((w, _iota(w, mesh), p), mesh, axis_name,
                                        splitter_bits, slack, exact, num_key_planes=2,
                                        exchange=exchange)
    return _as_u32(sp, 0), _as_u32(sp, 2), counts, overflow


def _payload_u32(payload, w: torch.Tensor) -> torch.Tensor:
    """``payload.astype(uint32)`` as an int32 plane on ``w``'s device."""
    from ..extras import _u32_values
    t, dtype, _ = api._as_input(payload, None if torch.is_tensor(payload) else w.device)
    if t.shape != w.shape:
        raise ValueError("payload must match the keys' length")
    return _u32_values(t.to(w.device), dtype)


def _check_method_kwargs(method: str, kw) -> None:
    _ALLOWED = {"balanced": {"chunk", "overlap", "exchange"},
                "shuffle": {"splitter_bits", "slack", "exact", "exchange"}}
    if method not in _ALLOWED:
        raise ValueError(f"unknown method {method!r}; 'balanced' or 'shuffle'")
    stray = set(kw) - _ALLOWED[method]
    if stray:
        raise TypeError(
            f"method={method!r} does not accept {sorted(stray)}; "
            f"valid options: {sorted(_ALLOWED[method])} "
            "(the balanced partition needs no exact/slack escape hatches)")


def _shuffle_kw(kw) -> tuple:
    return (kw.get("splitter_bits", 12), kw.get("slack", 0.5), kw.get("exact", False))


def distributed_sort(x, mesh: SortMesh, axis_name: str = "shards",
                     descending: bool = False, method: str = "balanced", **kw):
    """Dtype-generic distributed sort: any supported key dtype, either order.

    ``method="balanced"`` (default): exact-quantile partition and a
    multi-round chunked exchange (:mod:`.balanced`), balanced shards for any
    input, no overflow. ``"shuffle"``: the single-exchange top-digit bucket
    shuffle, which skew can overflow (detected; retry with ``exact=True``)
    and which partitions 64-bit keys on the high word only.

    Returns (sorted_padded_values, counts, overflow), per-rank tuples;
    padding slots decode from the sentinel key and are dropped via counts
    (:func:`gather_sorted`).
    """
    _check_method_kwargs(method, kw)
    if method == "balanced":
        from .balanced import distributed_sort_balanced
        return distributed_sort_balanced(
            x, mesh, axis_name, descending=descending, chunk=kw.get("chunk"),
            overlap=kw.get("overlap", False), exchange=kw.get("exchange", "xla"))
    words, dtype = _as_words(x, descending, mesh)
    sp, counts, overflow = _run_shuffle(words, mesh, axis_name, *_shuffle_kw(kw),
                                        num_key_planes=len(words),
                                        exchange=kw.get("exchange", "xla"))
    return _decode(sp, dtype, descending), counts, overflow


def distributed_argsort(x, mesh: SortMesh, axis_name: str = "shards",
                        descending: bool = False, method: str = "balanced", **kw):
    """Dtype-generic distributed stable rank sort, either method.

    Returns (sorted_values_padded, perm_padded, counts, overflow); the
    permutation (uint32 shards) is the unique stable one for the requested
    order (global-index tiebreak plane). With 64-bit keys the shuffle
    partitions on the high word only; the balanced method on the full key.
    """
    _check_method_kwargs(method, kw)
    if method == "balanced":
        from .balanced import distributed_argsort_balanced
        return distributed_argsort_balanced(x, mesh, axis_name, descending=descending, **kw)
    words, dtype = _as_words(x, descending, mesh)
    nw = len(words)
    out, counts, overflow = _run_shuffle(words + (_iota(words[0], mesh),),
                                         mesh, axis_name, *_shuffle_kw(kw),
                                         num_key_planes=nw + 1,
                                         exchange=kw.get("exchange", "xla"))
    return (_decode([o[:nw] for o in out], dtype, descending), _as_u32(out, nw),
            counts, overflow)


def distributed_sort_pairs(keys, values, mesh: SortMesh, axis_name: str = "shards",
                           descending: bool = False, method: str = "balanced", **kw):
    """Dtype-generic distributed stable record sort, either method.

    ``values`` is a payload tree (:mod:`._payload`); stability comes from
    the global-index tiebreak plane. Returns (sorted_keys_padded,
    permuted_values_padded, counts, overflow): every payload leaf becomes a
    tuple of per-rank shards; padding rows are dropped via counts.
    """
    _check_method_kwargs(method, kw)
    if method == "balanced":
        from .balanced import distributed_sort_pairs_balanced
        return distributed_sort_pairs_balanced(keys, values, mesh, axis_name,
                                               descending=descending, **kw)
    from ._payload import decode_payload_tree, encode_payload_tree
    words, dtype = _as_words(keys, descending, mesh)
    n = int(words[0].shape[0])
    payload_planes, ctx = encode_payload_tree(values, n, words[0].device)
    nk = len(words) + 1
    out, counts, overflow = _run_shuffle(
        words + (_iota(words[0], mesh),) + payload_planes, mesh, axis_name,
        *_shuffle_kw(kw), num_key_planes=nk, exchange=kw.get("exchange", "xla"))
    return (_decode([o[:len(words)] for o in out], dtype, descending),
            decode_payload_tree([o[nk:] for o in out], ctx), counts, overflow)


def _host(a) -> np.ndarray:
    """A tensor, a per-rank tuple of tensors, or an array, as numpy."""
    if isinstance(a, (tuple, list)):
        return np.concatenate([_host(s) for s in a])
    return kdf.to_numpy(a) if torch.is_tensor(a) else np.asarray(a)


def gather_sorted(sorted_padded, counts, overflow=None, *, mesh: Optional[SortMesh] = None
                  ) -> np.ndarray:
    """Assemble the exact sorted array on the host from the padded per-rank
    shards and their counts. Raises if the shuffle reported overflow.

    On a group mesh the shards are this process's, and they are always
    gathered over the group first: every process calls it together with
    ``mesh=`` and gets the whole array (the counterpart of an explicit
    replication in the JAX package). The shards do not name their mesh, so
    a call without ``mesh=`` in a ``torch.distributed`` world of more than
    one process raises ValueError rather than return this process's part;
    sharded consumption reads the shards with their counts instead.

    Shards of a numpy-only key dtype hold its carrier (``kdf.to_numpy(out,
    dtype)`` reads them as that dtype)."""
    if mesh is None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError("gather_sorted: in a group of processes the shards are this "
                             "process's part; pass mesh= to gather them over the group, "
                             "or read the shards with their counts")
    elif mesh.group is not None:
        sorted_padded = tuple(_mesh.all_gather(list(sorted_padded), mesh)[0])
        counts = _mesh.all_gather(list(counts), mesh, tiled=True)[0]
    if overflow is not None and int(_host(overflow)[0]) != 0:
        raise RuntimeError(
            "distributed_sort exchange capacity exceeded (skewed input); "
            "retry with exact=True or a larger slack")
    counts_np = _host(counts)
    if isinstance(sorted_padded, (tuple, list)):
        shards = [_host(s) for s in sorted_padded]
    else:
        flat = _host(sorted_padded)
        shards = np.split(flat, counts_np.shape[0])
    return np.concatenate([s[: counts_np[d]] for d, s in enumerate(shards)])
