"""Array utilities beyond sorting: ``bincount`` and the group-by slice.

The counterpart of ``radix_sorting_tpu.extras`` for the functions ported so
far: ``bincount``, ``unique_sorted``, ``value_counts`` and ``group_reduce``
(ROADMAP.md, port queue item 5 lists the rest). Inputs and outputs follow
:mod:`.api`: a tensor stays on its device and its results are tensors; a
numpy input goes to ``device=`` (the CUDA device by default) and its results
come back numpy. The routes are the JAX package's TPU routes: ``groups=``
takes the dense tiers, K10 / K11 (:func:`.ops.cuda_kernels.whist`,
:func:`.ops.cuda_kernels.whist_f32`) and K1 (:func:`bincount`); the rest
sorts. Fixed-shape results are built with no host sync, as the JAX
package's are (:func:`.ops.bitmap.nonzero_static`).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import api
from .config import DEFAULT_CONFIG, SortConfig
from .ops import cuda_kernels, hw_engine, kdf
from .ops.bitmap import bitmap_unique_sort, nonzero_static
from .ops.histogram import digit_histogram
from .ops.kdf import INT32_MIN

__all__ = ["bincount", "unique_sorted", "value_counts", "group_reduce"]

_HIST_MAX_LENGTH = 1 << cuda_kernels.HIST_MAX_BITS   # the JAX package's 2^18
# the dense group-by gates of the JAX package, kept so that an input takes
# the same route in both packages: planes * bins within this budget
_DENSE_BUDGET = 1 << 17
# accumulators of 32- and 64-bit values: their own dtype
_WIDE = {("u", 32): torch.uint32, ("i", 32): torch.int32, ("f", 32): torch.float32,
         ("u", 64): torch.uint64, ("i", 64): torch.int64, ("f", 64): torch.float64}


def _u32_values(x: torch.Tensor, dtype) -> torch.Tensor:
    """The values as the int32 plane of their u32 conversion (the JAX
    package's ``astype(uint32)``): signed values sign-extend, so negatives
    wrap far past any length; 64-bit values keep their low word."""
    bits, k = kdf.key_bits(dtype), kdf.kind(dtype)
    if bits == 64:
        return kdf.split64(x)[1]
    if k == "i" and bits < 32:
        return x.to(torch.int32)
    return kdf.raw_bits(x, dtype)[0]


def _max_u32(w: torch.Tensor) -> int:
    """The largest value of the plane ``w`` read as u32 (one host read)."""
    return (int(torch.max(w ^ INT32_MIN)) ^ INT32_MIN) & 0xFFFFFFFF


def bincount(x, *, length: Optional[int] = None, validate: bool = False,
             device=None):
    """Occurrence counts of non-negative integer values (``np.bincount``).

    Lengths of 4 to 2^18 take the JAX package's TPU route: the K1 histogram
    of the next power of two of bins, with values at or past ``length``
    dropped inside the kernel (``drop_ge``). Other lengths take the plain
    form, as the JAX package does off that route.

    Precondition: every value lies in ``[0, length)``. Out-of-range values
    are DROPPED (numpy raises on negatives); ``validate=True`` pays one max
    reduce and a host sync to raise ValueError instead. ``length`` defaults
    to the domain size of narrow unsigned and bool keys and is required
    otherwise. Returns int32 counts of ``length``: a tensor on ``x``'s
    device, or numpy for a numpy input (placed by ``device=``, the
    CUDA device by default).
    """
    from_numpy = not torch.is_tensor(x)
    if from_numpy:
        a = np.asarray(x)
        dtype, x = a.dtype, kdf.as_tensor(a, kdf.input_device(device))
    else:
        dtype = x.dtype
    if x.ndim != 1:
        raise ValueError(f"bincount input must be 1-D, got shape {tuple(x.shape)}")
    k = kdf.kind(dtype)
    if k in ("f", "S"):
        raise TypeError(f"bincount needs integer/bool values, got {dtype}")
    bits = kdf.key_bits(dtype)
    if length is None:
        if k in ("u", "b") and bits <= 16:
            length = 2 if k == "b" else 1 << bits
        else:
            raise ValueError(
                f"length is required for {dtype} (domain too wide to default)")
    length = int(length)
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    n = int(x.shape[0])
    w = _u32_values(x.contiguous(), dtype) if n else None
    if validate and n:
        # negatives wrap past any length in the u32 view, so one max reduce
        # (one host sync) covers both failure modes
        hi = _max_u32(w)
        if hi >= length:
            raise ValueError(
                f"bincount values outside [0, {length}): max raw bits 0x{hi:X}")
    if n == 0:
        out = torch.zeros(length, dtype=torch.int32, device=x.device)
    elif 4 <= length <= _HIST_MAX_LENGTH:
        radix_bits = (length - 1).bit_length()     # the kernel's power of two
        out = cuda_kernels.hist(w, 0, radix_bits, drop_ge=length)[:length]
    else:
        u = w.long() & 0xFFFFFFFF              # out-of-range values spill
        out = digit_histogram(torch.where(u < length, u, length), length)
    return kdf.to_numpy(out) if from_numpy else out


# ---------------------------------------------------------------------------
# helpers of the group-by slice


def _dtype_of(x):
    return x.dtype if hasattr(x, "dtype") else np.asarray(x).dtype


def _host_only(x) -> bool:
    """numpy 64-bit and byte-string input: the JAX package keeps it on the
    host (x64 off), and no dense tier takes it."""
    return isinstance(x, np.ndarray) and (x.dtype.kind == "S" or x.dtype.itemsize == 8)


def _dense_ok(arr, bits_cap: int = 32) -> bool:
    """True when ``arr`` can ride the dense group-by tier as one u32 plane:
    an integer or bool array of <= ``bits_cap`` bits."""
    if _host_only(arr):
        return False
    d = _dtype_of(arr)
    return kdf.kind(d) in ("u", "i", "b") and kdf.key_bits(d) <= bits_cap


def _dense_value_bytes(vdtype) -> int:
    bits = kdf.key_bits(vdtype)
    return 1 if bits <= 8 else (2 if bits <= 16 else 4)


def _dense_f32_ok(arr) -> bool:
    """True when ``arr`` can ride the float dense tier: a float of <= 32
    bits (f32, bf16, f16, float8: exact under one cast to f32)."""
    if _host_only(arr):
        return False
    d = _dtype_of(arr)
    return kdf.kind(d) == "f" and kdf.key_bits(d) <= 32


def _accum_dtype(vdtype) -> torch.dtype:
    """32-bit accumulator for sub-32-bit values (f32, u32, i32; bool counts
    in i32); 32- and 64-bit values accumulate at their own width."""
    k, bits = kdf.kind(vdtype), kdf.key_bits(vdtype)
    if bits >= 32:
        return _WIDE[(k, bits)]
    if k == "f":
        return torch.float32
    return torch.uint32 if k == "u" else torch.int32


def _where_live(live: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``where(live, t, 0)`` through a same-width signed view."""
    v = hw_engine.SIGNED_VIEW[t.element_size()]
    return torch.where(live, t.view(v), 0).view(t.dtype)


def _to_float(t: torch.Tensor, fdtype: torch.dtype) -> torch.Tensor:
    """``t`` as ``fdtype``, unsigned 32- and 64-bit integers read unsigned
    (each value rounded once, as numpy and XLA convert)."""
    if t.dtype == torch.uint32:
        return (t.view(torch.int32).long() & 0xFFFFFFFF).to(fdtype)
    if t.dtype == torch.uint64:
        hi, lo = (p.long() & 0xFFFFFFFF for p in kdf.split64(t))
        return hi.to(fdtype) * 2.0 ** 32 + lo.to(fdtype)
    return t.to(fdtype)


def _int64_values(t: torch.Tensor, dtype) -> torch.Tensor:
    """Integer or bool values as int64: 64-bit ones by their bits, unsigned
    and bool ones zero-extended, signed ones sign-extended."""
    if kdf.key_bits(dtype) == 64:
        return t.view(torch.int64)
    if kdf.kind(dtype) == "i":
        return t.to(torch.int64)
    return kdf.raw_bits(t, dtype)[0].long() & 0xFFFFFFFF


def _int_word(g: torch.Tensor, dtype, descending: bool) -> torch.Tensor:
    """The encoded plane (:func:`.ops.kdf.encode`) of the non-negative
    integers ``g`` as keys of the integer or bool ``dtype``."""
    bits = kdf.key_bits(dtype)
    w = g.to(torch.int32)
    if kdf.kind(dtype) == "i":
        w = w ^ kdf.i32(1 << (bits - 1))
    return w ^ kdf.i32((1 << bits) - 1) if descending else w


def _run_starts(words) -> torch.Tensor:
    """(n,) bool, n >= 1: where a run of equal multi-plane keys starts."""
    neq = functools.reduce(torch.logical_or, [w[1:] != w[:-1] for w in words])
    return torch.cat([neq.new_ones(1), neq])


def _sorted_words(xt: torch.Tensor, dtype, config: SortConfig):
    """The encoded planes of ``xt``, sorted as :func:`.api.sort` sorts them."""
    words = kdf.encode(xt, config.descending, dtype)
    return api._sort_words(words, dtype, config) if xt.shape[0] > 1 else words


def _sorted_boundaries(sw, dtype, descending: bool, size: int):
    """(boundary values, run lengths, number of runs) of sorted planes, at
    the fixed length ``size``: slots past the runs hold the last key with
    length 0. Uniqueness is bitwise on the encoded planes, so -0.0 and +0.0
    are distinct values, and so are NaNs with different payloads."""
    n = int(sw[0].shape[0])
    is_new = _run_starts(sw)
    num = is_new.sum(dtype=torch.int32)
    starts = nonzero_static(is_new, size, n)
    lens = torch.diff(starts, append=starts.new_full((1,), n)).to(torch.int32)
    live = torch.arange(size, device=starts.device) < num
    vals = kdf.decode(tuple(w[starts.clamp(max=n - 1)] for w in sw), dtype, descending)
    return vals, torch.where(live, lens, 0), num


def _empty_keys(kt: torch.Tensor, size: int) -> torch.Tensor:
    return torch.zeros((size,) + tuple(kt.shape[1:]), dtype=kt.dtype, device=kt.device)


def _results(from_numpy: bool, *pairs):
    """The results as they go back: tensors, or numpy for a numpy input.
    Each pair is (tensor, the numpy dtype its carrier stands for, or None)."""
    if not from_numpy:
        return tuple(t for t, _ in pairs)
    return tuple(kdf.to_numpy(t, d) for t, d in pairs)


def _check_groups(groups, x) -> int:
    groups = int(groups)
    if groups < 1:
        raise ValueError(f"groups must be >= 1, got {groups}")
    if not _dense_ok(x):
        raise TypeError("groups promises non-negative integer keys < groups; "
                        f"got dtype {_dtype_of(x)}")
    return groups


# ---------------------------------------------------------------------------
# unique_sorted, value_counts


def unique_sorted(x, *, size: Optional[int] = None,
                  config: SortConfig = DEFAULT_CONFIG, device=None):
    """Sorted unique values with a fixed-shape contract: ``(values, count)``.

    ``values`` has length ``size`` (default n); slots past ``count`` hold a
    maximal padding value (the domain maximum for narrow unsigned keys, the
    array maximum otherwise). uint8 / uint16 keys in ascending order take
    :func:`.ops.bitmap.bitmap_unique_sort` (no sort); everything else sorts
    and keeps the first key of each run. Uniqueness is bitwise under the KDF
    total order.
    """
    xt, dtype, from_numpy = api._as_input(x, device)
    n = int(xt.shape[0])
    size = n if size is None else int(size)
    if (not config.descending and kdf.kind(dtype) == "u"
            and kdf.key_bits(dtype) in (8, 16) and n > 0):
        vals, count = bitmap_unique_sort(xt, size=size)
    elif n == 0:
        vals, count = _empty_keys(xt, size), torch.zeros((), dtype=torch.int32)
    else:
        vals, _, count = _sorted_boundaries(_sorted_words(xt, dtype, config), dtype,
                                            config.descending, size)
    return _results(from_numpy, (vals, dtype), (count, None))


def value_counts(x, *, size: Optional[int] = None, groups: Optional[int] = None,
                 config: SortConfig = DEFAULT_CONFIG, device=None):
    """Sorted unique values with their multiplicities (run-length encode).

    Fixed-shape contract: ``(values, counts, num_unique)`` of length
    ``size`` (default n); slots past ``num_unique`` hold a maximal padding
    value with count 0. One sort plus boundary differencing; uniqueness is
    bitwise under the KDF total order. A ``size`` below the number of
    uniques keeps the first ``size`` runs.

    ``groups=G`` (integer keys promised in [0, G), G <= 2^17): no sort, one
    :func:`bincount` (K1) and a compaction; ``size`` then defaults to
    ``min(n, G)``, and keys outside [0, G) are dropped.
    """
    ndim = x.ndim if torch.is_tensor(x) else np.ndim(x)
    if ndim != 1:
        raise ValueError(f"keys must be 1-D, got {ndim} dimensions")
    if groups is not None:
        groups = _check_groups(groups, x)
    xt, dtype, from_numpy = api._as_input(x, device)
    n = int(xt.shape[0])
    if size is None:
        size = min(n, groups) if groups is not None else n
    size = int(size)
    if groups is not None and n > 0 and groups <= _DENSE_BUDGET:
        counts = bincount(_u32_values(xt, dtype), length=groups)
        out = _dense_emit(counts, None, "count", groups, size, dtype, config.descending)
    elif n == 0:
        out = (_empty_keys(xt, size), torch.zeros(size, dtype=torch.int32, device=xt.device),
               torch.zeros((), dtype=torch.int32))
    else:
        out = _sorted_boundaries(_sorted_words(xt, dtype, config), dtype,
                                 config.descending, size)
    return _results(from_numpy, (out[0], dtype), (out[1], None), (out[2], None))


# ---------------------------------------------------------------------------
# group_reduce: the dense tiers (K10, K11) and the sort-native route


def _dense_emit(counts, tot, reduce: str, G: int, size: int, kdtype, desc: bool):
    """Compact a dense (G,) tier result to the fixed-shape ``(unique_keys,
    reduced, num_groups)`` contract: the present keys sorted, then the
    maximal padding key with a zero reduction."""
    present = counts > 0
    num_groups = present.sum(dtype=torch.int32)
    pos = nonzero_static(present.flip(0) if desc else present, size, G)
    live = torch.arange(size, device=counts.device) < num_groups
    gid = ((G - 1) - pos if desc else pos).clamp(0, G - 1)
    ukeys = kdf.decode((torch.where(live, _int_word(gid, kdtype, desc), -1),), kdtype,
                       desc)
    if reduce == "count":
        return ukeys, torch.where(live, counts[gid], 0), num_groups
    gtot = hw_engine.gather(tot, gid)
    if reduce == "mean":
        mean = _to_float(gtot, torch.float32) / counts[gid].clamp(min=1).to(torch.float32)
        return ukeys, torch.where(live, mean, 0.0), num_groups
    return ukeys, _where_live(live, gtot), num_groups


def _group_reduce_dense(kt, kdtype, vt, vdtype, reduce, G, size, desc):
    """Integer dense tier: counts and sums mod 2^32 in one K10 read, no
    sort; keys outside [0, G) are dropped. The sums are the JAX package's
    recombined byte planes, bit for bit, with no planes: integer atomics
    wrap mod 2^32."""
    bits = max(2, (G - 1).bit_length())
    counts, tot = cuda_kernels.whist(_u32_values(kt, kdtype), _u32_values(vt, vdtype),
                                     bits, G)
    tot = tot[:G]
    if _accum_dtype(vdtype) == torch.uint32:
        tot = tot.view(torch.uint32)
    return _dense_emit(counts[:G], tot, reduce, G, size, kdtype, desc)


def _group_reduce_dense_f32(kt, kdtype, vt, reduce, G, size, desc):
    """Float dense tier: counts and f32 sums in one K11 read, no sort; keys
    outside [0, G) are dropped. Each group's sum is a direct f32 sum of its
    own values, in an order that varies (float atomics): error per group
    within sum|v| * 2^-14 + 1e-5 of a float64 sum. A non-finite value makes
    only its own group non-finite (the JAX package's TPU route spreads it to
    every group; its other routes keep it to the group, as here)."""
    bits = max(2, (G - 1).bit_length())
    counts, tot = cuda_kernels.whist_f32(_u32_values(kt, kdtype), vt.to(torch.float32),
                                         bits, G, with_counts=True)
    return _dense_emit(counts[:G], tot[:G], reduce, G, size, kdtype, desc)


def _group_reduce_sorted(kt, kdtype, vt, vdtype, reduce, size, desc):
    """The sort-native route: ONE unstable keys-only sort of the (key planes,
    value planes) composite serves every reduction. Within a run of equal
    keys the values land sorted, so min / max are the run's boundary
    elements, and sum is a difference of prefix sums at the boundaries."""
    n = int(kt.shape[0])
    kw = kdf.encode(kt, desc, kdtype)
    sw, _ = hw_engine.sort_words(kw + kdf.encode(vt, False, vdtype), stable=False)
    skw, svw = sw[: len(kw)], sw[len(kw):]
    is_new = _run_starts(skw)
    num_groups = is_new.sum(dtype=torch.int32)
    starts = nonzero_static(is_new, size, n)
    live = torch.arange(size, device=kt.device) < num_groups
    at_start = starts.clamp(max=n - 1)
    ukeys = kdf.decode(tuple(torch.where(live, w[at_start], -1) for w in skw), kdtype,
                       desc)
    sv = kdf.decode(svw, vdtype)
    bounded = torch.cat([starts, starts.new_full((1,), n)])
    ends = (bounded[1:] - 1).clamp(0, n - 1)          # last index of each run
    if reduce in ("min", "max"):
        out = _where_live(live, hw_engine.gather(sv, at_start if reduce == "min" else ends))
        return ukeys, out.to(torch.int32) if out.dtype == torch.bool else out, num_groups

    acc = _accum_dtype(vdtype)
    if acc.is_floating_point:
        c = torch.cumsum(sv.to(acc), 0)
    else:
        # exact in int64; the 32-bit sums keep the low bits of the difference
        # (the JAX package's wrapping u32 / i32 cumsum), 64-bit ones wrap
        c = torch.cumsum(_int64_values(sv, vdtype), 0)
    c = torch.cat([c.new_zeros(1), c])
    tot = c[ends + 1] - c[at_start]
    if acc in (torch.int32, torch.uint32):
        tot = cuda_kernels.low32(tot)
    if acc in (torch.uint32, torch.uint64):
        tot = tot.view(acc)
    if reduce == "sum":
        return ukeys, _where_live(live, tot), num_groups
    lens = torch.diff(bounded).clamp(min=1)
    fd = torch.float64 if kdf.key_bits(vdtype) == 64 else torch.float32
    mean = _to_float(tot, fd) / lens.to(fd)
    return ukeys, torch.where(live, mean, 0.0), num_groups


def group_reduce(keys, values, *, reduce: str = "sum", size: Optional[int] = None,
                 groups: Optional[int] = None, validate: bool = False,
                 config: SortConfig = DEFAULT_CONFIG, device=None):
    """Per-unique-key reduction of ``values`` (a group-by).

    Returns ``(unique_keys, reduced, num_groups)`` with the fixed-shape
    contract of :func:`value_counts`: length ``size`` (default n), group
    keys sorted (``config.descending`` applies to the keys), slots past
    ``num_groups`` hold a maximal padding key with a zero reduction.
    ``reduce`` is ``'sum'``, ``'mean'``, ``'min'`` or ``'max'``. ``values``
    go to the keys' device; the containers follow the keys.

    Routes, as in the JAX package:

    * ``groups=G``, a promise that every key is a non-negative integer < G:
      ``sum`` / ``mean`` of integer or bool values take K10 (one read, no
      sort) when ``(value_bytes + 1) * bins <= 2^17`` (bins: G rounded up to
      a power of two, at least 4); of floats of <= 32 bits, K11 with counts
      when ``3 * bins <= 2^17``. Keys outside [0, G) are then DROPPED, where
      the sort-native route keeps them; ``validate=True`` pays one max reduce
      and a host read to raise ValueError instead. ``size`` defaults to
      ``min(n, G)``.
    * everything else (``min`` / ``max``, wider promises, 64-bit values, no
      ``groups``) sorts the (key, value) composite once.

    ``min`` / ``max`` follow the KDF total order (-0.0 < +0.0, NaN payloads
    above +inf); of bool values they are int32, as in the JAX package.
    ``sum`` / ``mean`` accumulate sub-32-bit values in 32 bits (f32, u32,
    i32) and return that dtype; integer sums are exact mod 2^32 (64-bit
    values: mod 2^64). ``mean`` is float32, float64 for 64-bit values.
    Float sums on the sort-native route are prefix-sum differences: their
    rounding is that of a prefix, which can be far larger than the group.
    """
    if reduce not in ("sum", "mean", "min", "max"):
        raise ValueError(f"reduce must be sum|mean|min|max, got {reduce!r}")
    if groups is not None:
        groups = _check_groups(groups, keys)
    kt, kdtype, from_numpy = api._as_input(keys, device)
    vt, vdtype, _ = api._as_input(values, None if torch.is_tensor(values) else kt.device)
    if vt.device != kt.device:
        raise ValueError("values must be on the keys' device")
    if kdf.kind(vdtype) == "S":
        raise TypeError("group_reduce needs numeric or bool values, got byte strings")
    if groups is not None and validate and kt.shape[0]:
        hi = _max_u32(_u32_values(kt, kdtype))
        if hi >= groups:
            raise ValueError(f"group keys outside [0, {groups}): max raw bits 0x{hi:X}")
    if vt.shape[0] != kt.shape[0]:
        raise ValueError("values must match the keys' length")
    n = int(kt.shape[0])
    desc = config.descending
    if size is None:
        size = min(n, groups) if groups is not None else n
    size = int(size)

    out = None
    if groups is not None and n > 0 and reduce in ("sum", "mean"):
        bins = 1 << max(2, (groups - 1).bit_length())
        if _dense_ok(values) and (_dense_value_bytes(vdtype) + 1) * bins <= _DENSE_BUDGET:
            out = _group_reduce_dense(kt, kdtype, vt, vdtype, reduce, groups, size, desc)
        elif _dense_f32_ok(values) and 3 * bins <= _DENSE_BUDGET:
            out = _group_reduce_dense_f32(kt, kdtype, vt, reduce, groups, size, desc)
    if out is None and n == 0:
        acc = {"mean": torch.float32, "sum": _accum_dtype(vdtype)}.get(reduce, vt.dtype)
        out = (_empty_keys(kt, size), torch.zeros(size, dtype=acc, device=kt.device),
               torch.zeros((), dtype=torch.int32))
    elif out is None:
        out = _group_reduce_sorted(kt, kdtype, vt, vdtype, reduce, size, desc)
    ukeys, reduced, num_groups = out
    # min / max of a numpy input come back in its dtype (bf16, int4: carriers)
    vnp = vdtype if reduced.dtype == vt.dtype and not isinstance(vdtype, torch.dtype) \
        else None
    return _results(from_numpy, (ukeys, kdtype), (reduced, vnp), (num_groups, None))
