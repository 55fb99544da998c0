"""Sort-adjacent operations: ``bincount``, the group-by slice and the sorter
composites.

The counterpart of ``radix_sorting_tpu.extras``, whole: ``bincount``,
``unique_sorted``, ``value_counts``, ``group_reduce``; ``lexsort``,
``segmented_sort`` / ``segmented_argsort``, ``merge_sorted``,
``searchsorted``, ``nth_element``, ``top_k`` / ``top_k_batched``,
``stable_partition`` and ``sort_complex``. Inputs and outputs follow
:mod:`.api`: a tensor stays on its device and its results are tensors; a
numpy input goes to ``device=`` (the CUDA device by default) and its results
come back numpy. Where a function takes several arrays, numpy ones join a
tensor's device, and the results are numpy only when every input is. The
routes are the JAX package's TPU routes: ``groups=`` takes the dense tiers,
K10 / K11 (:func:`.ops.cuda_kernels.whist`, :func:`.ops.cuda_kernels.whist_f32`)
and K1 (:func:`bincount`); the rest sorts, through :func:`.api.sort`'s
dispatch (the counting kernels for narrow keys) or the sorter of
:mod:`.ops.hw_engine`. Fixed-shape results are built with no host sync, as
the JAX package's are (:func:`.ops.bitmap.nonzero_static`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from . import api
from .config import DEFAULT_CONFIG, SortConfig
from .ops import cuda_kernels, hw_engine, kdf
from .ops.bitmap import bitmap_unique_sort, nonzero_static
from .ops.histogram import digit_histogram
from .ops.kdf import INT32_MIN

__all__ = ["lexsort", "unique_sorted", "segmented_sort", "segmented_argsort",
           "top_k_batched", "searchsorted", "bincount", "top_k", "merge_sorted",
           "nth_element", "stable_partition", "value_counts", "group_reduce",
           "sort_complex"]

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


# ---------------------------------------------------------------------------
# the sorter composites: inputs, and the packing of narrow words


def _inputs(arrays, device):
    """1-D key arrays on one device: (carrier tensors, key dtypes,
    from_numpy). Numpy arrays join the first tensor's device, or go to
    ``device=`` when every array is numpy; from_numpy then holds."""
    tensors = [a for a in arrays if torch.is_tensor(a)]
    if tensors:
        dev = tensors[0].device
        if device is not None and torch.device(device) != dev:
            raise ValueError("device= places numpy input; a tensor is sorted on its own device")
        if any(t.device != dev for t in tensors):
            raise ValueError("the input tensors must share a device")
    else:
        dev = kdf.input_device(device)
    out = [api._as_input(a, None if torch.is_tensor(a) else dev) for a in arrays]
    return [t for t, _, _ in out], [d for _, d, _ in out], not tensors


def _length(x) -> int:
    """The length of a 1-D tensor or array-like; ValueError otherwise."""
    shape = tuple(x.shape) if torch.is_tensor(x) else np.shape(x)
    if len(shape) != 1:
        raise ValueError(f"keys must be 1-D, got shape {shape}")
    return int(shape[0])


def _word_pairs(words, dtype):
    """[(plane, live width), ...] of one key's encoded planes.

    The KDF maps a b-bit dtype into b bits, zero-extended, so one plane of a
    narrow dtype is bounded by 2^b. Every plane of a 64-bit key or a byte
    string is a full 32-bit field (R5: a byte string's bytes sit at the top
    of its planes, and each plane orders; the JAX package keeps only the
    first plane of a key of three or more, and packs the plane of a 1- to
    3-byte string as if its bytes sat at the bottom).
    """
    if len(words) > 1 or kdf.kind(dtype) == "S":
        return [(w, 32) for w in words]
    return [(words[0], min(32, kdf.key_bits(dtype)))]


def _pack_narrow_words(pairs):
    """Pack width-bounded words into the fewest 32-bit sort operands.

    ``pairs`` is [(word, live bits), ...], most significant first; each word
    is < 2^bits, so concatenating fields within a plane keeps the
    lexicographic order (a lexsort of four u8 columns sorts ONE operand).
    Returns ``(packed planes, layout)``, ``layout[i] = (plane, shift,
    bits)`` locating pair i's field.
    """
    groups, cur, cur_bits = [], [], 0
    for w, bits in pairs:
        if cur and cur_bits + bits > 32:
            groups.append(cur)
            cur, cur_bits = [], 0
        cur.append((w, bits))
        cur_bits += bits
    groups.append(cur)
    packed, layout = [], []
    for gi, g in enumerate(groups):
        shift = sum(b for _, b in g)
        acc = None
        for w, bits in g:
            shift -= bits
            term = w << shift if shift else w       # int32 << wraps as u32 does
            acc = term if acc is None else acc | term
            layout.append((gi, shift, bits))
        packed.append(acc)
    return tuple(packed), layout


def _field_masks(layout, indices, num_words):
    """Per-plane u32 masks (Python ints) covering the fields ``indices``."""
    masks = [0] * num_words
    for i in indices:
        gi, shift, bits = layout[i]
        masks[gi] |= ((1 << bits) - 1) << shift
    return masks


def _xor_masks(words, masks):
    """Complement the masked fields in place (a b-bit field's complement is
    ``field ^ (2^b - 1)``): descending order for those fields alone."""
    return tuple(w ^ kdf.i32(m) if m else w for w, m in zip(words, masks))


def _unpack_fields(sorted_words, layout):
    """Each field of the sorted packed planes, as its own plane (``>>`` is
    arithmetic on int32, so every field below 32 bits is masked)."""
    planes = []
    for gi, shift, bits in layout:
        w = sorted_words[gi]
        if shift:
            w = w >> shift
        if bits < 32:
            w = w & ((1 << bits) - 1)
        planes.append(w)
    return planes


# ---------------------------------------------------------------------------
# lexsort, the segmented sorts, merge_sorted


def lexsort(keys: Sequence, *, config: SortConfig = DEFAULT_CONFIG, device=None):
    """Stable argsort by several keys, the last key most significant (numpy's
    order); returns the permutation as uint32.

    Every key is KDF-encoded, the narrow words pack into the fewest 32-bit
    planes (:func:`_pack_narrow_words`), and one stable sort orders them
    (planes past two chain stable sorts, :mod:`.ops.hw_engine`).
    ``config.descending`` complements the packed planes (the complement
    distributes over the concatenated fields).
    """
    keys = list(keys)
    if not keys:
        raise ValueError("lexsort needs at least one key")
    ts, dtypes, from_numpy = _inputs(keys, device)
    n = int(ts[0].shape[0])
    pairs = []
    for t, d in zip(reversed(ts), reversed(dtypes)):   # numpy: the last key is primary
        if int(t.shape[0]) != n:
            raise ValueError("lexsort keys must share a common length")
        pairs += _word_pairs(kdf.encode(t, False, d), d)
    packed, _ = _pack_narrow_words(pairs)
    if config.descending:
        packed = kdf.complement(packed)
    _, perm = hw_engine.argsort_words(packed)
    return kdf.to_numpy(perm) if from_numpy else perm


def _segment_planes(keys, segment_ids, descending: bool, device):
    """The (segment, key) composite packed into the fewest planes, the key
    fields complemented in place when ``descending`` (the segments stay
    ascending): (packed, layout, key masks, number of segment fields,
    (key, segment) dtypes, from_numpy)."""
    (kt, st), (kd, sd), from_numpy = _inputs((keys, segment_ids), device)
    if int(st.shape[0]) != int(kt.shape[0]):
        raise ValueError("segment_ids must match the keys' length")
    seg_pairs = _word_pairs(kdf.encode(st, False, sd), sd)
    packed, layout = _pack_narrow_words(seg_pairs + _word_pairs(kdf.encode(kt, False, kd), kd))
    kmasks = _field_masks(layout, range(len(seg_pairs), len(layout)), len(packed))
    if descending:
        packed = _xor_masks(packed, kmasks)
    return packed, layout, kmasks, len(seg_pairs), (kd, sd), from_numpy


def segmented_sort(keys, segment_ids, *, config: SortConfig = DEFAULT_CONFIG, device=None):
    """Sort keys within segments: one keys-only sort of the (segment, key)
    composite. Returns ``(sorted_keys, sorted_segment_ids)``, ordered by
    segment id, then by key (``config.descending`` applies to the keys
    only); segments already grouped in ascending order keep their layout."""
    packed, layout, kmasks, ns, (kd, sd), from_numpy = _segment_planes(
        keys, segment_ids, config.descending, device)
    sw, _ = hw_engine.sort_words(packed, stable=False)
    if config.descending:
        sw = _xor_masks(sw, kmasks)
    planes = _unpack_fields(sw, layout)
    return _results(from_numpy, (kdf.decode(tuple(planes[ns:]), kd), kd),
                    (kdf.decode(tuple(planes[:ns]), sd), sd))


def segmented_argsort(keys, segment_ids, *, config: SortConfig = DEFAULT_CONFIG,
                      index_dtype=torch.uint32, device=None):
    """Stable argsort by (segment, key): the permutation form of
    :func:`segmented_sort`; ties within a segment go to the lower index."""
    packed, _, _, _, _, from_numpy = _segment_planes(keys, segment_ids,
                                                     config.descending, device)
    idt = api._index_dtype(index_dtype)
    api._check_index_width(int(packed[0].shape[0]), idt)
    _, perm = hw_engine.argsort_words(packed, index_dtype=idt)
    return kdf.to_numpy(perm) if from_numpy else perm


def merge_sorted(a, b, *, config: SortConfig = DEFAULT_CONFIG, device=None):
    """Merge two sorted arrays into one (``std::merge``): keys-only, so one
    unstable sort of the concatenation, made on the device, gives it."""
    (at, bt), (da, db), from_numpy = _inputs((a, b), device)
    if kdf._canonical_dtype(da) != kdf._canonical_dtype(db):
        raise TypeError(f"merge_sorted inputs must share a dtype, got {da} and {db}")
    words = kdf.encode(torch.cat([at, bt]), config.descending, da)
    sw, _ = hw_engine.sort_words(words, stable=False)
    return api._decode(sw, da, config.descending, from_numpy)


# ---------------------------------------------------------------------------
# searchsorted

# searchsorted's query block: the tagged union sorts the n keys with at most
# this many queries at a time, which bounds its intermediates at any q.
# Module-level so tests can shrink it.
_SEARCHSORTED_QBLOCK = 1 << 22
_SEARCH_METHODS = ("auto", "scan", "scan_unrolled", "compare_all", "sort")


def _integer_dtype(d) -> bool:
    if isinstance(d, torch.dtype):
        return not (d.is_floating_point or d.is_complex or d == torch.bool)
    return np.issubdtype(np.dtype(d), np.integer)


def _tagged_union(sw, qw, right: bool) -> torch.Tensor:
    """Insertion positions of the query planes ``qw`` into the sorted planes
    ``sw``: ONE unstable sort of the union with an index plane, then the
    stable inverse-permutation sort.

    The index plane orders every tie, so no flag operand is needed: for
    'left' the queries take indices 0..m-1 and the keys m..m+n-1 (a query
    lands before its equals), for 'right' the reverse. A query's position is
    the number of keys sorted before it.
    """
    n, m = int(sw[0].shape[0]), int(qw[0].shape[0])
    if n + m >= 1 << 31:
        raise ValueError(f"searchsorted indexes n + a query block ({n} + {m}) in 31 bits")
    idx = torch.arange(n + m, dtype=torch.int32, device=sw[0].device)
    idx_s, idx_q = (idx[:n], idx[n:]) if right else (idx[m:], idx[:m])
    words = tuple(torch.cat([s, q]) for s, q in zip(sw, qw)) + (torch.cat([idx_s, idx_q]),)
    sidx = hw_engine.sort_words(words, stable=False)[0][-1]
    is_key = ((sidx < n) if right else (sidx >= m)).to(torch.int32)
    before = torch.cumsum(is_key, 0, dtype=torch.int32) - is_key      # exclusive
    # back to the union's order: sidx is unique, so the stable sort is exact
    _, (restored,) = hw_engine.sort_words((sidx,), (before,))
    return restored[n:] if right else restored[:m]


def searchsorted(sorted_keys, queries, *, side: str = "left", method: str = "auto",
                 sorter=None, config: SortConfig = DEFAULT_CONFIG, device=None):
    """Insertion positions of ``queries`` into a sorted array
    (``np.searchsorted``); returns int32 positions in [0, n].

    Positions follow the KDF total order (floats with NaN and -0.0 place as
    this package's sorts place them); ``config.descending`` searches an
    array sorted descending. That ``sorted_keys`` is sorted is the caller's
    promise, not checked (as in numpy).

    Routes, the JAX package's TPU routes: keys of one plane (<= 32 bits)
    with ``'scan'``, ``'scan_unrolled'`` or ``'compare_all'`` take
    ``torch.searchsorted`` of the sign-flipped planes; ``'sort'`` takes the
    tagged union (:func:`_tagged_union`; one int64 sort of the (key, index)
    planes); ``'auto'`` takes ``'sort'`` when ``32 * q >= n``, else
    ``'scan'``. Keys of two planes (64-bit, 5- to 8-byte strings) always
    take the tagged union. Wider byte strings raise ValueError. Queries go
    in blocks of ``_SEARCHSORTED_QBLOCK`` through the tagged union.

    ``sorter`` (numpy's third argument) is an integer permutation that sorts
    ``sorted_keys``; its dtype and shape are checked, then one sort of the
    keys (the route of :func:`.api.sort`) takes the place of the gather:
    any sorting permutation gives the sorted keys.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if sorter is not None:
        sdt = sorter.dtype if hasattr(sorter, "dtype") else np.asarray(sorter).dtype
        if not _integer_dtype(sdt):
            raise TypeError(f"sorter must be an integer permutation, got {sdt}")
        sshape = tuple(sorter.shape) if torch.is_tensor(sorter) else np.shape(sorter)
        kshape = tuple(sorted_keys.shape) if torch.is_tensor(sorted_keys) \
            else np.shape(sorted_keys)
        if sshape != kshape:
            raise ValueError(f"sorter.shape {sshape} must equal sorted_keys.shape {kshape}")
    if method not in _SEARCH_METHODS:
        raise ValueError(f"method must be one of {_SEARCH_METHODS}, got {method!r}")
    (st, qt), (sd, qd), from_numpy = _inputs((sorted_keys, queries), device)
    if kdf._canonical_dtype(sd) != kdf._canonical_dtype(qd):
        raise TypeError(f"searchsorted inputs must share a dtype, got {sd} and {qd}")
    desc = config.descending
    sw = _sorted_words(st, sd, config) if sorter is not None else kdf.encode(st, desc, sd)
    qw = kdf.encode(qt, desc, qd)
    n, q = int(sw[0].shape[0]), int(qw[0].shape[0])
    if len(sw) > 2:
        raise ValueError(
            f"searchsorted takes keys of at most two 32-bit planes; {sd} keys have "
            f"{len(sw)} (the tagged union's sort would carry every plane)")
    if q == 0 or n == 0:
        out = torch.zeros(q, dtype=torch.int32, device=st.device)
    elif len(sw) == 1 and method != "sort" and not (method == "auto" and 32 * q >= n):
        out = torch.searchsorted(hw_engine._key(sw), hw_engine._key(qw),
                                 right=side == "right", out_int32=True)
    else:
        B = _SEARCHSORTED_QBLOCK
        out = torch.cat([_tagged_union(sw, tuple(w[i:i + B] for w in qw), side == "right")
                         for i in range(0, q, B)])
    return kdf.to_numpy(out) if from_numpy else out


# ---------------------------------------------------------------------------
# selection: nth_element, top_k, top_k_batched; stable_partition


def nth_element(x, ranks, *, config: SortConfig = DEFAULT_CONFIG, device=None):
    """Values at the given sorted ranks (exact order statistics), a
    (len(ranks),) array of x's dtype; ``ranks`` are ints in [0, n), in the
    order of ``config.descending``. One full sort (:func:`.api.sort`'s
    route: narrow keys select at the counting kernels' speed), then a take
    of the ranks' planes."""
    n = _length(x)
    ranks = [int(r) for r in ranks]
    if not ranks:
        raise ValueError("ranks must be non-empty")
    if not all(0 <= r < n for r in ranks):
        raise ValueError(f"ranks must be in [0, {n})")
    xt, dtype, from_numpy = api._as_input(x, device)
    sw = _sorted_words(xt, dtype, config)
    idx = torch.tensor(ranks, device=xt.device)
    return api._decode(tuple(w[idx] for w in sw), dtype, config.descending, from_numpy)


def top_k(x, k: int, *, largest: bool = True, index_dtype=torch.uint32, device=None):
    """Top-k values of ``x`` with their original indices: ``(values,
    indices)`` of length ``k``, best first (descending for
    ``largest=True``); ties go to the lower index. Any key dtype, 64-bit
    and byte strings included: one stable argsort of the keys encoded with
    ``descending=largest``."""
    words, dtype, from_numpy = api._as_words(x, largest, device)
    n = int(words[0].shape[0])
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    idt = api._index_dtype(index_dtype)
    api._check_index_width(n, idt)
    sw, perm = hw_engine.argsort_words(words, index_dtype=idt)
    vals = kdf.decode(tuple(w[:k] for w in sw), dtype, largest)
    return _results(from_numpy, (vals, dtype), (perm[:k], None))


def top_k_batched(x, k: int, *, axis: int = -1, largest: bool = True,
                  index_dtype=torch.uint32, device=None):
    """Top-k of every 1-D slice along ``axis``: ``(values, indices)`` with
    ``k`` in place of that axis's size, best first, ties to the lower index
    of each slice. One ``torch.sort(dim=-1, stable=True)`` of the slices'
    packed keys (:func:`.api._batch_key`); stability gives the order of the
    JAX package's index-as-last-key. A batch of one row goes through
    :func:`top_k`."""
    xm, axis = api._moveaxis_last(api._as_array(x), axis)
    if api._single_batch(xm):
        vals, idx = top_k(xm.reshape(-1), k, largest=largest, index_dtype=index_dtype,
                          device=device)
        shape = tuple(xm.shape[:-1]) + (k,)
        return (api._restore_axis(vals.reshape(shape), axis),
                api._restore_axis(idx.reshape(shape), axis))
    n = int(xm.shape[-1])
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    idt = api._index_dtype(index_dtype)
    api._check_index_width(n, idt)
    key, planes, dtype, from_numpy = api._batch_key(xm, largest, device)
    s = torch.sort(key, dim=-1, stable=True)
    vals = api._batch_decode(s.values[..., :k], planes, dtype, largest, from_numpy)
    idx = s.indices[..., :k].to(idt)
    return (api._restore_axis(vals, axis),
            api._restore_axis(kdf.to_numpy(idx) if from_numpy else idx, axis))


def stable_partition(pred, values, *, device=None):
    """Stable partition of a payload pytree by a boolean predicate: rows where
    ``pred`` is False first, then the rest, each group in input order.
    Returns ``(partitioned_values, num_false)`` (num_false int32). One
    stable :func:`.api.sort_pairs` by the bool key."""
    pd = pred.dtype if torch.is_tensor(pred) else np.asarray(pred).dtype
    if pd not in (torch.bool, np.dtype(np.bool_)):
        raise TypeError(f"pred must be boolean, got {pd}")
    pt, _, from_numpy = api._as_input(pred, device)
    _, out = api.sort_pairs(pt, values)
    num_false = (~pt).sum(dtype=torch.int32)
    return out, kdf.to_numpy(num_false) if from_numpy else num_false


# ---------------------------------------------------------------------------
# sort_complex


def sort_complex(x, *, config: SortConfig = DEFAULT_CONFIG, device=None) -> np.ndarray:
    """``np.sort_complex``: sort by the real part, ties by the imaginary.

    Takes numpy only (as the JAX package does) and returns numpy. The host
    splits the real and imaginary parts; each is KDF-encoded on ``device``
    (complex64: one plane a part; complex128: two, as
    :func:`.ops.kdf.encode64_np` makes them), and one keys-only sort of the 2 or 4
    planes orders them. Each part follows the KDF total order (-0.0 < +0.0,
    NaNs by sign and payload). Real input is promoted as numpy promotes it:
    int8, int16, uint8, uint16 to complex64, the rest to complex128.
    ``config.descending`` reverses the order.
    """
    if not isinstance(x, np.ndarray):
        raise TypeError("sort_complex takes a NUMPY array (the host splits the real and "
                        f"imaginary planes), got {type(x).__name__}")
    if x.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {x.shape}")
    if x.dtype.kind != "c":
        x = x.astype(np.complex64 if x.dtype.char in "bhBH" else np.complex128)
    if x.dtype not in (np.complex64, np.complex128):
        raise TypeError(f"sort_complex takes complex64 or complex128, got {x.dtype}")
    if x.shape[0] == 0:
        return x.copy()
    dev = kdf.input_device(device)
    desc = config.descending
    part = np.float32 if x.dtype == np.complex64 else np.float64
    re, im = (kdf.as_tensor(np.ascontiguousarray(p), dev) for p in (x.real, x.imag))
    out, _ = hw_engine.sort_words(kdf.encode(re, desc) + kdf.encode(im, desc), stable=False)
    h = len(out) // 2
    res = np.empty(x.shape, x.dtype)
    res.real = kdf.to_numpy(kdf.decode(out[:h], np.dtype(part), desc))
    res.imag = kdf.to_numpy(kdf.decode(out[h:], np.dtype(part), desc))
    return res
