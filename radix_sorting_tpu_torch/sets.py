"""numpy's set routines: the counterpart of ``radix_sorting_tpu.sets``, whole.

:func:`unique` with ``return_index`` / ``return_inverse`` / ``return_counts``,
``size``, ``axis=`` and ``equal_nan``; the numpy-2 quartet
:func:`unique_values` / :func:`unique_counts` / :func:`unique_inverse` /
:func:`unique_all`; :func:`union1d`, :func:`intersect1d` (with
``return_indices``), :func:`setdiff1d`, :func:`setxor1d`; :func:`isin` and
:func:`in1d`. Inputs and outputs follow :mod:`.api`: a tensor stays on its
device and its results are tensors; a numpy input goes to ``device=`` (the
CUDA device by default) and every field of its results comes back numpy.
Two-input functions place their arrays as :mod:`.extras` does.

The contract is the JAX package's, bit for bit: fixed-shape results
(``size`` slots, the live count a 0-d int32 on the device), padding slots
holding the KDF-order-last value (all-ones planes decoded), equality
bitwise under the KDF total order (-0.0 and +0.0 differ, NaN payloads
differ unless ``equal_nan=True``).

How it is reached differs where the JAX formulation is a TPU's:

* ``unique`` with no permutation flag sorts through :func:`.api.sort`'s
  dispatch (the counting kernels for narrow keys); with one, one stable
  argsort. ``inverse`` goes back to input order by one scatter through the
  permutation (unique, so exact), where the JAX package sorts again.
* The binary set operations and ``isin`` sort the concatenation's value
  planes once, stably: the side flag and the per-side index that the JAX
  package sorts as extra planes are the concatenation's order, which a
  stable sort keeps, so they are read off the permutation
  (``flag = perm >= na``, ``index = perm - na * flag``).
* Each run's verdict is decided at one position of the run (its first, its
  last or its A-to-B step), and the emitted positions are compacted by
  :func:`.ops.bitmap.nonzero_static`, with no sort and no host sync.
* ``isin`` reads whether a run holds a test from the run's first element
  (tests precede queries in every run), by one cumsum and one scatter of
  run ids (``torch.cummax`` scans a 1-D tensor in one block), and puts the
  answers back in input order by one scatter.
* Indices are computed in int64 from ``torch.sort``'s permutation, so every
  size the JAX package admits is admitted; ``index_dtype`` is applied last.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from . import api
from .config import DEFAULT_CONFIG, SortConfig
from .extras import _dtype_of, _inputs, _run_starts, _sorted_words
from .ops import hw_engine, kdf
from .ops.bitmap import nonzero_static

__all__ = ["unique", "unique_values", "unique_counts", "unique_inverse", "unique_all",
           "UniqueResult", "UniqueValuesResult", "UniqueCountsResult",
           "UniqueInverseResult", "UniqueAllResult", "isin", "in1d", "union1d",
           "intersect1d", "setdiff1d", "setxor1d"]

Array = Union[torch.Tensor, np.ndarray]


class UniqueResult(NamedTuple):
    """Fixed-shape :func:`unique` result; unrequested fields are ``None``.

    ``values`` has length ``size``; slots past ``num_unique`` hold the
    KDF-order-last value. ``index`` / ``counts`` share that length (padded
    with 0); ``inverse`` has the input's length.
    """
    values: Array
    index: Optional[Array]
    inverse: Optional[Array]
    counts: Optional[Array]
    num_unique: Array


class UniqueValuesResult(NamedTuple):
    """numpy-2 ``unique_values`` plus the live count (fixed shape needs it)."""
    values: Array
    num_unique: Array


class UniqueCountsResult(NamedTuple):
    values: Array
    counts: Array
    num_unique: Array


class UniqueInverseResult(NamedTuple):
    values: Array
    inverse_indices: Array
    num_unique: Array


class UniqueAllResult(NamedTuple):
    values: Array
    indices: Array
    inverse_indices: Array
    counts: Array
    num_unique: Array


# ---------------------------------------------------------------------------
# helpers


def _ndim(x) -> int:
    return x.ndim if torch.is_tensor(x) else np.ndim(x)


def _ones(dtype) -> int:
    """The all-ones plane of ``dtype``'s encoding: every live bit (narrow
    keys are zero-extended), so that it decodes as the JAX package decodes
    a plane of 32 ones (the descending decode of a bool reads its low 8)."""
    bits = kdf.key_bits(dtype)
    return -1 if bits >= 32 or kdf.kind(dtype) == "S" else (1 << bits) - 1


def _max_pad(dtype, size: int, descending: bool, device) -> torch.Tensor:
    """(size,) carrier of the KDF-order-last value of ``dtype``: all-ones
    planes decoded under the configured order, the padding of every
    fixed-shape result here (empty inputs included)."""
    ones = torch.full((size,), _ones(dtype), dtype=torch.int32, device=device)
    return kdf.decode((ones,) * kdf.num_words(dtype), dtype, descending)


def _collapse_nans(x):
    """Every NaN of a float array as its dtype's canonical NaN, the
    ``equal_nan=True`` preprocessing; other arrays pass through. A numpy
    array is canonicalized on the host, a tensor on its device, each with
    the NaN its library makes, as the JAX package does on the host and in
    its graph."""
    if kdf.kind(_dtype_of(x)) != "f":
        return x
    if torch.is_tensor(x):
        v = hw_engine.SIGNED_VIEW[x.element_size()]
        nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
        isnan = torch.isnan(x.float() if x.element_size() == 1 else x)
        return torch.where(isnan, nan.view(v), x.view(v)).view(x.dtype)
    a = np.asarray(x)
    return np.where(np.isnan(a), np.array(np.nan, a.dtype), a)


def _zeros(size: int, dtype: torch.dtype, device) -> torch.Tensor:
    # through int32: torch makes few kernels for its unsigned dtypes
    return torch.zeros(size, dtype=torch.int32, device=device).to(dtype)


def _live(size: int, count: torch.Tensor) -> torch.Tensor:
    return torch.arange(size, device=count.device) < count


def _take(sw, pos: torch.Tensor, live: torch.Tensor, dtype):
    """The planes at ``pos``, all-ones (the padding) in the dead slots."""
    return tuple(torch.where(live, w[pos], _ones(dtype)) for w in sw)


def _host(from_numpy: bool, t, dtype=None):
    return kdf.to_numpy(t, dtype) if from_numpy and t is not None else t


# ---------------------------------------------------------------------------
# unique


def _unique_sorted(sw, perm, size: int, dtype, decode_rep, return_index: bool,
                   return_inverse: bool, return_counts: bool, idt: torch.dtype):
    """The run-boundary pipeline over sorted planes (``perm`` the stable
    permutation, or None; every plane a key of ``dtype``): (values, index,
    inverse, counts, num_unique)."""
    n = int(sw[0].shape[0])
    is_new = _run_starts(sw)
    num = is_new.sum(dtype=torch.int32)
    starts = nonzero_static(is_new, size, n)
    live = _live(size, num)
    at = starts.clamp(max=n - 1)
    values = decode_rep(_take(sw, at, live, dtype))
    index = inverse = counts = None
    if return_index:
        index = torch.where(live, perm[at], 0).to(idt)
    if return_inverse:
        run = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
        inverse = torch.empty_like(run).scatter_(0, perm, run)
    if return_counts:
        lens = torch.diff(starts, append=starts.new_full((1,), n))
        counts = torch.where(live, lens, 0).to(torch.int32)
    return values, index, inverse, counts, num


def _unique_core(words, size: int, dtype, decode_rep, return_index: bool,
                 return_inverse: bool, return_counts: bool, idt: torch.dtype):
    """One stable argsort when a permutation is asked for, else one
    unstable keys-only sort of the composite planes ``words``."""
    if return_index or return_inverse:
        api._check_index_width(int(words[0].shape[0]), idt)
        sw, perm = hw_engine.argsort_words(words, index_dtype=torch.int64)
    else:
        (sw, _), perm = hw_engine.sort_words(words, stable=False), None
    return _unique_sorted(sw, perm, size, dtype, decode_rep, return_index, return_inverse,
                          return_counts, idt)


def _unique_1d(xt: torch.Tensor, dtype, size: Optional[int], return_index: bool,
               return_inverse: bool, return_counts: bool, config: SortConfig,
               idt: torch.dtype):
    n = int(xt.shape[0])
    size = n if size is None else int(size)
    desc, dev = config.descending, xt.device
    if n == 0:
        return (_max_pad(dtype, size, desc, dev),
                _zeros(size, idt, dev) if return_index else None,
                _zeros(0, torch.int32, dev) if return_inverse else None,
                _zeros(size, torch.int32, dev) if return_counts else None,
                _zeros((), torch.int32, dev))

    def decode_rep(reps):
        return kdf.decode(reps, dtype, desc)

    if return_index or return_inverse:
        return _unique_core(kdf.encode(xt, desc, dtype), size, dtype, decode_rep,
                            return_index, return_inverse, return_counts, idt)
    # no permutation: api.sort's dispatch (the counting kernels for narrow
    # keys, as in the JAX package: not bitmap_unique_sort)
    return _unique_sorted(_sorted_words(xt, dtype, config), None, size, dtype, decode_rep,
                          False, False, return_counts, idt)


def _unique_rows(x, axis: int, return_index: bool, return_inverse: bool,
                 return_counts: bool, size: Optional[int], config: SortConfig,
                 idt: torch.dtype, device):
    """Row-wise :func:`unique` (``axis=0`` / ``1``): (tensor results, key
    dtype, from_numpy)."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be None, 0 or 1, got {axis}")
    if _ndim(x) != 2:
        shape = tuple(x.shape) if torch.is_tensor(x) else np.shape(x)
        raise ValueError(f"axis={axis} needs a 2-D array, got shape {shape}")
    if torch.is_tensor(x):
        if device is not None and torch.device(device) != x.device:
            raise ValueError("device= places numpy input; a tensor stays on its own device")
        xt, dtype, from_numpy = x, x.dtype, False
    else:
        a = np.asarray(x)
        xt, dtype, from_numpy = kdf.as_tensor(a, kdf.input_device(device)), a.dtype, True
    if axis == 1:
        xt = xt.transpose(0, 1)           # unique columns: rows of the transpose
    n, k = int(xt.shape[0]), int(xt.shape[1])
    size = n if size is None else int(size)
    desc, dev = config.descending, xt.device
    if n == 0 or k == 0:
        # numpy: zero columns make every row equal (one unique when n > 0);
        # num_unique stays exact whatever size is
        vals = torch.stack([_max_pad(dtype, size, desc, dev) for _ in range(k)], dim=1) \
            if k else xt.new_zeros((size, 0) + tuple(xt.shape[2:]))
        cnt = _zeros(size, torch.int32, dev)
        if k == 0 and n and size:
            cnt[0] = n
        out = (vals, _zeros(size, idt, dev) if return_index else None,
               _zeros(n, torch.int32, dev) if return_inverse else None,
               cnt if return_counts else None,
               torch.tensor(0 if n == 0 else 1, dtype=torch.int32, device=dev))
    else:
        # one composite key: every column's planes, leftmost most significant
        cols = [kdf.encode(xt[:, j].contiguous(), desc, dtype) for j in range(k)]
        p = len(cols[0])

        def decode_rep(reps):
            return torch.stack([kdf.decode(reps[j * p:(j + 1) * p], dtype, desc)
                                for j in range(k)], dim=1)

        out = _unique_core(tuple(w for c in cols for w in c), size, dtype, decode_rep,
                           return_index, return_inverse, return_counts, idt)
    if axis == 1:
        out = (out[0].transpose(0, 1),) + out[1:]
    return out, dtype, from_numpy


def unique(x, *, return_index: bool = False, return_inverse: bool = False,
           return_counts: bool = False, size: Optional[int] = None,
           axis: Optional[int] = None, equal_nan: bool = False,
           config: SortConfig = DEFAULT_CONFIG, index_dtype=torch.uint32,
           device=None) -> UniqueResult:
    """``np.unique`` with the full flag surface, at a fixed shape.

    Sorted unique values and, on request, each one's first-occurrence index
    (``index``, as ``index_dtype``), each input element's slot (``inverse``,
    int32: ``values[inverse]`` rebuilds ``x``) and the run lengths
    (``counts``, int32). ``config.descending`` orders the uniques
    descending.

    No permutation flag: one sort through :func:`.api.sort`'s dispatch (u8
    and u16 keys take the counting kernels K2 + K5 / K8 where its gates
    admit them). ``index`` or ``inverse``: one stable argsort, the index the
    permutation at each run's start, the inverse scattered back through it.

    ``size`` (default ``len(x)``) must be at least the number of uniques for
    exact ``values`` / ``index`` / ``counts``; a smaller one keeps the first
    ``size`` runs and folds the dropped runs' mass into the last kept count.
    ``inverse`` and ``num_unique`` are exact whatever ``size`` is.

    ``axis=0``: unique rows of a 2-D array, sorted lexicographically
    (leftmost column first), with every flag; each column's planes join one
    composite key. ``axis=1``: unique columns (rows of the transpose).
    Equality is bitwise under the KDF order there too (numpy's axis path
    merges -0.0 with +0.0).

    ``equal_nan=True`` makes every NaN one value (numpy's default); the
    default ``False`` keeps NaN payloads apart, the bitwise contract of the
    JAX package (ROADMAP R3). With ``axis=`` it merges rows that differ in
    NaN payloads only.
    """
    idt = api._index_dtype(index_dtype)
    if equal_nan:
        x = _collapse_nans(x)
    if axis is not None:
        out, dtype, from_numpy = _unique_rows(x, axis, return_index, return_inverse,
                                              return_counts, size, config, idt, device)
    else:
        if _ndim(x) != 1:
            shape = tuple(x.shape) if torch.is_tensor(x) else np.shape(x)
            raise ValueError(f"keys must be 1-D, got shape {shape} "
                             "(pass axis=0 for row-wise unique)")
        xt, dtype, from_numpy = api._as_input(x, device)
        out = _unique_1d(xt, dtype, size, return_index, return_inverse, return_counts,
                         config, idt)
    values, index, inverse, counts, num = out
    return UniqueResult(_host(from_numpy, values, dtype), _host(from_numpy, index),
                        _host(from_numpy, inverse), _host(from_numpy, counts),
                        _host(from_numpy, num))


def unique_values(x, *, size: Optional[int] = None, config: SortConfig = DEFAULT_CONFIG,
                  device=None) -> UniqueValuesResult:
    """numpy-2 / array-API ``unique_values``: :func:`unique` with no flags;
    ``num_unique`` trails because the values are padded to ``size``."""
    r = unique(x, size=size, config=config, device=device)
    return UniqueValuesResult(r.values, r.num_unique)


def unique_counts(x, *, size: Optional[int] = None, config: SortConfig = DEFAULT_CONFIG,
                  device=None) -> UniqueCountsResult:
    """numpy-2 ``unique_counts``: values and multiplicities."""
    r = unique(x, return_counts=True, size=size, config=config, device=device)
    return UniqueCountsResult(r.values, r.counts, r.num_unique)


def unique_inverse(x, *, size: Optional[int] = None, config: SortConfig = DEFAULT_CONFIG,
                   index_dtype=torch.uint32, device=None) -> UniqueInverseResult:
    """numpy-2 ``unique_inverse``. The inverse is exact whatever ``size``
    is; ``values[inverse_indices]`` rebuilds ``x`` when ``size >=
    num_unique``."""
    r = unique(x, return_inverse=True, size=size, config=config, index_dtype=index_dtype,
               device=device)
    return UniqueInverseResult(r.values, r.inverse, r.num_unique)


def unique_all(x, *, size: Optional[int] = None, config: SortConfig = DEFAULT_CONFIG,
               index_dtype=torch.uint32, device=None) -> UniqueAllResult:
    """numpy-2 ``unique_all``: values, first-occurrence indices, inverse and
    counts from one stable argsort."""
    r = unique(x, return_index=True, return_inverse=True, return_counts=True, size=size,
               config=config, index_dtype=index_dtype, device=device)
    return UniqueAllResult(r.values, r.index, r.inverse, r.counts, r.num_unique)


# ---------------------------------------------------------------------------
# the binary set operations


def _check_pair(a, b, what: str) -> None:
    if _ndim(a) != 1 or _ndim(b) != 1:
        raise ValueError(f"{what} inputs must be 1-D")
    da, db = _dtype_of(a), _dtype_of(b)
    if kdf._canonical_dtype(da) != kdf._canonical_dtype(db):
        raise TypeError(f"{what} inputs must share a dtype, got {da} and {db}")


def _merged(at: torch.Tensor, bt: torch.Tensor, dtype, descending: bool):
    """(sorted planes, stable permutation as int64) of concat(a, b).

    Within a run of equal values the A elements come first and each side
    keeps its index order: the order of the JAX package's side-flag and
    index planes, read here off the permutation."""
    words = tuple(torch.cat([wa, wb]) for wa, wb in
                  zip(kdf.encode(at, descending, dtype), kdf.encode(bt, descending, dtype)))
    return hw_engine.argsort_words(words, index_dtype=torch.int64)


def _compact(sw, emit: torch.Tensor, size: int, dtype, descending: bool):
    """(values, count): the planes at the emitted positions, in order,
    padded with all-ones past the count; one emitted position per run."""
    n = int(sw[0].shape[0])
    count = emit.sum(dtype=torch.int32)
    pos = nonzero_static(emit, size, n).clamp(max=n - 1)
    return kdf.decode(_take(sw, pos, _live(size, count), dtype), dtype, descending), count


def _a_to_b(is_new: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """Where a run steps from its A elements to its B elements: one
    position in each run that holds both, its first B element."""
    prev = torch.cat([flag.new_zeros(1), flag[:-1]])
    return flag & ~(is_new | prev)


def _binary_setop(a, b, which: str, size: Optional[int], config: SortConfig, device):
    _check_pair(a, b, "set-op")
    (at, bt), (dtype, _), from_numpy = _inputs((a, b), device)
    na, nb = int(at.shape[0]), int(bt.shape[0])
    if size is None:
        size = {"union": na + nb, "intersect": min(na, nb), "diff": na, "xor": na + nb}[which]
    size = int(size)
    desc, dev = config.descending, at.device
    if na == 0 or nb == 0:
        # one side empty: unique() of the other side, or nothing
        keep = at if nb == 0 else bt
        if which == "intersect" or (na == 0 and which == "diff") or keep.shape[0] == 0:
            vals, count = _max_pad(dtype, size, desc, dev), _zeros((), torch.int32, dev)
        else:
            vals, _, _, _, count = _unique_1d(keep, dtype, size, False, False, False, config,
                                              torch.int64)
    else:
        sw, perm = _merged(at, bt, dtype, desc)
        flag = perm >= na                       # B side
        is_new = _run_starts(sw)
        is_last = torch.cat([is_new[1:], is_new.new_ones(1)])
        # a run holds A iff its first element is A, B iff its last is B
        emit = {"union": lambda: is_new,
                "intersect": lambda: _a_to_b(is_new, flag),
                "diff": lambda: is_last & ~flag,
                "xor": lambda: (is_new & flag) | (is_last & ~flag)}[which]()
        vals, count = _compact(sw, emit, size, dtype, desc)
    return _host(from_numpy, vals, dtype), _host(from_numpy, count)


def union1d(a, b, *, size: Optional[int] = None, config: SortConfig = DEFAULT_CONFIG,
            device=None):
    """Sorted union of two arrays: fixed-shape ``(values, count)``.

    ``values`` has length ``size`` (default ``len(a) + len(b)``, the exact
    bound); slots past ``count`` hold the KDF-order-last value. ``count`` is
    the exact cardinality; with a smaller ``size`` the first ``size``
    results are kept. The same contract holds for the four set operations.
    """
    return _binary_setop(a, b, "union", size, config, device)


def intersect1d(a, b, *, assume_unique: bool = False, return_indices: bool = False,
                size: Optional[int] = None, config: SortConfig = DEFAULT_CONFIG, device=None):
    """Sorted values present in both: ``(values, count)``; ``size``
    defaults to ``min(len(a), len(b))``. ``assume_unique`` is accepted and
    ignored (the merged sort is right with duplicates).

    ``return_indices=True``: ``(values, comm1, comm2, count)``, the first
    occurrence of each common value in ``a`` and in ``b`` (int32), padded
    with ``len(a)`` / ``len(b)``. In each run the first element is the
    first A occurrence, and the run's A-to-B step the first B occurrence.
    """
    del assume_unique
    if not return_indices:
        return _binary_setop(a, b, "intersect", size, config, device)
    _check_pair(a, b, "set-op")
    (at, bt), (dtype, _), from_numpy = _inputs((a, b), device)
    na, nb = int(at.shape[0]), int(bt.shape[0])
    n = na + nb
    size = min(na, nb) if size is None else int(size)
    desc, dev = config.descending, at.device
    if na == 0 or nb == 0:
        vals = _max_pad(dtype, size, desc, dev)
        comm1 = torch.full((size,), na, dtype=torch.int32, device=dev)
        comm2 = torch.full((size,), nb, dtype=torch.int32, device=dev)
        count = _zeros((), torch.int32, dev)
    else:
        sw, perm = _merged(at, bt, dtype, desc)
        is_new = _run_starts(sw)
        step = _a_to_b(is_new, perm >= na)
        count = step.sum(dtype=torch.int32)
        pos = nonzero_static(step, size, n).clamp(max=n - 1)
        live = _live(size, count)
        run = torch.cumsum(is_new, 0)
        start = torch.searchsorted(run, run[pos])        # each step's run start
        comm1 = torch.where(live, perm[start], na).to(torch.int32)
        comm2 = torch.where(live, perm[pos] - na, nb).to(torch.int32)
        vals = kdf.decode(_take(sw, pos, live, dtype), dtype, desc)
    return (_host(from_numpy, vals, dtype), _host(from_numpy, comm1),
            _host(from_numpy, comm2), _host(from_numpy, count))


def setdiff1d(a, b, *, size: Optional[int] = None, config: SortConfig = DEFAULT_CONFIG,
              device=None):
    """Sorted values of ``a`` not in ``b``: ``(values, count)``; ``size``
    defaults to ``len(a)``. Contract as :func:`union1d`."""
    return _binary_setop(a, b, "diff", size, config, device)


def setxor1d(a, b, *, size: Optional[int] = None, config: SortConfig = DEFAULT_CONFIG,
             device=None):
    """Sorted values in exactly one input: ``(values, count)``; ``size``
    defaults to ``len(a) + len(b)``. Contract as :func:`union1d`."""
    return _binary_setop(a, b, "xor", size, config, device)


# ---------------------------------------------------------------------------
# isin


def isin(element, test, *, assume_unique: bool = False, invert: bool = False,
         config: SortConfig = DEFAULT_CONFIG, device=None):
    """Membership of each of ``element`` in ``test`` (``np.isin``, 1-D): a
    bool array of ``len(element)``; ``invert=True`` negates it. Membership
    is bitwise under the KDF order (a NaN matches a bit-identical NaN
    only). ``assume_unique`` is accepted and ignored.

    One stable sort of concat(test, element): in each run the tests come
    first, so a run holds a test iff its first element is one. Each run's
    answer is scattered by run id (one cumsum) and gathered back to its
    positions, then one scatter through the permutation restores input
    order.
    """
    _check_pair(element, test, "isin")
    del assume_unique
    (et, tt), (dtype, _), from_numpy = _inputs((element, test), device)
    q, n = int(et.shape[0]), int(tt.shape[0])
    dev = et.device
    if q == 0 or n == 0:
        out = torch.full((q,), bool(invert), dtype=torch.bool, device=dev)
    else:
        desc, m = config.descending, n + q
        words = tuple(torch.cat([t, e]) for t, e in
                      zip(kdf.encode(tt, desc, dtype), kdf.encode(et, desc, dtype)))
        sw, perm = hw_engine.argsort_words(words, index_dtype=torch.int64)
        is_new = _run_starts(sw)
        run = torch.cumsum(is_new, 0, dtype=torch.int32 if m < 1 << 31 else torch.int64) - 1
        # run r's first element writes has_test[r]; the rest write slot m
        has_test = torch.zeros(m + 1, dtype=torch.bool, device=dev)
        has_test.scatter_(0, torch.where(is_new, run, m).long(), perm < n)
        member = has_test[run]
        out = torch.empty(m, dtype=torch.bool, device=dev)
        out[perm] = ~member if invert else member
        out = out[n:]
    return _host(from_numpy, out)


def in1d(ar1, ar2, *, assume_unique: bool = False, invert: bool = False,
         config: SortConfig = DEFAULT_CONFIG, device=None):
    """numpy < 2's ``in1d`` spelling of :func:`isin`."""
    return isin(ar1, ar2, assume_unique=assume_unique, invert=invert, config=config,
                device=device)
