"""Order statistics, ranks and binning: the counterpart of
``radix_sorting_tpu.stats``, whole.

``rankdata`` (``scipy.stats.rankdata``), ``quantile`` / ``percentile`` /
``median``, ``digitize``, ``histogram`` (integer bins or an edge array) and
``histogram_bin_edges``, ``mode``, ``partition`` / ``argpartition``. Inputs
and outputs follow :mod:`.api`: a tensor stays on its device and its results
are tensors; a numpy input goes to ``device=`` (the CUDA device by default)
and its results come back numpy. Bin edges are numpy float64 arrays, as in
the JAX package. Floats order by the KDF total order (-0.0 < +0.0, NaNs above
+inf by payload): numpy's NaN-propagating quantiles are not replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import api
from .config import DEFAULT_CONFIG, SortConfig
from .extras import (_DENSE_BUDGET, _int64_values, _length, _results, _sorted_words,
                     _to_float, bincount, group_reduce, searchsorted, value_counts)
from .ops import cuda_kernels, hw_engine, kdf

__all__ = ["rankdata", "quantile", "percentile", "median", "mode", "digitize",
           "histogram", "histogram_bin_edges", "partition", "argpartition"]

_RANK_METHODS = ("average", "min", "max", "dense", "ordinal")
_Q_METHODS = ("linear", "lower", "higher", "nearest", "midpoint")


def _extent(xt: torch.Tensor, dtype) -> Tuple[float, float]:
    """(min, max) of the values, in one host read: integers of <= 32 bits
    exactly, everything else as the float32 values that are binned."""
    if kdf.kind(dtype) in ("u", "i", "b") and kdf.key_bits(dtype) <= 32:
        t = _int64_values(xt, dtype)
    else:
        t = xt.to(torch.float32)
    lo, hi = torch.stack(torch.aminmax(t)).tolist()
    return float(lo), float(hi)


def _edges(xt: torch.Tensor, dtype, bins: int, range) -> np.ndarray:
    if bins <= 0:
        raise ValueError(f"bins must be positive, got {bins}")
    if range is None:
        lo, hi = _extent(xt, dtype) if xt.shape[0] else (0.0, 1.0)
    else:
        lo, hi = float(range[0]), float(range[1])
        if not lo <= hi:
            raise ValueError(f"range must be increasing, got {(lo, hi)}")
    if lo == hi:         # numpy widens a degenerate range by +-0.5
        lo, hi = lo - 0.5, hi + 0.5
    return np.linspace(lo, hi, bins + 1)


def histogram_bin_edges(x, bins: int = 10, range: Optional[Tuple[float, float]] = None,
                        *, device=None) -> np.ndarray:
    """Uniform bin edges for :func:`histogram` (``np.histogram_bin_edges``
    for integer ``bins``). Without ``range`` the data's extent is taken:
    one device reduce and one host read; pass ``range`` to stay sync-free."""
    if range is not None:
        return _edges(None, None, bins, range)
    xt, dtype, _ = api._as_input(x, device)
    return _edges(xt, dtype, bins, None)


def histogram(x, bins: Union[int, np.integer, Sequence] = 10,
              range: Optional[Tuple[float, float]] = None, weights=None,
              density: bool = False, *, device=None):
    """``np.histogram``: ``(counts, edges)``.

    ``bins`` is an integer (uniform edges over ``range`` or the data's
    extent, see :func:`histogram_bin_edges`) or an increasing array of at
    least two edges. Values outside the edges (NaN too) are dropped and the
    last bin is closed on the right. Binning is float32, as in the JAX
    package: uniform bins take ``floor((x - lo) * scale)`` in f32
    arithmetic, so a value within about one f32 ulp of an interior edge may
    land one bin off numpy's float64 arithmetic; edge arrays take one
    :func:`digitize` of the values against the edges cast to float32 (exact
    against numpy where the edges are f32 values).

    Unweighted counts (int32) go through :func:`.extras.bincount` (K1).
    Weighted sums (float32) go through K11 (:func:`.ops.cuda_kernels.whist_f32`)
    when ``2 * bins <= 2^17`` (bins: ``nb + 1`` rounded up to a power of two),
    else through :func:`.extras.group_reduce` and an add into the bins. A
    non-finite weight makes only its own bin non-finite. ``density=True``
    returns float32.
    """
    xt, dtype, from_numpy = api._as_input(x, device)
    n = int(xt.shape[0])
    xf = xt.to(torch.float32)
    f32 = torch.float32

    def scalar(v):
        return torch.tensor(np.float32(v), dtype=f32, device=xt.device)

    if isinstance(bins, (int, np.integer)):
        nb = int(bins)
        edges = _edges(xt, dtype, nb, range)
        lo, hi = scalar(edges[0]), scalar(edges[-1])
        idx = torch.floor((xf - lo) * scalar(nb / (edges[-1] - edges[0]))).to(torch.int32)
        # close the last bin on the right; everything outside [lo, hi], NaN
        # included, goes to the drop bin nb
        idx = torch.where(idx == nb, nb - 1, idx)
        idx = torch.where((xf >= lo) & (xf <= hi), idx, nb)
    else:
        edges = np.asarray(bins, np.float64)
        if edges.ndim != 1 or edges.shape[0] < 2:
            raise ValueError("bin edges must be a 1-D array of length >= 2")
        if np.any(edges[1:] < edges[:-1]):
            raise ValueError("bin edges must be increasing")
        nb = edges.shape[0] - 1
        pos = digitize(xf, torch.as_tensor(edges.astype(np.float32), device=xt.device),
                       descending=False)
        last = scalar(edges[-1])
        idx = torch.where(xf == last, nb - 1, pos - 1)       # the last bin closed
        # pos 0: below edges[0] (side 'right' counts the equals)
        idx = torch.where((pos == 0) | (xf > last) | torch.isnan(xf), nb, idx)

    if weights is None:
        counts = bincount(idx, length=nb + 1)[:nb]
    elif n == 0:
        counts = torch.zeros(nb, dtype=f32, device=xt.device)
    else:
        wt, _, _ = api._as_input(weights, None if torch.is_tensor(weights) else xt.device)
        if wt.shape != xt.shape or wt.device != xt.device:
            raise ValueError("weights must match the input's shape and device")
        wf = wt.to(f32)
        bbins = 1 << max(2, nb.bit_length())      # covers [0, nb]; drop bin nb
        if 2 * bbins <= _DENSE_BUDGET:
            counts = cuda_kernels.whist_f32(idx, wf, bbins.bit_length() - 1,
                                            drop_ge=nb + 1)[:nb]
        else:
            uk, sums, _ = group_reduce(idx.view(torch.uint32), wf, reduce="sum",
                                       size=min(n, nb + 1))
            at = uk.view(torch.int32).long().clamp(0, nb)   # padding keys: bin 0, + 0
            counts = torch.zeros(nb + 1, dtype=f32, device=xt.device)
            counts = counts.index_add_(0, at, sums)[:nb]
    if density:
        widths = torch.as_tensor(np.diff(edges), dtype=f32, device=xt.device)
        counts = counts.to(f32) / (counts.sum().to(f32) * widths)
    return _results(from_numpy, (counts, None))[0], edges


def mode(x, *, config: SortConfig = DEFAULT_CONFIG, device=None):
    """Most frequent value and its count (``scipy.stats.mode``: ties go to
    the smallest value). One :func:`.extras.value_counts`, then the first
    largest count, which is the smallest tied value since the runs are
    sorted. Returns ``(value, count)``, both 0-d (count int32)."""
    ndim = x.ndim if torch.is_tensor(x) else np.ndim(x)
    if ndim != 1:
        raise ValueError(f"keys must be 1-D, got {ndim} dimensions")
    n = int(x.shape[0]) if torch.is_tensor(x) else len(x)
    if n == 0:
        raise ValueError("mode of an empty array is undefined")
    vals, counts, _ = value_counts(x, config=config, device=device)
    if isinstance(vals, np.ndarray):
        w = int(np.argmax(counts))
        return vals[w], np.int32(counts[w])
    win = torch.argmax(counts)
    return hw_engine.gather(vals, win), counts[win]


# ---------------------------------------------------------------------------
# quantiles; the helpers are shared with ``parallel.distributed_quantile``


def _quantile_positions(qs, n: int, method: str):
    """(lo_idx, hi_idx, frac) int64 / float64 take positions for quantiles
    ``qs`` over ``n`` sorted elements."""
    h = qs * (n - 1)
    lo_i = np.floor(h).astype(np.int64)
    hi_i = np.ceil(h).astype(np.int64)
    frac = h - lo_i
    if method == "lower":
        hi_i = lo_i
    elif method == "higher":
        lo_i = hi_i
    elif method == "nearest":
        # numpy rounds half to the EVEN neighbouring index
        lo_i = hi_i = np.rint(h).astype(np.int64)
    return lo_i, hi_i, frac


def _quantile_combine(lo, hi, frac, method: str):
    """Interpolate gathered (lo, hi) order statistics. numpy arrays combine
    in float64 with numpy's own ``_lerp`` rounding form (the callers pass
    the values of 64-bit keys so); tensors combine in float32 on their
    device."""
    if method in ("lower", "higher", "nearest"):
        return lo
    if isinstance(lo, np.ndarray):
        a, b = lo.astype(np.float64), hi.astype(np.float64)
        if method == "midpoint":
            return a * 0.5 + b * 0.5
        t = frac
        return np.where(t >= 0.5, b - (b - a) * (1.0 - t), a + (b - a) * t)
    a, b = _to_float(lo, torch.float32), _to_float(hi, torch.float32)
    if method == "midpoint":
        return (a + b) * 0.5
    f = torch.as_tensor(np.asarray(frac, np.float32), device=lo.device)
    return a * (1.0 - f) + b * f


def quantile(x, q, *, method: str = "linear", config: SortConfig = DEFAULT_CONFIG,
             device=None):
    """Exact quantiles of ``x`` at probabilities ``q`` in [0, 1]
    (``np.quantile``); ``method`` is numpy's ``'linear'`` (default),
    ``'lower'``, ``'higher'``, ``'nearest'`` or ``'midpoint'``.

    Returns a scalar for a scalar ``q``, else a (len(q),) array: of the
    input's dtype for the exact methods (numpy promotes integers to float64
    there), float32 for the interpolating ones, combined on the device;
    float64 for 64-bit keys, combined on the host with numpy's rounding, as
    the JAX package combines them (and byte strings, which it keeps on the
    host too). One full sort (:func:`.api.sort`'s route: narrow keys at the
    counting kernels' speed), then a take of the positions' planes and one
    interpolation. NaNs are the top order statistics (KDF order), where
    numpy propagates them.
    """
    if method not in _Q_METHODS:
        raise ValueError(f"method must be one of {_Q_METHODS}, got {method!r}")
    scalar = np.ndim(q) == 0
    qs = np.atleast_1d(np.asarray(q, np.float64))
    if qs.ndim != 1:
        raise ValueError(f"q must be a scalar or 1-D sequence, got shape {qs.shape}")
    if qs.size and (np.min(qs) < 0.0 or np.max(qs) > 1.0):
        raise ValueError("quantile probabilities must lie in [0, 1]")
    n = _length(x)
    if n == 0:
        raise ValueError("quantile of an empty array is undefined")
    xt, dtype, from_numpy = api._as_input(x, device)
    sw = _sorted_words(xt, dtype, config)
    lo_i, hi_i, frac = _quantile_positions(qs, n, method)

    def take(i):
        idx = torch.as_tensor(i, device=xt.device)
        return kdf.decode(tuple(w[idx] for w in sw), dtype, config.descending)

    lo, hi = take(lo_i), take(hi_i)
    if method in ("lower", "higher", "nearest"):
        out = _results(from_numpy, (lo, dtype))[0]
    elif kdf.key_bits(dtype) == 64 or kdf.kind(dtype) == "S":
        out = _quantile_combine(kdf.to_numpy(lo, dtype), kdf.to_numpy(hi, dtype), frac,
                                method)
        out = out if from_numpy else torch.from_numpy(out).to(xt.device)
    else:
        out = _results(from_numpy, (_quantile_combine(lo, hi, frac, method), None))[0]
    return out[0] if scalar else out


def percentile(x, q, *, method: str = "linear", config: SortConfig = DEFAULT_CONFIG,
               device=None):
    """``np.percentile``: :func:`quantile` at ``q / 100``."""
    return quantile(x, np.asarray(q, np.float64) / 100.0 if np.ndim(q) else float(q) / 100.0,
                    method=method, config=config, device=device)


def median(x, *, config: SortConfig = DEFAULT_CONFIG, device=None):
    """``np.median``: the linear 0.5 quantile (see :func:`quantile`)."""
    return quantile(x, 0.5, config=config, device=device)


# ---------------------------------------------------------------------------
# rankdata, digitize, partition


def rankdata(x, *, method: str = "average", config: SortConfig = DEFAULT_CONFIG,
             device=None):
    """Tie-aware 1-based ranks (``scipy.stats.rankdata``).

    ``'average'`` gives tied keys the mean of their positions, ``'min'`` /
    ``'max'`` the first / last, ``'dense'`` consecutive group numbers,
    ``'ordinal'`` distinct ranks in input order among ties. The order
    follows ``config.descending``; ties group bitwise under the KDF total
    order. Returns float32 for ``'average'`` (exact below 2^23), else int32.

    One stable argsort, boundary flags in sorted order, each position's run
    number by one cumsum, each run's first position by one scatter (the
    next run's first, less one, is its last), then one scatter through the
    permutation restores input order (the JAX package sorts the
    (permutation, rank) planes: the same bits, the permutation being
    unique). The JAX package takes the run starts and ends as running
    maxima (``lax.cummax``); ``torch.cummax`` scans a 1-D tensor in one
    block: 110.8 ms for 40M int32 keys on an H100 80GB HBM3 at 700 W,
    against 11.9 ms for this whole call (PERF.md, run BY).
    """
    if method not in _RANK_METHODS:
        raise ValueError(f"method must be one of {_RANK_METHODS}, got {method!r}")
    words, _, from_numpy = api._as_words(x, config.descending, device)
    n = int(words[0].shape[0])
    dev = words[0].device
    if n == 0:
        out = torch.zeros(0, dtype=torch.float32 if method == "average" else torch.int32,
                          device=dev)
        return kdf.to_numpy(out) if from_numpy else out
    api._check_index_width(n, torch.uint32)
    sw, perm = hw_engine.argsort_words(words, index_dtype=torch.int32)
    neq = sw[0][1:] != sw[0][:-1]
    for w in sw[1:]:
        neq = neq | (w[1:] != w[:-1])
    is_new = torch.cat([neq.new_ones(1), neq])
    run = torch.cumsum(is_new, 0, dtype=torch.int32)        # 1-based: the dense rank
    i = torch.arange(n, dtype=torch.int32, device=dev)
    if method == "ordinal":
        num = 2 * i + 2                     # numerators of 2 * rank, halved at the end
    elif method == "dense":
        num = 2 * run
    else:
        # first[r]: run r's first position (every other position writes the
        # spill slot 0); first[runs + 1] = n closes the last run
        first = torch.zeros(n + 2, dtype=torch.int32, device=dev)
        first.scatter_(0, torch.where(is_new, run, 0).long(), i)
        first.scatter_(0, (run[-1:] + 1).long(), torch.full((1,), n, dtype=torch.int32,
                                                                device=dev))
        if method == "min":
            num = 2 * first[run] + 2
        elif method == "max":
            num = 2 * first[run + 1]                         # 2 * (last + 1)
        else:
            num = first[run] + first[run + 1] + 1            # first + last + 2
    restored = torch.empty(n, dtype=torch.int32, device=dev)
    restored[perm.long()] = num.to(torch.int32)
    out = restored.to(torch.float32) * 0.5 if method == "average" else restored // 2
    return kdf.to_numpy(out) if from_numpy else out


def digitize(x, bins, *, right: bool = False, descending: Optional[bool] = None,
             device=None):
    """Bin index of each value against monotonic ``bins`` (``np.digitize``).

    Increasing bins: ``bins[i-1] <= x < bins[i]`` (``right=True``:
    ``bins[i-1] < x <= bins[i]``); decreasing bins reverse both. One
    :func:`.extras.searchsorted`, numpy's own equivalence, with side
    ``'right'`` exactly when ``right == descending``. ``descending=None``
    reads the order from the end values of ``bins`` on the host (one read
    of two values for a tensor). Monotonicity is the caller's promise (numpy
    checks the ends only).
    """
    if descending is None:
        shape = tuple(bins.shape) if torch.is_tensor(bins) else np.shape(bins)
        if len(shape) != 1:
            raise ValueError(f"bins must be 1-D, got shape {shape}")
        nb, descending = shape[0], False
        if nb >= 2:                          # the first and the last bin
            ends = bins[:: nb - 1] if torch.is_tensor(bins) else np.asarray(bins)[:: nb - 1]
            ends = kdf.to_numpy(ends) if torch.is_tensor(ends) else ends
            descending = bool(ends[0] > ends[1])
    side = "right" if bool(right) == bool(descending) else "left"
    return searchsorted(bins, x, side=side, config=SortConfig(descending=bool(descending)),
                        device=device)


def _check_kth(kth, n: int) -> None:
    for k in np.atleast_1d(np.asarray(kth, np.int64)):
        if not -n <= k < n:
            raise ValueError(f"kth {int(k)} out of range for {n} elements")


def partition(x, kth, *, config: SortConfig = DEFAULT_CONFIG, device=None):
    """``np.partition``: returns the fully sorted array, the strongest order
    that meets the contract (one :func:`.api.sort`; no partial selection is
    cheaper than the sort's routes). ``kth`` (int or ints) is checked
    against [-n, n) and otherwise unused."""
    _check_kth(kth, _length(x))
    return api.sort(x, config=config, device=device)


def argpartition(x, kth, *, config: SortConfig = DEFAULT_CONFIG, index_dtype=torch.uint32,
                 device=None):
    """``np.argpartition``: the full stable argsort permutation (see
    :func:`partition`)."""
    _check_kth(kth, _length(x))
    return api.argsort(x, config=config, index_dtype=index_dtype, device=device)
