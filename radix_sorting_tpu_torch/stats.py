"""Statistics built on the group-by slice: ``histogram``, its bin edges, ``mode``.

The counterpart of ``radix_sorting_tpu.stats`` for the functions ported so
far (ROADMAP.md, port queue item 5 lists the rest). Inputs and outputs
follow :mod:`.api`: a tensor stays on its device and its results are
tensors; a numpy input goes to ``device=`` (the CUDA device by default) and
its results come back numpy. Bin edges are numpy float64 arrays, as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import api
from .config import DEFAULT_CONFIG, SortConfig
from .extras import (_DENSE_BUDGET, _int64_values, _results, bincount, group_reduce,
                     value_counts)
from .ops import cuda_kernels, hw_engine, kdf

__all__ = ["histogram", "histogram_bin_edges", "mode"]

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


def histogram(x, bins: Union[int, np.integer] = 10,
              range: Optional[Tuple[float, float]] = None, weights=None,
              density: bool = False, *, device=None):
    """``np.histogram`` with integer ``bins``: ``(counts, edges)``.

    Uniform edges over ``range`` or the data's extent (see
    :func:`histogram_bin_edges`); values outside them (NaN too) are dropped
    and the last bin is closed on the right. Binning is float32, as in the
    JAX package: ``floor((x - lo) * scale)`` in f32 arithmetic, so a value
    within about one f32 ulp of an interior edge may land one bin off
    numpy's float64 arithmetic.

    Unweighted counts (int32) go through :func:`.extras.bincount` (K1).
    Weighted sums (float32) go through K11 (:func:`.ops.cuda_kernels.whist_f32`)
    when ``2 * bins <= 2^17`` (bins: ``nb + 1`` rounded up to a power of two),
    else through :func:`.extras.group_reduce` and an add into the bins. A
    non-finite weight makes only its own bin non-finite. ``density=True``
    returns float32. Edge-array ``bins`` need ``searchsorted``, not ported
    yet: they raise NotImplementedError.
    """
    if not isinstance(bins, (int, np.integer)):
        raise NotImplementedError(
            "histogram with an array of bin edges needs searchsorted, not "
            "ported yet (ROADMAP.md, port queue item 5); pass an integer bins")
    xt, dtype, from_numpy = api._as_input(x, device)
    n = int(xt.shape[0])
    nb = int(bins)
    edges = _edges(xt, dtype, nb, range)
    xf = xt.to(torch.float32)
    f32 = torch.float32

    def scalar(v):
        return torch.tensor(np.float32(v), dtype=f32, device=xt.device)

    lo, hi = scalar(edges[0]), scalar(edges[-1])
    idx = torch.floor((xf - lo) * scalar(nb / (edges[-1] - edges[0]))).to(torch.int32)
    # close the last bin on the right; everything outside [lo, hi], NaN
    # included, goes to the drop bin nb
    idx = torch.where(idx == nb, nb - 1, idx)
    idx = torch.where((xf >= lo) & (xf <= hi), idx, nb)

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
# quantile helpers, shared with ``parallel.distributed_quantile`` (the public
# ``quantile`` is not ported yet: ROADMAP.md, port queue item 4)


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
    in float64 with numpy's own ``_lerp`` rounding form; tensors combine in
    float32 on their device."""
    if method in ("lower", "higher", "nearest"):
        return lo
    if isinstance(lo, np.ndarray):
        a, b = lo.astype(np.float64), hi.astype(np.float64)
        if method == "midpoint":
            return a * 0.5 + b * 0.5
        t = frac
        return np.where(t >= 0.5, b - (b - a) * (1.0 - t), a + (b - a) * t)
    from .extras import _to_float
    a, b = _to_float(lo, torch.float32), _to_float(hi, torch.float32)
    if method == "midpoint":
        return (a + b) * 0.5
    f = torch.as_tensor(np.asarray(frac, np.float32), device=lo.device)
    return a * (1.0 - f) + b * f
