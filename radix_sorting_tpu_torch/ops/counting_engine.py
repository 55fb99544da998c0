"""COUNTING engine: histogram + regeneration for small live domains.

The counterpart of ``radix_sorting_tpu.ops.counting_engine`` for one- and
two-plane (64-bit) keys. A keys-only sort over a live domain of B = 2^k bit
patterns is fully determined by its histogram (`counting_sort_8.c:5-21`):
PEXT the live bits, count them, scan, and rewrite
``out[j] = #{b : cum[b] <= j}`` with the live bits PDEP-ed back and the
constant dead bits restored. A dense domain (values < bins) needs no PEXT:
K1 counts the values and K4/K7 regenerate them (:func:`counting_sort_compact`).

The range probes (:func:`sort_word_range_probe`,
:func:`sort_words2_range_probe`; ``SortConfig.device_probe``) read the key
range once and send keys whose range fits :func:`probe_bins` bins to that
dense tier, on ``w - min``; everything else goes to the sorter.

Routing keeps the JAX package's gates (``counting_max_bits``,
``_REGEN_MAX_BINS``, ``_REGEN_WIN_MAX_BINS``, ``_WIDE_MIN_KEYS_PER_BIN``,
``pick_window``, ``bins >= 4`` / ``nbits >= 2``), so the same input takes the
same route in both packages. The port builds the accelerator's dispatch
graph on every device: the kernel wrappers of :mod:`.cuda_kernels` launch on
CUDA tensors and run their plain versions on CPU tensors.

Two differences are deliberate.

* The JAX windowed tier wraps its regeneration in
  ``lax.cond(regen_windows_fit(...), regen, sorter)`` because a TPU block can
  only compare against a fixed VMEM window of bins. The Hopper regeneration
  kernel searches the whole cumulative histogram and is right for every
  distribution, so that check and its sorter fallback are gone; the output
  is the same, because the route is keys-only.
* The JAX probes decide on the device with ``lax.cond``, with no host sync.
  Eager PyTorch has no device-side branch, so a probe reads its decision on
  the host: one read of the key range per call (for 64-bit keys the ranges
  of both planes, in the same read). The sorter branch's presorted guard
  keeps its own read, as on the default sorter route: folding its flag into
  the probe's read would cost a full extra pass on the narrow branch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..utils.timing import READ, span
from . import cuda_kernels, hw_engine, probes
from .histogram import digit_histogram
from .kdf import INT32_MIN

__all__ = ["counting_sort_compact", "sort_word_counting",
           "sort_words_counting", "sort_word_range_probe",
           "sort_words2_range_probe", "probe_bins"]

# The JAX package's routing thresholds, kept as they are (tuned on a TPU;
# retuning them for the H100 is ROADMAP.md work, not a correctness matter).
_REGEN_MAX_BINS = 1 << 10
_REGEN_WIN_MAX_BINS = 1 << 16
_REGEN_WIDE_MAX_BINS = 1 << 17
_WIDE_MIN_KEYS_PER_BIN = 512


def _windowed_bins_ok(n: int, bins: int) -> bool:
    """Static gate: is the windowed counting tier applicable at (n, bins)?

    Power-of-two bins in (2^10, 2^17]; the uniform-case span bound must fit
    the JAX package's largest window; past 2^16 bins the keys-per-bin
    density floor applies too.
    """
    if not (4 <= bins <= _REGEN_WIDE_MAX_BINS) or bins & (bins - 1):
        return False
    if bins <= _REGEN_MAX_BINS:
        return False
    if cuda_kernels.pick_window(n, bins) == 0:
        return False
    if bins > _REGEN_WIN_MAX_BINS and n < bins * _WIDE_MIN_KEYS_PER_BIN:
        return False
    return True


def counting_sort_compact(c: torch.Tensor, bins: int) -> torch.Tensor:
    """Sort a dense-domain int32 plane (values < bins) by regeneration.

    The JAX package's TPU routes: 4 to 2^10 power-of-two bins take K1
    (:func:`.cuda_kernels.hist`) and K4 (:func:`.cuda_kernels.regen`); wider
    domains that the windowed gate admits take K1 and K7; other wide domains
    go to the sorter. Fewer than 4 bins, or a bin count that is not a power
    of two, take the plain histogram and ``searchsorted`` rewrite, as in the
    JAX package.
    """
    n = int(c.shape[0])
    if bins > _REGEN_MAX_BINS and not _windowed_bins_ok(n, bins):
        (s,), _ = hw_engine.sort_words((c,), stable=False)
        return s
    if bins >= 4 and bins & (bins - 1) == 0:
        hist = cuda_kernels.hist(c, 0, bins.bit_length() - 1)
        return cuda_kernels.regen(torch.cumsum(hist, 0, dtype=torch.int32), n)
    cum = torch.cumsum(digit_histogram(c, bins), 0, dtype=torch.int32)
    j = torch.arange(n, dtype=torch.int32, device=c.device)
    return torch.searchsorted(cum, j, right=True).to(torch.int32)


def probe_bins(n: int) -> int:
    """Widest dense domain the range probe uses at size n: the largest power
    of two whose windowed tier is applicable at this n (2^17 only from
    n >= 2^17 * 512, 2^16 from ~8.4M), else the plain tier's 2^10."""
    for bits in range(17, 10, -1):
        if _windowed_bins_ok(n, 1 << bits):
            return 1 << bits
    return _REGEN_MAX_BINS


def _unsigned(v: int) -> int:
    """A sign-flipped int32 value read on the host, as the u32 it orders."""
    return (v ^ INT32_MIN) & 0xFFFFFFFF


def _ranges(planes: Sequence[torch.Tensor]) -> Tuple[Tuple[int, int], ...]:
    """Unsigned (min, max) of each plane, in ONE host read."""
    mm = torch.cat([torch.stack(torch.aminmax(p ^ INT32_MIN)) for p in planes])
    with span(READ):
        flat = mm.tolist()
    return tuple((_unsigned(flat[2 * i]), _unsigned(flat[2 * i + 1]))
                 for i in range(len(planes)))


def _sorter(words: Tuple[torch.Tensor, ...], guard: bool):
    if guard:
        sw, _ = hw_engine.sort_words_presort_guard(words, stable=False)
    else:
        sw, _ = hw_engine.sort_words(words, stable=False)
    return tuple(sw)


def _range_sort(w: torch.Tensor, mn: int, mx: int, guard: bool) -> torch.Tensor:
    """The probe's branch for one word whose unsigned range is [mn, mx]."""
    n = int(w.shape[0])
    bins = probe_bins(n)
    if mx - mn >= bins:
        return _sorter((w,), guard)[0]
    # narrow: K1 counts w - mn (subtracted on the read), K4 (<= 2^10 bins)
    # or K7 writes the sorted values plus mn (added on the store)
    hist = cuda_kernels.hist(w, 0, bins.bit_length() - 1, offset=mn)
    cum = torch.cumsum(hist, 0, dtype=torch.int32)
    return cuda_kernels.regen(cum, n, offset=mn)


def sort_word_range_probe(w: torch.Tensor, guard: bool = False) -> torch.Tensor:
    """Keys-only sort of one derived word, dispatched on its key range.

    The reference's always-on probe (`radix_sort.hpp:64-70`) as a range
    check: one min/max reduce, read on the host, decides whether the keys
    fit :func:`probe_bins` bins; if so the dense counting tier sorts
    ``w - min`` and adds the offset back (no PEXT needed), otherwise the
    sorter runs. ``guard``: the sorter branch uses the presorted guard.
    """
    if int(w.shape[0]) <= 1:
        return w
    ((mn, mx),) = _ranges((w,))
    return _range_sort(w, mn, mx, guard)


def sort_words2_range_probe(hi: torch.Tensor, lo: torch.Tensor,
                            guard: bool = False):
    """Keys-only sort of a two-word (64-bit) derived key, dispatched on the
    ranges of both planes (one host read).

    A constant hi plane (every key in one 2^32 span: clustered timestamps,
    offset ids) leaves the order to the lo plane, which then takes the
    single-word probe's branch: one sorter operand, or the dense counting
    tier when its range is narrow. Otherwise the two-word sorter runs.
    Returns the sorted ``(hi, lo)`` planes.
    """
    if int(hi.shape[0]) <= 1:
        return hi, lo
    (hmn, hmx), (lmn, lmx) = _ranges((hi, lo))
    if hmn != hmx:
        return _sorter((hi, lo), guard)
    # a constant plane is its own sorted self
    return hi, _range_sort(lo, lmn, lmx, guard)


def sort_word_counting(w: torch.Tensor, live_mask: int,
                       descending: bool = False) -> torch.Tensor:
    """Keys-only sort of one derived word with a static live-bit mask
    (the mask's popcount sets the bin count; callers keep the budget)."""
    (out,) = sort_words_counting((w,), (int(live_mask),), descending=descending)
    return out


def sort_words_counting(words: Sequence[torch.Tensor], masks: Sequence[int],
                        descending: bool = False) -> Tuple[torch.Tensor, ...]:
    """Keys-only counting sort of derived keys with static live masks.

    ``words`` are one plane or two (``(hi, lo)``), ``masks`` their live-bit
    masks; ``sum(popcount(m))`` must be <= 32. Past the regeneration budget,
    where the windowed gate rejects (n, bins), the raw planes are sorted
    instead (dead bits are constant under the mask promise, so raw order is
    compacted order).
    """
    words = tuple(words)
    masks = tuple(int(m) for m in masks)
    nbits = sum(bin(m).count("1") for m in masks)
    if nbits > 32:
        raise ValueError("compacted live bits must fit one 32-bit word")
    bins = 1 << nbits
    n = int(words[0].shape[0])
    if bins > _REGEN_MAX_BINS and not _windowed_bins_ok(n, bins):
        s, _ = hw_engine.sort_words(words, stable=False)
        return tuple(p.flip(0) for p in s) if descending else s

    # Fused tier: PEXT inside the histogram read, PDEP and the dead bits
    # inside the regeneration write; two (three for two planes) full-array
    # streams in all. Both the plain (<= 2^10 bins) and the windowed tier
    # run the same kernels. nbits >= 2 mirrors the JAX gate (2-bin domains
    # take the plain path).
    if not descending and nbits >= 2:
        if len(words) == 1 and masks[0]:
            (w,) = words
            hist = cuda_kernels.hist_pext(w, masks[0])
            cum = torch.cumsum(hist, 0, dtype=torch.int32)
            return (cuda_kernels.regen_pdep(cum, n, masks[0], w),)
        if len(words) == 2:
            hi, lo = words
            hist = cuda_kernels.hist_pext2(hi, lo, masks[0], masks[1])
            cum = torch.cumsum(hist, 0, dtype=torch.int32)
            return cuda_kernels.regen_pdep2(cum, n, masks[0], masks[1], hi, lo)

    c = probes.compact_word_planes(words, masks)
    if descending:
        c = (bins - 1) - c
    s = counting_sort_compact(c, bins)
    if descending:
        s = (bins - 1) - s
    return probes.expand_word_planes(s, words, masks)
