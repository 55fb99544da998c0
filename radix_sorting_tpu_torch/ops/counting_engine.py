"""COUNTING engine: histogram + regeneration for small live domains.

The counterpart of ``radix_sorting_tpu.ops.counting_engine`` for one- and
two-plane (64-bit) keys. A keys-only sort over a live domain of B = 2^k bit
patterns is fully determined by its histogram (`counting_sort_8.c:5-21`):
PEXT the live bits, count them, scan, and rewrite
``out[j] = #{b : cum[b] <= j}`` with the live bits PDEP-ed back and the
constant dead bits restored.

Routing keeps the JAX package's gates (``counting_max_bits``,
``_REGEN_MAX_BINS``, ``_REGEN_WIN_MAX_BINS``, ``_WIDE_MIN_KEYS_PER_BIN``,
``pick_window``, ``bins >= 4`` / ``nbits >= 2``), so the same input takes the
same route in both packages. The port builds the accelerator's dispatch
graph on every device: the kernel wrappers of :mod:`.cuda_kernels` launch on
CUDA tensors and run their plain versions on CPU tensors.

One difference is deliberate. The JAX windowed tier wraps its regeneration in
``lax.cond(regen_windows_fit(...), regen, sorter)`` because a TPU block can
only compare against a fixed VMEM window of bins. The Hopper regeneration
kernel searches the whole cumulative histogram and is right for every
distribution, so that check and its sorter fallback are gone; the output is
the same, because the route is keys-only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import cuda_kernels, hw_engine, probes
from .histogram import digit_histogram

__all__ = ["counting_sort_compact", "sort_words_counting"]

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

    Plain PyTorch: histogram, inclusive scan, ``searchsorted`` rewrite.
    Domains wider than ``_REGEN_MAX_BINS`` go to the sorter. (The JAX
    package's TPU route here runs K1/K4/K7, which the slice's main path
    does not reach; ROADMAP.md, port queue item 5.)
    """
    n = int(c.shape[0])
    if bins > _REGEN_MAX_BINS:
        (s,), _ = hw_engine.sort_words((c,), stable=False)
        return s
    cum = torch.cumsum(digit_histogram(c, bins), 0, dtype=torch.int32)
    j = torch.arange(n, dtype=torch.int32, device=c.device)
    return torch.searchsorted(cum, j, right=True).to(torch.int32)


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
