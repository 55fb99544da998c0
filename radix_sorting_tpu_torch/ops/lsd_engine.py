"""LSD engine: the chunked least-significant-digit radix sort on the card.

The counterpart of ``radix_sorting_tpu.ops.lsd_engine`` (`Strategy.LSD`),
with its pass structure, for each live digit from the least significant
(`README.md:316-335`):

  1. per-tile digit histograms, L1 (:func:`.histogram.chunked_digit_histogram`,
     `radix_sort_u32.c:24-37`);
  2. exclusive scans into scatter bases (:func:`.scan.scatter_bases`,
     `radix_sort_u32.c:39-57`);
  3. the stable scatter into a fresh buffer, L2
     (:func:`.cuda_kernels.lsd_scatter`, `radix_sort_u32.c:59-90`): within a
     tile the j-th key of a digit lands at its base + j.

It serves ``Strategy.LSD`` and, for one plane on the card, the AUTO /
HW_SORT sorter K0 (:mod:`.hw_engine`).

A digit that is the same in every key is skipped when ``skip_trivial`` is set
(column skipping, `radix_sort.hpp:64-70`). The JAX package skips it on the
device with ``lax.cond``; here the live-digit flags come from one K1
``hist_multi`` read of every digit's histogram a plane (a digit is dead where
one bin holds all n keys, :func:`live_digit_flags`; every digit width of 1
to 16 bits is one K1 launch) and reach the host in one read a call, with the
presorted guard's flag when it is asked for.

The JAX engine pads n to a multiple of its chunk with all-ones sentinels;
the kernels here take a short last tile instead. The output of a stable sort
is unique, so neither the padding nor the tile changes a bit of it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import cuda_kernels, probes
from .histogram import chunked_digit_histogram
from .kdf import gather
from .scan import scatter_bases

__all__ = ["sort_words_lsd", "lsd_tile", "live_digit_flags"]


def lsd_tile(chunk: int, radix_bits: int) -> int:
    """Keys per tile of the kernels: ``chunk`` (``SortConfig.lsd_chunk``),
    raised to 2^radix_bits so that the (tiles, bins) counts, written,
    scanned and read once a pass, stay within n + 2^radix_bits (at 16-bit
    digits and the default 8192, tiles of 65,536 keys)."""
    return max(int(chunk), 1 << radix_bits)


def live_digit_flags(words: Sequence[torch.Tensor], radix_bits: int) -> torch.Tensor:
    """(digits,) bool on the planes' device, one flag per digit position,
    least significant first across the words (the order of
    :func:`.probes.live_digit_mask`): True where the digit varies. One K1
    ``hist_multi`` a plane; a digit is dead where one of its bins holds all
    n keys. No host read."""
    n = int(words[0].shape[0])
    return torch.cat([cuda_kernels.hist_multi(w, radix_bits).max(dim=1).values != n
                      for w in reversed(tuple(words))])


def sort_words_lsd(words: Sequence[torch.Tensor],
                   payloads: Sequence[torch.Tensor] = (),
                   radix_bits: int = 8, chunk: int = 8192,
                   skip_trivial: bool = True, guard: bool = False) -> Tuple[tuple, tuple]:
    """Stable ascending LSD radix sort of int32 word planes (most
    significant first), carrying payloads: (sorted words, payloads).

    The contract of :func:`.hw_engine.sort_words`. 1-D payloads of 4-byte
    elements ride the scatter as int32 views. Any other payload (8-, 2- or
    1-byte elements, ``(n, W)`` byte rows) rides as one shared int32 index
    plane and is gathered once at the end: a pass then moves 4 bytes for
    them all, where a 64-bit leaf would move 8 and a row W.

    ``guard``: the presorted early exit (`radix_sort.hpp:60-62`), its flag
    read with the live digits in one host read; an ordered input comes back
    as given and launches no pass.
    """
    words, payloads = tuple(words), tuple(payloads)
    n = int(words[0].shape[0])
    if n <= 1:
        return words, payloads
    words = tuple(w.contiguous() for w in words)      # the kernels read dense planes
    live = None
    if skip_trivial or guard:
        flags = [probes.is_sorted_words(words).view(1)] if guard else []
        if skip_trivial:
            flags.append(live_digit_flags(words, radix_bits))
        read = torch.cat(flags).tolist()          # the call's one host read
        if guard and read.pop(0):
            return words, payloads
        live = read if skip_trivial else None
    rides = [p.ndim == 1 and p.element_size() == 4 for p in payloads]
    planes = list(words) + [p.contiguous().view(torch.int32)
                            for p, r in zip(payloads, rides) if r]
    gathered = not all(rides)
    if gathered:
        planes.append(torch.arange(n, dtype=torch.int32, device=words[0].device))
    tile = lsd_tile(chunk, radix_bits)
    digits_per_word = -(-32 // radix_bits)
    for p in range(digits_per_word * len(words)):
        if live is not None and not live[p]:
            continue
        w = planes[len(words) - 1 - p // digits_per_word]
        shift = (p % digits_per_word) * radix_bits
        bases = scatter_bases(chunked_digit_histogram(w, shift, radix_bits, tile))
        planes = list(cuda_kernels.lsd_scatter(w, planes, shift, radix_bits, tile, bases))
    perm = planes.pop().long() if gathered else None
    riding = iter(planes[len(words):])
    out = tuple(next(riding).view(p.dtype) if r else gather(p, perm)
                for p, r in zip(payloads, rides))
    return tuple(planes[:len(words)]), out
