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

It serves ``Strategy.LSD``. K0, the AUTO / HW_SORT sorter of one or two
planes on the card (:mod:`.hw_engine`), runs the same loop with one launch a live
digit, :func:`.cuda_kernels.k0_sweep`: the digits' global starts from the
histograms the live-digit read already made (one cumsum), and each tile's
prefix from a decoupled look-back in the launch, in place of L1 and the
scan (:func:`sort_words_k0`).

A digit that is the same in every key is skipped when ``skip_trivial`` is set
(column skipping, `radix_sort.hpp:64-70`). The JAX package skips it on the
device with ``lax.cond``; here the live-digit flags come from one K1
``live_digits`` read of every digit's histogram of one plane or two (a digit
is dead where one bin holds all n keys, :func:`live_digit_flags`; every
digit width of 1 to 16 bits is one K1 launch) and reach the host in one read
a call. K0's presorted guard (`radix_sort.hpp:48-62`), where it is asked for,
is the same launch: each key is compared with the one before it as it is
read, and the flag leads the same host read, so an ordered input launches
no pass and costs one read of the keys. Three or more planes take one
``hist_multi`` a plane.

K0's two planes may come as a pair, the two halves of one dense 64-bit
buffer (:func:`.kdf.halves`: ``api.sort`` and ``api.argsort`` encode an
ascending u64 key so, with no copy). The live-digit read and the first live
pass then read the caller's words where they lie, the last live pass
writes the sorted keys as the halves of one fresh buffer, which
:func:`.kdf.join64` returns as it is, and the passes between take dense
planes; where no pass runs, the pair is copied once, so no result is a view
of the input.

The JAX engine pads n to a multiple of its chunk with all-ones sentinels;
the kernels here take a short last tile instead. The output of a stable sort
is unique, so neither the padding nor the tile changes a bit of it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..utils.timing import K0, K0_PASS, LIVE_DIGITS, READ, span
from . import cuda_kernels
from .histogram import chunked_digit_histogram
from .kdf import gather, halves, pair_of
from .scan import exclusive_scan, scatter_bases

__all__ = ["sort_words_lsd", "sort_words_k0", "lsd_tile", "live_digit_flags"]


def lsd_tile(chunk: int, radix_bits: int) -> int:
    """Keys per tile of the kernels: ``chunk`` (``SortConfig.lsd_chunk``),
    raised to 2^radix_bits so that the (tiles, bins) counts, written,
    scanned and read once a pass, stay within n + 2^radix_bits (at 16-bit
    digits and the default 8192, tiles of 65,536 keys)."""
    return max(int(chunk), 1 << radix_bits)


def _digit_hists(words: Sequence[torch.Tensor], radix_bits: int, order: bool = False):
    """((digits, 2^radix_bits) int32, descent): every digit's histogram,
    least significant first across the words, and with ``order`` a 0-d
    flag, non-zero where some key is below the one before it (else None).
    One K1 ``live_digits`` launch where it takes the planes (one or two)
    and wherever the flag is asked for (``live_digits`` refuses more
    planes), else one ``hist_multi`` a plane; the choice is the shape's,
    made on the host."""
    words = tuple(words)
    if order or cuda_kernels.live_digits_fit(len(words), radix_bits):
        return cuda_kernels.live_digits(words, radix_bits, order)
    return torch.cat([cuda_kernels.hist_multi(w, radix_bits) for w in reversed(words)]), None


def live_digit_flags(words: Sequence[torch.Tensor], radix_bits: int) -> torch.Tensor:
    """(digits,) bool on the planes' device, one flag per digit position,
    least significant first across the words (the order of
    :func:`.probes.live_digit_mask`): True where the digit varies. One K1
    read of every plane; a digit is dead where one of its bins holds all
    n keys. No host read."""
    return _digit_hists(words, radix_bits)[0].max(dim=1).values != int(words[0].shape[0])


def sort_words_lsd(words: Sequence[torch.Tensor],
                   payloads: Sequence[torch.Tensor] = (),
                   radix_bits: int = 8, chunk: int = 8192,
                   skip_trivial: bool = True) -> Tuple[tuple, tuple]:
    """Stable ascending LSD radix sort of int32 word planes (most
    significant first), carrying payloads: (sorted words, payloads).
    Each live digit takes L1 + the scan + L2.

    The contract of :func:`.hw_engine.sort_words`. 1-D payloads of 4-byte
    elements ride the scatter as int32 views. Any other payload (8-, 2- or
    1-byte elements, ``(n, W)`` byte rows) rides as one shared int32 index
    plane and is gathered once at the end: a pass then moves 4 bytes for
    them all, where a 64-bit leaf would move 8 and a row W.
    """
    sw, out, _ = _sort(words, payloads, radix_bits, lsd_tile(chunk, radix_bits),
                       skip_trivial, False, None, sweep=False)
    return sw, out


def sort_words_k0(words: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor] = (),
                  guard: bool = False,
                  index_dtype: Optional[torch.dtype] = None) -> Tuple[tuple, tuple, Optional[torch.Tensor]]:
    """K0: :func:`sort_words_lsd` at 8-bit digits and tiles of 8,192 keys,
    one :func:`.cuda_kernels.k0_sweep` a live digit: (sorted words,
    payloads, the stable permutation as ``index_dtype``, int32 or int64, or
    None where ``index_dtype`` is None).

    The index, where one is asked for or a payload is gathered, is born in
    the first live pass (each key's position) and written in its dtype by
    the last; all planes of a pass go in one launch, so past
    ``K0_SWEEP_MAX_PLANES`` every payload is gathered through the index.
    ``guard``: the presorted early exit (`radix_sort.hpp:60-62`), its flag
    found by the live digits' launch and read with them in one host read.
    With no live digit, or an ordered input under ``guard``, no pass runs
    and the index is one ``torch.arange``. ``words`` may be a pair
    (:func:`.kdf.halves`), read where it lies; the sorted words are then a
    pair of a fresh buffer.
    """
    if index_dtype not in (None, torch.int32, torch.int64):
        raise ValueError("sort_words_k0: the index is int32 or int64")
    with span(K0):
        return _sort(words, payloads, cuda_kernels.K0_SWEEP_BITS,
                     cuda_kernels.K0_SWEEP_TILE, True, guard, index_dtype, sweep=True)


def _sort(words, payloads, radix_bits: int, tile: int, skip_trivial: bool, guard: bool,
          index_dtype, sweep: bool):
    """The loop of both engines: the one host read (with ``guard``, K0's
    alone, the descent flag, then the live digits, both from one
    ``live_digits`` launch), the planes that ride, one pass a live digit
    (``sweep``: K0's sweep, else L1 + scan + L2), the gathers. Returns
    (sorted words, payloads, index or None)."""
    words, payloads = tuple(words), tuple(payloads)
    n, device = int(words[0].shape[0]), words[0].device
    identity = lambda: None if index_dtype is None else torch.arange(
        n, dtype=index_dtype, device=device)
    # K0 reads a pair (two halves of one 64-bit buffer) where it lies and
    # writes its last pass's keys as one; every other read takes dense planes
    pair = sweep and len(words) == 2 and pair_of(*words) is not None
    unsorted = lambda: halves(pair_of(*words).clone()) if pair else words  # noqa: E731
    if n <= 1:
        return unsorted(), payloads, identity()
    if not pair:
        words = tuple(w.contiguous() for w in words)      # the kernels read dense planes
    digits_per_word = -(-32 // radix_bits)
    live = [True] * (digits_per_word * len(words))
    if skip_trivial:
        with span(LIVE_DIGITS):
            hists, descent = _digit_hists(words, radix_bits, guard)
            flags = hists.max(dim=1).values != n
            if guard:       # the descent flag first
                flags = torch.cat([descent.view(1), flags])
            if sweep:       # every digit's global starts, queued before the read
                starts = exclusive_scan(hists, axis=1)
                status = cuda_kernels.k0_sweep_status(n, device)
        with span(READ):
            read = flags.tolist()                 # the call's one host read
        if guard and not read.pop(0):
            return unsorted(), payloads, identity()
        live = read
    rides = [p.ndim == 1 and p.element_size() == 4 for p in payloads]
    indexed = index_dtype is not None or not all(rides)
    if sweep and len(words) + sum(rides) + indexed > cuda_kernels.K0_SWEEP_MAX_PLANES:
        rides, indexed = [False] * len(payloads), True   # one launch a pass: gather them all
    planes = list(words) + [p.contiguous().view(torch.int32)
                            for p, r in zip(payloads, rides) if r]
    wide = torch.int64 if index_dtype == torch.int64 else torch.int32
    if indexed and not sweep:
        planes.append(torch.arange(n, dtype=torch.int32, device=device))
    passes = [p for p in range(digits_per_word * len(words)) if live[p]]
    if not passes:
        planes[:len(words)] = unsorted()
    for e, p in enumerate(passes, 1):
        w = planes[len(words) - 1 - p // digits_per_word]
        shift = (p % digits_per_word) * radix_bits
        if sweep:
            with span(K0_PASS):
                planes = list(cuda_kernels.k0_sweep(
                    w, planes, shift, radix_bits, tile, starts[p], status, e,
                    position=indexed and e == 1,
                    index_dtype=wide if indexed and e == len(passes) else torch.int32,
                    pair_out=pair and e == len(passes)))
        else:
            bases = scatter_bases(chunked_digit_histogram(w, shift, radix_bits, tile))
            planes = list(cuda_kernels.lsd_scatter(w, planes, shift, radix_bits, tile, bases))
    if indexed and sweep and not passes:
        planes.append(torch.arange(n, dtype=wide, device=device))
    perm = planes.pop() if indexed else None
    riding = iter(planes[len(words):])
    out = tuple(next(riding).view(p.dtype) if r else gather(p, perm.long())
                for p, r in zip(payloads, rides))
    return tuple(planes[:len(words)]), out, perm if index_dtype is not None else None
