"""Input probes and the PEXT/PDEP bit networks on int32 word planes.

The PyTorch counterpart of ``radix_sorting_tpu.ops.probes``: presorted
detection (`radix_sort.hpp:48-62`), the live-bit mask behind column skipping
(`radix_sort.hpp:64-70`) and the static-mask key compaction (PEXT) and its
inverse (PDEP) that make the counting tier reach masked keys
(`README.md:716-758`).

Planes are int32 tensors carrying u32 bit patterns (see :mod:`.kdf`): order
is compared in sign-flipped space and every right shift is masked. Masks are
Python ints in [0, 2^32).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..utils.timing import GUARD, READ, span
from .kdf import INT32_MIN, i32

__all__ = [
    "word_lt",
    "is_sorted_words",
    "shift_right",
    "or_reduce",
    "and_reduce",
    "live_bit_mask",
    "live_digit_mask",
    "mask_runs",
    "compact_live_bits",
    "expand_live_bits",
    "compact_word_planes",
    "expand_word_planes",
]


def _signed_lex_lt(a: Sequence[torch.Tensor],
                   b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise lexicographic a < b over int32 word tuples, signed."""
    lt = eq = None
    for wa, wb in zip(a, b):
        this_lt, this_eq = wa < wb, wa == wb
        if lt is None:
            lt, eq = this_lt, this_eq
        else:
            lt = lt | (eq & this_lt)
            eq = eq & this_eq
    return lt


def word_lt(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise lexicographic a < b over word tuples (most significant
    first), unsigned: compared in sign-flipped space."""
    return _signed_lex_lt([w ^ INT32_MIN for w in a], [w ^ INT32_MIN for w in b])


def is_sorted_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: the derived-key sequence is non-decreasing
    (the reference's early-exit predicate, `radix_sort.hpp:49-62`)."""
    n = words[0].shape[0]
    if n < 2:
        return torch.ones((), dtype=torch.bool, device=words[0].device)
    with span(GUARD):
        flipped = [w ^ INT32_MIN for w in words]      # one flip per plane
        return ~torch.any(_signed_lex_lt([f[1:] for f in flipped],
                                         [f[:-1] for f in flipped]))


def shift_right(w: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a plane's u32 bit patterns by ``s`` in [0, 32)."""
    return (w >> s) & i32(0xFFFFFFFF >> s) if s else w


def _fold(w: torch.Tensor, op) -> torch.Tensor:
    """Reduce a non-empty 1-D plane with a bitwise ``op`` by halving
    (torch has no bitwise reductions): 0-d result, no host sync."""
    while w.shape[0] > 1:
        half = w.shape[0] // 2
        folded = op(w[:half], w[half:2 * half])
        w = torch.cat([folded, w[2 * half:]]) if w.shape[0] % 2 else folded
    return w[0]


def or_reduce(w: torch.Tensor) -> torch.Tensor:
    """Bitwise OR of every element of a non-empty 1-D plane (0-d)."""
    return _fold(w, torch.bitwise_or)


def and_reduce(w: torch.Tensor) -> torch.Tensor:
    """Bitwise AND of every element of a non-empty 1-D plane (0-d)."""
    return _fold(w, torch.bitwise_and)


def live_bit_mask(words: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Per-plane mask of the bits that vary across the input (OR ^ AND)."""
    return tuple(or_reduce(w) ^ and_reduce(w) for w in words)


def live_digit_mask(mask_words: Sequence, radix_bits: int) -> Tuple[bool, ...]:
    """One flag per digit position, least significant first across the
    words (the LSD pass order, `README.md:316-335`): True where the digit
    varies. A False entry is a trivial pass, skipped like the reference's
    column skip (`radix_sort.hpp:82-90`).

    ``mask_words`` are :func:`live_bit_mask`'s planes (0-d tensors) or ints,
    most significant first. Digits never cross a word: at ``radix_bits=11``
    a word's top digit has 10 bits. The masks come to the host in one read.
    """
    if torch.is_tensor(mask_words[0]):
        stacked = torch.stack(tuple(mask_words))
        with span(READ):
            mask_words = stacked.tolist()
    words = [int(m) & 0xFFFFFFFF for m in mask_words]
    digits_per_word = -(-32 // radix_bits)
    digit_mask = (1 << radix_bits) - 1
    return tuple(bool((words[len(words) - 1 - d // digits_per_word]
                       >> (d % digits_per_word * radix_bits)) & digit_mask)
                 for d in range(digits_per_word * len(words)))


def mask_runs(mask: int) -> List[Tuple[int, int, int]]:
    """Maximal runs of set bits of ``mask``: (source shift, width, packed shift).

    PEXT moves each run down to its packed shift; PDEP moves it back. A mask
    of 32 bits has at most 16 runs.
    """
    runs, bit, dst = [], 0, 0
    mask &= 0xFFFFFFFF
    while bit < 32:
        if mask >> bit & 1:
            width = 0
            while bit + width < 32 and mask >> (bit + width) & 1:
                width += 1
            runs.append((bit, width, dst))
            dst += width
            bit += width
        else:
            bit += 1
    return runs


def compact_live_bits(w: torch.Tensor, mask: int) -> torch.Tensor:
    """Gather the bits of ``w`` selected by ``mask`` into the low positions
    (vectorised PEXT, one shift-and-mask per run of set bits)."""
    out = torch.zeros_like(w)
    for src, width, dst in mask_runs(mask):
        out = out | (((w >> src) & i32((1 << width) - 1)) << dst)
    return out


def expand_live_bits(c: torch.Tensor, mask: int) -> torch.Tensor:
    """Inverse of :func:`compact_live_bits` (vectorised PDEP)."""
    out = torch.zeros_like(c)
    for src, width, dst in mask_runs(mask):
        out = out | (((c >> dst) & i32((1 << width) - 1)) << src)
    return out


def compact_word_planes(words: Sequence[torch.Tensor],
                        masks: Sequence[int]) -> torch.Tensor:
    """Merge the live bits of multi-plane keys into ONE int32 word, the most
    significant plane taking the high positions (total popcount <= 32)."""
    merged = torch.zeros_like(words[0])
    shift = 0
    for w, m in zip(reversed(tuple(words)), reversed(tuple(masks))):
        if m:
            merged = merged | (compact_live_bits(w, m) << shift)
            shift += bin(m).count("1")
    if shift > 32:
        raise ValueError("compacted live bits must fit one 32-bit word")
    return merged


def expand_word_planes(merged: torch.Tensor, words: Sequence[torch.Tensor],
                       masks: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Inverse of :func:`compact_word_planes` plus the dead-bit restore:
    element 0 of each plane supplies its constant dead bits."""
    masks = tuple(int(m) for m in masks)
    shift = sum(bin(m).count("1") for m in masks)
    out = []
    for w, m in zip(words, masks):
        nb = bin(m).count("1")
        shift -= nb
        plane = (expand_live_bits((merged >> shift) & i32((1 << nb) - 1), m)
                 if m else torch.zeros_like(merged))
        out.append(plane | (w[0] & i32(~m)))
    return tuple(out)
