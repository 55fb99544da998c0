"""Digit histograms: the plain form, digit extraction and the fused all-digits read.

The PyTorch counterpart of ``radix_sorting_tpu.ops.histogram``
(`radix_sort.hpp:47-58`'s ``cnt[digit]++``; the fused first pass of
`radix_sort_u32.c:24-37`). The JAX package writes the plain form as a dense
one-hot compare-reduce because a TPU vector unit has no scatter; here
``torch.bincount`` is the plain form. ``multi_digit_histogram`` of one plane
runs K1 (:func:`.cuda_kernels.hist_multi`) on every device, as the JAX
package runs its Pallas kernel on its TPU route. ``chunked_digit_histogram``
(the LSD engine's per-tile counts) runs L1 (:func:`.cuda_kernels.lsd_hist`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import cuda_kernels
from .probes import shift_right

__all__ = ["extract_digit", "digit_histogram", "chunked_digit_histogram",
           "multi_digit_histogram"]


def extract_digit(words: Sequence[torch.Tensor], pass_index: int,
                  radix_bits: int) -> torch.Tensor:
    """Digit value of each key for the given LSD pass.

    Digits are numbered least-significant first across the concatenated
    words (words are most-significant first, as :mod:`.kdf` produces them).
    Mirrors the per-pass shift/mask of `radix_sort_u32.c:26-29`.
    """
    digits_per_word = -(-32 // radix_bits)
    word_idx = pass_index // digits_per_word       # 0 = least significant word
    shift = (pass_index % digits_per_word) * radix_bits
    w = words[len(words) - 1 - word_idx]
    return shift_right(w, shift) & ((1 << radix_bits) - 1)


def digit_histogram(digits: torch.Tensor, bins: int) -> torch.Tensor:
    """(bins,) int32 histogram of non-negative digits; digits >= bins are
    dropped, as the JAX one-hot drops them."""
    return torch.bincount(digits, minlength=bins)[:bins].to(torch.int32)


def chunked_digit_histogram(w: torch.Tensor, shift: int, radix_bits: int,
                            tile: int) -> torch.Tensor:
    """(tiles, 2^radix_bits) int32 histograms of the digit at bit ``shift``
    of the plane ``w``, one row per tile of ``tile`` keys (the last tile
    short): the tile-major counts whose scan gives the stable scatter bases.

    The JAX package's form takes the digits and a chunk count that divides
    n (its engine pads); here the kernel extracts the digit on its read and
    needs no padding. Plain form ``bincount(tile_id * bins + digit)``.
    """
    return cuda_kernels.lsd_hist(w, shift, radix_bits, tile)


def multi_digit_histogram(words: Sequence[torch.Tensor],
                          radix_bits: int) -> torch.Tensor:
    """All passes' histograms: (num_passes, 2^radix_bits) int32.

    One plane: K1 counts every digit in ONE read of the keys. More planes
    (64-bit keys): one plain histogram per digit, as the JAX package does.
    """
    if len(words) == 1:
        return cuda_kernels.hist_multi(words[0], radix_bits)
    num_passes = -(-32 // radix_bits) * len(words)
    return torch.stack([digit_histogram(extract_digit(words, p, radix_bits),
                                        1 << radix_bits)
                        for p in range(num_passes)])
