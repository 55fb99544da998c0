"""HW_SORT engine: sort by the derived key with the device's general sorter.

The counterpart of ``radix_sorting_tpu.ops.hw_engine``, whose sorter is XLA's
``lax.sort``, a library routine outside every Pallas kernel. Until the
hand-written LSD radix sort lands (ROADMAP.md, port queue item 2), the port's
stand-in for it is ``torch.sort``.

``torch.sort`` takes one key tensor (``lax.sort`` takes ``num_keys``), so
multi-plane keys are sorted in one of two ways:

* one or two planes become one key: the sign-flipped int32 plane, or the two
  planes packed into one int64 ``((hi ^ INT32_MIN) << 32) | lo`` (one
  :func:`.kdf.join64`), whose signed order is the planes' unsigned
  lexicographic order;
* more planes (byte strings) chain stable sorts over such packed pairs, least
  significant pair first, carrying a permutation: right only because every
  pass is stable (`README.md:471-473`), as in the multipass u64 sort.

Payloads (1-D planes, or ``(n, W)`` byte rows) follow the stable permutation
through a gather. ``argsort_words`` returns ``torch.sort(stable=True)``'s
indices in place of the JAX package's index-as-last-key: the permutation is
the same, the unique stable one.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import probes
from .kdf import INT32_MIN, join64, split64

__all__ = ["sort_words", "argsort_words", "sort_words_presort_guard", "gather"]

# same-width signed views: torch indexes few of its unsigned dtypes
SIGNED_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _key(group: Sequence[torch.Tensor]) -> torch.Tensor:
    """One signed sort key for one or two planes (most significant first)."""
    if len(group) == 1:
        return group[0] ^ INT32_MIN
    hi, lo = group
    return join64(hi ^ INT32_MIN, lo, torch.int64)


def _unkey(s: torch.Tensor, planes: int) -> Tuple[torch.Tensor, ...]:
    """Inverse of :func:`_key` on the sorted keys."""
    if planes == 1:
        return (s ^ INT32_MIN,)
    hi, lo = split64(s)
    return hi ^ INT32_MIN, lo


def gather(p: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``p[perm]`` along dim 0, through a same-width integer view."""
    v = SIGNED_VIEW[p.element_size()]
    return p.view(v)[perm].view(p.dtype)


def _stable_sort(words: Sequence[torch.Tensor]) -> Tuple[tuple, torch.Tensor]:
    """(sorted words, stable ascending permutation as int64) of multi-plane
    keys. One or two planes sort as one key, whose sorted values are the
    sorted words (no gather); more planes chain stable sorts over pairs."""
    words = tuple(words)
    if len(words) <= 2:
        s = torch.sort(_key(words), stable=True)
        return _unkey(s.values, len(words)), s.indices
    # pairs of planes from the least significant end: LSD order
    groups: List[tuple] = [words[max(0, i - 2):i]
                           for i in range(len(words), 0, -2)]
    perm = None
    for group in groups:
        key = _key(group)
        if perm is not None:
            key = key[perm]
        idx = torch.sort(key, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return tuple(gather(w, perm) for w in words), perm


def sort_words(words: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor] = (),
               stable: bool = True) -> Tuple[tuple, tuple]:
    """Ascending sort by multi-plane derived keys, carrying payloads.

    ``words`` are int32 planes, most significant first; payloads share their
    length (dim 0). Returns (sorted_words, permuted_payloads).
    ``stable=False`` is exact for keys-only sorts: equal keys are
    indistinguishable.
    """
    words, payloads = tuple(words), tuple(payloads)
    if payloads and not stable:
        raise ValueError("unstable sort is only valid for keys-only sorts")
    if not payloads and len(words) <= 2:
        s = torch.sort(_key(words), stable=stable).values
        return _unkey(s, len(words)), ()
    sw, perm = _stable_sort(words)
    return sw, tuple(gather(p, perm) for p in payloads)


def argsort_words(words: Sequence[torch.Tensor],
                  index_dtype=torch.uint32) -> Tuple[tuple, torch.Tensor]:
    """Stable argsort: (sorted_words, permutation as ``index_dtype``).

    The permutation is the unique stable rank order, the reference rank
    sort's output (`radix_sort_rank.hpp:22-92`).
    """
    sw, perm = _stable_sort(words)
    return sw, perm.to(index_dtype)


def sort_words_presort_guard(words: Sequence[torch.Tensor],
                             payloads: Sequence[torch.Tensor] = (),
                             stable: bool = True) -> Tuple[tuple, tuple]:
    """:func:`sort_words` with the presorted early exit (`radix_sort.hpp:60-62`).

    The JAX package branches on the device with ``lax.cond``. Eager torch
    has no device-side branch, so the probe's answer comes to the host (one
    sync) and an ordered input skips the sort, as in the reference.
    """
    words, payloads = tuple(words), tuple(payloads)
    if bool(probes.is_sorted_words(words)):
        return words, payloads
    return sort_words(words, payloads, stable=stable)
