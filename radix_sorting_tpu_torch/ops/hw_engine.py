"""HW_SORT engine: sort by the derived key with the device's general sorter.

The counterpart of ``radix_sorting_tpu.ops.hw_engine``, whose sorter is XLA's
``lax.sort``, a library routine outside every Pallas kernel. Here the sorter
of one or two word planes on the card is **K0**, the port's own LSD radix
sort (:func:`.lsd_engine.sort_words_k0` at 8-bit digits and tiles of 8,192
keys, the ``SortConfig`` defaults): the live digits, every digit's global
starts and the presorted guard's flag from one K1 ``live_digits`` launch
over every plane and one host read, then one ``k0_sweep`` launch per live
digit, its tiles' prefixes from a decoupled
look-back (``csrc/hist.cu``, ``csrc/lsd.cu``), on the unsigned words
themselves, with no sign flip. Two planes (64-bit keys, and every composite
packed into two words) take up to eight passes, each moving both planes.
:func:`sorter_route` picks it on the host before any launch, from
``LSD_MIN_KEYS`` keys for one plane and ``K0_TWO_PLANE_MIN_KEYS`` for two; a
kernel that fails to build or launch raises, and the call never falls back.
Every 1-D sorter call of the port comes through this module, so each sort
and argsort of one or two planes past its gate takes K0. The planes that
``api.sort`` and ``api.argsort`` hand to K0 may be a pair (the two halves of
one 64-bit buffer, :func:`.kdf.halves`), which they make only where
:func:`sorter_route` picks K0.

``torch.sort`` sorts the rest (ROADMAP.md, port queue item 2): keys of
three or more planes, shorter planes, and CPU tensors, where it is K0's
plain version (the same function). ``torch.sort`` takes one key tensor
(``lax.sort`` takes ``num_keys``), so multi-plane keys are sorted in one of
two ways:

* one or two planes become one key: the sign-flipped int32 plane, or the two
  planes packed into one int64 ``((hi ^ INT32_MIN) << 32) | lo`` (one
  :func:`.kdf.join64`), whose signed order is the planes' unsigned
  lexicographic order;
* more planes (byte strings) chain stable sorts over such packed pairs, least
  significant pair first, carrying a permutation: right only because every
  pass is stable (`README.md:471-473`), as in the multipass u64 sort.

Payloads (1-D planes, or ``(n, W)`` byte rows) follow the stable permutation
through a gather (on K0, 4-byte payloads ride the scatter and the rest one
index plane, :mod:`.lsd_engine`). ``argsort_words`` returns the stable
permutation in place of the JAX package's index-as-last-key: the same
permutation, the unique stable one (on K0 the index is born as each key's
position in the first live pass and written as int32 or int64 by the
last).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..utils.timing import READ, TORCH_SORT, span
from . import cuda_kernels, lsd_engine, probes
from .kdf import INT32_MIN, SIGNED_VIEW, gather, join64, split64

__all__ = ["sort_words", "argsort_words", "sort_words_presort_guard", "gather",
           "SIGNED_VIEW", "sorter_route", "LSD_MIN_KEYS", "K0_TWO_PLANE_MIN_KEYS"]

# The fewest keys K0 sorts and argsorts: from 2^24 on, K0's keys-only sort
# and its argsort (int64 and uint32 indices) were faster than torch.sort of
# the same signed key (stable=True for the argsort) at every n of five
# sweeps of scripts/k0_gate.py on an H100; at 2^23 two of the five had the
# keys-only sort, and four the argsort, slower (PERF.md). A call costs one
# sync and 0.23 to 0.86 ms of host dispatch at any n, so shorter planes go
# to torch.sort.
LSD_MIN_KEYS = 1 << 24
# The same for two planes (64-bit keys, two-word packed keys): from 2^23 on,
# K0's sort and its argsort in both index dtypes were no slower than this
# module's torch.sort route (the key packed into one int64, sorted, unpacked)
# at every n of three sweeps of scripts/k0_gate.py --planes 2 on an H100, and
# the keys-only sort no slower than torch.sort of the packed key alone in all
# six sweeps; there the argsort takes 0.88 to 1.12 times that bare sort (PERF.md).
K0_TWO_PLANE_MIN_KEYS = 1 << 23
_INDEX_LIMIT = 1 << 31     # K0's index is born as an int32 position


def sorter_route(device_type: str, planes: int, n: int) -> str:
    """The sorter of ``n`` keys of ``planes`` word planes on a device of
    ``device_type``, decided on the host before any launch: ``"k0"`` on
    CUDA for one plane with ``LSD_MIN_KEYS <= n < 2^31`` and two planes
    with ``K0_TWO_PLANE_MIN_KEYS <= n < 2^31``, else ``"torch.sort"``."""
    gate = {1: LSD_MIN_KEYS, 2: K0_TWO_PLANE_MIN_KEYS}.get(planes)
    if device_type == "cuda" and gate is not None and gate <= n < _INDEX_LIMIT:
        return "k0"
    return "torch.sort"


def _takes_k0(words: Sequence[torch.Tensor]) -> bool:
    w = words[0]
    return sorter_route(w.device.type, len(words), int(w.shape[0])) == "k0"


def _k0(words: tuple, payloads: tuple = (), guard: bool = False,
        index_dtype=None) -> Tuple[tuple, tuple, torch.Tensor]:
    """K0: the stable LSD radix sort of one or two planes, carrying
    payloads, and the permutation as ``index_dtype`` (int32 / int64, or
    None: none); ``guard``: the presorted exit, its flag found by the live
    digits' launch and read with them in one sync."""
    out = lsd_engine.sort_words_k0(words, payloads, guard=guard, index_dtype=index_dtype)
    if words[0].is_cuda:
        cuda_kernels.LAUNCHES["lsd_sort"] += 1
    return out


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


def _index_as(perm: torch.Tensor, index_dtype) -> torch.Tensor:
    """K0's int32 or int64 permutation as ``index_dtype``: a view for a
    type of its width (every index is below 2^31), else a cast."""
    if index_dtype.itemsize == perm.element_size() and not index_dtype.is_floating_point:
        return perm.view(index_dtype)
    return perm.to(index_dtype)


def _ordered(words: tuple) -> bool:
    """The presorted guard off K0: its torch passes
    (:func:`.probes.is_sorted_words`), the flag read on the host."""
    flag = probes.is_sorted_words(words)
    with span(READ):
        return bool(flag)


def _stable_sort(words: Sequence[torch.Tensor], index_dtype=torch.int64,
                 guard: bool = False) -> Tuple[tuple, torch.Tensor]:
    """(sorted words, stable ascending permutation as ``index_dtype``) of
    multi-plane keys. K0 writes the index itself, 8 bytes wide where
    ``index_dtype`` is, else 4; on ``torch.sort`` one
    or two planes sort as one key, whose sorted values are the sorted words
    (no gather), and more planes chain stable sorts over pairs. ``guard``:
    an ordered input's permutation is the identity, with no sort."""
    words = tuple(words)
    n, device = words[0].shape[0], words[0].device
    if _takes_k0(words):
        wide = index_dtype.itemsize == 8
        sw, _, perm = _k0(words, (), guard, torch.int64 if wide else torch.int32)
        return sw, _index_as(perm, index_dtype)
    if guard and _ordered(words):
        return words, torch.arange(n, device=device).to(index_dtype)
    with span(TORCH_SORT):
        if len(words) <= 2:
            s = torch.sort(_key(words), stable=True)
            return _unkey(s.values, len(words)), s.indices.to(index_dtype)
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
        return tuple(gather(w, perm) for w in words), perm.to(index_dtype)


def _check_stable(payloads: tuple, stable: bool) -> None:
    if payloads and not stable:
        raise ValueError("unstable sort is only valid for keys-only sorts")


def sort_words(words: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor] = (),
               stable: bool = True) -> Tuple[tuple, tuple]:
    """Ascending sort by multi-plane derived keys, carrying payloads.

    ``words`` are int32 planes, most significant first; payloads share their
    length (dim 0). Returns (sorted_words, permuted_payloads).
    ``stable=False`` is exact for keys-only sorts: equal keys are
    indistinguishable (K0 is stable either way).
    """
    words, payloads = tuple(words), tuple(payloads)
    _check_stable(payloads, stable)
    if _takes_k0(words):
        return _k0(words, payloads)[:2]
    if not payloads and len(words) <= 2:
        with span(TORCH_SORT):
            s = torch.sort(_key(words), stable=stable).values
            return _unkey(s, len(words)), ()
    sw, perm = _stable_sort(words)
    return sw, tuple(gather(p, perm) for p in payloads)


def argsort_words(words: Sequence[torch.Tensor], index_dtype=torch.uint32,
                  guard: bool = False) -> Tuple[tuple, torch.Tensor]:
    """Stable argsort: (sorted_words, permutation as ``index_dtype``).

    The permutation is the unique stable rank order, the reference rank
    sort's output (`radix_sort_rank.hpp:22-92`). ``guard``: the presorted
    early exit (`radix_sort.hpp:60-62`), an ordered input's permutation the
    identity; on K0 found by the live digits' launch and read with them in
    one sync.
    """
    return _stable_sort(words, index_dtype, guard)


def sort_words_presort_guard(words: Sequence[torch.Tensor],
                             payloads: Sequence[torch.Tensor] = (),
                             stable: bool = True) -> Tuple[tuple, tuple]:
    """:func:`sort_words` with the presorted early exit (`radix_sort.hpp:60-62`).

    The JAX package branches on the device with ``lax.cond``. Eager torch
    has no device-side branch, so the probe's answer comes to the host and
    an ordered input skips the sort, as in the reference. On K0 the answer
    comes from the live digits' launch, which compares each key with the one
    before it as it reads them, and in the same read (one sync a call): an
    ordered input then costs that one K1 read of the keys and launches no
    pass. Off K0 the probe is :func:`.probes.is_sorted_words`'s torch passes
    and its own read.
    """
    words, payloads = tuple(words), tuple(payloads)
    if _takes_k0(words):
        _check_stable(payloads, stable)
        return _k0(words, payloads, guard=True)[:2]
    if _ordered(words):
        return words, payloads
    return sort_words(words, payloads, stable=stable)
