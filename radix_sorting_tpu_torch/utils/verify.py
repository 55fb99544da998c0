"""Self-verification oracles, the counterpart of ``radix_sorting_tpu.utils.verify``.

* sortedness in the KDF order, ascending or descending: the CLI's always-on
  ``-DVERIFY_SORT`` check (`radix_experiment.cpp:137-174,208-212`);
* permutation validity through a presence count (`radix_tests.cpp:82-91`);
* multiset preservation: a sort is a permutation of its input;
* the stability witness of rank sorts: equal keys keep ascending indices.

Sortedness, permutations and stability are reductions on the device of the
tensor they are given (a numpy input goes to ``device=``, the CUDA device by
default, as in every entry point of the port); the multiset check compares
sorted raw bits on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kdf

__all__ = [
    "is_sorted",
    "is_permutation",
    "same_multiset",
    "rank_is_stable_sort",
]


def is_sorted(x, descending: bool = False, *, device=None) -> bool:
    """True iff ``x`` is sorted in the KDF order (floats with NaN and -0
    included)."""
    from ..api import _as_words
    from ..ops.probes import is_sorted_words
    words, _, _ = _as_words(x, descending, device)
    return bool(is_sorted_words(words))


def _indices(perm, device) -> torch.Tensor:
    """An index array as int64: the low 32 bits, sign-extended (the JAX
    package casts to int32)."""
    t = perm if torch.is_tensor(perm) else kdf.as_tensor(np.asarray(perm), kdf.input_device(device))
    if t.element_size() == 8:
        t = t.view(torch.int64) & 0xFFFFFFFF
        return (t ^ (1 << 31)) - (1 << 31)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).long()
    return t.long()


def is_permutation(perm, n: int | None = None, *, device=None) -> bool:
    """Every index in [0, n) exactly once: a presence count
    (``index_add_``) on the indices' device, the vectorised form of the
    reference's 64-bit presence mask and popcount (`radix_tests.cpp:82-91`)."""
    p = _indices(perm, device)
    if n is None:
        n = p.shape[0]
    if p.shape[0] != n:
        return False
    in_range = (p >= 0) & (p < n)
    seen = torch.zeros(n, dtype=torch.int32, device=p.device)
    seen.index_add_(0, p[in_range], torch.ones_like(p[in_range], dtype=torch.int32))
    return bool(in_range.all() & (seen == 1).all())


def _host(a) -> np.ndarray:
    return kdf.to_numpy(a) if torch.is_tensor(a) else np.asarray(a)


def same_multiset(a, b) -> bool:
    """True iff ``b`` is a permutation of ``a``: their raw bits sorted on the
    host (NaNs with equal payloads compare equal)."""
    an, bn = _host(a), _host(b)
    if an.shape != bn.shape:
        return False
    av = an.view(np.dtype(f"u{an.dtype.itemsize}"))
    bv = bn.view(np.dtype(f"u{bn.dtype.itemsize}"))
    return bool(np.array_equal(np.sort(av), np.sort(bv)))


def rank_is_stable_sort(keys, perm, descending: bool = False, *, device=None) -> bool:
    """True iff ``perm`` is THE stable KDF-order permutation of ``keys``:
    stability makes it unique (`README.md:471-473`), so the gathered key
    tuples with the index as the last word must strictly increase."""
    from ..api import _as_words
    from ..ops.probes import word_lt
    words, _, _ = _as_words(keys, descending, device)
    dev = words[0].device
    p = _indices(perm if torch.is_tensor(perm) else np.asarray(perm), dev).to(dev)
    if not is_permutation(p, words[0].shape[0]):
        return False
    ops = tuple(w[p] for w in words) + (p.to(torch.int32),)
    return bool(word_lt(tuple(o[:-1] for o in ops), tuple(o[1:] for o in ops)).all())
