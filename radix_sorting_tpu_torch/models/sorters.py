"""The sorter "model zoo": one configured sorter per reference listing.

The counterpart of ``radix_sorting_tpu.models.sorters``: the reference is
seven C listings plus two generic C++ engines (SURVEY §2), and each class
here is a thin configuration over the port's :mod:`..api` with the same
observable contract, kept 1:1 with that inventory. ``device`` places numpy
input, as the entry points' ``device=`` does (the CUDA device by default);
a tensor is sorted on its own device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import api
from ..config import DEFAULT_CONFIG, SortConfig
from ..ops.bitmap import bitmap_unique_sort

__all__ = [
    "CountingSorter8",
    "StableCountingSorter8",
    "RecordCountingSorter",
    "RadixSorterU32",
    "MultipassSorterU64",
    "RankSorter",
    "BitmapSorter16",
    "GenericRadixSorter",
]


@dataclasses.dataclass(frozen=True)
class _ConfiguredSorter:
    config: SortConfig = DEFAULT_CONFIG
    device: Optional[object] = None


def _is_uint8(keys) -> bool:
    if torch.is_tensor(keys):
        return keys.dtype == torch.uint8
    return np.asarray(keys).dtype == np.uint8


class CountingSorter8(_ConfiguredSorter):
    """Keys-only 256-bin counting sort for uint8 (`counting_sort_8.c:5-21`).

    Regeneration path: output rebuilt from the histogram, no data movement.
    """

    def __call__(self, keys):
        if not _is_uint8(keys):
            raise TypeError("CountingSorter8 sorts uint8 keys")
        return api.counting_sort(keys, config=self.config, device=self.device)


class StableCountingSorter8(_ConfiguredSorter):
    """Stable scatter-form counting sort with payload (`counting_sort_8s.c:5-35`)."""

    def __call__(self, keys, values):
        if not _is_uint8(keys):
            raise TypeError("StableCountingSorter8 sorts uint8 keys")
        return api.counting_sort(keys, values, config=self.config, device=self.device)


class RecordCountingSorter(_ConfiguredSorter):
    """Record sort via key extraction (`counting_sort_rec_sk.c:10-41`).

    ``key_of`` plays the reference's ``key_of()`` role; records are a payload
    pytree (structure of arrays), permuted stably alongside the keys.
    """

    def __call__(self, records, key_of):
        _, sorted_records = api.sort_pairs(key_of(records), records, config=self.config,
                                           device=self.device)
        return sorted_records


class RadixSorterU32(_ConfiguredSorter):
    """4-pass-equivalent LSD radix sort of u32 keys (`radix_sort_u32.c:16-90`)."""

    def __call__(self, keys, value_mask: Optional[int] = None):
        return api.sort(keys, config=self.config, value_mask=value_mask, device=self.device)


class MultipassSorterU64(_ConfiguredSorter):
    """u64 sort as two chained stable 32-bit sorts (`radix_sort_u64_multipass.c`)."""

    def __call__(self, keys):
        return api.sort_u64_multipass(keys, config=self.config, device=self.device)


class RankSorter(_ConfiguredSorter):
    """Stable rank/index sort over const input (`radix_sort_u32_ranks.c:38-110`,
    generic `radix_sort_rank.hpp:22-112`)."""

    def __call__(self, keys, index_dtype=torch.uint32):
        return api.argsort(keys, config=self.config, index_dtype=index_dtype,
                           device=self.device)


class BitmapSorter16(_ConfiguredSorter):
    """Bitmap unique-sort over a 16-bit domain (`bitmap_sort_16.c:6-28`).

    Honors ``config.descending`` by reversing the valid prefix (the bitmap
    scan itself is ascending-only, like the reference's `bits & -bits` walk).
    """

    def __call__(self, keys, size: Optional[int] = None):
        values, count = bitmap_unique_sort(keys, size=size, device=self.device)
        if self.config.descending:
            # reverse only the valid prefix; padding stays at the tail
            from_numpy = not torch.is_tensor(values)
            v = torch.from_numpy(values) if from_numpy else values
            c = torch.as_tensor(count, device=v.device)
            i = torch.arange(v.shape[0], device=v.device)
            v = v[torch.where(i < c, c - 1 - i, i)]
            values = v.numpy() if from_numpy else v
        return values, count


class GenericRadixSorter(_ConfiguredSorter):
    """The generic engine over every supported key dtype (`radix_sort.hpp:31-115`).

    Dispatches on dtype like the reference dispatches on its template KDF
    overload set; payload optional (value sort vs record sort).
    """

    def __call__(self, keys, values=None, value_mask: Optional[int] = None):
        if values is None:
            return api.sort(keys, config=self.config, value_mask=value_mask,
                            device=self.device)
        return api.sort_pairs(keys, values, config=self.config, device=self.device)
