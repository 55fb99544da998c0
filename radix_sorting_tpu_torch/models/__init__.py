"""Configured sorters, one per reference listing (see :mod:`.sorters`)."""

from .sorters import (  # noqa: F401
    BitmapSorter16,
    CountingSorter8,
    GenericRadixSorter,
    MultipassSorterU64,
    RadixSorterU32,
    RankSorter,
    RecordCountingSorter,
    StableCountingSorter8,
)

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
