"""Exclusive prefix sums over histograms: the second phase of a radix pass.

The counterpart of ``radix_sorting_tpu.ops.scan`` (`counting_sort_8s.c:16-21`,
`radix_sort_u32.c:39-57`). With the keys cut into tiles, a stable scatter
needs for tile ``c`` and bucket ``b``::

    base[c, b] = global_bucket_start[b] + (# keys with digit b in tiles < c)

an exclusive scan over buckets of the total histogram plus an exclusive scan
over tiles within each bucket (`counting_sort_8s.c:23-34`, generalized):
together, one exclusive scan of the counts in bucket-major order.
"""

from __future__ import annotations

import torch

__all__ = ["exclusive_scan", "scatter_bases"]


def exclusive_scan(counts: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exclusive prefix sum along ``axis``, in the input's dtype."""
    return torch.cumsum(counts, axis, dtype=counts.dtype) - counts


def scatter_bases(chunk_hist: torch.Tensor) -> torch.Tensor:
    """(tiles, bins) int32 stable scatter bases of (tiles, bins) int32
    per-tile digit counts: within tile ``c`` the j-th key of digit ``b`` (in
    input order) lands at ``base[c, b] + j``.

    One 1-D scan of the transposed counts: torch's scan along the outer
    dimension of a (tiles, bins) matrix took 0.84 ms at 4,883 x 256 (H100
    80GB HBM3, 700 W; chip_smoke.py --profile), more than a digit pass's
    histogram.
    """
    by_bucket = chunk_hist.t().contiguous().view(-1)
    return exclusive_scan(by_bucket, axis=0).view(chunk_hist.shape[1], -1).t().contiguous()
