"""Distributed histogram reduction: local counts, then one sum over the mesh.

The counterpart of ``radix_sorting_tpu.parallel.histogram``: every rank
histograms its shard and one :func:`._mesh.psum` gives the exact global
per-digit distribution (the distributed form of `radix_sort.hpp:47-58`'s
histogram pass). Inputs are global tensors or numpy arrays (placed on the
mesh's first device, then sharded), on a group mesh each process's slice;
the results are replicated, returned once, on the first local rank's
device.
"""

from __future__ import annotations

import torch

from ..extras import _u32_values, bincount
from ..ops.histogram import digit_histogram, extract_digit
from ..ops.probes import and_reduce, or_reduce
from ._mesh import SortMesh, all_gather, axis_size, psum, shard
from .shuffle import _as_input, _layout, _u32_plane

__all__ = ["global_digit_histogram", "global_live_bit_mask", "distributed_bincount"]


def global_digit_histogram(x, mesh: SortMesh, pass_index: int = 0,
                           radix_bits: int = 8, axis_name: str = "shards") -> torch.Tensor:
    """Exact global histogram of one digit of a mesh-sharded u32 array."""
    num_passes = -(-32 // radix_bits)
    if not 0 <= pass_index < num_passes:
        raise ValueError(
            f"pass_index {pass_index} out of range for {radix_bits}-bit "
            f"digits of a u32 plane (valid: 0..{num_passes - 1})")
    D = axis_size(mesh, axis_name)
    w = _u32_plane(x, mesh)
    _layout(mesh, int(w.shape[0]), D)
    bins = 1 << radix_bits
    local = [digit_histogram(extract_digit((s,), pass_index, radix_bits), bins)
             for s in shard(w, mesh)]
    return psum(local, mesh)[0]


def global_live_bit_mask(x, mesh: SortMesh, axis_name: str = "shards") -> torch.Tensor:
    """Global live-bit mask (OR ^ AND) of a mesh-sharded u32 array, a 0-d
    uint32 tensor: the per-rank (OR, AND) pairs gathered in one collective,
    then folded."""
    D = axis_size(mesh, axis_name)
    w = _u32_plane(x, mesh)
    _layout(mesh, int(w.shape[0]), D)
    local = [torch.stack([or_reduce(s), and_reduce(s)]) for s in shard(w, mesh)]
    g = all_gather(local, mesh)[0]                  # (D, 2)
    return (or_reduce(g[:, 0]) ^ and_reduce(g[:, 1])).view(torch.uint32)


def distributed_bincount(x, mesh: SortMesh, length: int,
                         axis_name: str = "shards") -> torch.Tensor:
    """``np.bincount`` of a mesh-sharded integer array: local histograms
    (:func:`..extras.bincount`, K1 on the card) and one sum over ranks.

    Values outside ``[0, length)`` are dropped (the ``extras.bincount``
    contract), which makes the pad to a multiple of D free: pads carry the
    u32 sentinel, always out of range. Returns int32 counts of shape
    ``(length,)``, on the first rank's device.
    """
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    t, dtype = _as_input(x, mesh)
    w = _u32_values(t, dtype)
    D = axis_size(mesh, axis_name)
    pad = _layout(mesh, int(w.shape[0]), D).pad
    if pad:
        w = torch.cat([w, w.new_full((pad,), -1)])
    return psum([bincount(s, length=length) for s in shard(w, mesh)], mesh)[0]
