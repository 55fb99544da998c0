"""Bitonic sort of a few word planes for small key counts (K12).

The counterpart of ``radix_sorting_tpu.ops.vmem_sort``, whose Pallas kernel
runs the whole bitonic network in one invocation with every plane resident
in VMEM. Here :func:`.cuda_kernels.bitonic` runs it on the card
(`csrc/bitonic.cu`): in one launch where every plane fits the shared memory
of one block or of one cluster of 8 (:func:`.cuda_kernels.bitonic_route`),
else in tiles in shared memory with the wider steps through device memory.
On a CPU tensor :func:`.cuda_kernels.bitonic_plain` runs the same pairs in
torch.

The gate and the errors are the JAX package's. Planes are the port's int32
carriers of u32 bit patterns, compared unsigned. One difference, by design
(ROADMAP.md §3, R1): every compare-exchange swaps a pair only when it is out
of order, so equal key tuples keep a permutation of their records; the TPU
kernel gives both partners of an equal pair the lower one's record, and its
payloads come out duplicated.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch

from . import cuda_kernels

__all__ = ["sort_planes_vmem", "vmem_sort_ok", "VMEM_SORT_MAX_ELEMS",
           "VMEM_SORT_MIN_PAD"]

# The JAX package's bounds on the padded size: at least 1024 keys, and a cap
# from its VMEM budget and its measured crossover with the flat sorter
# (overridable, as there, for experiments).
VMEM_SORT_MIN_PAD = cuda_kernels.BITONIC_MIN_PAD
VMEM_SORT_MAX_ELEMS = int(os.environ.get("RST_VMEM_SORT_MAX", 1 << 17))
_VMEM_PLANE_BUDGET = 6 * (1 << 20)   # bytes of live planes


def vmem_sort_ok(n: int, num_planes: int, max_elems: int | None = None) -> bool:
    """True when an n-element num_planes sort fits the gate."""
    if n < 1:
        return False
    np2 = cuda_kernels.bitonic_pad_len(n)
    cap = VMEM_SORT_MAX_ELEMS if max_elems is None else max_elems
    return np2 <= cap and np2 * 4 * num_planes <= _VMEM_PLANE_BUDGET


def sort_planes_vmem(planes: Sequence[torch.Tensor],
                     num_keys: int) -> Tuple[torch.Tensor, ...]:
    """Ascending sort of u32 ``planes`` (int32 carriers) by the first
    ``num_keys`` planes; returns the sorted planes.

    All planes are 1-D int32 of one length n; key planes are most
    significant first (64-bit keys as (hi, lo); stability as an index plane
    as the last key). Payload planes, past ``num_keys``, are permuted along.
    The network is oblivious, so equal key tuples come out in an order of
    its own: callers that need stability make the tuples distinct.
    """
    planes = tuple(planes)
    if not 1 <= num_keys <= len(planes):
        raise ValueError(f"num_keys must be in [1, {len(planes)}]")
    n = int(planes[0].shape[0])
    for x in planes:
        if not torch.is_tensor(x) or x.dtype != torch.int32 or x.ndim != 1 \
                or int(x.shape[0]) != n:
            raise ValueError("planes must be equal-length 1-D int32 (u32 bit patterns)")
    return cuda_kernels.bitonic(tuple(x.contiguous() for x in planes), num_keys)
