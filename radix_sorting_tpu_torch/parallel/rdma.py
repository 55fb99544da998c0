"""The all-to-all exchange over the hand-written ring kernel K13.

The counterpart of ``radix_sorting_tpu.parallel.rdma``, whose Pallas kernel
pushes each device's per-destination rows straight into the destination's
output buffer over the interconnect. Here every rank's launch of K13
(:func:`..ops.cuda_kernels.rdma_exchange`, ``csrc/exchange.cu``) writes its
rows into every rank's output: on one card the ranks share its memory, on
several cards the writes go to peer memory over NVLink.

Semantics match :func:`._mesh.all_to_all` (the ``"xla"`` exchange), that is
``lax.all_to_all(x, axis_name, split_axis=axis, concat_axis=axis,
tiled=True)`` for an axis of length D = mesh size: slice s of rank d's input
goes to rank s, and slice s of rank d's output is what rank s sent it.

Divergences from the JAX module: the 128-lane pad of the rows is a TPU
layout need and is dropped (the output does not depend on it);
``detect_races=True`` raises, since the Pallas interpret-mode race detector
has no counterpart here; and the refusals of a multi-process or multi-axis
mesh cannot arise for a single-controller 1-D :class:`._mesh.SortMesh`.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from ..ops import cuda_kernels
from ._mesh import SortMesh

__all__ = ["rdma_all_to_all"]


def rdma_all_to_all(sends: Sequence[torch.Tensor], mesh: SortMesh, axis: int = 0, *,
                    detect_races: bool = False) -> List[torch.Tensor]:
    """All-to-all of the per-rank tensors ``sends`` along ``axis`` through K13.

    ``sends[d]`` lies on rank d's device (it is moved there if not) and
    ``sends[d].shape[axis]`` must equal the mesh size D (one slice per
    destination rank). Returns the per-rank outputs, of the sends' shape.
    """
    if detect_races:
        raise ValueError(
            "detect_races=True runs the Pallas interpret-mode race detector of "
            "the JAX package, which has no counterpart in the port")
    D = mesh.size
    if len(sends) != D:
        raise ValueError(f"rdma_all_to_all: {len(sends)} sends for {D} ranks")
    for x in sends:
        if x.shape[axis] != D:
            raise ValueError(
                f"rdma_all_to_all: axis {axis} has length {x.shape[axis]}, "
                f"expected the mesh size {D}")
    if D == 1:
        return [sends[0].to(mesh.devices[0])]
    moved = [x.to(dev).movedim(axis, 0) for x, dev in zip(sends, mesh.devices)]
    rest = tuple(moved[0].shape[1:])
    m = math.prod(rest)
    out = cuda_kernels.rdma_exchange([x.reshape(D, m).contiguous() for x in moved])
    return [o.reshape((D,) + rest).movedim(0, axis) for o in out]
