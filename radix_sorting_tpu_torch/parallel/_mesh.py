"""A 1-D mesh of ranks driven by one process, and its collectives.

The counterpart of the ``jax.sharding.Mesh``, ``shard_map`` and ``lax``
collectives that the JAX package's SPMD bodies use. That package is
single-controller: one program takes a global array and maps a body over the
mesh's devices. The port keeps that form. A :class:`SortMesh` is an explicit
list of torch devices, one process drives every rank, and the list may name
one device more than once, as the JAX tests run eight virtual CPU devices in
one process: ``SortMesh(("cpu",) * 8)`` here, four ranks on ``cuda:0`` on a
machine with one card, or one rank per card on a host with several.

An SPMD body becomes a sequence of steps. Each step is a loop over ranks on
per-rank lists (element ``r`` lives on ``mesh.devices[r]``), and the
collectives below sit between the steps. A replicated value is reduced on
the first rank's device and handed to every rank with ``.to(device)``, which
copies nothing where the devices are the same. No collective reads anything
back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["SortMesh", "axis_size", "shard", "replicate", "psum", "pmax", "all_gather",
           "all_to_all", "ppermute"]


@dataclass(frozen=True)
class SortMesh:
    """A 1-D mesh: rank ``r`` computes on ``devices[r]``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "shards"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis_name: D}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def axis_size(mesh: SortMesh, axis_name: str) -> int:
    """D, the mesh size, for the mesh's own axis name (``mesh.shape[name]``)."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    return mesh.size


def shard(x: torch.Tensor, mesh: SortMesh) -> List[torch.Tensor]:
    """Split a global tensor along dim 0 into D equal shards, shard ``r`` on
    rank ``r``'s device (a view where it already lies there). Gathering is
    the caller's ``torch.cat``."""
    D = mesh.size
    if x.shape[0] % D:
        raise ValueError(f"length {x.shape[0]} does not split into {D} equal shards")
    return [s.to(dev) for s, dev in zip(torch.chunk(x, D), mesh.devices)] \
        if x.shape[0] else [x.to(dev) for dev in mesh.devices]


def replicate(t: torch.Tensor, mesh: SortMesh) -> List[torch.Tensor]:
    """One value handed to every rank."""
    return [t.to(dev) for dev in mesh.devices]


def psum(xs: Sequence[torch.Tensor], mesh: SortMesh) -> List[torch.Tensor]:
    """``lax.psum``: the elementwise sum of every rank's tensor, on every rank
    (summed on the first rank's device)."""
    dev0 = mesh.devices[0]
    total = xs[0].to(dev0).clone()
    for x in xs[1:]:
        total += x.to(dev0)
    return replicate(total, mesh)


def pmax(xs: Sequence[torch.Tensor], mesh: SortMesh) -> List[torch.Tensor]:
    """``lax.pmax``: the elementwise maximum over ranks, on every rank."""
    dev0 = mesh.devices[0]
    return replicate(torch.stack([x.to(dev0) for x in xs]).amax(0), mesh)


def all_gather(xs: Sequence[torch.Tensor], mesh: SortMesh,
               tiled: bool = False) -> List[torch.Tensor]:
    """``lax.all_gather``: every rank's tensor stacked along a new leading
    axis (concatenated along dim 0 when ``tiled``), on every rank."""
    dev0 = mesh.devices[0]
    parts = [x.to(dev0) for x in xs]
    return replicate(torch.cat(parts) if tiled else torch.stack(parts), mesh)


def all_to_all(sends: Sequence[torch.Tensor], mesh: SortMesh,
               axis: int = 0) -> List[torch.Tensor]:
    """``lax.all_to_all(split_axis=axis, concat_axis=axis, tiled=True)``, the
    ``"xla"`` exchange: block ``d`` (along ``axis``) of rank ``s``'s send goes
    to block ``s`` of rank ``d``'s receive, one ``copy_`` a (s, d) pair."""
    D = mesh.size
    if len(sends) != D:
        raise ValueError(f"all_to_all: {len(sends)} sends for {D} ranks")
    b = sends[0].shape[axis] // D
    if sends[0].shape[axis] != b * D:
        raise ValueError(f"all_to_all: axis {axis} of length {sends[0].shape[axis]} "
                         f"does not split into {D} blocks")
    recv = []
    for d, dev in enumerate(mesh.devices):
        out = torch.empty(sends[d].shape, dtype=sends[d].dtype, device=dev)
        for s in range(D):
            out.narrow(axis, s * b, b).copy_(sends[s].narrow(axis, d * b, b))
        recv.append(out)
    return recv


def ppermute(xs: Sequence[torch.Tensor], mesh: SortMesh,
             shift: int = 1) -> List[torch.Tensor]:
    """``lax.ppermute`` with pairs ``(d, (d + shift) % D)``: rank ``d``
    receives rank ``(d - shift) % D``'s tensor."""
    D = mesh.size
    return [xs[(d - shift) % D].to(dev) for d, dev in enumerate(mesh.devices)]
