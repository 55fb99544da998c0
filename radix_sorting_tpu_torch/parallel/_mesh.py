"""A 1-D mesh of ranks, driven by one process or by a group of processes, and
its collectives.

The counterpart of the ``jax.sharding.Mesh``, ``shard_map`` and ``lax``
collectives that the JAX package's SPMD bodies use. That package runs one
program per host: with one host it is single-controller, one program taking
a global array and mapping a body over the mesh's devices; on a pod each
host's program drives its own devices (``jax.distributed``). The port has
both forms.

* **One process** (``group=None``): a :class:`SortMesh` is an explicit list
  of torch devices, one process drives every rank, and the list may name one
  device more than once, as the JAX tests run eight virtual CPU devices in
  one process: ``SortMesh(("cpu",) * 8)`` here, four ranks on ``cuda:0`` on
  a machine with one card, or one rank per card on a host with several.
* **A group of processes** (``group=`` a ``torch.distributed`` process
  group): every process of the group builds its mesh together with the
  others, and ``devices`` are the ranks that this process drives, its
  *local* ranks, the same number on every process. Global rank
  ``process_index * L + i`` is local rank ``i`` of process
  ``process_index`` (``L`` local ranks a process), and ``size`` is the
  global D. gloo carries the group on the CPU, NCCL between cards.

An SPMD body becomes a sequence of steps. Each step is a loop over this
process's ranks on per-rank lists (element ``i`` lives on
``mesh.devices[i]``), and the collectives below sit between the steps. A
replicated value is reduced on the first local rank's device (and, with a
group, then over the group) and handed to every local rank with
``.to(device)``, which copies nothing where the devices are the same. No
collective reads anything back to the host, with one exception: a gloo
group is a CPU transport, so on CUDA tensors it is handed host copies. The
collectives that take them carry small control tensors (counts, pivots,
masks, edge summaries); the bulk exchange of CUDA tensors never goes over
gloo (:func:`.shuffle._exchange` refuses it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["SortMesh", "axis_size", "shard", "replicate", "total", "psum", "pmax",
           "all_gather", "all_to_all", "ppermute"]


@dataclass(frozen=True)
class SortMesh:
    """A 1-D mesh: local rank ``i`` computes on ``devices[i]``; with a
    ``group``, one process of a group that drives ``len(devices)`` ranks
    each (see the module's notes). A value: the world size and this
    process's index are read from the group."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "shards"
    group: Optional[Any] = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis_name: D}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: self.size}

    @property
    def size(self) -> int:
        """The global D: every process's ranks."""
        return len(self.devices) * self.num_processes

    @property
    def num_processes(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def process_index(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def ranks(self) -> range:
        """The global ranks of this process's ranks, in local order."""
        L, me = len(self.devices), self.process_index
        return range(me * L, (me + 1) * L)


def axis_size(mesh: SortMesh, axis_name: str) -> int:
    """D, the mesh size, for the mesh's own axis name (``mesh.shape[name]``)."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    return mesh.size


def shard(x: torch.Tensor, mesh: SortMesh) -> List[torch.Tensor]:
    """Split this process's tensor (the global one without a group) along
    dim 0 into one equal shard a local rank, shard ``i`` on local rank
    ``i``'s device (a view where it already lies there). Gathering is the
    caller's ``torch.cat``."""
    L = len(mesh.devices)
    if x.shape[0] % L:
        raise ValueError(f"length {x.shape[0]} does not split into {L} equal shards")
    return [s.to(dev) for s, dev in zip(torch.chunk(x, L), mesh.devices)] \
        if x.shape[0] else [x.to(dev) for dev in mesh.devices]


def replicate(t: torch.Tensor, mesh: SortMesh) -> List[torch.Tensor]:
    """One value handed to every local rank."""
    return [t.to(dev) for dev in mesh.devices]


# ---------------------------------------------------------------------------
# the group's transport


def _check_bulk(mesh: SortMesh, tensors: Sequence[torch.Tensor], what: str) -> None:
    """Refuse to hand a gloo group the bulk exchange of CUDA tensors: gloo is
    a CPU transport and would stage every row through the host."""
    if mesh.group is None or not any(t.is_cuda for t in tensors):
        return
    import torch.distributed as dist
    if dist.get_backend(mesh.group) == "gloo":
        raise ValueError(f"{what}: a gloo group carries CUDA tensors through the host; "
                         "exchange CUDA tensors with exchange='rdma' (K13 over CUDA IPC) "
                         "or over an NCCL group")


def _wire_device(mesh: SortMesh) -> torch.device:
    """Where the group's collectives take their tensors: gloo the host,
    NCCL the first local card."""
    import torch.distributed as dist
    return torch.device("cpu") if dist.get_backend(mesh.group) == "gloo" else mesh.devices[0]


def _gather_ints(values: Sequence[int], mesh: SortMesh) -> List[int]:
    """Every process's ``values`` (the same count on each), concatenated in
    process order on the host: one small all_gather."""
    import torch.distributed as dist
    t = torch.tensor(list(values), dtype=torch.int64, device=_wire_device(mesh))
    out = t.new_empty(t.numel() * mesh.num_processes)
    dist.all_gather_into_tensor(out, t, group=mesh.group)
    return [int(v) for v in out.tolist()]


def _bytes_of(t: torch.Tensor, wire: torch.device) -> torch.Tensor:
    """A tensor's bytes, flat, on the wire's device (gloo and NCCL move
    bytes of any dtype; gloo refuses some dtypes as such)."""
    return t.to(wire).contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of :func:`_bytes_of`: ``like``'s dtype, ``shape``, on
    ``like``'s device."""
    return b.view(like.dtype).reshape(shape).to(like.device)


# a sum wraps the same in the signed type of the same width; gloo refuses
# the unsigned types
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def _all_reduce(t: torch.Tensor, mesh: SortMesh, op: str) -> torch.Tensor:
    import torch.distributed as dist
    w = t.to(_wire_device(mesh), copy=True)
    dist.all_reduce(w, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=mesh.group)
    return w.to(t.device)


def _all_gather_rows(t: torch.Tensor, mesh: SortMesh) -> torch.Tensor:
    """Every process's ``t`` (the same shape on each) concatenated along dim
    0 in process order."""
    import torch.distributed as dist
    b = _bytes_of(t, _wire_device(mesh))
    out = b.new_empty(b.numel() * mesh.num_processes)
    dist.all_gather_into_tensor(out, b, group=mesh.group)
    return _from_bytes(out, t, (t.shape[0] * mesh.num_processes,) + tuple(t.shape[1:]))


# ---------------------------------------------------------------------------
# the collectives


def total(xs: Sequence[torch.Tensor], mesh: SortMesh) -> torch.Tensor:
    """The elementwise sum of every rank's tensor, once, on the first local
    rank's device. Unsigned tensors sum as their signed bit patterns (the
    same sum mod 2^bits)."""
    dev0 = mesh.devices[0]
    signed = _SIGNED.get(xs[0].dtype)
    parts = [x.view(signed) for x in xs] if signed else xs
    out = parts[0].to(dev0).clone()
    for x in parts[1:]:
        out += x.to(dev0)
    if mesh.group is not None:
        out = _all_reduce(out, mesh, "sum")
    return out.view(xs[0].dtype) if signed else out


def psum(xs: Sequence[torch.Tensor], mesh: SortMesh) -> List[torch.Tensor]:
    """``lax.psum``: the elementwise sum of every rank's tensor, on every rank
    (summed on the first local rank's device, then over the group)."""
    return replicate(total(xs, mesh), mesh)


def pmax(xs: Sequence[torch.Tensor], mesh: SortMesh) -> List[torch.Tensor]:
    """``lax.pmax``: the elementwise maximum over ranks, on every rank. A
    group takes signed types (its maximum of unsigned bit patterns would be
    the signed one)."""
    if mesh.group is not None and xs[0].dtype in _SIGNED:
        raise TypeError(f"pmax of {xs[0].dtype} over a group: widen it first")
    dev0 = mesh.devices[0]
    out = torch.stack([x.to(dev0) for x in xs]).amax(0)
    return replicate(out if mesh.group is None else _all_reduce(out, mesh, "max"), mesh)


def all_gather(xs: Sequence[torch.Tensor], mesh: SortMesh,
               tiled: bool = False) -> List[torch.Tensor]:
    """``lax.all_gather``: every rank's tensor stacked along a new leading
    axis (concatenated along dim 0 when ``tiled``) in global rank order, on
    every rank."""
    dev0 = mesh.devices[0]
    parts = [x.to(dev0) for x in xs]
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return replicate(out if mesh.group is None else _all_gather_rows(out, mesh), mesh)


def all_to_all(sends: Sequence[torch.Tensor], mesh: SortMesh,
               axis: int = 0) -> List[torch.Tensor]:
    """``lax.all_to_all(split_axis=axis, concat_axis=axis, tiled=True)``, the
    ``"xla"`` exchange: block ``d`` (along ``axis``) of rank ``s``'s send goes
    to block ``s`` of rank ``d``'s receive. One process: one ``copy_`` a
    (s, d) pair. A group: one ``all_to_all_single`` of the local ranks'
    blocks, laid out by destination process (this process's own share is
    the collective's local copy)."""
    D, L = mesh.size, len(mesh.devices)
    if len(sends) != L:
        raise ValueError(f"all_to_all: {len(sends)} sends for {L} ranks")
    b = sends[0].shape[axis] // D
    if sends[0].shape[axis] != b * D:
        raise ValueError(f"all_to_all: axis {axis} of length {sends[0].shape[axis]} "
                         f"does not split into {D} blocks")
    if mesh.group is None:
        recv = []
        for d, dev in enumerate(mesh.devices):
            out = torch.empty(sends[d].shape, dtype=sends[d].dtype, device=dev)
            for s in range(D):
                out.narrow(axis, s * b, b).copy_(sends[s].narrow(axis, d * b, b))
            recv.append(out)
        return recv
    import torch.distributed as dist
    P = mesh.num_processes
    moved = [x.to(mesh.devices[0]).movedim(axis, 0) for x in sends]    # (D * b, *rest)
    rest = tuple(moved[0].shape[1:])
    # [dest process, local source, dest local rank and its b rows, rest]
    send = torch.stack([x.reshape((P, L * b) + rest) for x in moved], 1)
    wire = _bytes_of(send, _wire_device(mesh))
    got = torch.empty_like(wire)
    dist.all_to_all_single(got, wire, group=mesh.group)
    # [source process, its local source, my local rank, b rows, rest]
    got = _from_bytes(got, moved[0], (P, L, L, b) + rest)
    return [got[:, :, j].reshape((D * b,) + rest).movedim(0, axis).to(dev)
            for j, dev in enumerate(mesh.devices)]


def ppermute(xs: Sequence[torch.Tensor], mesh: SortMesh,
             shift: int = 1) -> List[torch.Tensor]:
    """``lax.ppermute`` with pairs ``(d, (d + shift) % D)``: rank ``d``
    receives rank ``(d - shift) % D``'s tensor. Over a group, a tensor whose
    two ends are in this process moves locally, the others in one
    ``batch_isend_irecv``."""
    D, L = mesh.size, len(mesh.devices)
    if mesh.group is None:
        return [xs[(d - shift) % D].to(dev) for d, dev in enumerate(mesh.devices)]
    import torch.distributed as dist
    me, wire = mesh.process_index, _wire_device(mesh)
    out: List[Optional[torch.Tensor]] = [None] * L
    ops, pending = [], []
    for i, d in enumerate(mesh.ranks):
        q, j = divmod((d - shift) % D, L)
        if q == me:
            out[i] = xs[j].to(mesh.devices[i])
        else:
            buf = torch.empty(xs[i].numel() * xs[i].element_size(), dtype=torch.uint8,
                              device=wire)
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(mesh.group, q),
                                  mesh.group, tag=d))
            pending.append((i, buf))
        q2 = (d + shift) % D // L
        if q2 != me:
            ops.append(dist.P2POp(dist.isend, _bytes_of(xs[i], wire),
                                  dist.get_global_rank(mesh.group, q2), mesh.group,
                                  tag=(d + shift) % D))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    for i, buf in pending:
        out[i] = buf.view(xs[i].dtype).reshape(xs[i].shape).to(mesh.devices[i])
    return out
