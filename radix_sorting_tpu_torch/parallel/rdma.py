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

On a group mesh (one process per card or per rank group, :mod:`._mesh`)
each launch writes into the other processes' receive buffers, opened from
their CUDA IPC handles (:class:`IpcPeers`); CPU sends take the plain
version, the group's ``all_to_all_single``. Divergences from the JAX
module: the 128-lane pad of the rows is a TPU layout need and is dropped
(the output does not depend on it); ``detect_races=True`` raises, since the
Pallas interpret-mode race detector has no counterpart here; the JAX module
refuses a multi-process mesh off a TPU (its interpret-mode semaphores do not
cross processes), where the port runs K13 across processes on the card and
its plain version on a CPU group mesh; a multi-axis mesh cannot arise for
the 1-D :class:`._mesh.SortMesh`.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import Dict, List, Sequence

import torch

from ..ops import cuda_kernels
from . import _mesh
from ._mesh import SortMesh

__all__ = ["rdma_all_to_all", "IpcPeers", "peers", "close_peers"]

# K13's view of each group mesh, made on first use (:func:`peers`) and kept
# until :func:`close_peers`
_PEERS: Dict[SortMesh, "IpcPeers"] = {}


def peers(mesh: SortMesh) -> "IpcPeers":
    """The :class:`IpcPeers` of a group mesh: one a mesh (equal meshes share
    it), made on first use, kept until :func:`close_peers`."""
    if mesh.group is None:
        raise ValueError("rdma peers: a mesh of one process has no peers")
    if mesh not in _PEERS:
        _PEERS[mesh] = IpcPeers(mesh)
    return _PEERS[mesh]


def close_peers(mesh: SortMesh) -> None:
    """Release what K13 holds for ``mesh``: its receive buffers and the
    peers' buffers it opened (:meth:`IpcPeers.close`). Every process of the
    group calls it together. A later exchange on the mesh opens them
    afresh."""
    held = _PEERS.pop(mesh, None)
    if held is not None:
        held.close()


def rdma_all_to_all(sends: Sequence[torch.Tensor], mesh: SortMesh, axis: int = 0, *,
                    detect_races: bool = False) -> List[torch.Tensor]:
    """All-to-all of the per-rank tensors ``sends`` along ``axis`` through K13.

    ``sends[i]`` lies on local rank i's device (it is moved there if not)
    and ``sends[i].shape[axis]`` must equal the mesh size D (one slice per
    destination rank). Returns the per-rank outputs, of the sends' shape.
    """
    if detect_races:
        raise ValueError(
            "detect_races=True runs the Pallas interpret-mode race detector of "
            "the JAX package, which has no counterpart in the port")
    D, L = mesh.size, len(mesh.devices)
    if len(sends) != L:
        raise ValueError(f"rdma_all_to_all: {len(sends)} sends for {L} ranks")
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
    rows = [x.reshape(D, m).contiguous() for x in moved]
    out = (cuda_kernels.rdma_exchange(rows) if mesh.group is None
           else cuda_kernels.rdma_exchange(rows, peers(mesh)))
    return [o.reshape((D,) + rest).movedim(0, axis) for o in out]


class _DeviceBytes:
    """``nbytes`` bytes of device memory at ``ptr``, for ``torch.as_tensor``
    (a view; the memory stays the owner's)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "strides": None,
                                         "version": 3}


class IpcPeers:
    """K13 on a group mesh: this process's receive buffers and the other
    processes' buffers, opened from their CUDA IPC handles.

    Each local rank's receive buffer is memory of its own
    (``rst_ipc_alloc``: ``cudaMalloc``, outside PyTorch's caching allocator,
    so a handle names the buffer's base and nothing else). The handles cross
    the group in one all_gather and each peer buffer is opened once; the
    buffers persist across calls and rounds and grow when a call needs more
    (every process decides alike: the sends have one shape on every
    process). :meth:`close` (through :func:`close_peers`) closes the opened
    handles on every process, meets the group, then frees the buffers: no
    buffer is freed while a peer holds it open. ``opens`` and ``open_ms`` count the handles
    opened and the time spent allocating, exchanging and opening.
    """

    def __init__(self, mesh: SortMesh):
        self.mesh = mesh
        self.size = mesh.size
        self.ranks = tuple(mesh.ranks)
        self.capacity = 0
        self.opens = 0
        self.open_ms = 0.0
        self._own = []          # per local rank: (pointer, uint8 view of the buffer)
        self._opened = []       # pointers opened from the peers' handles
        self._table = None      # the D receive buffers, in global rank order

    def all_to_all(self, sends: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The plain version: the group's ``all_to_all_single`` of the
        local ranks' (D, m) sends (:func:`._mesh.all_to_all`)."""
        _mesh._check_bulk(self.mesh, sends, "rdma_exchange_plain")
        return _mesh.all_to_all(sends, self.mesh, axis=0)

    def begin(self, need: int):
        """Before the launches: the streams synchronise (every earlier read
        of a receive buffer is done), the group meets, the buffers grow to
        ``need`` bytes if they must. Returns the launches' pointer table."""
        self._sync()
        agreed = self._meet(need)
        if agreed != need:
            raise RuntimeError(f"rdma_exchange: this process sends {need} bytes a rank, "
                               f"another {agreed}: the processes' sends must agree")
        if need > self.capacity:
            self._grow(need)
        return self._table

    def end(self, outs: Sequence[torch.Tensor]) -> None:
        """After the launches: the streams synchronise (this process's rows
        are in every receiver's buffer), the group meets (every process's
        are), and each local rank's buffer is copied into its output."""
        self._sync()
        self._meet(0)
        for (_, view), out in zip(self._own, outs):
            flat = out.reshape(-1).view(torch.uint8)
            flat.copy_(view[: flat.numel()])

    def close(self) -> None:
        """Close the opened handles, meet the group, free the buffers. A
        later exchange grows them afresh."""
        if not self.capacity:
            return
        lib = self._lib()
        self._sync()
        for p in self._opened:
            self._check(lib.rst_ipc_close(p), "closing a peer's buffer")
        self._opened = []
        self._meet(0)           # no peer holds a handle to this process's buffers
        for ptr, _ in self._own:
            self._check(lib.rst_ipc_free(ptr), "freeing a receive buffer")
        self._own, self._table, self.capacity = [], None, 0

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _lib():
        from ..ops._build import load_library
        return load_library()

    def _check(self, err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"rdma_exchange: {what}: CUDA error {err}: "
                               f"{self._lib().rst_error_string(err).decode()}")

    def _sync(self) -> None:
        for dev in dict.fromkeys(self.mesh.devices):
            torch.cuda.synchronize(dev)

    def _meet(self, value: int) -> int:
        """A barrier of the group that also carries the largest ``value``."""
        return max(_mesh._gather_ints([value], self.mesh))

    def _grow(self, need: int) -> None:
        t0 = time.perf_counter()
        self.close()
        lib = self._lib()
        devices = self.mesh.devices
        handles = torch.empty((len(devices), lib.rst_ipc_handle_bytes()), dtype=torch.uint8)
        for i, dev in enumerate(devices):
            ptr = ctypes.c_void_p()
            with torch.cuda.device(dev):
                self._check(lib.rst_ipc_alloc(need, ctypes.byref(ptr), handles[i].data_ptr()),
                            f"allocating a {need}-byte receive buffer")
            self._own.append((ptr.value, torch.as_tensor(_DeviceBytes(ptr.value, need),
                                                         device=dev)))
        self.capacity = need
        every = _mesh._all_gather_rows(handles, self.mesh)          # (D, handle bytes)
        table = []
        for d in range(self.size):
            if d in self.ranks:
                table.append(self._own[d - self.ranks[0]][0])
                continue
            ptr = ctypes.c_void_p()
            with torch.cuda.device(devices[0]):
                self._check(lib.rst_ipc_open(every[d].data_ptr(), ctypes.byref(ptr)),
                            f"opening rank {d}'s receive buffer")
            self._opened.append(ptr.value)
            table.append(ptr.value)
        self._table = (ctypes.c_void_p * self.size)(*table)
        self.opens += len(self._opened)
        self.open_ms += (time.perf_counter() - t0) * 1e3
