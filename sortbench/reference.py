"""Plain PyTorch for the configurations' references and controls.

Nothing here comes from the program: each function works its answer out
from the keys the benchmark made. Keys are tensors of any integer dtype,
1-D or rows (sorted along the last axis). Their order is read from an int64
that orders as they do (:func:`sortable`), where every operation torch has
is defined. Keys of up to 32 bits get a unique stable order by sorting
composite int64 keys whose low 32 bits are the position, so that the
sort's own stability does not matter; 64-bit keys take ``torch.sort``'s
stable form.
"""

from __future__ import annotations

import torch

SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_LOW = 0xFFFFFFFF
_INT64_MIN = -(1 << 63)


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as the signed integer dtype of its width (gathers,
    compares and reductions are defined there on every build)."""
    return t if t.dtype == SIGNED[t.element_size()] else t.view(SIGNED[t.element_size()])


def is_unsigned(dtype: torch.dtype) -> bool:
    return dtype == torch.uint8 or str(dtype).startswith("torch.uint")


def sortable(keys: torch.Tensor) -> torch.Tensor:
    """int64 values that order as ``keys`` do (an integer dtype)."""
    s = signed_view(keys).to(torch.int64)
    if not is_unsigned(keys.dtype):
        return s
    if keys.element_size() < 8:
        return s & ((1 << 8 * keys.element_size()) - 1)
    return s ^ _INT64_MIN


def _offset(keys: torch.Tensor) -> torch.Tensor:
    """The keys of up to 32 bits as int64 in [0, 2^width)."""
    v = sortable(keys)
    return v if is_unsigned(keys.dtype) else v + (1 << 8 * keys.element_size() - 1)


def _positions(keys: torch.Tensor) -> torch.Tensor:
    n = keys.shape[-1]
    return torch.arange(n, dtype=torch.int64, device=keys.device).expand(keys.shape)


def order(primary: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """The positions (int64) along the last axis that put ``primary`` (int64
    in [0, 2^32)) ascending, equal values by ascending ``tie`` (distinct, in
    [0, 2^31))."""
    composite = (primary - (1 << 31)) * (1 << 32) + tie     # no int64 overflow
    return torch.sort(composite, dim=-1).values & _LOW


def stable_order(keys: torch.Tensor) -> torch.Tensor:
    """The stable ascending order (int64 positions) along the last axis."""
    if keys.element_size() <= 4:
        return order(_offset(keys), _positions(keys))
    return torch.sort(sortable(keys), dim=-1, stable=True).indices


def take(t: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``t`` gathered along its last axis at ``positions``, in its dtype."""
    return torch.gather(signed_view(t), -1, positions).view(t.dtype)


def sorted_keys(keys: torch.Tensor) -> torch.Tensor:
    """``keys`` ascending along the last axis."""
    return take(keys, stable_order(keys))


def index_as(positions: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 positions in the index dtype an argsort states."""
    width = torch.empty((), dtype=dtype).element_size()
    return positions.to(SIGNED[width]).view(dtype)


def stable_permutation(keys: torch.Tensor, dtype: torch.dtype = torch.uint32) -> torch.Tensor:
    """The unique stable ascending permutation of ``keys`` in ``dtype``."""
    return index_as(stable_order(keys), dtype)


def sorted_by_top_bits(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Keys of up to 32 bits ordered by their top ``bits`` bits alone,
    stably: the order of a sort done at a lower precision than the keys'."""
    width = 8 * keys.element_size()
    if width > 32:
        raise ValueError("sorted_by_top_bits takes keys of up to 32 bits")
    return take(keys, order(_offset(keys) >> (width - bits), _positions(keys)))


def ties_reversed_permutation(keys: torch.Tensor, dtype: torch.dtype = torch.uint32
                              ) -> torch.Tensor:
    """The ascending permutation of keys of up to 32 bits with equal keys in
    descending position: a sort that breaks stability."""
    n = keys.shape[-1]
    back = n - 1 - _positions(keys)
    return index_as(n - 1 - order(_offset(keys), back), dtype)


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``want`` that ``got`` does not reproduce bit for bit: the
    positions that differ, or every element where the dtype or the shape
    differs."""
    if got.dtype != want.dtype or tuple(got.shape) != tuple(want.shape):
        return max(want.numel(), got.numel())
    return int((signed_view(got) != signed_view(want)).sum())
