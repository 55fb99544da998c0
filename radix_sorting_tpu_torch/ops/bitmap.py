"""Bitmap ("esoteric") unique-sort: one flag of presence per possible value.

The counterpart of ``radix_sorting_tpu.ops.bitmap``, the reference's
`bitmap_sort_16.c:6-28`: mark the presence of each value, then emit the
sorted unique values. O(domain) memory; duplicates collapse.

Presence is a boolean vector over the value domain. From 2^16 keys on it
comes from the K1 histogram (:func:`.cuda_kernels.hist`) at the dtype's full
width, as on the JAX package's TPU route; below that, from a presence
scatter. Emission keeps the JAX package's fixed-shape contract,
``(values, count)`` with ``values`` padded to a static ``size``, and needs
no host sync: each present value goes to the slot its running count gives.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import cuda_kernels, kdf

__all__ = ["bitmap_unique_sort"]

_HIST_MIN_KEYS = 1 << 16   # the JAX package's gate for the histogram route


def _presence(w: torch.Tensor, domain_bits: int) -> torch.Tensor:
    """(2^domain_bits,) bool: which values of the int32 plane ``w`` occur."""
    if w.shape[0] >= _HIST_MIN_KEYS:
        return cuda_kernels.hist(w, 0, domain_bits) > 0
    present = torch.zeros(1 << domain_bits, dtype=torch.bool, device=w.device)
    present[w.long()] = True
    return present


def _emit(present: torch.Tensor, size: int, fill_value: int):
    """(values, count): the first ``size`` present values in order, padded
    with ``fill_value``, and the number present."""
    slot = torch.cumsum(present, 0) - 1
    # absent values, and present ones past ``size``, go to a spill slot
    slot = torch.where(present & (slot < size), slot, size)
    values = torch.full((size + 1,), fill_value, dtype=torch.int64,
                        device=present.device)
    values.scatter_(0, slot, torch.arange(present.shape[0], device=present.device))
    return values[:size], present.sum(dtype=torch.int32)


def bitmap_unique_sort(x, size: Optional[int] = None,
                       fill_value: Optional[int] = None, *, device=None):
    """Sorted unique values of an unsigned array of <= 16-bit domain.

    Args:
      x: 1-D uint8/uint16 tensor, or numpy array with ``device=``.
      size: static length of the returned value vector (default: the full
        domain).
      fill_value: padding past ``count`` (default: the domain's maximum).

    Returns:
      (values, count): ``values[:count]`` are the sorted uniques (``x``'s
      dtype), the tail is ``fill_value``; ``count`` is an int32 scalar.
      Tensors on ``x``'s device, or numpy for a numpy input.
    """
    from_numpy = not torch.is_tensor(x)
    if from_numpy:
        if device is None:
            raise TypeError("a numpy input needs device= (e.g. 'cuda')")
        a = np.asarray(x)
        if a.dtype not in (np.uint8, np.uint16):
            raise TypeError("bitmap_unique_sort supports uint8/uint16 keys")
        x = kdf.as_tensor(a, device)
    elif x.dtype not in (torch.uint8, torch.uint16):
        raise TypeError("bitmap_unique_sort supports uint8/uint16 keys")
    if x.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(x.shape)}")
    domain_bits = 8 * x.element_size()
    size = (1 << domain_bits) if size is None else int(size)
    fill_value = (1 << domain_bits) - 1 if fill_value is None else int(fill_value)
    (w,) = kdf.raw_bits(x.contiguous())
    values, count = _emit(_presence(w, domain_bits), size, fill_value)
    # to the key dtype, wrapping as the JAX package's astype does
    values = values.to(torch.uint8) if domain_bits == 8 \
        else values.to(torch.int16).view(torch.uint16)
    if from_numpy:
        return kdf.to_numpy(values), kdf.to_numpy(count)
    return values, count
