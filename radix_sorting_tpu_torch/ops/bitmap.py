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

__all__ = ["bitmap_unique_sort", "nonzero_static"]

_HIST_MIN_KEYS = 1 << 16   # the JAX package's gate for the histogram route


def _presence(w: torch.Tensor, domain_bits: int) -> torch.Tensor:
    """(2^domain_bits,) bool: which values of the int32 plane ``w`` occur."""
    if w.shape[0] >= _HIST_MIN_KEYS:
        return cuda_kernels.hist(w, 0, domain_bits) > 0
    present = torch.zeros(1 << domain_bits, dtype=torch.bool, device=w.device)
    present[w.long()] = True
    return present


def nonzero_static(flags: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """(size,) int64: the positions of the first ``size`` set flags in
    order, padded with ``fill_value``. The JAX package's ``jnp.nonzero(size=,
    fill_value=)`` without a host sync (``torch.nonzero`` reads its size):
    the j-th set flag is where the running count first reaches j, one
    binary search per slot (a scatter of every position costs more than the
    count itself: 1.13 ms at 40M flags on an H100 80GB HBM3 at 700 W)."""
    count = torch.cumsum(flags, 0)
    pos = torch.searchsorted(count, torch.arange(1, size + 1, device=flags.device))
    return torch.where(pos < flags.shape[0], pos, fill_value)


def bitmap_unique_sort(x, size: Optional[int] = None,
                       fill_value: Optional[int] = None, *, device=None):
    """Sorted unique values of an unsigned array of <= 16-bit domain.

    Args:
      x: 1-D uint8/uint16 tensor, or numpy array (placed by ``device=``,
        the CUDA device by default).
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
        a = np.asarray(x)
        if a.dtype not in (np.uint8, np.uint16):
            raise TypeError("bitmap_unique_sort supports uint8/uint16 keys")
        x = kdf.as_tensor(a, kdf.input_device(device))
    elif x.dtype not in (torch.uint8, torch.uint16):
        raise TypeError("bitmap_unique_sort supports uint8/uint16 keys")
    if x.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(x.shape)}")
    domain_bits = 8 * x.element_size()
    size = (1 << domain_bits) if size is None else int(size)
    fill_value = (1 << domain_bits) - 1 if fill_value is None else int(fill_value)
    (w,) = kdf.raw_bits(x.contiguous())
    present = _presence(w, domain_bits)
    values = nonzero_static(present, size, fill_value)
    count = present.sum(dtype=torch.int32)
    # to the key dtype, wrapping as the JAX package's astype does
    values = values.to(torch.uint8) if domain_bits == 8 \
        else values.to(torch.int16).view(torch.uint16)
    if from_numpy:
        return kdf.to_numpy(values), kdf.to_numpy(count)
    return values, count
