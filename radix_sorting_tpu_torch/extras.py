"""Array utilities beyond sorting; so far ``bincount``.

The counterpart of ``radix_sorting_tpu.extras`` for the functions ported so
far (ROADMAP.md, port queue item 5 lists the rest).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops import cuda_kernels, kdf
from .ops.histogram import digit_histogram
from .ops.kdf import INT32_MIN

__all__ = ["bincount"]

_HIST_MAX_LENGTH = 1 << cuda_kernels.HIST_MAX_BITS   # the JAX package's 2^18


def _u32_values(x: torch.Tensor, dtype) -> torch.Tensor:
    """The values as the int32 plane of their u32 conversion (the JAX
    package's ``astype(uint32)``): signed values sign-extend, so negatives
    wrap far past any length; 64-bit values keep their low word."""
    bits, k = kdf.key_bits(dtype), kdf.kind(dtype)
    if bits == 64:
        return kdf.split64(x)[1]
    if k == "i" and bits < 32:
        return x.to(torch.int32)
    return kdf.raw_bits(x, dtype)[0]


def bincount(x, *, length: Optional[int] = None, validate: bool = False,
             device=None):
    """Occurrence counts of non-negative integer values (``np.bincount``).

    Lengths of 4 to 2^18 take the JAX package's TPU route: the K1 histogram
    of the next power of two of bins, with values at or past ``length``
    dropped inside the kernel (``drop_ge``). Other lengths take the plain
    form, as the JAX package does off that route.

    Precondition: every value lies in ``[0, length)``. Out-of-range values
    are DROPPED (numpy raises on negatives); ``validate=True`` pays one max
    reduce and a host sync to raise ValueError instead. ``length`` defaults
    to the domain size of narrow unsigned and bool keys and is required
    otherwise. Returns int32 counts of ``length``: a tensor on ``x``'s
    device, or numpy for a numpy input (which needs ``device=``).
    """
    from_numpy = not torch.is_tensor(x)
    if from_numpy:
        if device is None:
            raise TypeError("a numpy input needs device= (e.g. 'cuda')")
        a = np.asarray(x)
        dtype, x = a.dtype, kdf.as_tensor(a, device)
    else:
        dtype = x.dtype
    if x.ndim != 1:
        raise ValueError(f"bincount input must be 1-D, got shape {tuple(x.shape)}")
    k = kdf.kind(dtype)
    if k in ("f", "S"):
        raise TypeError(f"bincount needs integer/bool values, got {dtype}")
    bits = kdf.key_bits(dtype)
    if length is None:
        if k in ("u", "b") and bits <= 16:
            length = 2 if k == "b" else 1 << bits
        else:
            raise ValueError(
                f"length is required for {dtype} (domain too wide to default)")
    length = int(length)
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    n = int(x.shape[0])
    w = _u32_values(x.contiguous(), dtype) if n else None
    if validate and n:
        # negatives wrap past any length in the u32 view, so one max reduce
        # (one host sync) covers both failure modes
        hi = (int(torch.max(w ^ INT32_MIN)) ^ INT32_MIN) & 0xFFFFFFFF
        if hi >= length:
            raise ValueError(
                f"bincount values outside [0, {length}): max raw bits 0x{hi:X}")
    if n == 0:
        out = torch.zeros(length, dtype=torch.int32, device=x.device)
    elif 4 <= length <= _HIST_MAX_LENGTH:
        radix_bits = (length - 1).bit_length()     # the kernel's power of two
        out = cuda_kernels.hist(w, 0, radix_bits, drop_ge=length)[:length]
    else:
        u = w.long() & 0xFFFFFFFF              # out-of-range values spill
        out = digit_histogram(torch.where(u < length, u, length), length)
    return kdf.to_numpy(out) if from_numpy else out
