"""The one generator of every traffic mix.

A mix is a data file, ``traffic/<mix>.json``, that this module reads with
the configuration of the cell (its ``key_dtype``, any integer dtype torch
names: ``uint32``, ``uint64``, ``int16``, ...):

* ``sizes``: ``{"fixed": n, "count": c}`` (c inputs of n keys a row) or
  ``{"log_uniform": [lo, hi], "count": c}`` (the c sizes at evenly spaced
  quantiles of a log-uniform distribution over [lo, hi], so that every seed
  has the same size mix);
* ``rows`` (optional, default 1 and a 1-D input): each input is ``rows``
  rows of n keys, for the batched entry points;
* ``keys``: how a key is drawn:

  - ``and_of``: k (default 1): each key is the bitwise AND of k uniform
    words of its width, so each bit is 1 with probability 2^-k (CUB's
    entropy axis; k = 0, the AND of no words, sets every bit: all keys
    equal);
  - ``mask`` (optional): a hex string ANDed into every key (the counting
    tier's ``value_mask``, or a bounded number of groups);
  - ``order`` (optional, default ``"random"``): ``"sorted"``,
    ``"reversed"`` or ``"nearly_sorted"`` (sorted, then ``swap_share`` of
    the positions of each row swapped in pairs drawn from the seed);

* ``payload`` (optional): ``{"dtype": name}``: a second tensor of the keys'
  shape beside them (uniform [0, 1) for a float dtype, uniform bits for an
  integer one), for the entry points that carry values;
* ``sample_calls``: how many calls of the window are kept for the check;
* ``trace_calls``: how many calls a traced run profiles.

An input is a dict: ``keys`` and, where the mix asks, ``payload``. The seed
draws the words (on the device, one ``torch.randint`` a word for the whole
pool), the payload, the swaps and the order in which the pool is cycled, so
the same seed gives the same calls.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .reference import SIGNED, signed_view, sortable, take

ALIGN = 256     # bytes: every tensor of the pool starts on this boundary


def sizes(mix: dict) -> List[int]:
    """The keys a row of each input of the pool, in pool order."""
    spec = mix["sizes"]
    count = int(spec["count"])
    if count < 1:
        raise ValueError("a mix needs at least one array")
    if "fixed" in spec:
        return [int(spec["fixed"])] * count
    if "log_uniform" in spec:
        lo, hi = (math.log(int(v)) for v in spec["log_uniform"])
        return [round(math.exp(lo + (i + 0.5) / count * (hi - lo)))
                for i in range(count)]
    raise ValueError(f"unknown sizes {spec}")


def shapes(mix: dict) -> List[tuple]:
    """The shape of each input's keys, in pool order."""
    rows = int(mix.get("rows", 1))
    if rows < 1:
        raise ValueError("rows must be at least 1")
    return [(n,) if "rows" not in mix else (rows, n) for n in sizes(mix)]


def order(mix: dict, seed: int) -> List[int]:
    """The order, drawn from the seed, in which the pool is cycled."""
    rng = np.random.default_rng(seed % 2**64)
    return [int(i) for i in rng.permutation(len(sizes(mix)))]


def key_dtype(config: dict) -> torch.dtype:
    dtype = getattr(torch, config["key_dtype"])
    if dtype.is_floating_point or dtype.is_complex or dtype == torch.bool:
        raise ValueError(f"key_dtype {config['key_dtype']}: the generator draws integer keys")
    return dtype


def _words(gen: torch.Generator, nbytes: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``nbytes`` of uniform bits as a flat tensor of ``dtype``."""
    w = torch.randint(-(1 << 31), 1 << 31, (nbytes // 4,), dtype=torch.int32,
                      device=device, generator=gen)
    return w.view(torch.uint8).view(dtype)


def _as_signed(mask: int, width: int) -> int:
    mask &= (1 << 8 * width) - 1
    return mask - (1 << 8 * width) if mask >> (8 * width - 1) else mask


def _arrange(keys: torch.Tensor, spec: dict, gen: torch.Generator) -> torch.Tensor:
    """The keys of one input (rows along the last axis) put in the mix's
    order."""
    how = spec.get("order", "random")
    if how == "random":
        return keys
    if how not in ("sorted", "reversed", "nearly_sorted"):
        raise ValueError(f"unknown order {how!r}")
    positions = torch.sort(sortable(keys), dim=-1, stable=True).indices
    if how == "reversed":
        positions = positions.flip(-1)
    elif how == "nearly_sorted":
        n = keys.shape[-1]
        pairs = int(round(float(spec["swap_share"]) * n / 2))
        if pairs:
            swap = torch.arange(n, dtype=torch.int64, device=keys.device)
            picked = torch.randperm(n, generator=gen, device=keys.device)[:2 * pairs]
            swap[picked[:pairs]] = picked[pairs:]
            swap[picked[pairs:]] = picked[:pairs]
            positions = positions[..., swap]
    return take(keys, positions)


def make_pool(mix: dict, seed: int, device, config: dict) -> List[Dict[str, torch.Tensor]]:
    """The pool's inputs on ``device``, drawn from the seed in a few large
    calls: dicts of ``keys`` (and ``payload``)."""
    device = torch.device(device)
    dtype = key_dtype(config)
    width = torch.empty(0, dtype=dtype).element_size()
    spec = mix.get("keys", {})
    and_of = int(spec.get("and_of", 1))
    if and_of < 0:
        raise ValueError("and_of must be at least 0")
    shp = shapes(mix)
    spans, total = [], 0
    for s in shp:
        nbytes = math.prod(s) * width
        spans.append((total, nbytes))
        total += -(-nbytes // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    if and_of == 0:
        words = torch.full((total // width,), -1, dtype=SIGNED[width], device=device).view(dtype)
    else:
        words = _words(gen, total, dtype, device)
        for _ in range(and_of - 1):
            signed_view(words).bitwise_and_(signed_view(_words(gen, total, dtype, device)))
    if "mask" in spec:
        signed_view(words).bitwise_and_(_as_signed(int(spec["mask"], 16), width))
    pool = [{"keys": _arrange(words[s // width:(s + b) // width].view(sh), spec, gen)}
            for (s, b), sh in zip(spans, shp)]
    if "payload" in mix:
        pdtype = getattr(torch, mix["payload"]["dtype"])
        pwidth = torch.empty(0, dtype=pdtype).element_size()
        ptotal = sum(-(-math.prod(s) * pwidth // ALIGN) * ALIGN for s in shp)
        if pdtype.is_floating_point:
            flat = torch.rand((ptotal // pwidth,), dtype=pdtype, device=device, generator=gen)
        else:
            flat = _words(gen, ptotal, pdtype, device)
        start = 0
        for x, s in zip(pool, shp):
            x["payload"] = flat[start:start + math.prod(s)].view(s)
            start += -(-math.prod(s) * pwidth // ALIGN) * ALIGN // pwidth
    return pool
