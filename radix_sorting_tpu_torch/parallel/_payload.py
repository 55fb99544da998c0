"""Value-preserving int32-plane codecs for distributed payload trees.

The counterpart of ``radix_sorting_tpu.parallel._payload``. Payload planes
carry no order (unlike key planes, :mod:`..ops.kdf`): they only have to
survive the exchange bit for bit, so the encoding is the leaf's raw bits
with an exact inverse. Leaves follow :func:`..api._flatten_payload`: 1-D
tensors or numpy arrays of any fixed-width dtype (64-bit ones as two
planes), numpy ``S``/``V`` byte fields and ``(n, W)`` uint8/int8 byte
fields (big-endian packed, 4 bytes a plane). Shared by both exchange
methods (:mod:`.balanced`, :mod:`.shuffle`).

Decoded leaves are the per-rank shards of the leaf: tensors of its dtype,
or of its carrier for the numpy-only dtypes (``(n, W)`` uint8 for byte
fields, int8 / uint8 for int4 / uint4).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from .. import api
from ..ops import kdf

__all__ = ["payload_to_words", "payload_from_words", "encode_payload_tree",
           "decode_payload_tree"]


def payload_to_words(p: torch.Tensor, dtype) -> Tuple[Tuple[torch.Tensor, ...], tuple]:
    """One payload leaf's carrier ``p`` (of key dtype ``dtype``) as int32
    planes, with the metadata of the inverse."""
    if p.ndim == 2:
        return kdf.pack_bytes_be(p.view(torch.uint8)), ("bytes", int(p.shape[1]), p.dtype)
    return kdf.raw_bits(p, dtype), ("bits", kdf._canonical_dtype(dtype), p.dtype)


def payload_from_words(words: Sequence[torch.Tensor], meta) -> torch.Tensor:
    tag, what, carrier = meta
    if tag == "bytes":
        return kdf.unpack_bytes_be(words, what).view(carrier)
    if len(words) == 2:
        return kdf.join64(words[0], words[1], carrier)
    return kdf._from_raw(words[0], what)


def encode_payload_tree(values, n: int, device):
    """Flatten a payload tree into int32 planes on ``device`` (the keys'
    global device; numpy leaves are placed there). Returns (planes, ctx)."""
    leaves, (treedef, specs) = api._flatten_payload(values, device)
    planes, metas, widths = [], [], []
    it = iter(leaves)
    for spec in specs:
        if spec is None:
            metas.append(None)
            widths.append(0)
            continue
        p = next(it)
        ps, meta = payload_to_words(p, p.dtype if isinstance(spec, str) else spec)
        planes.extend(ps)
        metas.append(meta)
        widths.append(len(ps))
    for p in planes:
        if p.shape[0] != n:
            raise ValueError("payload leaves must share the key length")
    return tuple(planes), (treedef, metas, widths)


def decode_payload_tree(planes_by_rank, ctx):
    """The payload tree from each rank's payload planes: every leaf becomes
    the tuple of its per-rank shards (None stays None)."""
    treedef, metas, widths = ctx
    leaves, at = [], 0
    for meta, k in zip(metas, widths):
        if meta is None:
            leaves.append(None)
            continue
        leaves.append(tuple(payload_from_words(tuple(pl[at:at + k]), meta)
                            for pl in planes_by_rank))
        at += k
    return pytree.tree_unflatten(leaves, treedef)
