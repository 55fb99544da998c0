"""Public sort API of the PyTorch port: typed, stable, strategy-dispatched sorts.

The counterpart of ``radix_sorting_tpu.api``: ``sort`` (`radix_sort.hpp:98`),
``argsort`` / ``rank_sort`` (`radix_sort_rank.hpp:97-112`), ``sort_pairs``
(`counting_sort_rec_sk.c`), ``counting_sort`` (`counting_sort_8.c`, `_8s.c`)
and ``sort_u64_multipass`` (`radix_sort_u64_multipass.c:117-118`). Every path
KDF-encodes to word planes, sorts ascending, decodes; the dispatch decisions
are the JAX package's, so an input takes the same route in both packages.

Inputs: a torch tensor is sorted on its own device and the results are
tensors on that device. A numpy array (or anything ``numpy.asarray`` takes)
is copied bit for bit (:func:`.ops.kdf.as_tensor`) to ``device=``, the CUDA
device when none is given (without a card that raises: pass
``device="cpu"``), sorted, and the results come back as numpy arrays of its
dtype. Byte-string (``S<W>``) and int4/uint4 keys exist only as numpy input.

``SortConfig.dynamic_probe`` and ``SortConfig.device_probe`` are read by
``sort`` in AUTO strategy, as in the JAX package, and each costs one host
read of what it measured (the JAX package's ``device_probe`` decides on the
device with ``lax.cond``; eager PyTorch has no device-side branch).
``argsort``, ``rank_sort`` and ``sort_pairs`` accept both flags and ignore
them. Not ported yet, and refused with NotImplementedError:
``Strategy.LSD`` (see ROADMAP.md, port queue).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .config import DEFAULT_CONFIG, SortConfig, Strategy
from .ops import counting_engine, hw_engine, kdf, probes

__all__ = ["sort", "argsort", "rank_sort", "sort_pairs", "counting_sort",
           "sort_u64_multipass"]


def _refuse_unported(cfg: SortConfig) -> None:
    if cfg.strategy == Strategy.LSD:
        raise NotImplementedError(
            "Strategy.LSD is not ported yet (ROADMAP.md, port queue item 2)")


# ---------------------------------------------------------------------------
# input normalization


def _as_input(x, device) -> Tuple[torch.Tensor, object, bool]:
    """A 1-D key array as (dense carrier tensor, key dtype, from_numpy).

    The key dtype is the tensor's torch dtype, or the numpy dtype of a numpy
    input, which goes to ``device`` (:func:`.ops.kdf.input_device`).
    """
    if torch.is_tensor(x):
        if device is not None and torch.device(device) != x.device:
            raise ValueError("device= places numpy input; a tensor is sorted "
                             "on its own device")
        if x.ndim != 1:
            raise ValueError(f"keys must be 1-D, got shape {tuple(x.shape)}")
        # the kernels take dense planes; a strided view is copied once here
        return x.contiguous(), x.dtype, False
    a = np.asarray(x)
    if a.ndim != 1:
        what = "byte-string keys" if a.dtype.kind == "S" else "keys"
        raise ValueError(f"{what} must be 1-D, got shape {a.shape}")
    # the numpy codec: 64-bit keys, byte strings and int4 cross as carriers
    return kdf.as_tensor(a, kdf.input_device(device)), a.dtype, True


def _as_words(x, descending: bool, device) -> Tuple[tuple, object, bool]:
    """KDF-encode a 1-D key array into int32 word planes.

    Returns (words, key dtype, from_numpy), as :func:`_as_input` gives them.
    """
    t, dtype, from_numpy = _as_input(x, device)
    return kdf.encode(t, descending, dtype), dtype, from_numpy


def _decode(words, dtype, descending: bool, from_numpy: bool):
    out = kdf.decode(words, dtype, descending)
    return kdf.to_numpy(out, dtype) if from_numpy else out


def _index_dtype(index_dtype) -> torch.dtype:
    """A torch integer dtype from a torch or numpy dtype-like."""
    t = index_dtype if isinstance(index_dtype, torch.dtype) \
        else getattr(torch, np.dtype(index_dtype).name, None)
    if t not in (torch.uint8, torch.int8, torch.uint16, torch.int16,
                 torch.uint32, torch.int32, torch.uint64, torch.int64):
        raise TypeError(f"index_dtype must be an integer dtype, got {index_dtype}")
    return t


def _check_index_width(n: int, index_dtype: torch.dtype) -> None:
    """Raise when ``index_dtype`` cannot represent indices [0, n) (a
    wrapping index would silently corrupt the permutation)."""
    name = str(index_dtype).replace("torch.", "")
    if n - 1 > int(np.iinfo(name).max):
        raise ValueError(f"index_dtype {name} cannot index {n} keys")


def _check_field_width(W: int) -> None:
    if W == 0:
        raise ValueError("byte-field payload width must be > 0")
    if W > 256:
        raise ValueError(
            f"byte-field payload width {W} > 256: each 4 bytes adds a sort "
            "operand — carry long blobs as an index payload and gather on "
            "the host instead")


def _flatten_payload(values, device):
    """Payload pytree -> payload planes on ``device`` + rebuild metadata.

    Leaves are 1-D tensors or numpy arrays (64-bit ones included), numpy
    ``S``/``V`` byte fields, or ``(n, W)`` uint8/int8 byte fields; byte
    fields ride as ``(n, W)`` uint8 rows that the sorter gathers whole. A
    tensor leaf comes back a tensor, a numpy leaf numpy with its dtype.
    Returns (planes, meta), meta = (treedef, specs), one spec per leaf:
    None for a None leaf, "tensor", or the numpy leaf's dtype.
    """
    if values is None:
        return (), None
    leaves, treedef = pytree.tree_flatten(values)
    n = None
    planes, specs = [], []
    for leaf in leaves:
        if leaf is None:
            specs.append(None)
            continue
        if torch.is_tensor(leaf):
            if leaf.device != torch.device(device):
                raise ValueError("payload tensors must be on the keys' device")
            t, spec, dt = leaf, "tensor", leaf.dtype
            narrow = dt in (torch.uint8, torch.int8)
        else:
            a = np.asarray(leaf)
            spec, dt = a.dtype, a.dtype
            if kdf.is_byte_field(a.dtype) and a.ndim == 1:
                _check_field_width(a.dtype.itemsize)
            narrow = a.dtype in (np.uint8, np.int8)
            t = a
        if t.ndim == 2 and narrow:
            _check_field_width(int(t.shape[1]))
        elif t.ndim != 1:
            raise ValueError(
                "payload leaves must be 1-D arrays (or fixed-width byte "
                f"fields: numpy S/V or (n, W) uint8/int8), got "
                f"{tuple(t.shape)} {dt}")
        if not isinstance(spec, str):
            t = kdf.as_tensor(t, device)
        ln = int(t.shape[0])
        if n is None:
            n = ln
        elif ln != n:
            raise ValueError("payload leaves must share the key length")
        planes.append(t.contiguous())
        specs.append(spec)
    return tuple(planes), (treedef, tuple(specs))


def _unflatten_payload(sorted_planes, meta):
    if meta is None:
        return None
    treedef, specs = meta
    out, i = [], 0
    for spec in specs:
        if spec is None:
            out.append(None)
            continue
        p = sorted_planes[i]
        i += 1
        out.append(p if isinstance(spec, str) else kdf.to_numpy(p, spec))
    return pytree.tree_unflatten(out, treedef)


def _reject_bytes_mask(dtype, value_mask) -> None:
    """Byte-string keys have no bit-mask story: a hex mask is a fixed-width
    integer promise (`radix_experiment.cpp:188-198`)."""
    if value_mask is not None and kdf.is_bytes_dtype(dtype):
        raise ValueError(
            "value_mask is not applicable to byte-string (numpy 'S') keys")


def _validate_value_mask(x, dtype, value_mask: int) -> None:
    """Raise when any key carries live bits outside ``value_mask``.

    One OR-reduce per plane plus a host sync: the opt-in check behind
    ``validate_mask=True``. A numpy input is checked on the host.
    """
    if torch.is_tensor(x):
        bits_or = 0
        for p in kdf.raw_bits(x.contiguous(), dtype):
            bits_or = (bits_or << 32) | (int(probes.or_reduce(p)) & 0xFFFFFFFF)
    else:
        a = np.asarray(x)
        bits_or = int(np.bitwise_or.reduce(
            np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")))
    width_mask = (1 << kdf.key_bits(dtype)) - 1
    stray = bits_or & ~int(value_mask) & width_mask
    if stray:
        raise ValueError(
            f"value_mask violated: keys carry live bits 0x{stray:X} "
            f"outside mask 0x{int(value_mask):X}")


def _compaction_masks(words, value_mask, dtype,
                      cfg: SortConfig) -> Optional[Tuple[int, ...]]:
    """Per-plane masks when PEXT plane compaction pays for the sorter.

    Masked 64-bit keys whose ``value_mask`` leaves <= 32 live bits sort as
    ONE compacted operand instead of two planes. The budget is the 32-bit
    plane width, not ``counting_max_bits`` (no histogram is involved).
    """
    if len(words) != 2 or value_mask is None or kdf.is_bytes_dtype(dtype):
        return None
    if int(words[0].shape[0]) < 2:
        return None          # the dead-bit restore samples element 0
    return _static_live_mask(words, value_mask, dtype,
                             cfg.replace(counting_max_bits=32))


def _static_live_mask(words, value_mask, dtype,
                      cfg: SortConfig) -> Optional[Tuple[int, ...]]:
    """Static per-plane live-bit masks for the COUNTING path, or None.

    From (a) the dtype's width for narrow keys, the `counting_sort_8.c`
    domain, or (b) an explicit ``value_mask`` promise
    (`radix_experiment.cpp:188-198`), split into (hi, lo) masks for 64-bit
    keys.
    """
    if kdf.is_bytes_dtype(dtype):
        return None
    bits = kdf.key_bits(dtype)
    kind = kdf.kind(dtype)
    mask = None
    if value_mask is not None:
        mask = int(value_mask) & ((1 << bits) - 1)
        # the float KDF inverts every bit of a negative key, so a mask that
        # admits the sign bit spreads liveness beyond its positions
        if kind == "f" and mask & (1 << (bits - 1)):
            return None
    elif kind == "b":
        mask = 1
    elif kind in ("u", "i", "f") and bits <= cfg.counting_max_bits:
        mask = (1 << bits) - 1
    if mask is None:
        return None
    if bin(mask).count("1") > min(cfg.counting_max_bits, 32):
        return None
    if len(words) == 2:
        return (mask >> 32, mask & 0xFFFFFFFF)
    return (mask,)


def _operands(words, cmasks):
    return words if cmasks is None \
        else (probes.compact_word_planes(words, cmasks),)


# ---------------------------------------------------------------------------
# public ops


def sort(x, *, config: SortConfig = DEFAULT_CONFIG,
         value_mask: Optional[int] = None, validate_mask: bool = False,
         device=None):
    """Sort a 1-D key array; returns the sorted keys (same dtype, same device).

    ``value_mask`` is a static promise that every key satisfies
    ``key == key & value_mask``; it enables the COUNTING path when few bits
    are live. A broken promise truncates keys to the mask;
    ``validate_mask=True`` pays one OR-reduce and a host sync to raise
    ValueError instead. ``device`` places a numpy input (the CUDA device by
    default).
    """
    cfg = config
    _refuse_unported(cfg)
    words, dtype, from_numpy = _as_words(x, cfg.descending, device)
    _reject_bytes_mask(dtype, value_mask)
    n = int(words[0].shape[0])
    if n <= 1:
        return np.asarray(x).copy() if from_numpy else x.clone()
    if value_mask is not None and validate_mask:
        _validate_value_mask(x, dtype, value_mask)
    sw = _sort_words(words, dtype, cfg, value_mask)
    return _decode(sw, dtype, cfg.descending, from_numpy)


def _sort_words(words, dtype, cfg: SortConfig, value_mask: Optional[int] = None):
    """The strategy dispatch of :func:`sort`: the planes of at least two
    encoded keys, sorted ascending (the complemented planes of a descending
    sort)."""
    strategy = cfg.strategy
    # computed once, consulted twice: the device probe runs only where
    # compaction does not engage, and HW_SORT compacts with the same masks
    cmasks = _compaction_masks(words, value_mask, dtype, cfg)
    mask = None
    if strategy == Strategy.AUTO:
        mask = _static_live_mask(words, value_mask, dtype, cfg)
        if mask is None and cfg.dynamic_probe and len(words) <= 2:
            # the runtime column-skip probe (`radix_sort.hpp:64-70`, live-bit
            # form): dead bits are constant by measurement; one host read
            measured = tuple(int(m) & 0xFFFFFFFF for m in
                             torch.stack(probes.live_bit_mask(words)).tolist())
            if 0 < sum(bin(m).count("1") for m in measured) \
                    <= min(cfg.counting_max_bits, 32):
                mask = measured
        if mask is not None:
            strategy = Strategy.COUNTING
        elif cfg.device_probe and cmasks is None and len(words) <= 2:
            # the range probe (a 64-bit value_mask with 18-32 live bits is a
            # static promise of the one-operand sorter, which it must not
            # pre-empt); the complemented word's range is the complement of
            # the original's, so descending needs nothing more
            if len(words) == 1:
                sw = (counting_engine.sort_word_range_probe(
                    words[0], guard=cfg.detect_presorted),)
            else:
                sw = counting_engine.sort_words2_range_probe(
                    words[0], words[1], guard=cfg.detect_presorted)
            return sw
        else:
            strategy = Strategy.HW_SORT
    elif strategy == Strategy.COUNTING:
        mask = _static_live_mask(words, value_mask, dtype, cfg)
        if mask is None:
            raise ValueError(
                "COUNTING strategy needs a narrow key dtype or a value_mask "
                f"with <= {cfg.counting_max_bits} live bits")

    if strategy == Strategy.COUNTING:
        # the descending complement flips bits in place, so the live-bit
        # positions are unchanged; decode restores order and values
        sw = counting_engine.sort_words_counting(words, mask)
    else:
        # HW_SORT; keys-only, so the unstable sorter is exact. Masked 64-bit
        # keys with <= 32 live bits sort as one compacted operand.
        operands = _operands(words, cmasks)
        if cfg.detect_presorted:
            sw, _ = hw_engine.sort_words_presort_guard(operands, stable=False)
        else:
            sw, _ = hw_engine.sort_words(operands, stable=False)
        if cmasks is not None:
            sw = probes.expand_word_planes(sw[0], words, cmasks)
    return sw


def argsort(x, *, config: SortConfig = DEFAULT_CONFIG, index_dtype=torch.uint32,
            value_mask: Optional[int] = None, validate_mask: bool = False,
            device=None):
    """Stable argsort: the rank/index sort (`radix_sort_rank.hpp:97-112`).

    The input is never modified; returns the unique stable permutation as
    ``index_dtype`` (a torch or numpy integer dtype; uint32 by default).
    ``value_mask`` (the promise of :func:`sort`) lets masked 64-bit keys
    with <= 32 live bits rank with ONE compacted key operand.
    """
    cfg = config
    _refuse_unported(cfg)
    words, dtype, from_numpy = _as_words(x, cfg.descending, device)
    _reject_bytes_mask(dtype, value_mask)
    n = int(words[0].shape[0])
    idt = _index_dtype(index_dtype)
    _check_index_width(n, idt)
    if n > 1 and value_mask is not None and validate_mask:
        _validate_value_mask(x, dtype, value_mask)
    if n > 1 and cfg.strategy == Strategy.COUNTING:
        raise ValueError(
            "Strategy.COUNTING is keys-only (regeneration rebuilds values "
            "from the histogram and cannot carry a permutation); use AUTO, "
            "LSD, or HW_SORT for argsort")
    operands = _operands(words, _compaction_masks(words, value_mask, dtype, cfg))
    # the presorted guard (`radix_sort.hpp:60-62`): an ordered input's
    # stable permutation is the identity
    if n <= 1 or (cfg.detect_presorted and bool(probes.is_sorted_words(operands))):
        perm = torch.arange(n, device=words[0].device).to(idt)
    else:
        _, perm = hw_engine.argsort_words(operands, index_dtype=idt)
    return kdf.to_numpy(perm) if from_numpy else perm


# Reference naming alias: rank sort == argsort (`radix_sort_rank.hpp:7`).
rank_sort = argsort


def sort_pairs(keys, values, *, config: SortConfig = DEFAULT_CONFIG,
               value_mask: Optional[int] = None, validate_mask: bool = False,
               device=None):
    """Stable sort of keys carrying a payload pytree (dicts, lists, tuples).

    The record sort (`counting_sort_rec_sk.c:14-41`) as structure-of-arrays
    payload permutation. Leaves: see :func:`_flatten_payload`. Returns
    (sorted keys, sorted payload tree). ``value_mask`` lets masked 64-bit
    keys with <= 32 live bits ship one compacted key operand (a bijection on
    the masked domain, so the stable payload order is unchanged).
    """
    cfg = config
    _refuse_unported(cfg)
    words, dtype, from_numpy = _as_words(keys, cfg.descending, device)
    _reject_bytes_mask(dtype, value_mask)
    leaves, pmeta = _flatten_payload(values, words[0].device)
    n = int(words[0].shape[0])
    if n != (leaves[0].shape[0] if leaves else n):
        raise ValueError("keys and payload lengths differ")
    if value_mask is not None and validate_mask:
        _validate_value_mask(keys, dtype, value_mask)

    if cfg.strategy == Strategy.COUNTING:
        raise ValueError(
            "Strategy.COUNTING is keys-only (regeneration rebuilds values "
            "from the histogram and cannot carry a payload); use AUTO, LSD, "
            "or HW_SORT for sort_pairs")
    cmasks = _compaction_masks(words, value_mask, dtype, cfg)
    operands = _operands(words, cmasks)
    if cfg.detect_presorted:
        sw, sp = hw_engine.sort_words_presort_guard(operands, leaves)
    else:
        sw, sp = hw_engine.sort_words(operands, leaves)
    if cmasks is not None:
        sw = probes.expand_word_planes(sw[0], words, cmasks)
    sorted_keys = _decode(sw, dtype, cfg.descending, from_numpy)
    return sorted_keys, _unflatten_payload(sp, pmeta)


def counting_sort(keys, values=None, *, config: SortConfig = DEFAULT_CONFIG,
                  device=None):
    """Counting sort for narrow integer keys (<= 16 bits).

    Keys-only: the regeneration path (`counting_sort_8.c`). With a payload:
    the stable form (`counting_sort_8s.c`, `counting_sort_rec_sk.c`), one
    stable sort by the narrow derived key.
    """
    size = keys.element_size() if torch.is_tensor(keys) \
        else np.asarray(keys).dtype.itemsize
    if size * 8 > 16 or kdf.is_bytes_dtype(getattr(keys, "dtype", None)):
        raise TypeError("counting_sort requires a key dtype of <= 16 bits")
    if values is None:
        cfg = config.replace(strategy=Strategy.AUTO,
                             counting_max_bits=max(config.counting_max_bits,
                                                   size * 8))
        return sort(keys, config=cfg, device=device)
    # the payload form IS the counting-with-payload realization, so an
    # explicit COUNTING request maps to AUTO here
    if config.strategy == Strategy.COUNTING:
        config = config.replace(strategy=Strategy.AUTO)
    return sort_pairs(keys, values, config=config, device=device)


def sort_u64_multipass(x, *, config: SortConfig = DEFAULT_CONFIG, device=None):
    """64-bit sort as two chained stable 32-bit sorts.

    The multipass composition of `radix_sort_u64_multipass.c:117-118`: sort
    by the low word carrying the high word, then stable-sort by the high
    word carrying the low word; right only because each pass is stable
    (`README.md:471-473`).
    """
    cfg = config
    words, dtype, from_numpy = _as_words(x, cfg.descending, device)
    if len(words) != 2:
        raise TypeError("sort_u64_multipass requires a 64-bit key dtype")
    hi, lo = words
    (lo1,), (hi1,) = hw_engine.sort_words((lo,), (hi,))
    (hi2,), (lo2,) = hw_engine.sort_words((hi1,), (lo1,))
    return _decode((hi2, lo2), dtype, cfg.descending, from_numpy)
