"""Key-derivation functions (KDF) on torch tensors, and the numpy codec.

The PyTorch counterpart of ``radix_sorting_tpu.ops.kdf``: order-preserving
bijections from a key dtype into unsigned 32-bit word planes, most
significant first (`radix_sort_basic_kdf.hpp:10-48`), with an explicit
inverse so keys-only sorts sort the derived words and decode them.

* unsigned ints and bool: identity (zero-extended);
* signed ints: flip the sign bit at the native width;
* floats: ``x ^ (-(x >> (B-1)) & live | 1 << (B-1))``, the total order
  -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN;
* 64-bit keys: two planes ``(hi, lo)``; the sign flip and the float rule
  act on the pair (`radix_sort_basic_kdf.hpp:40-46`);
* byte strings (numpy ``S<W>``): ``ceil(W/4)`` big-endian planes, so plane
  order is byte-lexicographic order, numpy's order for ``S`` arrays;
* descending order complements the live bits (every bit of a 64-bit or
  byte-string key), so narrow keys stay zero-extended.

**Word planes are ``int32`` tensors that carry the u32 bit pattern.** Torch's
``uint32`` lacks ``>>``, ``<`` and reductions on some builds, so every plane
op here is an int32 op: shifts are masked afterwards (int32 ``>>`` is
arithmetic) and unsigned order is compared in sign-flipped space
(``w ^ INT32_MIN``, see :mod:`.probes`). 64-bit tensors are split through an
int32 view and never computed on as floats, so NaN payloads survive.

Key dtypes are torch dtypes, or numpy dtypes for what torch cannot hold:

* ``bool, uint8, int8, uint16, int16, float16, bfloat16, float8_e4m3fn,
  float8_e5m2, uint32, int32, float32, uint64, int64, float64``: a tensor of
  that dtype carries the keys;
* numpy ``S<W>`` (1 <= W <= 256): a ``(n, W)`` uint8 tensor carries them;
* ml_dtypes ``int4`` / ``uint4`` (logical width 4): an int8 / uint8 tensor
  of the values carries them (torch's ``int4``/``uint4`` cannot compute, and
  raise TypeError).

:func:`as_tensor` makes the carrier of a numpy array and :func:`to_numpy`
turns a carrier back into numpy, bit for bit. Little-endian hosts only (the
64-bit split reads the low word first), as the JAX package assumes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.timing import READ, span

__all__ = [
    "encode",
    "decode",
    "complement",
    "kind",
    "key_bits",
    "num_words",
    "is_bytes_dtype",
    "is_byte_field",
    "raw_bits",
    "split64",
    "join64",
    "halves",
    "pair_of",
    "gather",
    "SIGNED_VIEW",
    "encode64_np",
    "decode64_np",
    "pack_bytes_be",
    "unpack_bytes_be",
    "encode_bytes_np",
    "decode_bytes_np",
    "input_device",
    "as_tensor",
    "to_numpy",
    "i32",
    "INT32_MIN",
    "SUPPORTED_DTYPES",
]

INT32_MIN = -(1 << 31)

# torch dtype -> (logical width in bits, kind); the kinds are those of the
# JAX package's kdf.kind ('b' bool, 'u' unsigned, 'i' signed, 'f' float)
_DTYPES = {
    torch.bool: (8, "b"),
    torch.uint8: (8, "u"),
    torch.int8: (8, "i"),
    torch.float8_e4m3fn: (8, "f"),
    torch.float8_e5m2: (8, "f"),
    torch.uint16: (16, "u"),
    torch.int16: (16, "i"),
    torch.float16: (16, "f"),
    torch.bfloat16: (16, "f"),
    torch.uint32: (32, "u"),
    torch.int32: (32, "i"),
    torch.float32: (32, "f"),
    torch.uint64: (64, "u"),
    torch.int64: (64, "i"),
    torch.float64: (64, "f"),
}
# numpy-only key dtypes: name -> (logical width, kind, carrier dtype)
_SUB_BYTE = {"int4": (4, "i", torch.int8), "uint4": (4, "u", torch.uint8)}
SUPPORTED_DTYPES = tuple(_DTYPES) + tuple(_SUB_BYTE) + ("S<W>",)

_MAX_BYTES_KEY_WIDTH = 256


def i32(v: int) -> int:
    """A u32 bit pattern (Python int) as the int32 value that carries it."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _canonical_dtype(dtype):
    """A torch key dtype, or the numpy dtype of a byte-string / 4-bit key."""
    if isinstance(dtype, torch.dtype):
        if dtype in _DTYPES:
            return dtype
        if _name(dtype) in _SUB_BYTE:
            raise TypeError(f"torch.{_name(dtype)} tensors cannot compute; pass "
                            f"{_name(dtype)} keys as a numpy ml_dtypes array")
    else:
        try:
            d = np.dtype(dtype)
        except TypeError:
            d = None
        if d is not None:
            if d.kind == "S" or d.name in _SUB_BYTE:
                return d
            t = getattr(torch, d.name, None)
            if t in _DTYPES:
                return t
    raise TypeError(f"unsupported key dtype {_name(dtype)}; supported: "
                    f"{tuple(_name(d) for d in SUPPORTED_DTYPES)}")


def _info(dtype) -> Tuple[int, str]:
    d = _canonical_dtype(dtype)
    if isinstance(d, torch.dtype):
        return _DTYPES[d]
    if d.kind == "S":
        return 8 * d.itemsize, "S"
    return _SUB_BYTE[d.name][:2]


def is_bytes_dtype(dtype) -> bool:
    """True for numpy fixed-width byte-string dtypes (kind 'S')."""
    if isinstance(dtype, (torch.dtype, str)) or dtype is None:
        return False
    try:
        return np.dtype(dtype).kind == "S"
    except TypeError:
        return False


def is_byte_field(dtype) -> bool:
    """True for numpy fixed-width byte fields: ``S<W>`` and ``V<W>`` (not
    the ml_dtypes types, which numpy also reports as kind 'V')."""
    d = np.dtype(dtype)
    return d.kind == "S" or d.type is np.void


def kind(dtype) -> str:
    """'u' / 'i' / 'f' / 'b' / 'S' for a supported key dtype."""
    return _info(dtype)[1]


def key_bits(dtype) -> int:
    """LOGICAL width of the key type in bits (8 for bool, 4 for int4/uint4,
    8*W for byte strings), as in the JAX package."""
    return _info(dtype)[0]


def num_words(dtype) -> int:
    """Number of 32-bit planes the encoded key occupies: 1 up to 32 bits,
    2 for 64-bit keys, ceil(W/4) for byte strings."""
    bits, _ = _info(dtype)
    return -(-bits // 32)


def _check_bytes_width(W: int) -> None:
    if W == 0:
        raise ValueError("byte-string key width must be > 0 (got S0)")
    if W > _MAX_BYTES_KEY_WIDTH:
        raise ValueError(
            f"byte-string key width {W} > {_MAX_BYTES_KEY_WIDTH}: each 4 "
            "bytes adds a sort operand — sort an index payload and gather "
            "long blobs on the host instead")


# ---------------------------------------------------------------------------
# raw bits


def split64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw ``(hi, lo)`` int32 planes of a 64-bit tensor (no KDF transform).

    One copy through an int32 view: element i's low word is column 0.
    Inverse: :func:`join64`.
    """
    if x.numel() == 0:          # an empty tensor may carry a stride of 0
        e = torch.empty(0, dtype=torch.int32, device=x.device)
        return e, e.clone()
    planes = x.contiguous().view(torch.int32).view(-1, 2).t().contiguous()
    return planes[1], planes[0]


def join64(hi: torch.Tensor, lo: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`split64`: a 64-bit tensor of ``dtype``.

    Where ``hi`` and ``lo`` are the two halves of one dense buffer (a pair,
    :func:`pair_of`, as K0's last pass writes them), that buffer as a view,
    with no copy. Other planes are stacked as rows, then one transposing
    copy: 0.49 ms at 40M keys, where ``torch.stack(dim=1)`` takes 0.93
    (H100 80GB HBM3, 700 W). The copy is flattened before the 64-bit view:
    ``contiguous()`` of one (1, 2) pair keeps the transposed strides, which
    the view refuses (F2).
    """
    base = pair_of(hi, lo)
    if base is not None:
        return base.view(dtype)
    pairs = torch.stack([lo, hi]).t().reshape(-1)
    return pairs.view(torch.int64).view(dtype)


def halves(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair layout: the ``(hi, lo)`` int32 halves of a dense 1-D 64-bit
    tensor, as views with a stride of 2 (no copy). lo is the buffer's even
    words and hi its odd ones, so element i's low word is column 0, as
    :func:`split64` reads it. K0 reads and writes such a pair in place of
    two dense planes (:func:`pair_of`); every other wrapper refuses it."""
    v = buf.view(torch.int32)
    return v[1::2], v[0::2]


def pair_of(hi: torch.Tensor, lo: torch.Tensor) -> Optional[torch.Tensor]:
    """The dense int64 buffer whose :func:`halves` ``hi`` and ``lo`` are,
    as a view, or None. Exactly the pair: 1-D int32 views of one storage
    and length, a stride of 2 words, lo on an 8-byte boundary and hi the
    word after it; no other stride, order or offset."""
    # the stride first: dense planes, K0's every other pass, fail at once
    if not torch.is_tensor(hi) or hi.stride() != (2,) or not torch.is_tensor(lo) \
            or lo.stride() != (2,):
        return None
    if hi.dtype != torch.int32 or lo.dtype != torch.int32 or hi.shape != lo.shape \
            or hi.device != lo.device or lo.numel() == 0 or lo.data_ptr() % 8 \
            or hi.data_ptr() != lo.data_ptr() + 4 \
            or hi.untyped_storage().data_ptr() != lo.untyped_storage().data_ptr():
        return None
    return torch.as_strided(lo, (2 * lo.shape[0],), (1,)).view(torch.int64)


# same-width signed views: torch indexes few of its unsigned dtypes
SIGNED_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather(p: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``p[perm]`` along dim 0, through a same-width integer view."""
    v = SIGNED_VIEW[p.element_size()]
    return p.view(v)[perm].view(p.dtype)


def _sub_byte_bits(x: torch.Tensor) -> torch.Tensor:
    """The 4-bit patterns of int4/uint4 values carried one per byte."""
    return x.view(torch.uint8).to(torch.int32) & 0xF


def raw_bits(x: torch.Tensor, dtype=None) -> Tuple[torch.Tensor, ...]:
    """The raw key bits as int32 planes, most significant first: ``(hi, lo)``
    for 64-bit keys, else one plane zero-extended from the key's width."""
    dtype = _canonical_dtype(x.dtype if dtype is None else dtype)
    bits, k = _info(dtype)
    if k == "S":
        raise TypeError("byte-string keys have no integer bits")
    if bits == 64:
        return split64(x)
    if bits == 4:
        return (_sub_byte_bits(x),)
    if x.dtype == torch.bool:
        return (x.to(torch.int32),)
    if bits < 32:
        return (x.view(torch.uint8 if bits == 8 else torch.uint16).to(torch.int32),)
    return (x.view(torch.int32),)


def _signed_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The raw bits of ``x`` sign-extended from their width into int32."""
    if bits < 32:
        return x.view(torch.int8 if bits == 8 else torch.int16).to(torch.int32)
    return x.view(torch.int32)


def _from_raw(raw: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`raw_bits` for one plane: int32 bits (live in the low
    ``bits``) back to the carrier of ``dtype``. Narrowing wraps."""
    bits, k = _info(dtype)
    if bits == 4:
        p = raw & 0xF
        return ((p ^ 8) - 8).to(torch.int8) if k == "i" else p.to(torch.uint8)
    if dtype == torch.bool:
        return raw != 0
    if bits == 8:
        return raw.to(torch.uint8).view(dtype)
    if bits == 16:
        return raw.to(torch.int16).view(dtype)
    return raw.view(dtype)


def _live(bits: int) -> int:
    return i32((1 << bits) - 1)


def _float_mangle(s: torch.Tensor, bits: int) -> torch.Tensor:
    """Reference rule (`radix_sort_basic_kdf.hpp:32-38`) at width ``bits``:
    negative floats invert every live bit, non-negative ones set the sign.

    ``s`` holds the raw bits sign-extended, so ``s >> (bits-1)`` is 0 or -1
    and ``s ^ -1 = ~s`` clears the extension: the key is zero-extended.
    """
    return s ^ ((s >> (bits - 1)) | i32(1 << (bits - 1)))


def _float_unmangle(k: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`_float_mangle` in the low ``bits`` (the bits above
    are left undefined: :func:`_from_raw` drops them)."""
    nonneg = (k >> (bits - 1)) & 1        # the key's top bit
    return k ^ ((nonneg - 1) | i32(1 << (bits - 1)))


# ---------------------------------------------------------------------------
# byte strings


def pack_bytes_be(u8: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(n, W) uint8 -> ceil(W/4) big-endian int32 planes, most significant
    first; a ragged tail is zero-padded (order-neutral: the pad is the same
    in every row). Inverse: :func:`unpack_bytes_be`."""
    n, W = u8.shape
    cols = u8.to(torch.int32)
    G = -(-W // 4)
    if W != 4 * G:
        cols = torch.nn.functional.pad(cols, (0, 4 * G - W))
    return tuple((cols[:, 4 * g] << 24) | (cols[:, 4 * g + 1] << 16)
                 | (cols[:, 4 * g + 2] << 8) | cols[:, 4 * g + 3]
                 for g in range(G))


def unpack_bytes_be(planes: Sequence[torch.Tensor], W: int) -> torch.Tensor:
    """Inverse of :func:`pack_bytes_be`: int32 planes -> (n, W) uint8."""
    cols = [((p >> s) & 0xFF).to(torch.uint8)
            for p in planes for s in (24, 16, 8, 0)]
    return torch.stack(cols, dim=1)[:, :W].contiguous()


# ---------------------------------------------------------------------------
# encode / decode


def encode(x: torch.Tensor, descending: bool = False,
           dtype=None, pair: bool = False) -> Tuple[torch.Tensor, ...]:
    """Encode keys into order-preserving int32 word planes, most significant
    first: ``(w,)`` up to 32 bits, ``(hi, lo)`` for 64-bit keys,
    ``ceil(W/4)`` planes for byte strings.

    ``dtype`` names the key dtype when ``x`` is a carrier (byte strings,
    int4/uint4); it defaults to ``x.dtype``. Narrow keys are zero-extended,
    so only the low ``key_bits`` of ``w`` are live. ``descending=True``
    complements the live bits (`README.md:566-574`). ``pair``: ascending
    unsigned 64-bit keys, whose KDF is the identity, come as the
    :func:`halves` of ``x`` itself, with no copy, for K0 to read in place
    (``api`` asks for it only where the sorter is K0).
    """
    dtype = _canonical_dtype(x.dtype if dtype is None else dtype)
    bits, k = _info(dtype)
    if k == "S":
        _check_bytes_width(dtype.itemsize)
        words = pack_bytes_be(x)
        return complement(words) if descending else words
    if bits == 64:
        if pair and k == "u" and not descending and x.numel():
            return halves(x.contiguous())
        hi, lo = split64(x)
        if k == "i":
            hi = hi ^ INT32_MIN
        elif k == "f":
            s = hi >> 31                    # 0 or -1: the sign, extended
            hi = hi ^ (s | INT32_MIN)
            lo = lo ^ s
        return complement((hi, lo)) if descending else (hi, lo)
    if k == "f":
        w = _float_mangle(_signed_bits(x, bits), bits)
    else:
        (w,) = raw_bits(x, dtype)
    if k == "i":
        w = w ^ i32(1 << (bits - 1))
    if descending:
        w = w ^ _live(bits)      # = ~w on the live bits; w has no others
    return (w,)


def decode(words: Sequence[torch.Tensor], dtype,
           descending: bool = False) -> torch.Tensor:
    """Inverse of :func:`encode`: the carrier of the keys of ``dtype``."""
    dtype = _canonical_dtype(dtype)
    bits, k = _info(dtype)
    if k == "S":
        words = complement(words) if descending else words
        return unpack_bytes_be(words, dtype.itemsize)
    if bits == 64:
        hi, lo = complement(words) if descending else words
        if k == "i":
            hi = hi ^ INT32_MIN
        elif k == "f":
            e = ~(hi >> 31)                 # 0 for keys of non-negatives
            hi = hi ^ (e | INT32_MIN)
            lo = lo ^ e
        return join64(hi, lo, dtype)
    (w,) = words
    if descending:
        w = w ^ _live(bits)
    if k == "i":
        w = w ^ i32(1 << (bits - 1))
    elif k == "f":
        w = _float_unmangle(w, bits)
    return _from_raw(w, dtype)


def complement(words: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Complement derived keys (the reference's ``~kf(x)``, README 566-574)."""
    return tuple(~w for w in words)


# ---------------------------------------------------------------------------
# numpy <-> torch codec: the same bits into both packages


def input_device(device=None) -> torch.device:
    """Where a numpy input goes: ``device``, or the CUDA device when None.

    The entry points run on the card unless the caller asks for another
    device; without a card a numpy input with no ``device=`` raises.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("numpy input goes to the CUDA device by default and "
                           "none is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def as_tensor(a, device) -> torch.Tensor:
    """Copy a numpy array onto ``device`` as its carrier tensor, bit for bit.

    ml_dtypes ``bfloat16`` and float8 cross through integer views; int4 /
    uint4 become int8 / uint8 values; fixed-width byte fields (``S<W>``,
    ``V<W>``) become ``(..., W)`` uint8. Inverse: :func:`to_numpy`.
    """
    a = np.ascontiguousarray(a)
    d = a.dtype
    if is_byte_field(d):
        u8 = a.view(np.uint8).reshape(*a.shape, d.itemsize)
        return torch.from_numpy(u8).to(device, copy=True)
    if d.name in _SUB_BYTE:
        a = a.astype(np.int8 if d.name == "int4" else np.uint8)
        return torch.from_numpy(a).to(device, copy=True)
    t = getattr(torch, d.name, None)
    if d.name == "bfloat16" or d.name.startswith("float8"):
        carried = a.view(np.int16 if d.itemsize == 2 else np.uint8)
        return torch.from_numpy(carried).to(device, copy=True).view(t)
    return torch.from_numpy(a).to(device, copy=True)


def to_numpy(t: torch.Tensor, dtype=None) -> np.ndarray:
    """Inverse of :func:`as_tensor`: a host numpy array with the same bits.

    ``dtype`` names a numpy dtype the carrier stands for (``S``/``V``
    fields, int4/uint4); by default the tensor's own dtype.
    """
    with span(READ):
        t = t.detach().cpu()
    d = None if dtype is None or isinstance(dtype, torch.dtype) else np.dtype(dtype)
    if d is not None and is_byte_field(d):
        return np.ascontiguousarray(t.numpy()).view(d).reshape(t.shape[:-1])
    if d is not None and d.name in _SUB_BYTE:
        return t.numpy().astype(d)
    if t.dtype == torch.bfloat16 or t.dtype in (torch.float8_e4m3fn,
                                                torch.float8_e5m2):
        import ml_dtypes
        width = torch.int16 if t.dtype == torch.bfloat16 else torch.uint8
        return t.view(width).numpy().view(getattr(ml_dtypes, _name(t.dtype)))
    return t.numpy()


def encode64_np(x: np.ndarray, descending: bool = False,
                device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """KDF-encode a 64-bit numpy array into ``(hi, lo)`` planes on ``device``."""
    return encode(as_tensor(x, device), descending)


def decode64_np(words, dtype, descending: bool = False) -> np.ndarray:
    """Host-side inverse of :func:`encode64_np`: a numpy array of ``dtype``."""
    return to_numpy(decode(words, np.dtype(dtype), descending))


def encode_bytes_np(x: np.ndarray, descending: bool = False,
                    device="cpu") -> Tuple[torch.Tensor, ...]:
    """KDF-encode a 1-D numpy ``S<W>`` array into ``ceil(W/4)`` planes."""
    d = np.dtype(x.dtype)
    if d.kind != "S":
        raise TypeError(f"expected a numpy 'S' dtype, got {d}")
    _check_bytes_width(d.itemsize)
    return encode(as_tensor(x, device), descending, d)


def decode_bytes_np(words, dtype, descending: bool = False) -> np.ndarray:
    """Host-side inverse of :func:`encode_bytes_np`: numpy array of ``dtype``."""
    return to_numpy(decode(words, dtype, descending), dtype)
