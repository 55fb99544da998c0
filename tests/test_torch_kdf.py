"""The port's KDF and numpy codec against ``radix_sorting_tpu.ops.kdf``.

The same keys, made with numpy from a seed, are encoded by both packages;
the derived words must agree bit for bit, and each package must decode the
other's words back to the original bits. Exact equality throughout: the
KDF is a bijection on integers.
"""

import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from radix_sorting_tpu.ops import kdf as jkdf
from radix_sorting_tpu_torch.ops import kdf as tkdf

DTYPES = ["bool", "uint8", "int8", "uint16", "int16", "float16", "bfloat16",
          "uint32", "int32", "float32"]
# 64-bit, float8 and int4/uint4 keys, and byte strings of widths 1 to 256
WIDE_DTYPES = ["uint64", "int64", "float64", "float8_e4m3fn", "float8_e5m2",
               "int4", "uint4"]
BYTE_DTYPES = ["S1", "S3", "S4", "S5", "S8", "S12", "S255", "S256"]
_ML_NAMES = ("bfloat16", "float8_e4m3fn", "float8_e5m2", "int4", "uint4")

_SPECIAL_BITS = {
    16: [0x0000, 0x8000, 0x7C00, 0xFC00, 0x7E00, 0xFE01, 0x7C01],   # f16
    "bf16": [0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC1, 0x7F81],
    32: [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
         0xFFC00001, 0x7F800123],
    64: [0x0, 0x8000000000000000, 0x7FF0000000000000, 0xFFF0000000000000,
         0x7FF8000000000000, 0xFFF8000000000001, 0x7FF0000000000123],
}


def np_dtype(name):
    return np.dtype(getattr(ml_dtypes, name)) if name in _ML_NAMES \
        else np.dtype(name)


def make_keys(name, n, rng):
    """n keys of dtype ``name`` from ``rng``: random raw bits over the whole
    domain, with +-0, +-inf and NaN payloads planted in float keys; byte
    strings from a small alphabet (duplicates) with trailing NULs."""
    dt = np_dtype(name)
    if name == "bool":
        return rng.integers(0, 2, size=n).astype(bool)
    if name in ("int4", "uint4"):
        lo = -8 if name == "int4" else 0
        return rng.integers(lo, lo + 16, size=n).astype(np.int8).astype(dt)
    if dt.kind == "S":
        W = dt.itemsize
        u8 = rng.integers(0, 4, size=(n, W), dtype=np.uint8) * np.uint8(85)
        keep = rng.integers(0, W + 1, size=(n, 1))
        u8 = np.where(np.arange(W)[None, :] < keep, u8, 0).astype(np.uint8)
        return np.ascontiguousarray(u8).view(dt).reshape(-1)
    ut = np.dtype(f"u{dt.itemsize}")
    bits = rng.integers(0, 1 << (8 * dt.itemsize), size=n, dtype=ut)
    if name in ("float16", "bfloat16", "float32", "float64"):
        special = _SPECIAL_BITS["bf16" if name == "bfloat16" else 8 * dt.itemsize]
        k = min(n, len(special))
        bits[:k] = np.array(special[:k], ut)
        bits = bits[rng.permutation(n)]
    return bits.view(dt)


def raw(a):
    """The raw bits of a numpy array, as unsigned integers (byte strings as
    they are)."""
    a = np.asarray(a)
    return a if a.dtype.kind == "S" else a.view(f"u{a.dtype.itemsize}")


def port_words(x, descending):
    (w,) = tkdf.encode(tkdf.as_tensor(x, "cpu"), descending=descending)
    assert w.dtype == torch.int32
    return w.numpy().view(np.uint32)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", DTYPES)
def test_encode_decode_match_jax(name, descending):
    rng = np.random.Generator(np.random.PCG64(DTYPES.index(name) * 2 + descending))
    x = make_keys(name, 5000, rng)
    (jw,) = jkdf.encode(jnp.asarray(x), descending=descending)
    jw = np.asarray(jw)
    tw = port_words(x, descending)
    assert np.array_equal(tw, jw)
    # each package decodes the other's words back to the original bits
    tdt = tkdf.as_tensor(x[:1], "cpu").dtype
    back = tkdf.decode((torch.from_numpy(jw.view(np.int32).copy()),), tdt,
                       descending)
    assert back.dtype == tdt
    assert np.array_equal(raw(tkdf.to_numpy(back)), raw(x))
    jback = jkdf.decode((jnp.asarray(tw),), jnp.dtype(np_dtype(name)), descending)
    assert np.array_equal(raw(np.asarray(jback)), raw(x))


@pytest.mark.parametrize("name", DTYPES)
def test_key_bits_kind_num_words_match_jax(name):
    tdt = tkdf.as_tensor(make_keys(name, 1, np.random.default_rng(0)), "cpu").dtype
    jdt = jnp.dtype(np_dtype(name))
    assert tkdf.key_bits(tdt) == jkdf.key_bits(jdt)
    assert tkdf.kind(tdt) == jkdf.kind(jdt)
    assert tkdf.num_words(tdt) == jkdf.num_words(jdt) == 1


@pytest.mark.parametrize("name", DTYPES)
def test_codec_round_trip_is_bit_exact(name):
    x = make_keys(name, 777, np.random.default_rng(1))
    t = tkdf.as_tensor(x, "cpu")
    assert t.shape == x.shape and t.element_size() == x.dtype.itemsize
    y = tkdf.to_numpy(t)
    assert y.dtype == x.dtype and np.array_equal(raw(y), raw(x))
    # the codec copies: the tensor does not alias the numpy buffer
    assert t.data_ptr() != x.__array_interface__["data"][0]


@pytest.mark.parametrize("dtype", [torch.uint64, torch.int64, torch.float64,
                                   torch.float8_e4m3fn, torch.float8_e5m2])
def test_later_key_dtypes_raise_not_implemented(dtype):
    """These torch key dtypes encode and decode back, bit for bit."""
    bits = torch.arange(-5, 251, dtype=torch.int64)
    x = bits.view(dtype) if dtype.itemsize == 8 else bits.to(torch.uint8).view(dtype)
    back = tkdf.decode(tkdf.encode(x, descending=True), dtype, descending=True)
    assert back.dtype == dtype and torch.equal(back.view(torch.uint8), x.view(torch.uint8))


@pytest.mark.parametrize("a", [
    np.array([b"ab", b"cd"], dtype="S2"),
    np.zeros(3, ml_dtypes.float8_e4m3fn),
    np.zeros(3, ml_dtypes.int4),
])
def test_codec_refuses_later_numpy_dtypes(a):
    """Byte strings, float8 and int4 cross the codec bit for bit."""
    y = tkdf.to_numpy(tkdf.as_tensor(a, "cpu"), a.dtype)
    assert y.dtype == a.dtype and y.tobytes() == a.tobytes()


def test_unsupported_dtype_is_a_type_error():
    with pytest.raises(TypeError, match="unsupported key dtype"):
        tkdf.encode(torch.zeros(3, dtype=torch.complex64))


def test_complement_is_bitwise_not():
    w = torch.tensor([0, -1, 5, -(1 << 31)], dtype=torch.int32)
    (c,) = tkdf.complement((w,))
    assert torch.equal(c, ~w)
    assert tkdf.i32(0xFFFFFFFF) == -1 and tkdf.i32(0x7FFFFFFF) == 0x7FFFFFFF


# ---------------------------------------------------------------------------
# 64-bit, float8, int4/uint4 and byte-string keys


def jax_words(x, descending):
    """The JAX package's planes for numpy keys, as its api encodes them."""
    if x.dtype.kind == "S":
        words = jkdf.encode_bytes_np(x, descending)
    elif x.dtype.itemsize == 8:
        words = jkdf.encode64_np(x, descending)
    else:
        words = jkdf.encode(jnp.asarray(x), descending=descending)
    return [np.asarray(w) for w in words]


def jax_decode(words, dtype, descending):
    words = tuple(jnp.asarray(w) for w in words)
    if dtype.kind == "S":
        return jkdf.decode_bytes_np(words, dtype, descending)
    if dtype.itemsize == 8:
        return jkdf.decode64_np(words, dtype, descending)
    return np.asarray(jkdf.decode(words, jnp.dtype(dtype), descending))


def as_planes(words):
    return tuple(torch.from_numpy(w.view(np.int32).copy()) for w in words)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", WIDE_DTYPES + BYTE_DTYPES)
def test_new_dtypes_encode_decode_match_jax(name, descending):
    dt = np_dtype(name)
    rng = np.random.Generator(np.random.PCG64(dt.itemsize * 2 + descending))
    x = make_keys(name, 3001, rng)
    jw = jax_words(x, descending)
    tw = tkdf.encode(tkdf.as_tensor(x, "cpu"), descending, dt)
    assert len(tw) == len(jw) == tkdf.num_words(dt)
    for t, j in zip(tw, jw):
        assert t.dtype == torch.int32 and t.is_contiguous()
        assert np.array_equal(t.numpy().view(np.uint32), j)
    # each package decodes the other's words back to the original bits
    back = tkdf.to_numpy(tkdf.decode(as_planes(jw), dt, descending), dt)
    assert back.dtype == dt and np.array_equal(raw(back), raw(x))
    jback = jax_decode([t.numpy().view(np.uint32) for t in tw], dt, descending)
    assert np.array_equal(raw(np.asarray(jback)), raw(x))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["uint64", "int64", "float64", "S7", "S12"])
def test_numpy_codecs_match_jax(name, descending):
    x = make_keys(name, 2049, np.random.default_rng(len(name) + descending))
    if name.startswith("S"):
        tw = tkdf.encode_bytes_np(x, descending, "cpu")
        back = tkdf.decode_bytes_np(tw, x.dtype, descending)
    else:
        tw = tkdf.encode64_np(x, descending, "cpu")
        back = tkdf.decode64_np(tw, x.dtype, descending)
    for t, j in zip(tw, jax_words(x, descending)):
        assert np.array_equal(t.numpy().view(np.uint32), j)
    assert back.dtype == x.dtype and np.array_equal(raw(back), raw(x))


@pytest.mark.parametrize("name", WIDE_DTYPES + BYTE_DTYPES)
def test_new_dtypes_key_bits_kind_num_words_match_jax(name):
    dt = np_dtype(name)
    jdt = dt if dt.kind == "S" else jnp.dtype(dt)
    assert tkdf.key_bits(dt) == jkdf.key_bits(jdt)
    assert tkdf.kind(dt) == jkdf.kind(jdt)
    assert tkdf.num_words(dt) == jkdf.num_words(jdt)
    assert tkdf.is_bytes_dtype(dt) == jkdf.is_bytes_dtype(dt)
    if dt.kind != "S" and name not in ("int4", "uint4"):
        t = getattr(torch, name)        # the same answers for the torch dtype
        assert (tkdf.key_bits(t), tkdf.kind(t), tkdf.num_words(t)) == (
            jkdf.key_bits(jdt), jkdf.kind(jdt), jkdf.num_words(jdt))


@pytest.mark.parametrize("name", WIDE_DTYPES + BYTE_DTYPES)
def test_new_dtypes_codec_round_trip_is_bit_exact(name):
    x = make_keys(name, 777, np.random.default_rng(2))
    t = tkdf.as_tensor(x, "cpu")
    assert t.shape[0] == x.shape[0]
    y = tkdf.to_numpy(t, x.dtype)
    assert y.dtype == x.dtype and y.tobytes() == x.tobytes()


def test_split64_join64_match_jax():
    x = make_keys("float64", 4099, np.random.default_rng(3))
    hi, lo = tkdf.split64(tkdf.as_tensor(x, "cpu"))
    jhi, jlo = jkdf.split64_np(x)
    assert np.array_equal(hi.numpy().view(np.uint32), np.asarray(jhi))
    assert np.array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
    y = tkdf.to_numpy(tkdf.join64(hi, lo, torch.float64))
    assert np.array_equal(raw(y), raw(jkdf.join64_np(jhi, jlo, x.dtype)))
    assert np.array_equal(raw(y), raw(x))


@pytest.mark.parametrize("n", [0, 1, 2])
def test_join64_of_few_keys(n):
    # F2: one (hi, lo) pair once kept transposed strides that the 64-bit
    # view refused, so sort_pairs and sort_u64_multipass of one 64-bit key
    # raised where the JAX package returns it
    import radix_sorting_tpu as rst
    import radix_sorting_tpu_torch as rt
    x = np.array([0x0123456789ABCDEF, 5], np.uint64)[:n]
    hi, lo = tkdf.split64(tkdf.as_tensor(x, "cpu"))
    assert np.array_equal(tkdf.to_numpy(tkdf.join64(hi, lo, torch.uint64)), x)
    v = np.arange(n, dtype=np.int32)
    keys, pay = rt.sort_pairs(x, v, device="cpu")
    jkeys, jpay = rst.sort_pairs(x, v)
    assert np.array_equal(keys, np.asarray(jkeys)) and np.array_equal(pay, np.asarray(jpay))
    assert np.array_equal(rt.sort_u64_multipass(x, device="cpu"),
                          np.asarray(rst.sort_u64_multipass(x)))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["uint64", "int64", "float64"])
def test_encode_hands_only_an_ascending_u64_key_as_a_pair(name, descending):
    """``encode(pair=True)``: an ascending u64 key (the identity KDF) comes
    as the two halves of the tensor itself, a view with no copy; every
    other 64-bit key as the dense planes it always was. The words match
    the JAX package's either way, and decode back to the keys."""
    x = make_keys(name, 4099, np.random.default_rng(4))
    t = tkdf.as_tensor(x, "cpu")
    words = tkdf.encode(t, descending, pair=True)
    pair = tkdf.pair_of(*words)
    if name == "uint64" and not descending:
        assert pair is not None and pair.data_ptr() == t.data_ptr()
    else:
        assert pair is None and all(w.is_contiguous() for w in words)
    jhi, jlo = jax_words(x, descending)
    assert np.array_equal(words[0].numpy().view(np.uint32), np.asarray(jhi))
    assert np.array_equal(words[1].numpy().view(np.uint32), np.asarray(jlo))
    assert all(torch.equal(a, b) for a, b in zip(words, tkdf.encode(t, descending)))
    assert raw(tkdf.to_numpy(tkdf.decode(words, t.dtype, descending))).tobytes() == \
        raw(x).tobytes()


@pytest.mark.parametrize("planes", ["a pair", "a pair in a slice", "dense planes",
                                    "a pair's copy"])
def test_join64_of_a_pair_is_a_view_and_of_dense_planes_a_copy(planes):
    """``join64`` of the halves of one dense buffer (also of a contiguous
    slice, on its 8-byte grid) is that buffer; of anything else, a copy.
    ``split64`` of that buffer makes the pair two dense planes, a copy."""
    x = make_keys("uint64", 4099, np.random.default_rng(5))
    t = tkdf.as_tensor(x, "cpu")
    base = t[7:4000] if planes == "a pair in a slice" else t
    hi, lo = tkdf.halves(base)
    if planes == "dense planes":
        hi, lo = tkdf.split64(base)
    elif planes == "a pair's copy":
        hi, lo = hi.clone(), lo.clone()
    joined = tkdf.join64(hi, lo, torch.uint64)
    assert raw(tkdf.to_numpy(joined)).tobytes() == raw(x[7:4000] if base is not t
                                                       else x).tobytes()
    view = planes.startswith("a pair") and planes != "a pair's copy"
    assert (joined.data_ptr() == base.data_ptr()) == view
    if view:
        dhi, dlo = tkdf.split64(joined)
        assert dhi.is_contiguous() and dlo.is_contiguous()
        assert torch.equal(dhi, hi) and torch.equal(dlo, lo)
        assert dhi.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()


@pytest.mark.parametrize("W", [1, 2, 4, 6, 9, 256])
def test_pack_bytes_be_matches_jax(W):
    u8 = np.random.default_rng(W).integers(0, 256, size=(1001, W), dtype=np.uint8)
    tp = tkdf.pack_bytes_be(torch.from_numpy(u8))
    jp = jkdf.pack_bytes_be(jnp.asarray(u8))
    assert len(tp) == len(jp) == -(-W // 4)
    for t, j in zip(tp, jp):
        assert np.array_equal(t.numpy().view(np.uint32), np.asarray(j))
    assert np.array_equal(tkdf.unpack_bytes_be(tp, W).numpy(), u8)


@pytest.mark.parametrize("W", [257, 300])
def test_byte_width_over_256_raises_like_jax(W):
    x = np.zeros(4, dtype=f"S{W}")
    with pytest.raises(ValueError, match="> 256"):
        jkdf.encode_bytes_np(x)
    with pytest.raises(ValueError, match="> 256"):
        tkdf.encode_bytes_np(x)


def test_torch_sub_byte_dtypes_are_type_errors():
    for name in ("int4", "uint4"):
        dt = getattr(torch, name, None)
        if dt is None:
            continue
        with pytest.raises(TypeError, match="numpy ml_dtypes"):
            tkdf.key_bits(dt)
