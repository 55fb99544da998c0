"""The port's set routines (``sets.py``) against the JAX package.

``unique`` with every flag, ``size``, ``axis=`` and ``equal_nan``; the
numpy-2 quartet; ``union1d``, ``intersect1d`` (with ``return_indices``),
``setdiff1d``, ``setxor1d``; ``isin`` / ``in1d``. The same numpy inputs,
from a seed, go through both packages, once on the JAX package's CPU routes
and once under ``RST_FORCE_TPU_ROUTES=1`` (the ``routes`` fixture; the port
takes the TPU routes always), and every field is compared bit for bit:
values, index, inverse, counts, the count, and the padding past it. Where
the JAX package's own tests hold a case against numpy, so do these.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu import sets as js
from radix_sorting_tpu.ops import counting_engine as jax_counting
from radix_sorting_tpu_torch import sets as ts

N, M = 3001, 1500      # one length each: the JAX package compiles per shape
SMALL, BIG = 10, N + M + 37        # sizes below and above every bound


@pytest.fixture(scope="module", params=["cpu", "tpu"])
def jax_routes(request):
    """Which of the JAX package's routes a test compares against; tests are
    grouped by it, so its caches are cleared only where the routes flip."""
    yield request.param
    if os.environ.pop("RST_FORCE_TPU_ROUTES", None):
        jax.clear_caches()


@pytest.fixture
def routes(jax_routes):
    want = "1" if jax_routes == "tpu" else None
    if os.environ.get("RST_FORCE_TPU_ROUTES") != want:
        if want:
            os.environ["RST_FORCE_TPU_ROUTES"] = want
        else:
            os.environ.pop("RST_FORCE_TPU_ROUTES")
        # the JAX gates are read per call, and at trace time by the one
        # jitted function of these paths that reads one: its traces go (the
        # compiled primitives, the same on both routes, stay)
        jax_counting.counting_sort_compact.clear_cache()
    return jax_routes


pytestmark = pytest.mark.usefixtures("routes")


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


def jin(x):
    """The JAX package's input: 64-bit and byte-string keys stay numpy (its
    host codec; x64 is off), the rest become jax arrays."""
    return x if x.dtype.kind == "S" or x.dtype.itemsize == 8 else jnp.asarray(x)


def np_of(a):
    return a if isinstance(a, np.ndarray) else np.asarray(a)


def same(got, want):
    """Bit for bit, field by field (None where the field was not asked for)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
        return
    if want is None:
        assert got is None
        return
    want = np_of(want)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def cfgs(descending):
    return rst.SortConfig(descending=descending), rt.SortConfig(descending=descending)


def both(name, *args, descending=False, **kw):
    """(port result, JAX result) of ``name`` on the same numpy inputs."""
    jc, tc = cfgs(descending)
    got = getattr(ts, name)(*args, config=tc, device="cpu", **kw)
    want = getattr(js, name)(*(jin(a) for a in args), config=jc, **kw)
    return got, want


ALL = dict(return_index=True, return_inverse=True, return_counts=True)
INTS = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16, "i16": np.int16,
        "u32": np.uint32, "i32": np.int32}
FLOATS = {"f16": np.float16, "bf16": ml_dtypes.bfloat16, "f32": np.float32,
          "f64": np.float64}


def column(kind, seed, n=N):
    """n keys of ``kind`` drawn from n // 3 values (duplicates)."""
    rng = rng_of(seed)
    m = n // 3
    if kind == "bool":
        base = rng.integers(0, 2, size=m).astype(bool)
    elif kind in INTS:
        info = np.iinfo(INTS[kind])
        base = rng.integers(info.min, int(info.max) + 1, size=m).astype(INTS[kind])
    elif kind in FLOATS:
        base = rng.standard_normal(m).astype(FLOATS[kind])
    else:
        base = rng.integers(0, 1 << 63, size=m).astype(np.uint64 if kind == "u64" else np.int64)
    return base[rng.integers(0, m, size=n)]




def bf16_padding(x, want, size, jc):
    """The JAX package's values with its padding of bf16 keys as its own
    ``_max_pad`` decodes it (0x7FFF): on XLA:CPU the ``jnp.where`` of its
    no-permutation path quiets that NaN to 0x7FC0. The port pads with the
    decode of all-ones planes on every path."""
    if x.dtype.name != "bfloat16":
        return want
    vals = np_of(want.values).copy()
    k = int(want.num_unique)
    vals[k:] = np_of(js._max_pad(jin(x), size, jc))[k:]
    return want._replace(values=vals)


# ---------------------------------------------------------------------------
# unique


@pytest.mark.parametrize("kind", ["bool", "i8", "u16", "bf16", "i32", "f32", "u64", "f64"])
def test_unique_all_flags_match_jax(kind):
    x = column(kind, 1)
    got, want = both("unique", x, **ALL)
    same(got, want)
    if kind not in ("f16", "bf16", "f32", "f64"):        # numpy merges -0.0 with +0.0
        uq, idx, inv, cnt = np.unique(x, **ALL)
        k = len(uq)
        assert int(got.num_unique) == k
        assert np.array_equal(got.values[:k], uq) and np.array_equal(got.index[:k], idx)
        assert np.array_equal(got.inverse, inv.reshape(-1))
        assert np.array_equal(got.counts[:k], cnt)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["bool", "u8", "i16", "u16", "f16", "bf16", "f32", "u64"])
def test_unique_values_and_counts_match_jax(kind, descending):
    """The no-permutation path: api.sort's route, which the routes flip for
    narrow keys (the counting kernels)."""
    x = column(kind, 2)
    jc = cfgs(descending)[0]
    for flags in ({}, dict(return_counts=True)):
        got, want = both("unique", x, descending=descending, **flags)
        same(got, bf16_padding(x, want, N, jc))
    assert int(got.counts.sum()) == N


@pytest.mark.parametrize("flags", [dict(return_counts=True), ALL])
@pytest.mark.parametrize("size", [SMALL, BIG])
def test_unique_size_below_and_above_the_bound(flags, size):
    x = rng_of(3).integers(0, 1000, size=N).astype(np.uint32)
    got, want = both("unique", x, size=size, **flags)
    same(got, want)
    assert int(got.num_unique) == len(np.unique(x))        # exact whatever size is
    if size == SMALL:
        assert np.array_equal(got.values, np.unique(x)[:SMALL])
        if got.counts is not None:           # the dropped runs' mass folds into the last
            assert int(got.counts.sum()) == N
    else:
        assert np.all(got.values[int(got.num_unique):] == np.uint32(0xFFFFFFFF))


def test_unique_reconstructs_input():
    x = np.repeat(rng_of(4).standard_normal(N // 3).astype(np.float32), 3)
    rng_of(5).shuffle(x)
    got, want = both("unique", x, return_inverse=True)
    same(got, want)
    assert np.array_equal(got.values[got.inverse], x)


def test_unique_first_occurrence_index_ties():
    x = rng_of(6).integers(0, 8, size=N).astype(np.int32)
    got, want = both("unique", x, return_index=True)
    same(got, want)
    uq, idx = np.unique(x, return_index=True)
    assert np.array_equal(got.index[: len(uq)], idx)


def test_unique_bitwise_zeros_and_nan_payloads():
    bits = np.array([0x00000000, 0x80000000, 0x3F800000, 0x80000000, 0x00000000,
                     0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001, 0x7FC00001], np.uint32)
    x = np.resize(bits, N).view(np.float32)
    got, want = both("unique", x, return_counts=True, return_index=True)
    same(got, want)
    assert int(got.num_unique) == 7              # -NaN first, then -0.0 and +0.0 apart
    v = got.values[1:3]
    assert np.signbit(v[0]) and v[0] == 0.0 and not np.signbit(v[1]) and v[1] == 0.0
    tiled = np.resize(bits, N)
    assert list(got.counts[1:3]) == [np.count_nonzero(tiled == 0x80000000),
                                     np.count_nonzero(tiled == 0)]


def test_unique_equal_nan_matches_jax():
    rng = rng_of(7)
    nans = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001],
                    np.uint32).view(np.float32)
    base = np.round(rng.standard_normal(N - 12).astype(np.float32), 2) + 9.0
    x = np.concatenate([base, np.tile(nans, 3)])
    rng.shuffle(x)
    got, want = both("unique", x, return_index=True, return_counts=True, equal_nan=True)
    same(got, want)
    m = int(got.num_unique)
    assert m == len(np.unique(x[~np.isnan(x)])) + 1 and int(got.counts[m - 1]) == 12
    assert int(got.index[m - 1]) == int(np.flatnonzero(np.isnan(x))[0])
    got, want = both("unique", x, return_inverse=True, equal_nan=True)
    same(got, want)
    assert np.array_equal(got.values[got.inverse], x, equal_nan=True)
    same(*both("unique", x, return_counts=True))       # default: 4 payloads survive
    # a tensor is canonicalized on its device with torch's NaN: the bits of
    # the JAX package's in-graph canonicalization
    r = ts.unique(torch.from_numpy(x), return_counts=True, equal_nan=True)
    same(tuple(None if f is None else f.numpy() for f in r),
         js.unique(jnp.asarray(x), return_counts=True, equal_nan=True))
    xi = rng.integers(0, 99, size=N).astype(np.int32)       # a no-op on integers
    same(*both("unique", xi, equal_nan=True))
    x64 = np.concatenate([base.astype(np.float64)[3:], np.full(12, np.nan)])
    x64[-12::4] = -np.nan
    got, want = both("unique", x64, return_counts=True, equal_nan=True)
    same(got, want)
    assert int(got.counts[int(got.num_unique) - 1]) == 12
    # a list: numpy's conversion (float64; the JAX package's jnp.asarray
    # makes float32), the same uniques and counts
    r = ts.unique([3.0, float("nan"), 1.0, float("nan")], equal_nan=True,
                  return_counts=True, device="cpu")
    assert int(r.num_unique) == 3 and int(r.counts[2]) == 2


def test_r3_equal_nan_follows_the_reference():
    """R3: equal_nan defaults to False (numpy's default is True), and
    equal_nan=True with axis= canonicalizes every NaN, so rows that differ
    only in NaN payload merge: the reference's contract, not numpy's."""
    nans = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000], np.uint32).view(np.float32)
    x = np.resize(np.concatenate([np.float32([1.0, 2.0, 1.0]), nans]), N)
    got, want = both("unique", x)
    same(got, want)
    assert int(got.num_unique) == 5 and len(np.unique(x)) == 3
    rows = np.float32([[1.0, 0.0], [1.0, 0.0], [2.0, 0.0]]).repeat(2, 0)
    rows[1::2, 1] = nans[[0, 1, 2]]
    rows = np.resize(rows, (N, 2))               # row i is rows[i % 6]
    got, want = both("unique", rows, axis=0, return_counts=True, equal_nan=True)
    same(got, want)
    assert int(got.num_unique) == 4              # (1, 0) (1, NaN) (2, 0) (2, NaN)
    got, want = both("unique", rows, axis=0, return_counts=True)
    same(got, want)
    assert int(got.num_unique) == 5              # every payload its own row


def test_unique_empty_and_fixed_shapes():
    e = np.zeros((0,), np.uint32)
    for flags in (ALL, {}, dict(return_counts=True)):
        got, want = both("unique", e, size=SMALL, **flags)
        same(got, want)
    x = rng_of(8).integers(0, 50, size=N).astype(np.uint32)
    got, want = both("unique", x, size=BIG, **ALL)
    same(got, want)
    assert np.array_equal(got.values[: int(got.num_unique)], np.unique(x))
    same(*both("unique", x[:1], **ALL))
    same(*both("unique", column("u64", 9)[:0], size=SMALL, **ALL))


def test_unique_byte_strings():
    """S6 keys: with a permutation flag both packages agree bit for bit;
    with none the JAX package raises (its host path views the keys as
    'u6'), and the port gives numpy's uniques."""
    x = rng_of(37).integers(0, 3, size=(N, 6)).astype(np.uint8).view("S6").reshape(-1)
    for descending in (False, True):
        same(*both("unique", x, descending=descending, **ALL))
        got = ts.unique(x, return_counts=True, config=cfgs(descending)[1], device="cpu")
        uq, cnt = np.unique(x, return_counts=True)
        k = int(got.num_unique)
        assert k == len(uq) and np.all(got.values[k:] == (b"" if descending else b"\xff" * 6))
        order = slice(None, None, -1) if descending else slice(None)
        assert np.array_equal(got.values[:k], uq[order])
        assert np.array_equal(got.counts[:k], cnt[order])
    with pytest.raises(TypeError):
        js.unique(x)
    a, b = x[:N // 2], x[N // 3:]
    same(*both("intersect1d", a, b, return_indices=True))
    same(*both("isin", a, b))


def test_unique_index_dtypes_and_errors():
    x = rng_of(10).integers(0, 100, size=N).astype(np.uint32)
    for idt, jdt in ((np.int32, jnp.int32), (torch.int16, jnp.int16), (np.uint16, jnp.uint16)):
        got = ts.unique(x, return_index=True, index_dtype=idt, device="cpu")
        same(got, js.unique(jnp.asarray(x), return_index=True, index_dtype=jdt))
    with pytest.raises(ValueError, match="cannot index"):
        ts.unique(x, return_inverse=True, index_dtype=np.uint8, device="cpu")
    with pytest.raises(ValueError):
        js.unique(jnp.asarray(x), return_inverse=True, index_dtype=jnp.uint8)
    with pytest.raises(TypeError):
        ts.unique(x, return_index=True, index_dtype=np.float32, device="cpu")


def test_tensors_in_tensors_out():
    x = rng_of(11).integers(0, 300, size=N).astype(np.int32)
    r = ts.unique(torch.from_numpy(x), **ALL)
    assert all(torch.is_tensor(f) for f in r)
    assert r.num_unique.dtype == torch.int32 and r.num_unique.shape == ()
    same(tuple(f.numpy() for f in r), js.unique(jnp.asarray(x), **ALL))
    a, b = torch.from_numpy(x), x[:M].copy()          # numpy joins the tensor's device
    vals, cnt = ts.union1d(a, b)
    assert torch.is_tensor(vals) and cnt.shape == () and cnt.dtype == torch.int32
    same((vals.numpy(), cnt.numpy()), js.union1d(jnp.asarray(x), jnp.asarray(b)))
    got = ts.isin(a, torch.from_numpy(b), invert=True)
    assert torch.is_tensor(got) and got.dtype == torch.bool
    same(got.numpy(), js.isin(jnp.asarray(x), jnp.asarray(b), invert=True))


def test_unique_counts_only_routes_through_api_sort(monkeypatch):
    """The no-permutation path sorts through api.sort's dispatch (the JAX
    package's own regression test), never the bitmap unique-sort, and keeps
    the domain maximum as padding."""
    from radix_sorting_tpu_torch import api as tapi
    from radix_sorting_tpu_torch.ops import bitmap
    calls = []
    real = tapi._sort_words
    monkeypatch.setattr(tapi, "_sort_words", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(bitmap, "bitmap_unique_sort", None)
    x = rng_of(12).integers(0, 200, size=N).astype(np.uint16)
    got, want = both("unique", x, return_counts=True)
    assert calls
    same(got, want)
    k = int(got.num_unique)
    assert np.array_equal(got.values[:k], np.unique(x))
    assert np.all(got.values[k:] == np.uint16(0xFFFF))


def test_unique_u16_counts_take_k2_and_k8(routes, monkeypatch):
    """u16 keys past the windowed gate (n >= 2^32 / 512 at 2^16 bins): the
    counts-only unique takes K2 + K8 in the port always, and in the JAX
    package on its TPU routes (its kernels in interpret mode); the launches
    of both are counted and compared."""
    from radix_sorting_tpu.ops import pallas_kernels as pk
    from radix_sorting_tpu_torch.ops import cuda_kernels as ck
    got_calls = {"hist_pext": 0, "regen_pdep_windowed": 0}
    want_calls = dict(got_calls)

    def spy(counts, name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    real_regen = ck.regen_pdep

    def regen(cum, *a, **k):          # K8 is the contract past 2^10 bins
        if cum.shape[0] > 1 << 10:
            got_calls["regen_pdep_windowed"] += 1
        return real_regen(cum, *a, **k)

    monkeypatch.setattr(ck, "hist_pext", spy(got_calls, "hist_pext", ck.hist_pext))
    monkeypatch.setattr(ck, "regen_pdep", regen)
    monkeypatch.setattr(pk, "histogram_pext_tpu",
                        spy(want_calls, "hist_pext", pk.histogram_pext_tpu))
    monkeypatch.setattr(pk, "regenerate_pdep_windowed_tpu",
                        spy(want_calls, "regen_pdep_windowed",
                            pk.regenerate_pdep_windowed_tpu))
    n = (1 << 32) // 511 + 1
    x = rng_of(13).integers(0, 1 << 16, size=n).astype(np.uint16)
    got, want = both("unique", x, return_counts=True, size=1 << 16)
    same(got, want)
    uq, cnt = np.unique(x, return_counts=True)
    assert np.array_equal(got.values[: len(uq)], uq)
    assert np.array_equal(got.counts[: len(uq)], cnt)
    assert got_calls == {"hist_pext": 1, "regen_pdep_windowed": 1}
    assert want_calls == (got_calls if routes == "tpu"
                          else {"hist_pext": 0, "regen_pdep_windowed": 0})


# ---------------------------------------------------------------------------
# unique along an axis


def test_unique_axis0_rows_full_flags():
    a = rng_of(14).integers(-50, 50, size=(N, 3)).astype(np.int32)
    a[: N // 4] = a[N // 4: N // 2]
    got, want = both("unique", a, axis=0, **ALL)
    same(got, want)
    wv, wi, winv, wc = np.unique(a, axis=0, **ALL)
    k = int(got.num_unique)
    assert k == len(wv) and np.array_equal(got.values[:k], wv)
    assert np.array_equal(got.index[:k], wi) and np.array_equal(got.counts[:k], wc)
    assert np.array_equal(got.inverse, winv.reshape(-1))
    assert np.array_equal(got.values[got.inverse], a)
    same(*both("unique", a, axis=0, return_counts=True, descending=True))


def test_unique_axis1_floats():
    a = rng_of(15).normal(size=(4, N)).round(1).astype(np.float32)
    a = np.where(a == 0.0, np.float32(0.25), a)      # off numpy's -0 == 0 corner
    got, want = both("unique", a, axis=1, **ALL)
    same(got, want)
    wv = np.unique(a, axis=1)
    assert np.array_equal(got.values[:, : int(got.num_unique)], wv)


def test_unique_axis0_u64_and_size():
    u = rng_of(16).integers(0, 1 << 63, size=(N, 2)).astype(np.uint64)
    u[:800] = u[800:1600]
    got, want = both("unique", u, axis=0, **ALL)
    same(got, want)
    wv, wc = np.unique(u, axis=0, return_counts=True)
    assert np.array_equal(got.values[: len(wv)], wv)
    assert np.array_equal(got.counts[: len(wc)], wc)
    au = rng_of(36).integers(0, 9, size=(N, 2)).astype(np.uint32)
    got, want = both("unique", au, axis=0, size=SMALL, return_counts=True)
    same(got, want)
    wv, wc = np.unique(au, axis=0, return_counts=True)
    assert np.array_equal(got.values, wv[:SMALL])
    assert np.array_equal(got.counts[:-1], wc[:SMALL - 1])     # the last folds the rest


def test_unique_axis_edges():
    for shape, flags, size in (((0, 3), dict(return_inverse=True), None),
                               ((5, 0), dict(return_counts=True), None),
                               ((5, 0), ALL, 0), ((5, 0), ALL, SMALL), ((0, 2), ALL, SMALL)):
        x = np.zeros(shape, np.uint32)
        for axis in (0, 1):
            got, want = both("unique", x, axis=axis, size=size, **flags)
            same(got, want)
    r = ts.unique(np.zeros((5, 0), np.uint32), axis=0, return_counts=True, device="cpu")
    assert int(r.num_unique) == 1 and r.counts[0] == 5     # numpy: zero-width rows are equal
    for shape, axis in (((4,), 0), ((4, 2), 2), ((4, 2), None)):
        with pytest.raises(ValueError):
            ts.unique(np.zeros(shape, np.uint32), axis=axis, device="cpu")
        with pytest.raises(ValueError):
            js.unique(jnp.zeros(shape, jnp.uint32), axis=axis)


# ---------------------------------------------------------------------------
# the numpy-2 quartet


def test_unique_quartet_matches_jax_and_numpy():
    x = rng_of(17).integers(0, 500, size=N).astype(np.uint32)
    uq, idx, inv, cnt = np.unique(x, **ALL)
    k = len(uq)
    got, want = both("unique_values", x)
    same(got, want)
    assert np.array_equal(got.values[:k], uq)
    got, want = both("unique_counts", x)
    same(got, want)
    assert np.array_equal(got.counts[:k], cnt)
    got, want = both("unique_inverse", x)
    same(got, want)
    assert np.array_equal(got.values[got.inverse_indices], x)
    got, want = both("unique_all", x)
    same(got, want)
    assert np.array_equal(got.indices[:k], idx) and np.array_equal(got.inverse_indices, inv)
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields


def test_unique_quartet_i64_and_size():
    x = rng_of(18).integers(-(1 << 40), 1 << 40, size=N // 10)
    x = x[rng_of(19).integers(0, N // 10, N)]
    got, want = both("unique_counts", x)
    same(got, want)
    uq, cnt = np.unique(x, return_counts=True)
    assert np.array_equal(got.values[: len(uq)], uq)
    assert np.array_equal(got.counts[: len(uq)], cnt)
    y = rng_of(20).integers(0, 64, size=N).astype(np.uint32)
    same(*both("unique_all", y, size=SMALL))
    same(*both("unique_inverse", y, size=BIG, index_dtype=np.int32))


# ---------------------------------------------------------------------------
# the set operations


OPS = ["union1d", "intersect1d", "setdiff1d", "setxor1d"]
NP_OPS = {"union1d": np.union1d, "intersect1d": np.intersect1d,
          "setdiff1d": np.setdiff1d, "setxor1d": np.setxor1d}


def pair(kind, seed):
    a, b = column(kind, seed), column(kind, seed + 1, M)
    b[: M // 2] = a[: M // 2]                      # shared values
    return a, b


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", ["u8", "i16", "f16", "i64"])
def test_setops_match_jax(op, kind):
    a, b = pair(kind, 21)
    got, want = both(op, a, b)
    same(got, want)
    if kind[0] != "f":
        ref = NP_OPS[op](a, b)
        assert int(got[1]) == len(ref) and np.array_equal(got[0][: len(ref)], ref)


@pytest.mark.parametrize("op", OPS)
def test_setops_u32_against_numpy(op):
    rng = rng_of(23)
    a = rng.integers(0, 400, size=N).astype(np.uint32)
    b = rng.integers(200, 600, size=M).astype(np.uint32)
    got, want = both(op, a, b)
    same(got, want)
    ref = NP_OPS[op](a, b)
    assert int(got[1]) == len(ref) and np.array_equal(got[0][: len(ref)], ref)
    assert np.all(got[0][len(ref):] == np.uint32(0xFFFFFFFF))


@pytest.mark.parametrize("op", OPS)
def test_setops_floats_descending_and_sizes(op):
    rng = rng_of(24)
    a = np.abs(np.round(rng.standard_normal(N).astype(np.float32), 2)) + 1
    b = np.abs(np.round(rng.standard_normal(M).astype(np.float32), 2)) + 1
    got, want = both(op, a, b)
    same(got, want)
    ref = NP_OPS[op](a, b)
    assert int(got[1]) == len(ref) and np.array_equal(got[0][: len(ref)], ref)
    same(*both(op, a, b, descending=True))
    for size in (SMALL, BIG):
        same(*both(op, a, b, size=size))


@pytest.mark.parametrize("op", OPS)
def test_setops_one_side_empty(op):
    a = rng_of(25).integers(0, 50, size=N).astype(np.int32)
    e = np.zeros((0,), np.int32)
    for x, y in ((a, e), (e, a), (e, e)):
        got, want = both(op, x, y)
        same(got, want)
        ref = NP_OPS[op](x, y)
        assert int(got[1]) == len(ref) and np.array_equal(got[0][: len(ref)], ref)
        same(*both(op, x, y, size=SMALL))
        same(*both(op, x, y, size=SMALL, descending=True))


def test_setops_errors_and_empty_side_padding():
    a = rng_of(26).integers(0, 50, size=N).astype(np.uint32)
    e = np.zeros((0,), np.uint32)
    for mod, conv in ((ts, lambda v: v), (js, jnp.asarray)):
        kw = {"device": "cpu"} if mod is ts else {}
        with pytest.raises(TypeError):
            mod.union1d(conv(e), conv(np.zeros(4, np.int32)), **kw)
        with pytest.raises(TypeError):
            mod.isin(conv(e), conv(np.zeros(4, np.int32)), **kw)
        with pytest.raises(ValueError):
            mod.setdiff1d(conv(np.uint32(3)), conv(a), **kw)
        with pytest.raises(ValueError):
            mod.isin(conv(a.reshape(10, 10)), conv(a), **kw)
    vals, cnt = ts.intersect1d(a, e, size=SMALL, device="cpu")
    assert int(cnt) == 0 and np.all(vals == np.uint32(0xFFFFFFFF))
    same(*both("union1d", e, e, size=SMALL))


def test_intersect1d_return_indices_matches_jax():
    rng = rng_of(27)
    a = rng.integers(0, 200, size=N).astype(np.uint32)
    b = rng.integers(100, 300, size=M).astype(np.uint32)
    got, want = both("intersect1d", a, b, return_indices=True)
    same(got, want)
    wv, w1, w2 = np.intersect1d(a, b, return_indices=True)
    k = len(wv)
    vals, c1, c2, cnt = got
    assert int(cnt) == k and np.array_equal(vals[:k], wv)
    assert np.array_equal(c1[:k], w1) and np.array_equal(c2[:k], w2)
    assert np.all(c1[k:] == N) and np.all(c2[k:] == M)
    for size in (SMALL, BIG):
        same(*both("intersect1d", a, b, return_indices=True, size=size))
    same(*both("intersect1d", a, b, return_indices=True, descending=True))
    same(*both("intersect1d", a, b, assume_unique=True))


@pytest.mark.parametrize("kind", ["i64", "f32", "i16"])
def test_intersect1d_return_indices_dtypes(kind):
    a, b = pair(kind, 28)
    got, want = both("intersect1d", a, b, return_indices=True, size=BIG)
    same(got, want)
    if kind[0] != "f":
        wv, w1, w2 = np.intersect1d(a, b, return_indices=True)
        k = len(wv)
        assert np.array_equal(got[1][:k], w1[:k]) and np.array_equal(got[2][:k], w2[:k])


def test_intersect1d_return_indices_empty_side():
    a = column("i64", 29)
    e = np.zeros((0,), np.int64)
    for x, y in ((a, e), (e, a), (e, e)):
        same(*both("intersect1d", x, y, size=SMALL, return_indices=True))
    vals, c1, c2, cnt = ts.intersect1d(a, e, size=SMALL, return_indices=True, device="cpu")
    assert int(cnt) == 0 and np.all(c1 == N) and np.all(c2 == 0)


# ---------------------------------------------------------------------------
# isin


@pytest.mark.parametrize("kind", ["u8", "bf16", "f32", "u64", "f64"])
def test_isin_matches_jax(kind):
    el, te = pair(kind, 30)
    for invert in (False, True):
        got, want = both("isin", el, te, invert=invert)
        same(got, want)
        if kind[0] not in "fb":
            assert np.array_equal(got, np.isin(el, te, invert=invert))


def test_isin_against_numpy_and_in1d():
    rng = rng_of(31)
    el = rng.integers(0, 1000, size=N).astype(np.uint32)
    te = rng.integers(500, 1500, size=M).astype(np.uint32)
    got, want = both("isin", el, te)
    same(got, want)
    assert np.array_equal(got, np.isin(el, te))
    got, want = both("in1d", el, te, assume_unique=True, invert=True)
    same(got, want)
    assert np.array_equal(got, np.isin(el, te, invert=True))
    same(*both("isin", el, te, descending=True))


def test_isin_empty_and_duplicate_heavy_runs():
    el = np.repeat(rng_of(32).integers(0, 40, size=N // 20).astype(np.int32), 20)
    te = np.repeat(rng_of(33).integers(20, 60, size=M // 13).astype(np.int32), 13)
    rng_of(34).shuffle(el)
    got, want = both("isin", el, te)
    same(got, want)
    assert np.array_equal(got, np.isin(el, te))
    e = np.zeros((0,), np.int32)
    for x, y, inv in ((el, e, False), (el, e, True), (e, el, False)):
        same(*both("isin", x, y, invert=inv))


def test_isin_and_inverse_never_call_cummax(monkeypatch):
    """isin carries each run's answer by run ids, unique's inverse by a
    scatter: torch.cummax (one block for a 1-D tensor) is never called."""
    def no_cummax(*a, **k):
        raise AssertionError("torch.cummax called")
    monkeypatch.setattr(torch, "cummax", no_cummax)
    monkeypatch.setattr(torch.Tensor, "cummax", no_cummax)
    el, te = pair("u32", 35)
    same(*both("isin", el, te))
    same(*both("unique", el, **ALL))
    same(*both("intersect1d", el, te, return_indices=True))


# ---------------------------------------------------------------------------
# the public API


def test_port_exports_the_whole_jax_api():
    assert set(rst.__all__) <= set(rt.__all__)
    for name in ("unique", "unique_values", "unique_counts", "unique_inverse", "unique_all",
                 "UniqueResult", "isin", "in1d", "union1d", "intersect1d", "setdiff1d",
                 "setxor1d"):
        assert getattr(rt, name) is getattr(ts, name)
