"""The sorter composites of the port's ``extras`` against the JAX package.

``lexsort``, ``segmented_sort`` / ``segmented_argsort``, ``merge_sorted``,
``searchsorted``, ``nth_element``, ``top_k`` / ``top_k_batched``,
``stable_partition`` and ``sort_complex``: the same numpy inputs, from a
seed, go through both packages, once on the JAX package's CPU routes and
once under ``RST_FORCE_TPU_ROUTES=1`` (the ``routes`` fixture; the port
takes the TPU routes always). Every output is compared bit for bit; where
the JAX package's own tests hold it against numpy, so do these. The one
deliberate divergence, R5 (byte-string planes pack as 32-bit fields), is
held against numpy in ``test_r5_byte_string_planes_match_numpy``.
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
from radix_sorting_tpu import extras as jx
from radix_sorting_tpu_torch import extras as tx
from radix_sorting_tpu_torch.ops import hw_engine
from radix_sorting_tpu_torch.ops.kdf import i32

N, Q = 3001, 1000      # one length each: the JAX package compiles per shape


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
        jax.clear_caches()        # the JAX gates are read at trace time
    return jax_routes


pytestmark = pytest.mark.usefixtures("routes")


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


def jin(x):
    """The JAX package's input: 64-bit and byte-string keys stay numpy (its
    host codec; x64 is off), the rest become jax arrays."""
    return x if x.dtype.kind == "S" or x.dtype.itemsize == 8 else jnp.asarray(x)


def np_of(a):
    """A JAX output as numpy (64-bit results are numpy already)."""
    return a if isinstance(a, np.ndarray) else np.asarray(a)


def same(got, want):
    want = np_of(want)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def cfgs(descending):
    return rst.SortConfig(descending=descending), rt.SortConfig(descending=descending)


def column(kind, seed, n=N):
    rng = rng_of(seed)
    if kind == "u8":
        return rng.integers(0, 256, size=n).astype(np.uint8)
    if kind == "u8_4":                         # few values: ties across keys
        return rng.integers(0, 4, size=n).astype(np.uint8)
    if kind == "u16":
        return rng.integers(0, 1 << 16, size=n).astype(np.uint16)
    if kind == "i16":
        return rng.integers(-3000, 3000, size=n).astype(np.int16)
    if kind == "u32_16":
        return rng.integers(0, 16, size=n).astype(np.uint32)
    if kind == "i32_16":
        return rng.integers(0, 16, size=n).astype(np.int32)
    if kind == "u32":
        return rng.integers(0, 1 << 20, size=n).astype(np.uint32)
    if kind == "f32":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "f16":                          # finite, both signs
        return (rng.integers(0, 0x7C00, size=n).astype(np.uint16)
                | (rng.integers(0, 2, size=n).astype(np.uint16) << np.uint16(15))
                ).view(np.float16)
    if kind == "u64":
        return rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    if kind == "int4":
        return rng.integers(-8, 8, size=n).astype(np.int8).astype(ml_dtypes.int4)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# lexsort


LEX_CASES = {"two keys": ("u32_16", "i32_16"), "mixed dtypes": ("f32", "u8_4"),
             "u64": ("u64",), "four u8 (one plane)": ("u8", "u8", "u8", "u8"),
             "mixed widths": ("u8", "i16", "f16"), "u64 with narrow": ("u8", "u64"),
             "int4 packs at 4 bits": ("int4", "u16", "u8")}


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("case", list(LEX_CASES))
def test_lexsort_matches_jax(case, descending):
    keys = [column(k, i + 7 * len(case)) for i, k in enumerate(LEX_CASES[case])]
    jc, tc = cfgs(descending)
    got = rt.lexsort(keys, config=tc, device="cpu")
    same(got, jx.lexsort([jin(k) for k in keys], config=jc))
    if not descending and case != "mixed widths":      # f16: numpy has -0.0 == +0.0
        assert np.array_equal(got, np.lexsort(tuple(k.astype(np.int64) if k.dtype.name == "int4"
                                                    else k for k in keys)))


def test_pack_narrow_words_layout():
    def layout(mod, zeros, widths):
        packed, lay = mod._pack_narrow_words([(zeros, b) for b in widths])
        return len(packed), lay
    z32 = torch.zeros(4, dtype=torch.int32)
    for widths in ([8, 8, 8, 8], [4, 16, 8, 4], [16, 32, 8, 8, 32], [32, 4]):
        assert layout(tx, z32, widths) == layout(jx, jnp.zeros(4, jnp.uint32), widths)
    assert layout(tx, z32, [8] * 4) == (1, [(0, 24, 8), (0, 16, 8), (0, 8, 8), (0, 0, 8)])


def test_pack_fields_round_trip():
    # fields above bit 31 wrap, every >> is masked: unpack gives each field back
    rng = rng_of(3)
    widths = [4, 12, 16, 32, 1, 7, 8, 16]
    planes = [torch.from_numpy(rng.integers(0, 1 << b, size=257, dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)) for b in widths]
    packed, layout = tx._pack_narrow_words(list(zip(planes, widths)))
    assert len(packed) == 3
    for got, want in zip(tx._unpack_fields(packed, layout), planes):
        assert torch.equal(got, want)
    masks = tx._field_masks(layout, range(len(widths)), len(packed))
    flipped = tx._unpack_fields(tx._xor_masks(packed, masks), layout)
    for got, want, b in zip(flipped, planes, widths):
        assert torch.equal(got, want ^ i32((1 << b) - 1) if b < 32 else ~want)


def test_lexsort_errors_match_jax():
    a = column("u8", 1)
    for call in (lambda m, **k: m.lexsort([], **k), lambda m, **k: m.lexsort([a, a[:5]], **k)):
        with pytest.raises(ValueError):
            call(jx)
        with pytest.raises(ValueError):
            call(rt, device="cpu")


# ---------------------------------------------------------------------------
# the segmented sorts, merge_sorted


SEG_CASES = {"u16 keys, sorted u8 segments": ("u16", "u8_sorted"),
             "i16 keys, u8 segments": ("i16", "u8_12"),
             "u8 keys, u16 segments": ("u8", "u16_300"),
             "f32 keys, u32 segments (no packing)": ("f32", "u32"),
             "u64 keys, u8 segments": ("u64", "u8_12")}


def segments(kind, seed):
    rng = rng_of(seed)
    if kind == "u8_sorted":
        return np.sort(rng.integers(0, 40, size=N)).astype(np.uint8)
    if kind == "u8_12":
        return rng.integers(0, 12, size=N).astype(np.uint8)
    if kind == "u16_300":
        return rng.integers(0, 300, size=N).astype(np.uint16)
    return column(kind, seed)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segmented_sorts_match_jax(case, descending):
    kk, sk = SEG_CASES[case]
    k, s = column(kk, len(case)), segments(sk, len(case) + 1)
    jc, tc = cfgs(descending)
    got = rt.segmented_sort(k, s, config=tc, device="cpu")
    want = jx.segmented_sort(jin(k), jin(s), config=jc)
    same(got[0], want[0])
    same(got[1], want[1])
    perm = rt.segmented_argsort(k, s, config=tc, device="cpu")
    same(perm, jx.segmented_argsort(jin(k), jin(s), config=jc))
    if descending:
        k = ~k if kk == "u64" else -k.astype(np.float64)
    order = np.lexsort((k, s))
    assert np.array_equal(perm, order) and np.array_equal(got[1], s[order])


def test_segmented_sort_errors_and_index_dtype():
    k, s = column("u16", 1), segments("u8_12", 2)
    with pytest.raises(ValueError):
        rt.segmented_sort(k, s[:10], device="cpu")
    with pytest.raises(ValueError):
        rt.segmented_argsort(k, s[:10], device="cpu")
    with pytest.raises(ValueError):
        rt.segmented_argsort(k, s, index_dtype=np.uint8, device="cpu")
    same(rt.segmented_argsort(k, s, index_dtype=np.int32, device="cpu"),
         jx.segmented_argsort(jin(k), jin(s), index_dtype=jnp.int32))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["u16", "f32", "u64"])
def test_merge_sorted_matches_jax(kind, descending):
    x = column(kind, 5)
    jc, tc = cfgs(descending)
    half = [np.asarray(rt.sort(x[:N // 2], config=tc, device="cpu")),
            np.asarray(rt.sort(x[N // 2:], config=tc, device="cpu"))]
    got = rt.merge_sorted(*half, config=tc, device="cpu")
    same(got, jx.merge_sorted(*(jin(h) for h in half), config=jc))
    with pytest.raises(TypeError):
        rt.merge_sorted(half[0], half[1].astype(np.int32), device="cpu")


# ---------------------------------------------------------------------------
# searchsorted


def sorted_and_queries(kind, seed):
    rng = rng_of(seed)
    if kind == "u32":
        return (np.sort(rng.integers(0, 1000, size=N).astype(np.uint32)),
                rng.integers(0, 1000, size=Q).astype(np.uint32))
    base = rng.integers(0, 1 << 64, size=N - 500, dtype=np.uint64)   # u64: duplicates
    a = np.sort(np.concatenate([base, base[:500]]))
    return a, np.concatenate([base[: Q // 2], rng.integers(0, 1 << 64, size=Q - Q // 2,
                                                           dtype=np.uint64)])


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("method", ["auto", "scan", "scan_unrolled", "compare_all", "sort"])
def test_searchsorted_methods_match_jax(method, side):
    a, v = sorted_and_queries("u32", 11)
    got = rt.searchsorted(a, v, side=side, method=method, device="cpu")
    same(got, jx.searchsorted(jin(a), jin(v), side=side, method=method))
    assert np.array_equal(got, np.searchsorted(a, v, side=side))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_u64_tagged_union_matches_jax(side):
    a, v = sorted_and_queries("u64", 12)
    got = rt.searchsorted(a, v, side=side, device="cpu")
    same(got, jx.searchsorted(a, v, side=side))
    assert np.array_equal(got, np.searchsorted(a, v, side=side))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_f32_specials_match_jax(side):
    from oracles import kdf_key
    a = np.array([-np.inf, -2.0, -0.0, 0.0, 1.5, 1.5, np.inf, np.nan], np.float32)
    v = np.array([np.nan, -np.nan, 1.5, 0.0, -0.0, 3.0, -np.inf], np.float32)
    for method in ("scan", "sort"):
        got = rt.searchsorted(a, v, side=side, method=method, device="cpu")
        same(got, jx.searchsorted(jin(a), jin(v), side=side, method=method))
        assert np.array_equal(got, np.searchsorted(kdf_key(a), kdf_key(v), side=side))


@pytest.mark.parametrize("kind", ["u32", "u64"])
def test_searchsorted_descending_matches_jax(kind):
    a, v = sorted_and_queries(kind, 13)
    a = a[::-1].copy()
    jc, tc = cfgs(True)
    for side in ("left", "right"):
        got = rt.searchsorted(a, v, side=side, config=tc, device="cpu")
        same(got, jx.searchsorted(jin(a), jin(v), side=side, config=jc))
        ref = np.searchsorted(-a.astype(np.float64), -v.astype(np.float64), side=side)
        if kind == "u32":
            assert np.array_equal(got, ref)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_sorter_matches_jax(side):
    rng = rng_of(14)
    cases = [(rng.integers(0, 300, size=N).astype(np.uint32),
              rng.integers(0, 300, size=Q).astype(np.uint32)),
             (column("u64", 15) >> np.uint64(1), column("u64", 16, Q) >> np.uint64(1)),
             (column("f32", 17), column("f32", 18, Q))]
    for a, v in cases:
        sorter = np.argsort(a, kind="stable")
        got = rt.searchsorted(a, v, side=side, sorter=sorter, device="cpu")
        same(got, jx.searchsorted(jin(a), jin(v), side=side, sorter=jnp.asarray(sorter)))
        assert np.array_equal(got, np.searchsorted(a, v, side=side, sorter=sorter))


def test_searchsorted_edges_and_errors_match_jax():
    a = np.array([5, 5, 5], np.uint32)
    q = np.array([4, 5, 6], np.uint32)
    for side, want in (("left", [0, 0, 3]), ("right", [0, 3, 3])):
        for method in ("scan", "sort"):
            assert rt.searchsorted(a, q, side=side, method=method,
                                   device="cpu").tolist() == want
    for a_, q_ in ((a, q[:0]), (a[:0], q[:1]), (column("u64", 1)[:0], column("u64", 2)[:3])):
        got = rt.searchsorted(a_, q_, device="cpu")
        same(got, jx.searchsorted(jin(a_), jin(q_)))
    i8 = np.arange(8, dtype=np.uint32)
    bad = [(ValueError, dict(side="middle")), (ValueError, dict(method="bisect")),
           (TypeError, dict(sorter=np.zeros(8, np.float32))),
           (ValueError, dict(sorter=np.zeros(4, np.int32)))]
    for err, kw in bad:
        with pytest.raises(err):
            jx.searchsorted(jnp.asarray(i8), jnp.asarray(i8), **kw)
        with pytest.raises(err):
            rt.searchsorted(i8, i8, device="cpu", **kw)
    with pytest.raises(TypeError):
        rt.searchsorted(i8, i8.astype(np.int32), device="cpu")
    with pytest.raises(TypeError):
        rt.searchsorted(torch.arange(4), torch.arange(4),
                        sorter=torch.zeros(4, dtype=torch.bool))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_query_blocks_match_jax(side, monkeypatch):
    """Small query blocks in both packages: the tagged union block by block
    gives the positions of one block of all the queries."""
    monkeypatch.setattr(jx, "_SEARCHSORTED_QBLOCK", 256)
    monkeypatch.setattr(tx, "_SEARCHSORTED_QBLOCK", 256)
    # a ragged last block (u32 by both methods, u64's tagged union), whole blocks
    for kind, q, method in (("u32", Q, "scan"), ("u32", Q, "sort"), ("u64", Q, "auto"),
                            ("u32", 768, "sort")):
        a, v = sorted_and_queries(kind, 19)
        got = rt.searchsorted(a, v[:q], side=side, method=method, device="cpu")
        same(got, jx.searchsorted(jin(a), jin(v[:q]), side=side, method=method))
        assert np.array_equal(got, np.searchsorted(a, v[:q], side=side))


def test_searchsorted_auto_takes_sort_at_32q_ge_n(routes, monkeypatch):
    """'auto' takes the tagged union exactly when 32 * q >= n (the JAX
    package's TPU gate), counted through a spy on the port's sorter; the JAX
    package makes the same choice on its TPU routes."""
    calls, methods = [], []
    real_sort_words, real_jsearch = hw_engine.sort_words, jnp.searchsorted

    def spy(*a, **k):
        calls.append(1)
        return real_sort_words(*a, **k)

    def jspy(sk, qk, side="left", method=None, **kw):
        methods.append(method)
        return real_jsearch(sk, qk, side=side, method=method, **kw)
    monkeypatch.setattr(hw_engine, "sort_words", spy)
    monkeypatch.setattr(jnp, "searchsorted", jspy)
    rng = rng_of(20)
    a = np.sort(rng.integers(0, 1 << 32, size=4096, dtype=np.uint32))
    for q, route in ((1, "scan"), (127, "scan"), (128, "sort"), (4096, "sort")):
        v = rng.integers(0, 1 << 32, size=q, dtype=np.uint32)
        del calls[:]
        got = rt.searchsorted(a, v, device="cpu")
        assert np.array_equal(got, np.searchsorted(a, v))
        assert (len(calls) == 2 if route == "sort" else not calls), (q, calls)
        jx.searchsorted(jnp.asarray(a), jnp.asarray(v))
        assert methods[-1] == (route if routes == "tpu" else "scan")


# ---------------------------------------------------------------------------
# selection; stable_partition


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["u8", "f32", "u64"])
def test_nth_element_matches_jax(kind, descending):
    x = column(kind, 21)
    jc, tc = cfgs(descending)
    ranks = [0, 1, 1500, N - 1]
    got = rt.nth_element(x, ranks, config=tc, device="cpu")
    same(got, jx.nth_element(jin(x), ranks, config=jc))
    for bad in ([], [N], [-1]):
        with pytest.raises(ValueError):
            rt.nth_element(x, bad, device="cpu")


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("kind", ["u32_16", "f32", "u64", "i16"])
def test_top_k_matches_jax(kind, largest):
    x = column(kind, 22)
    got = rt.top_k(x, 37, largest=largest, device="cpu")
    want = jx.top_k(jin(x), 37, largest=largest)
    same(got[0], want[0])
    same(got[1], want[1])
    order = np.argsort(x if not largest else ~x if kind == "u64"
                       else -x.astype(np.float64), kind="stable")[:37]
    assert np.array_equal(got[1], order)
    for k in (0, N + 1):
        with pytest.raises(ValueError):
            rt.top_k(x, k, device="cpu")


def test_top_k_batched_matches_jax():
    rng = rng_of(23)
    x = rng.integers(0, 100, size=(8, 512), dtype=np.uint32)        # heavy ties
    xf = rng.standard_normal((256, 4)).astype(np.float32)
    xf[0, :] = np.nan
    x64 = rng.integers(0, 1 << 64, size=(4, 64), dtype=np.uint64)
    for arr, k, kw in ((x, 9, {}), (xf, 3, dict(axis=0, largest=False)), (x64, 5, {}),
                       (x[:1], 9, {})):
        got = rt.top_k_batched(arr, k, device="cpu", **kw)
        want = jx.top_k_batched(jin(arr), k, **kw)
        same(got[0], want[0])
        same(got[1], want[1])
    for r in range(8):
        order = np.argsort(-x[r].astype(np.int64), kind="stable")[:9]
        assert np.array_equal(rt.top_k_batched(x, 9, device="cpu")[1][r], order)
    with pytest.raises(ValueError):
        rt.top_k_batched(x, 0, device="cpu")
    tv, ti = rt.top_k_batched(torch.from_numpy(xf), 3, axis=0)
    assert torch.is_tensor(tv) and ti.dtype == torch.uint32 and tv.shape == (3, 4)


def test_stable_partition_matches_jax():
    rng = rng_of(24)
    pred = rng.integers(0, 2, size=N).astype(bool)
    vals = {"a": column("u32", 25), "b": column("f32", 26), "c": column("u64", 27)}
    out, num_false = rt.stable_partition(pred, vals, device="cpu")
    jout, jnum = jx.stable_partition(jnp.asarray(pred), {k: jin(v) for k, v in vals.items()})
    assert num_false.dtype == np.int32 and int(num_false) == int(jnum) == int((~pred).sum())
    order = np.argsort(pred, kind="stable")
    for k, v in vals.items():
        same(out[k], jout[k])
        assert np.array_equal(out[k], v[order])
    tout, tnum = rt.stable_partition(torch.from_numpy(pred), torch.from_numpy(vals["b"]))
    assert torch.is_tensor(tnum) and torch.equal(tout, torch.from_numpy(vals["b"][order]))
    for m, kw in ((jx, {}), (rt, dict(device="cpu"))):
        with pytest.raises(TypeError):
            m.stable_partition(np.zeros(4, np.uint32), np.zeros(4, np.uint32), **kw)


# ---------------------------------------------------------------------------
# sort_complex


def test_sort_complex_matches_jax():
    rng = rng_of(28)
    re = rng.integers(-50, 50, size=N).astype(np.float32)          # real-part ties
    x64 = (re + 1j * rng.standard_normal(N).astype(np.float32)).astype(np.complex64)
    x128 = rng.integers(-9, 9, size=N) * 1e300 + 1j * rng.standard_normal(N) * 1e-300
    specials = np.array([1 + 1j, 1 - 1j, -np.inf + 0j, np.inf + 0j, 0 + 0j, -1 + 5j,
                         1 + 0j, complex(0.0, np.nan), complex(-0.0, 1)], np.complex64)
    for x in (x64, x128, specials):
        for descending in (False, True):
            jc, tc = cfgs(descending)
            same(rt.sort_complex(x, config=tc, device="cpu"), jx.sort_complex(x, config=jc))
    assert np.array_equal(rt.sort_complex(x64, device="cpu"), np.sort_complex(x64))
    assert np.array_equal(rt.sort_complex(x128, device="cpu"), np.sort_complex(x128))


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "int16", "uint8", "uint64"])
def test_sort_complex_promotes_as_numpy(dtype):
    x = (rng_of(29).standard_normal(N) * 100).astype(dtype)
    got = rt.sort_complex(x, device="cpu")
    same(got, jx.sort_complex(x))
    assert got.dtype == np.sort_complex(x).dtype and np.array_equal(got, np.sort_complex(x))


def test_sort_complex_errors():
    for m, kw in ((jx, {}), (rt, dict(device="cpu"))):
        with pytest.raises(TypeError, match="NUMPY"):
            m.sort_complex(jnp.zeros((4,), jnp.float32) if m is jx else torch.zeros(4), **kw)
        with pytest.raises(ValueError, match="1-D"):
            m.sort_complex(np.zeros((2, 2), np.complex64), **kw)
        assert m.sort_complex(np.zeros(0, np.complex64), **kw).shape == (0,)


# ---------------------------------------------------------------------------
# R5, and the conventions of the entry points


def bytes_keys(W, seed, live):
    """N byte strings of width W that differ only in the bytes ``live``."""
    u8 = np.zeros((N, W), np.uint8)
    u8[:, live] = rng_of(seed).integers(0, 4, size=(N, len(live))) * 60
    return u8.view(f"S{W}").reshape(-1)


def test_r5_byte_string_planes_match_numpy():
    """R5: the port packs every plane of a byte string as a 32-bit field and
    gives numpy's order; the JAX package keeps only the first plane of S9
    keys (wrong order; segmented_sort raises) and packs S2 keys as if their
    bytes sat at the bottom of the plane (wrong order beside another key)."""
    s9 = bytes_keys(9, 30, [0, 8])                # differs in its 9th byte too
    s2 = bytes_keys(2, 31, [0, 1])
    seg = column("u8_4", 32)
    assert np.array_equal(rt.lexsort([s9], device="cpu"), np.lexsort([s9]))
    assert not np.array_equal(np_of(jx.lexsort([s9])), np.lexsort([s9]))
    for keys in ([seg, s9], [s9, seg], [seg, s2], [s2, seg]):
        assert np.array_equal(rt.lexsort(keys, device="cpu"), np.lexsort(keys))
        assert not np.array_equal(np_of(jx.lexsort([jin(k) for k in keys])),
                                  np.lexsort(keys))
    for k in (s9, s2):
        order = np.lexsort([k, seg])
        assert np.array_equal(rt.segmented_argsort(k, seg, device="cpu"), order)
        sk, sid = rt.segmented_sort(k, seg, device="cpu")
        assert np.array_equal(sk, k[order]) and np.array_equal(sid, seg[order])
        assert not np.array_equal(np_of(jx.segmented_argsort(k, jnp.asarray(seg))), order)
    with pytest.raises(ValueError):
        jx.segmented_sort(s9, jnp.asarray(seg))
    # searchsorted of keys of more than two planes raises in both packages
    with pytest.raises(ValueError):
        jx.searchsorted(np.sort(s9), s9)
    with pytest.raises(ValueError, match="two 32-bit planes"):
        rt.searchsorted(np.sort(s9), s9, device="cpu")
    # S4 to S8 keys pack as the JAX package packs them
    s5 = bytes_keys(5, 33, [0, 4])
    same(rt.lexsort([seg, s5], device="cpu"), jx.lexsort([jnp.asarray(seg), s5]))
    same(rt.searchsorted(np.sort(s5), s5, device="cpu"), jx.searchsorted(np.sort(s5), s5))


def test_tensors_stay_tensors_and_numpy_needs_a_device():
    a, b = column("u16", 34), column("u8", 35)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    perm = rt.lexsort([ta, b])                     # numpy joins the tensor's device
    assert torch.is_tensor(perm) and np.array_equal(perm.numpy(), np.lexsort([a, b]))
    sk, sid = rt.segmented_sort(ta, tb)
    assert torch.is_tensor(sk) and sk.dtype == torch.uint16 and torch.is_tensor(sid)
    s = np.sort(a)
    pos = rt.searchsorted(torch.from_numpy(s), a)
    assert torch.is_tensor(pos) and pos.dtype == torch.int32
    assert np.array_equal(pos.numpy(), np.searchsorted(s, a))
    v, i = rt.top_k(ta, 5)
    assert torch.is_tensor(v) and v.dtype == torch.uint16 and i.dtype == torch.uint32
    assert torch.is_tensor(rt.nth_element(ta, [3])) and torch.is_tensor(rt.merge_sorted(ta, ta))
    with pytest.raises(ValueError):
        rt.lexsort([ta], device="meta")
    if not torch.cuda.is_available():
        for call in (lambda: rt.lexsort([a]), lambda: rt.searchsorted(s, a),
                     lambda: rt.top_k(a, 3), lambda: rt.sort_complex(a)):
            with pytest.raises(RuntimeError, match="device"):
                call()
