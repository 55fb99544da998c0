"""The port's argsort / rank_sort, sort_pairs, counting_sort and
sort_u64_multipass against the JAX package's.

The same keys and payloads (numpy, from a seed) and the same configuration
go to both packages; permutations, sorted keys and every payload leaf must be
equal bit for bit (exact equality: integer and bit-pattern outputs). The
JAX package runs on its CPU routes. Error paths must raise the JAX package's
exception types.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt

from test_torch_kdf import make_keys, raw
from test_torch_sort import jax_in


def keys(name, n, seed):
    return make_keys(name, n, np.random.Generator(np.random.PCG64(seed)))


def cfgs(**kw):
    jcfg = rst.SortConfig(**kw)
    return jcfg, rt.SortConfig.from_dict(dataclasses.asdict(jcfg))


def dup_keys(name, n, seed):
    """Keys with many duplicates, so stability shows."""
    x = keys(name, n, seed)
    if x.dtype.kind in "ui" and x.dtype.itemsize >= 4:
        x = (raw(x) & (raw(x).dtype.type(0xFF) << raw(x).dtype.type(
            8 * x.dtype.itemsize - 8))).view(x.dtype)
    return x


# ---------------------------------------------------------------------------
# argsort / rank_sort


ARGSORT_KEYS = ["uint32", "int32", "uint64", "int64", "float64", "float32",
                "uint16", "bool", "float8_e5m2", "int4", "S4", "S9"]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ARGSORT_KEYS)
def test_argsort_matches_jax(name, descending):
    x = dup_keys(name, 9001, len(name))
    jcfg, tcfg = cfgs(descending=descending)
    want = np.asarray(rst.argsort(jax_in(x), config=jcfg))
    got = rt.argsort(x, config=tcfg, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("index_dtype", [np.uint16, np.int32, np.int64, np.uint32])
@pytest.mark.parametrize("detect_presorted", [False, True])
def test_rank_sort_index_dtypes_match_jax(index_dtype, detect_presorted):
    x = dup_keys("uint64", 5003, 4)
    x[:1000] = np.sort(x[:1000])
    jcfg, tcfg = cfgs(detect_presorted=detect_presorted)
    want = np.asarray(rst.rank_sort(x, config=jcfg,
                                    index_dtype=jnp.dtype(index_dtype)))
    got = rt.rank_sort(x, config=tcfg, index_dtype=index_dtype, device="cpu")
    # the port returns the dtype asked for; the JAX package, with x64 off,
    # gives int32 indices for int64
    assert got.dtype == np.dtype(index_dtype)
    assert want.dtype == (np.int32 if index_dtype is np.int64 else got.dtype)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mask", [0xFFFF0000000000FF, 0x00FF00FF00FF00FF])
def test_argsort_compacted_masked_u64_matches_jax(mask):
    x = (raw(keys("uint64", 20_011, 7)) & np.uint64(mask)).view(np.uint64)
    want = np.asarray(rst.argsort(x, value_mask=mask, validate_mask=True))
    got = rt.argsort(x, value_mask=mask, validate_mask=True, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.argsort(x, kind="stable"))


def test_argsort_presorted_and_tiny_inputs_match_jax():
    for x in (np.arange(1000, dtype=np.uint64), np.zeros(0, np.int64),
              np.array([5], np.float64), np.full(77, 3, np.uint32)):
        assert np.array_equal(rt.argsort(x, device="cpu"),
                              np.asarray(rst.argsort(jax_in(x))))


def test_argsort_tensor_in_tensor_out():
    x = dup_keys("int64", 3001, 9)
    t = torch.from_numpy(x.copy())
    got = rt.argsort(t, index_dtype=torch.int64)
    assert torch.is_tensor(got) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.argsort(x, kind="stable"))
    assert torch.equal(t, torch.from_numpy(x))       # the input is unmodified


# ---------------------------------------------------------------------------
# sort_pairs


def payload(n, seed):
    """A nested payload tree of every leaf kind the JAX package takes."""
    rng = np.random.Generator(np.random.PCG64(seed))
    names = rng.integers(0, 256, size=(n, 7), dtype=np.uint8)
    return {
        "i64": rng.integers(-2**63, 2**63 - 1, size=n, dtype=np.int64),
        "nested": [keys("float64", n, seed + 1),
                   (rng.integers(0, 2**32, size=n, dtype=np.uint32),
                    keys("bfloat16", n, seed + 2))],
        "name": np.ascontiguousarray(names).view("S7").reshape(-1),
        "rec": np.ascontiguousarray(names[:, :3]).view("V3").reshape(-1),
        "row": rng.integers(0, 256, size=(n, 5), dtype=np.uint8),
        "srow": rng.integers(-128, 128, size=(n, 2), dtype=np.int8),
        "u64": rng.integers(0, 2**64, size=n, dtype=np.uint64),
        "f8": keys("float8_e4m3fn", n, seed + 3),
    }


def assert_trees_equal(got, want):
    import jax
    gl, gt = jax.tree.flatten(got)
    wl, wt = jax.tree.flatten(want)
    assert gt == wt and len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert isinstance(g, np.ndarray)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


PAIR_KEYS = ["uint32", "uint64", "int64", "float64", "int16", "S6",
             "float8_e4m3fn", "uint4"]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", PAIR_KEYS)
def test_sort_pairs_matches_jax(name, descending):
    n = 6007
    x = dup_keys(name, n, 11 + len(name))
    vals = payload(n, 3)
    jcfg, tcfg = cfgs(descending=descending)
    wk, wv = rst.sort_pairs(jax_in(x), vals, config=jcfg)
    gk, gv = rt.sort_pairs(x, vals, config=tcfg, device="cpu")
    assert np.array_equal(raw(gk), raw(np.asarray(wk)))
    assert_trees_equal(gv, wv)


@pytest.mark.parametrize("detect_presorted", [False, True])
def test_sort_pairs_compacted_masked_u64_matches_jax(detect_presorted):
    mask = 0x00FF000000FFFF00
    x = (raw(keys("uint64", 8009, 5)) & np.uint64(mask)).view(np.uint64)
    vals = {"i": np.arange(8009, dtype=np.int64)}
    jcfg, tcfg = cfgs(detect_presorted=detect_presorted)
    wk, wv = rst.sort_pairs(x, vals, config=jcfg, value_mask=mask)
    gk, gv = rt.sort_pairs(x, vals, config=tcfg, value_mask=mask, device="cpu")
    assert np.array_equal(gk, wk)
    assert_trees_equal(gv, wv)
    assert np.array_equal(gv["i"], np.argsort(x, kind="stable"))


def test_sort_pairs_tensor_leaves_stay_tensors():
    n = 5000
    k = dup_keys("uint32", n, 21)
    rng = np.random.default_rng(1)
    i64 = rng.integers(-2**40, 2**40, size=n, dtype=np.int64)
    f32 = rng.standard_normal(n).astype(np.float32)
    rows = rng.integers(0, 256, size=(n, 4), dtype=np.uint8)
    tk = torch.from_numpy(k.view(np.int32).copy()).view(torch.uint32)
    sk, sv = rt.sort_pairs(tk, {"i64": torch.from_numpy(i64),
                                "f32": [torch.from_numpy(f32)],
                                "rows": torch.from_numpy(rows), "none": None})
    perm = np.argsort(k, kind="stable")
    assert torch.is_tensor(sk) and sk.dtype == torch.uint32
    assert np.array_equal(sk.view(torch.int32).numpy().view(np.uint32), k[perm])
    assert np.array_equal(sv["i64"].numpy(), i64[perm])
    assert np.array_equal(sv["f32"][0].numpy(), f32[perm])
    assert np.array_equal(sv["rows"].numpy(), rows[perm])
    assert sv["none"] is None


def test_sort_pairs_without_payload_matches_jax():
    x = dup_keys("int64", 1001, 2)
    wk, wv = rst.sort_pairs(x, None)
    gk, gv = rt.sort_pairs(x, None, device="cpu")
    assert np.array_equal(gk, wk) and gv is None and wv is None


# ---------------------------------------------------------------------------
# counting_sort, sort_u64_multipass


@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("strategy", ["auto", "counting"])
@pytest.mark.parametrize("name", ["uint8", "int8", "uint16", "int16"])
def test_counting_sort_matches_jax(name, strategy, with_payload):
    x = keys(name, 20_011, len(name))
    jcfg, tcfg = cfgs(strategy=strategy)
    vals = {"v": np.arange(x.shape[0], dtype=np.int64)} if with_payload else None
    want = rst.counting_sort(jnp.asarray(x), vals, config=jcfg)
    got = rt.counting_sort(x, vals, config=tcfg, device="cpu")
    if with_payload:
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert_trees_equal(got[1], want[1])
    else:
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["uint64", "int64", "float64", "S8"])
def test_sort_u64_multipass_matches_jax(name, descending):
    x = keys(name, 20_011, 30 + len(name))
    jcfg, tcfg = cfgs(descending=descending)
    want = rst.sort_u64_multipass(x, config=jcfg)
    got = rt.sort_u64_multipass(x, config=tcfg, device="cpu")
    assert got.dtype == x.dtype
    assert np.array_equal(raw(got), raw(np.asarray(want)))
    t = rt.sort_u64_multipass(torch.from_numpy(x.copy()) if name != "S8" else x,
                              config=tcfg, device=None if name != "S8" else "cpu")
    assert np.array_equal(raw(tkdf_numpy(t)), raw(np.asarray(want)))


def tkdf_numpy(t):
    return t if isinstance(t, np.ndarray) else rt.to_numpy(t)


# ---------------------------------------------------------------------------
# error paths, against the JAX package's exceptions


U32 = np.arange(300, dtype=np.uint32)
BYTES = np.array([b"ab", b"cd", b"a"] * 100, dtype="S2")


@pytest.mark.parametrize("case", [
    # (call on the JAX package, call on the port, exception)
    (lambda: rst.argsort(U32, config=rst.SortConfig(strategy="counting")),
     lambda: rt.argsort(U32, config=rt.SortConfig(strategy="counting"), device="cpu"),
     ValueError),
    (lambda: rst.sort_pairs(U32, U32, config=rst.SortConfig(strategy="counting")),
     lambda: rt.sort_pairs(U32, U32, config=rt.SortConfig(strategy="counting"),
                           device="cpu"), ValueError),
    (lambda: rst.argsort(BYTES, value_mask=0xFF),
     lambda: rt.argsort(BYTES, value_mask=0xFF, device="cpu"), ValueError),
    (lambda: rst.sort_pairs(BYTES, U32, value_mask=0xFF),
     lambda: rt.sort_pairs(BYTES, U32, value_mask=0xFF, device="cpu"), ValueError),
    (lambda: rst.argsort(U32, index_dtype=jnp.uint8),
     lambda: rt.argsort(U32, index_dtype=np.uint8, device="cpu"), ValueError),
    (lambda: rst.argsort(U32, index_dtype=jnp.int8),
     lambda: rt.argsort(U32, index_dtype=torch.int8, device="cpu"), ValueError),
    (lambda: rst.sort_pairs(U32, U32[:299]),
     lambda: rt.sort_pairs(U32, U32[:299], device="cpu"), ValueError),
    (lambda: rst.sort_pairs(U32, {"a": U32, "b": U32[:7]}),
     lambda: rt.sort_pairs(U32, {"a": U32, "b": U32[:7]}, device="cpu"), ValueError),
    (lambda: rst.sort_pairs(U32, np.zeros((300, 0), np.uint8)),
     lambda: rt.sort_pairs(U32, np.zeros((300, 0), np.uint8), device="cpu"), ValueError),
    (lambda: rst.sort_pairs(U32, np.zeros((300, 300), np.uint8)),
     lambda: rt.sort_pairs(U32, np.zeros((300, 300), np.uint8), device="cpu"),
     ValueError),
    (lambda: rst.sort_pairs(U32, np.zeros(300, dtype="V300")),
     lambda: rt.sort_pairs(U32, np.zeros(300, dtype="V300"), device="cpu"), ValueError),
    (lambda: rst.sort_pairs(U32, np.zeros((300, 3), np.uint16)),
     lambda: rt.sort_pairs(U32, np.zeros((300, 3), np.uint16), device="cpu"),
     ValueError),
    (lambda: rst.argsort(np.zeros(4, dtype="S257")),
     lambda: rt.argsort(np.zeros(4, dtype="S257"), device="cpu"), ValueError),
    (lambda: rst.counting_sort(jnp.asarray(U32)),
     lambda: rt.counting_sort(U32, device="cpu"), TypeError),
    (lambda: rst.sort_u64_multipass(jnp.asarray(U32)),
     lambda: rt.sort_u64_multipass(U32, device="cpu"), TypeError),
])
def test_error_paths_match_jax(case):
    jax_call, port_call, exc = case
    with pytest.raises(exc):
        jax_call()
    with pytest.raises(exc):
        port_call()


def test_port_only_errors():
    # numpy input with no device= goes to the card, and raises without one
    if torch.cuda.is_available():
        assert np.array_equal(rt.argsort(U32), np.argsort(U32, kind="stable"))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rt.argsort(U32)
    with pytest.raises(ValueError):      # payload tensors live with the keys
        rt.sort_pairs(torch.arange(4), torch.arange(4, device="meta"))
    lsd = rt.sort_pairs(U32, U32, config=rt.SortConfig(strategy="lsd"), device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(lsd, rt.sort_pairs(U32, U32, device="cpu")))
    x = np.array([-8, 7, 0], np.int8).astype(ml_dtypes.int4)
    assert np.array_equal(rt.sort(x, device="cpu").astype(np.int8), [-8, 0, 7])
