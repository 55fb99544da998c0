"""The port's batched sorts against the JAX package's.

``sort_batched``, ``argsort_batched`` and ``sort_pairs_batched`` sort every
1-D slice along an axis; the same numpy keys and payloads (from a seed) go to
both packages, and outputs must be equal bit for bit. Shapes are (3, 1000)
and (4, 5, 300) along each axis, plus one-row batches, which both packages
send through their 1-D entry points.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt

from test_torch_kdf import make_keys, raw
from test_torch_sort import jax_in

CASES = [((3, 1000), -1), ((3, 1000), 0), ((4, 5, 300), 0), ((4, 5, 300), 1),
         ((4, 5, 300), 2)]
NAMES = ["uint8", "int16", "bfloat16", "uint32", "int32", "float32", "uint64",
         "int64", "float64"]


def keys(name, shape, seed):
    x = make_keys(name, int(np.prod(shape)), np.random.Generator(np.random.PCG64(seed)))
    if x.dtype.kind in "ui" and x.dtype.itemsize >= 4:       # duplicates in rows
        x = (raw(x) % raw(x).dtype.type(97)).view(x.dtype)
    return x.reshape(shape)


def cfgs(**kw):
    jcfg = rst.SortConfig(**kw)
    return jcfg, rt.SortConfig.from_dict(dataclasses.asdict(jcfg))


def same_bits(got, want):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(np.asarray(want))
    return got.shape == want.shape and np.array_equal(raw(got), raw(want))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("shape,axis", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_sort_batched_matches_jax(name, shape, axis, descending):
    x = keys(name, shape, NAMES.index(name) * 4 + axis % len(shape))
    jcfg, tcfg = cfgs(descending=descending)
    want = rst.sort_batched(jax_in(x), axis=axis, config=jcfg)
    got = rt.sort_batched(x, axis=axis, config=tcfg, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == x.dtype
    assert same_bits(got, want)


@pytest.mark.parametrize("shape,axis", CASES)
@pytest.mark.parametrize("name", ["uint8", "float32", "int64"])
def test_argsort_batched_matches_jax(name, shape, axis):
    x = keys(name, shape, 3)
    want = np.asarray(rst.argsort_batched(jax_in(x), axis=axis))
    got = rt.argsort_batched(x, axis=axis, device="cpu")
    assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.parametrize("shape,axis", CASES)
def test_sort_pairs_batched_matches_jax(shape, axis):
    rng = np.random.Generator(np.random.PCG64(axis % len(shape) + 7))
    k = keys("int32", shape, 5)
    vals = {"u32": rng.integers(0, 1 << 32, size=shape, dtype=np.uint32),
            "f32": rng.standard_normal(shape).astype(np.float32),
            "i64": rng.integers(-2**63, 2**63 - 1, size=shape, dtype=np.int64),
            "f64": rng.standard_normal(shape)}
    wk, wv = rst.sort_pairs_batched(jnp.asarray(k), vals, axis=axis)
    gk, gv = rt.sort_pairs_batched(k, vals, axis=axis, device="cpu")
    assert same_bits(gk, wk)
    for name in vals:
        assert gv[name].dtype == vals[name].dtype and same_bits(gv[name], wv[name])


def test_batched_u64_keys_with_64_bit_payload_match_jax():
    k = keys("uint64", (6, 500), 9)
    v = np.random.Generator(np.random.PCG64(1)).integers(0, 2**64, size=(6, 500),
                                                         dtype=np.uint64)
    wk, wv = rst.sort_pairs_batched(k, v)
    gk, gv = rt.sort_pairs_batched(k, v, device="cpu")
    assert same_bits(gk, wk) and same_bits(gv, wv)


@pytest.mark.parametrize("shape,axis", [((1, 4096), -1), ((4096, 1), 0), ((1, 1, 777), 2),
                                        ((777,), 0)])
def test_single_row_batches_match_jax(shape, axis):
    x = keys("uint32", shape, 1)
    assert same_bits(rt.sort_batched(x, axis=axis, device="cpu"),
                     rst.sort_batched(jnp.asarray(x), axis=axis))
    assert same_bits(rt.argsort_batched(x, axis=axis, device="cpu"),
                     rst.argsort_batched(jnp.asarray(x), axis=axis))
    p = np.random.Generator(np.random.PCG64(2)).integers(0, 1 << 62, size=shape)
    gk, gv = rt.sort_pairs_batched(x, p, axis=axis, device="cpu")
    wk, wv = rst.sort_pairs_batched(jnp.asarray(x), p, axis=axis)
    assert same_bits(gk, wk) and same_bits(gv, wv)


def test_tensors_in_tensors_out():
    x = np.random.Generator(np.random.PCG64(4)).standard_normal((4, 5, 300)).astype(np.float32)
    t = torch.from_numpy(x)
    s = rt.sort_batched(t, axis=1)
    assert torch.is_tensor(s) and np.array_equal(raw(s.numpy()), raw(np.sort(x, axis=1)))
    perm = rt.argsort_batched(t, axis=0, index_dtype=torch.int64)
    assert perm.dtype == torch.int64
    assert np.array_equal(perm.numpy(), np.argsort(x, axis=0, kind="stable"))
    sk, sv = rt.sort_pairs_batched(t, (t * 2,), axis=-1)
    assert torch.equal(sv[0], sk * 2)


def test_batched_errors_match_jax():
    x = keys("uint32", (3, 300), 1)
    with pytest.raises(ValueError):
        rst.sort_batched(jnp.asarray(x), axis=2)
    with pytest.raises(ValueError):
        rt.sort_batched(x, axis=2, device="cpu")
    with pytest.raises(ValueError, match="cannot index"):
        rst.argsort_batched(jnp.asarray(x), index_dtype=jnp.uint8)
    with pytest.raises(ValueError, match="cannot index"):
        rt.argsort_batched(x, index_dtype=np.uint8, device="cpu")
    with pytest.raises(ValueError):
        rst.sort_pairs_batched(jnp.asarray(x), jnp.asarray(x[:, :10]))
    with pytest.raises(ValueError):
        rt.sort_pairs_batched(x, x[:, :10], device="cpu")
    with pytest.raises(ValueError):
        rt.sort_batched(np.zeros((2, 3), "S4"), device="cpu")
