"""The port's configured sorters (``radix_sorting_tpu_torch.models``)
against the JAX package's, one per reference listing.

Each of the eight sorters gets the same numpy input (from a seed) in both
packages, the port's with ``device="cpu"``; outputs are equal bit for bit.
LSD-configured sorters are held as well, since the JAX package's AUTO and
LSD engines give the same stable output.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu import models as jm
from radix_sorting_tpu_torch import models as tm

from test_torch_kdf import make_keys, raw
from test_torch_sort import jax_in

N = 3001
LSD = {"strategy": "lsd"}


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


def pair(name, **cfg):
    """(JAX sorter, port sorter) of one class and configuration."""
    return (getattr(jm, name)(rst.SortConfig(**cfg)),
            getattr(tm, name)(rt.SortConfig(**cfg), device="cpu"))


def equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and np.array_equal(raw(got), raw(want))


def test_counting_sorter_8():
    x = rng_of(1).integers(0, 256, size=N, dtype=np.uint8)
    j, t = pair("CountingSorter8")
    assert equal(t(x), j(jnp.asarray(x)))
    with pytest.raises(TypeError):
        t(x.astype(np.uint16))
    with pytest.raises(TypeError):
        t(torch.from_numpy(x.astype(np.int16)))


def test_stable_counting_sorter_8():
    rng = rng_of(2)
    k = rng.integers(0, 8, size=N, dtype=np.uint8)
    v = rng.integers(0, 1 << 32, size=N, dtype=np.uint32)
    j, t = pair("StableCountingSorter8")
    (gk, gv), (wk, wv) = t(k, v), j(jnp.asarray(k), jnp.asarray(v))
    assert equal(gk, wk) and equal(gv, wv)
    with pytest.raises(TypeError):
        t(k.astype(np.int8), v)


@pytest.mark.parametrize("cfg", [{}, LSD], ids=["auto", "lsd"])
def test_record_counting_sorter(cfg):
    rng = rng_of(3)
    records = {"key": rng.integers(0, 45, size=N, dtype=np.uint8),
               "name": rng.integers(0, 1 << 32, size=N, dtype=np.uint32),
               "id": np.arange(N, dtype=np.int64)}
    j, t = pair("RecordCountingSorter", **cfg)
    got = t(records, key_of=lambda r: r["key"])
    want = j(records, key_of=lambda r: jnp.asarray(r["key"]))
    assert all(equal(got[name], want[name]) for name in records)


@pytest.mark.parametrize("cfg", [{}, LSD, {"strategy": "lsd", "radix_bits": 11}],
                         ids=["auto", "lsd", "lsd11"])
def test_radix_sorter_u32(cfg):
    x = rng_of(4).integers(0, 1 << 32, size=N, dtype=np.uint32)
    j, t = pair("RadixSorterU32", **cfg)
    assert equal(t(x), j(jnp.asarray(x)))
    xm = x & np.uint32(0xFF000000)
    assert equal(t(xm, value_mask=0xFF000000), j(jnp.asarray(xm), value_mask=0xFF000000))


@pytest.mark.parametrize("descending", [False, True])
def test_multipass_sorter_u64(descending):
    x = rng_of(5).integers(0, 1 << 64, size=N, dtype=np.uint64)
    j, t = pair("MultipassSorterU64", descending=descending)
    assert equal(t(x), j(x))


@pytest.mark.parametrize("cfg", [{}, LSD], ids=["auto", "lsd"])
def test_rank_sorter(cfg):
    x = rng_of(6).integers(0, 100, size=N, dtype=np.uint32)
    j, t = pair("RankSorter", **cfg)
    assert equal(t(x), j(jnp.asarray(x)))
    assert equal(t(x, index_dtype=np.int32), j(jnp.asarray(x), index_dtype=jnp.int32))


@pytest.mark.parametrize("descending", [False, True])
def test_bitmap_sorter_16(descending):
    x = rng_of(7).integers(0, 5000, size=N, dtype=np.uint16)
    j, t = pair("BitmapSorter16", descending=descending)
    (gv, gc), (wv, wc) = t(x), j(jnp.asarray(x))
    assert int(gc) == int(wc) and equal(gv, wv)
    tv, tc = t(torch.from_numpy(x.view(np.int16)).view(torch.uint16), size=6000)
    assert torch.is_tensor(tv) and int(tc) == int(wc)
    assert np.array_equal(tv.view(torch.int16).numpy().view(np.uint16)[: int(tc)],
                          np.asarray(wv)[: int(wc)])


@pytest.mark.parametrize("cfg", [{}, LSD, {"descending": True}],
                         ids=["auto", "lsd", "descending"])
@pytest.mark.parametrize("name", ["float32", "int32", "uint64", "bfloat16"])
def test_generic_radix_sorter(name, cfg):
    x = make_keys(name, N, rng_of(8))
    v = rng_of(9).integers(0, 1 << 32, size=N, dtype=np.uint32)
    j, t = pair("GenericRadixSorter", **cfg)
    assert equal(t(x), j(jax_in(x)))
    (gk, gv), (wk, wv) = t(x, v), j(jax_in(x), jnp.asarray(v))
    assert equal(gk, wk) and equal(gv, wv)
