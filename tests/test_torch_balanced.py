"""The port's distributed tier, part two: the balanced sorts, unique values
and the order statistics, against the JAX package's ``parallel.balanced``
(the group-by: tests/test_torch_dist_groupby.py).

As in tests/test_torch_parallel.py: the JAX side on its eight virtual CPU
devices (2 or 4 of them where D matters), the port on as many CPU ranks,
the same numpy inputs to both, and the port's concatenated shards held
against the JAX global arrays bit for bit (keys with their padding,
permutations with the strict-mode pad indices, payloads, counts, integer
selections). Quantile interpolation is float32 on both sides, in the same
order of operations; it is held bit for bit too.

The JAX entry points run under ``jax.jit``, one compile per entry point,
options and shape (the lengths are shared across cases). For 64-bit numpy
keys, which they split on the host, their balanced body runs under jit on
the host-encoded planes, as the entry point runs it eagerly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from radix_sorting_tpu import api as japi
from radix_sorting_tpu import parallel as jpar
from radix_sorting_tpu.parallel import _payload as jpayload
from radix_sorting_tpu.parallel import balanced as jbal
from radix_sorting_tpu_torch import parallel as tpar
from radix_sorting_tpu_torch.ops import cuda_kernels as ck

from test_torch_parallel import (GENERIC, INPUTS, N, NR, _jax_sort, _jit, host, jmesh,
                                 rng_of, same, same_all, tmesh)


def _jax_balanced(planes, D, num_key_planes, strict, **kw):
    """The JAX package's balanced body under one jit, on planes encoded on
    the host: what its dtype-generic entry points run eagerly for 64-bit
    numpy keys (an eager shard_map costs seconds a call)."""
    return jax.jit(lambda *p: jbal._run_balanced(
        p, jmesh(D), "shards", num_key_planes=num_key_planes, strict=strict, **kw))(*planes)


# ---------------------------------------------------------------------------
# the balanced sorts


@pytest.mark.parametrize("name", list(INPUTS))
def test_balanced_u32(name):
    x = INPUTS[name]
    want = _jit(jpar.distributed_sort_balanced_u32, x, mesh=jmesh())
    got = tpar.distributed_sort_balanced_u32(x, tmesh())
    assert got[0][0].dtype == torch.uint32
    same_all(got, want)
    assert np.array_equal(tpar.gather_sorted(*got), np.sort(x))


@pytest.mark.parametrize("exchange", ["xla", "rdma"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("name,chunk", [("uniform", 7), ("skewed", None),
                                        ("ragged_max", 1)])
def test_balanced_overlap_and_exchanges(name, chunk, overlap, exchange):
    # small chunks: many rounds, each shipping other data, so a receive
    # buffer reused before its placement would show
    x = INPUTS[name]
    want = _jit(jpar.distributed_sort_balanced_u32, x, mesh=jmesh(), chunk=chunk,
                overlap=False)
    got = tpar.distributed_sort_balanced_u32(x, tmesh(), chunk=chunk, overlap=overlap,
                                             exchange=exchange)
    same_all(got, want)


def test_balanced_rdma_counts_no_launch_on_cpu(monkeypatch):
    # the CPU ranks take K13's plain version through the wrapper: the wrapper
    # is called once a round, the kernel never
    calls = []
    real = ck.rdma_exchange

    def counting(sends):
        calls.append(len(sends))
        return real(sends)

    monkeypatch.setattr(ck, "rdma_exchange", counting)
    before = ck.launch_counts()["rdma_exchange"]
    x = INPUTS["uniform"]
    out = tpar.gather_sorted(*tpar.distributed_sort_balanced_u32(x, tmesh(), chunk=64,
                                                                  exchange="rdma"))
    assert np.array_equal(out, np.sort(x))
    assert calls and set(calls) == {8}
    assert ck.launch_counts()["rdma_exchange"] == before


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("name", ["ragged", "two_values"])
def test_balanced_mesh_sizes(D, name):
    x = INPUTS[name]
    same_all(tpar.distributed_sort_balanced_u32(x, tmesh(D)),
             _jit(jpar.distributed_sort_balanced_u32, x, mesh=jmesh(D)))


@pytest.mark.parametrize("name", ["ragged_max", "all_equal"])
def test_balanced_argsort_and_pairs_u32(name):
    # ragged_max: maximal keys in the tail, so the strict pad indices
    # n..n+pad-1 sort among them and must stay apart from the real rows
    x = INPUTS[name]
    pay = rng_of(11).integers(0, 1 << 32, size=x.size, dtype=np.uint32)
    got = tpar.distributed_argsort_balanced_u32(x, tmesh())
    same_all(got, _jit(jpar.distributed_argsort_balanced_u32, x, mesh=jmesh()))
    assert np.array_equal(tpar.gather_sorted(got[1], got[2]),
                          np.argsort(x, kind="stable").astype(np.uint32))
    same_all(tpar.distributed_sort_pairs_balanced_u32(x, pay, tmesh(), chunk=100),
             _jit(jpar.distributed_sort_pairs_balanced_u32, x, pay, mesh=jmesh(), chunk=100))


@pytest.mark.parametrize("dtype,descending,overlap", [("u64", False, True),
                                                      ("i32", True, False),
                                                      ("f32", True, True)])
def test_balanced_generic_dtypes(dtype, descending, overlap):
    x = GENERIC[dtype]
    kw = dict(chunk=300, overlap=overlap)
    got = tpar.distributed_sort(x, tmesh(), exchange="rdma", descending=descending, **kw)
    if x.dtype.itemsize == 8:
        words, kd = japi._as_words(x, descending)
        out, counts, ovf = _jax_balanced(words, 8, 2, False, **kw)
        want = (japi._decode(tuple(out), kd, descending), counts, ovf)
    else:
        want = _jax_sort(x, jmesh(), descending=descending, **kw)
    same_all(got, want)


def test_balanced_generic_argsort():
    x = GENERIC["f32"]
    kw = dict(descending=True, chunk=200)
    got = tpar.distributed_argsort(x, tmesh(), **kw)
    same_all(got, _jax_sort(x, jmesh(), jpar.distributed_argsort, **kw))


def test_balanced_pairs_pytree_with_64bit_and_bytes():
    x = GENERIC["u16"]
    r = rng_of(13)
    vals = {"i64": r.integers(-2**62, 2**62, size=NR, dtype=np.int64),
            "f64": r.standard_normal(NR),
            "name": r.integers(0, 256, size=(NR, 6), dtype=np.uint8).view("S6").reshape(-1)}
    got = tpar.distributed_sort_pairs(x, vals, tmesh(), chunk=500, overlap=True,
                                      exchange="rdma")
    # jpar.distributed_sort_pairs, its balanced body under jit
    words, kd = japi._as_words(jnp.asarray(x), False)
    planes, ctx = jpayload.encode_payload_tree(vals, NR)
    idx = jnp.arange(NR, dtype=jnp.uint32)
    out, counts, ovf = _jax_balanced(tuple(words) + (idx,) + planes, 8, 2, True, chunk=500)
    want_keys = japi._decode(tuple(out[:1]), kd, False)
    want_vals = jpayload.decode_payload_tree(out[2:], ctx)
    same(got[0], want_keys)
    same(got[1]["i64"], want_vals["i64"])
    same(got[1]["f64"], want_vals["f64"])
    assert np.array_equal(host(got[1]["name"]).view("S6").reshape(-1), want_vals["name"])
    same_all(got[2:], (counts, ovf))
    order = np.argsort(x, kind="stable")
    assert np.array_equal(tpar.gather_sorted(got[1]["i64"], got[2]), vals["i64"][order])
    assert np.array_equal(tpar.gather_sorted(got[1]["name"], got[2]).view("S6").reshape(-1),
                          vals["name"][order])


def test_balanced_errors():
    with pytest.raises(ValueError, match="n >= 1"):
        tpar.distributed_sort_balanced_u32(np.zeros(0, np.uint32), tmesh())
    with pytest.raises(ValueError, match="exchange must be"):
        tpar.distributed_sort_balanced_u32(np.zeros(64, np.uint32), tmesh(), exchange="x")


# ---------------------------------------------------------------------------
# unique values


@pytest.mark.parametrize("name", ["two_values", "narrow", "all_equal", "ragged"])
def test_distributed_unique_sorted(name):
    x = INPUTS[name]
    got = tpar.distributed_unique_sorted(x, tmesh())
    same_all(got, _jit(jpar.distributed_unique_sorted, x, mesh=jmesh()))
    assert np.array_equal(tpar.gather_sorted(got[0], got[1]), np.unique(x))


def test_distributed_unique_sorted_small_mesh():
    x = INPUTS["narrow"]
    for D in (1, 2):
        same_all(tpar.distributed_unique_sorted(x, tmesh(D)),
                 _jit(jpar.distributed_unique_sorted, x, mesh=jmesh(D)))


# ---------------------------------------------------------------------------
# selection


def test_distributed_select():
    x = GENERIC["f32"]
    ranks = [0, 1, 17, NR // 2, NR - 1]
    for desc in (False, True):
        got = tpar.distributed_select(x, ranks, tmesh(), descending=desc)
        same(got, _jit(jpar.distributed_select, x, ranks=ranks, mesh=jmesh(),
                       descending=desc))
    x = INPUTS["all_equal"]
    same(tpar.distributed_select(x, [0, N - 1], tmesh(2)),
         _jit(jpar.distributed_select, x, ranks=[0, N - 1], mesh=jmesh(2)))
    same(tpar.distributed_select(x, [5], tmesh(1)), x[[5]])
    with pytest.raises(ValueError, match="ranks must be in"):
        tpar.distributed_select(x, [N], tmesh())
    with pytest.raises(ValueError, match="non-empty"):
        tpar.distributed_select(x, [], tmesh())


@pytest.mark.parametrize("method", ["linear", "lower", "higher", "nearest", "midpoint"])
def test_distributed_quantile(method):
    x = INPUTS["ragged"]
    qs = [0.0, 0.1, 0.5, 0.999, 1.0]
    got = tpar.distributed_quantile(x, qs, tmesh(), method=method)
    same(got, _jit(jpar.distributed_quantile, x, q=qs, mesh=jmesh(), method=method))


def test_distributed_median_and_u64_host_path():
    x = INPUTS["narrow"]
    m = tpar.distributed_median(x, tmesh())
    assert m.ndim == 0
    same(m, _jit(jpar.distributed_median, x, mesh=jmesh()))
    # 64-bit keys: the JAX package's host path is numpy's own float64
    # arithmetic (its eager shard_map costs seconds), so numpy is the oracle
    x64 = GENERIC["u64"]
    got = tpar.distributed_quantile(x64, [0.25, 0.5, 0.7], tmesh())
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert np.array_equal(got, np.quantile(x64, [0.25, 0.5, 0.7]))
    with pytest.raises(ValueError, match="lie in"):
        tpar.distributed_quantile(x, -0.1, tmesh())
    with pytest.raises(ValueError, match="empty"):
        tpar.distributed_quantile(np.zeros(0, np.float32), 0.5, tmesh())
    with pytest.raises(ValueError, match="method must be"):
        tpar.distributed_quantile(x, 0.5, tmesh(), method="cubic")


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("name", ["two_values", "ragged"])
def test_distributed_top_k(name, largest):
    x = INPUTS[name]
    got = tpar.distributed_top_k(x, 100, tmesh(), largest=largest)
    same_all(got, _jit(jpar.distributed_top_k, x, k=100, mesh=jmesh(), largest=largest))
    order = np.argsort(~x if largest else x, kind="stable")[:100]
    assert np.array_equal(host(got[1]), order.astype(np.uint32))
    v1, i1 = tpar.distributed_top_k(x, 100, tmesh(1), largest=largest, index_dtype=np.int64)
    same(v1, got[0])
    assert i1.dtype == torch.int64 and np.array_equal(host(i1), order)
    with pytest.raises(ValueError, match="exceeds the shard size"):
        tpar.distributed_top_k(x, x.size // 4, tmesh())
