"""The port's distributed tier, part three: ``distributed_group_reduce``,
sort-backed and dense, against the JAX package's.

As in tests/test_torch_parallel.py: the JAX side on its eight virtual CPU
devices (two for one case), the port on as many CPU ranks, the same numpy
inputs to both, and the port's concatenated shards held against the JAX
global arrays bit for bit: group keys, counts, integer sums (mod 2^32),
min / max, f32 means of integer sums. The exception is the f32 sums of the
dense tier (K11 on the card, ``segment_sum`` in the JAX package's CPU
route): each group within sum|v| * 2^-14 + 1e-5 of a float64 sum, the JAX
package's documented bound.
"""

import numpy as np
import pytest

from radix_sorting_tpu import parallel as jpar
from radix_sorting_tpu_torch import parallel as tpar

from test_torch_parallel import INPUTS, NR, _jit, host, jmesh, rng_of, same, same_all, tmesh


# ---------------------------------------------------------------------------
# group-by


def _groups():
    r = rng_of(21)
    # long runs of few keys: most runs span shard edges, some whole shards
    k = np.sort(r.integers(0, 6, size=NR)).astype(np.uint32)
    r.shuffle(k[: NR // 3])
    return k, r.integers(-2**31, 2**31 - 1, size=NR, dtype=np.int64).astype(np.int32)


GK, GV = _groups()


def _jax_group_reduce(keys, values=None, **kw):
    return jpar.distributed_group_reduce(keys, values, **kw)


@pytest.mark.parametrize("reduce", ["sum", "mean", "min", "max", "count"])
def test_group_reduce_sorted(reduce):
    v = None if reduce == "count" else GV
    args = (GK,) if v is None else (GK, v)
    want = _jit(_jax_group_reduce, *args, mesh=jmesh(), reduce=reduce, chunk=333)
    got = tpar.distributed_group_reduce(GK, v, tmesh(), reduce=reduce, chunk=333)
    same_all(got, want)


@pytest.mark.parametrize("reduce,D", [("min", 2)])
def test_group_reduce_sorted_small_mesh_and_floats(reduce, D):
    r = rng_of(22)
    vf = r.standard_normal(NR).astype(np.float32)
    vf[::40] = -0.0
    k = (INPUTS["ragged"] % np.uint32(300)).astype(np.uint32)
    vals = vf if reduce == "min" else (GV % 1000).astype(np.uint16)
    same_all(tpar.distributed_group_reduce(k, vals, tmesh(D), reduce=reduce),
             _jit(_jax_group_reduce, k, vals, mesh=jmesh(D), reduce=reduce))


@pytest.mark.parametrize("reduce,vdtype", [("sum", np.int32), ("mean", np.uint8),
                                           ("count", None)])
def test_group_reduce_dense(reduce, vdtype):
    r = rng_of(23)
    k = r.integers(0, 1000, size=NR).astype(np.uint32)
    k[k % 7 == 3] = 5                         # absent groups and one heavy group
    v = None if vdtype is None else r.integers(
        np.iinfo(vdtype).min, np.iinfo(vdtype).max, size=NR, dtype=np.int64).astype(vdtype)
    args = (k,) if v is None else (k, v)
    want = _jit(_jax_group_reduce, *args, mesh=jmesh(), reduce=reduce, groups=1000)
    got = tpar.distributed_group_reduce(k, v, tmesh(), reduce=reduce, groups=1000)
    assert got[0][0].shape == (125,)          # ceil(G / D) rows a shard
    same_all(got, want)


def test_group_reduce_dense_f32():
    r = rng_of(24)
    k = r.integers(0, 1000, size=NR).astype(np.int32)
    v = (r.standard_normal(NR) * 100).astype(np.float32)
    want = _jit(_jax_group_reduce, k, v, mesh=jmesh(), reduce="sum", groups=1000)
    uk, red, cnt, ovf = tpar.distributed_group_reduce(k, v, tmesh(), reduce="sum",
                                                      groups=1000)
    same(uk, want[0])
    same_all((cnt, ovf), want[2:])
    # f32 sums: the JAX package's bound per group of a float64 sum
    keys, sums, counts = host(uk), host(red), host(cnt)
    live = np.concatenate([np.arange(125) < c for c in counts])
    ref = np.bincount(k, weights=v.astype(np.float64), minlength=1000)
    absum = np.bincount(k, weights=np.abs(v.astype(np.float64)), minlength=1000)
    kk = keys[live]
    assert np.array_equal(kk, np.flatnonzero(np.bincount(k, minlength=1000)))
    assert np.all(np.abs(sums[live] - ref[kk]) <= absum[kk] * 2.0 ** -14 + 1e-5)


def test_group_reduce_checks():
    k = np.arange(64, dtype=np.uint32)
    v = np.ones(64, np.int32)
    with pytest.raises(ValueError, match="outside"):
        tpar.distributed_group_reduce(k, v, tmesh(), groups=10, validate=True)
    with pytest.raises(ValueError, match="reduce must be"):
        tpar.distributed_group_reduce(k, v, tmesh(), reduce="median")
    with pytest.raises(ValueError, match="values=None"):
        tpar.distributed_group_reduce(k, v, tmesh(), reduce="count")
    with pytest.raises(ValueError, match="single-plane"):
        tpar.distributed_group_reduce(k, v.astype(np.int64), tmesh(), reduce="sum")
    with pytest.raises(TypeError, match="groups promises"):
        tpar.distributed_group_reduce(k.astype(np.float32), v, tmesh(), groups=10)
