"""The port's distributed tier, part one: the mesh, the distributed
histograms, the payload codec and the top-digit shuffle, against the JAX
package's ``parallel``.

The JAX side runs on the eight virtual CPU devices that tests/conftest.py
forces (``make_sort_mesh(8)``, and 2 or 4 of them for the cases that depend
on D); the port on a mesh of as many CPU ranks (``make_sort_mesh(devices=
["cpu"] * D)``), where ``exchange="rdma"`` runs K13's plain version. Inputs
are made from a seed with numpy and handed to both. The port's per-rank
shards, concatenated, are held against the JAX global array bit for bit:
sorted keys with their sentinel padding, permutations, payloads, ``counts``
and ``overflow``. The lengths are shared across cases (2^12, 2^12 + 37 for
the ragged pads, 2^14), since the JAX side compiles once per shape.
"""

import ml_dtypes
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from radix_sorting_tpu import parallel as jpar
from radix_sorting_tpu_torch import parallel as tpar
from radix_sorting_tpu_torch.ops import kdf
from radix_sorting_tpu_torch.parallel import _mesh, _payload

N, NR, NL = 1 << 12, (1 << 12) + 37, 1 << 14


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


_JMESH, _TMESH = {}, {}


def jmesh(D=8):
    if len(jax.devices()) < D:
        pytest.skip("needs the 8-device virtual mesh")
    if D not in _JMESH:
        _JMESH[D] = jpar.make_sort_mesh(D)
    return _JMESH[D]


def tmesh(D=8):
    if D not in _TMESH:
        _TMESH[D] = tpar.make_sort_mesh(devices=["cpu"] * D)
    return _TMESH[D]


def host(a):
    """The port's per-rank shards (a tuple of tensors) or one tensor, or a
    JAX / numpy array, as one numpy array."""
    if isinstance(a, (tuple, list)):
        return np.concatenate([host(s) for s in a])
    if torch.is_tensor(a):
        return kdf.to_numpy(a)
    return np.asarray(a)


def bits(a):
    a = np.asarray(a)
    if a.dtype.kind in "SV":
        return a.view(np.uint8)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype != np.bool_ else a


def same(port, want):
    """Bit-for-bit equality of the port's result and the JAX package's."""
    got, want = host(port), host(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(bits(got), bits(want))


def same_all(port, want):
    assert len(port) == len(want)
    for p, w in zip(port, want):
        same(p, w)


# ---------------------------------------------------------------------------
# the mesh and its collectives


def test_make_sort_mesh(monkeypatch):
    m = tpar.make_sort_mesh(devices=["cpu"] * 8)
    assert m.shape == {"shards": 8} and m.size == 8
    assert all(d == torch.device("cpu") for d in m.devices)
    assert tpar.make_sort_mesh(3, devices=["cpu"] * 8).shape["shards"] == 3
    assert tpar.make_sort_mesh(devices=["cpu"], axis_name="x").shape == {"x": 1}
    with pytest.raises(ValueError, match="requested 9 devices"):
        tpar.make_sort_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="at least one device"):
        tpar.SortMesh(())
    # no card and no devices=: raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_sort_mesh()
    with pytest.raises(ValueError, match="axis is 'shards'"):
        tpar.distributed_sort_u32(np.zeros(64, np.uint32), m, axis_name="x")


def test_collectives():
    mesh = tmesh(4)
    xs = [torch.full((3,), r, dtype=torch.int32) + torch.arange(3, dtype=torch.int32)
          for r in range(4)]
    assert all(torch.equal(s, torch.tensor([6, 10, 14], dtype=torch.int32))
               for s in _mesh.psum(xs, mesh))
    assert all(torch.equal(s, xs[3]) for s in _mesh.pmax(xs, mesh))
    assert torch.equal(_mesh.all_gather(xs, mesh)[2], torch.stack(xs))
    assert torch.equal(_mesh.all_gather(xs, mesh, tiled=True)[0], torch.cat(xs))
    assert [int(t[0]) for t in _mesh.ppermute(xs, mesh)] == [3, 0, 1, 2]
    sends = [torch.arange(8, dtype=torch.int32).reshape(4, 2) + 100 * r for r in range(4)]
    recv = _mesh.all_to_all(sends, mesh)
    for d in range(4):
        for s in range(4):
            assert torch.equal(recv[d][s], sends[s][d])
    x = torch.arange(12)
    assert [s.tolist() for s in _mesh.shard(x, mesh)] == [[0, 1, 2], [3, 4, 5],
                                                         [6, 7, 8], [9, 10, 11]]
    with pytest.raises(ValueError, match="equal shards"):
        _mesh.shard(torch.arange(13), mesh)


# ---------------------------------------------------------------------------
# the distributed histograms


@pytest.mark.parametrize("pass_index,radix_bits", [(0, 8), (3, 8), (2, 11), (0, 16)])
def test_global_digit_histogram(pass_index, radix_bits):
    x = rng_of(pass_index).integers(0, 1 << 32, size=N, dtype=np.uint32)
    want = jpar.global_digit_histogram(jnp.asarray(x), jmesh(), pass_index=pass_index,
                                       radix_bits=radix_bits)
    got = tpar.global_digit_histogram(x, tmesh(), pass_index=pass_index,
                                      radix_bits=radix_bits)
    assert got.dtype == torch.int32
    same(got, want)


def test_global_digit_histogram_bad_pass():
    with pytest.raises(ValueError, match="out of range"):
        tpar.global_digit_histogram(np.zeros(64, np.uint32), tmesh(), pass_index=4)


@pytest.mark.parametrize("D", [2, 8])
def test_global_live_bit_mask(D):
    base = np.uint32(0x90000001)
    x = ((rng_of(D).integers(0, 16, size=N, dtype=np.uint32) << 12) | base).astype(np.uint32)
    got = tpar.global_live_bit_mask(x, tmesh(D))
    assert got.dtype == torch.uint32 and int(got) == 0xF000
    same(got, jpar.global_live_bit_mask(jnp.asarray(x), jmesh(D)))
    eq = np.full(N, 0xFFFFFFFF, np.uint32)
    assert int(tpar.global_live_bit_mask(eq, tmesh(D))) == 0


@pytest.mark.parametrize("length", [1000, 1 << 19, 3])
@pytest.mark.parametrize("n", [N, NR])
def test_distributed_bincount(length, n):
    r = rng_of(length + n)
    x = r.integers(0, length, size=n).astype(np.int32)
    x[::97] = r.integers(length, length + 50, size=x[::97].size)   # out of range
    x[::101] = -3                                                  # negatives drop too
    want = jpar.distributed_bincount(jnp.asarray(x), jmesh(), length)
    got = tpar.distributed_bincount(x, tmesh(), length)
    same(got, want)
    keep = (x >= 0) & (x < length)
    assert np.array_equal(host(got), np.bincount(x[keep], minlength=length))
    assert torch.equal(tpar.distributed_bincount(torch.from_numpy(x), tmesh(), length), got)


# ---------------------------------------------------------------------------
# the payload codec


def test_payload_codec_round_trip():
    r = rng_of(5)
    n = 9
    tree = {"i64": r.integers(-2**62, 2**62, size=n, dtype=np.int64),
            "f16": r.standard_normal(n).astype(np.float16),
            "bf16": r.standard_normal(n).astype(ml_dtypes.bfloat16),
            "pair": (r.integers(0, 2, size=n).astype(np.bool_),
                     torch.from_numpy(r.integers(-100, 100, size=n).astype(np.int8))),
            "name": r.integers(0, 256, size=(n, 5), dtype=np.uint8).view("S5").reshape(-1),
            "none": None}
    planes, ctx = _payload.encode_payload_tree(tree, n, torch.device("cpu"))
    assert all(p.dtype == torch.int32 and p.shape == (n,) for p in planes)
    assert len(planes) == 2 + 1 + 1 + 1 + 1 + 2
    split = [tuple(p[:4] for p in planes), tuple(p[4:] for p in planes)]
    out = _payload.decode_payload_tree(split, ctx)
    assert out["none"] is None
    same(out["i64"], tree["i64"])
    same(out["f16"], tree["f16"])
    same(out["bf16"], tree["bf16"])
    same(out["pair"][0], tree["pair"][0])
    same(out["pair"][1], tree["pair"][1].numpy())
    assert np.array_equal(host(out["name"]).view("S5").reshape(-1), tree["name"])
    with pytest.raises(ValueError, match="share the key length"):
        _payload.encode_payload_tree({"a": np.zeros(3, np.int32)}, 4, torch.device("cpu"))


# ---------------------------------------------------------------------------
# the shuffle


def _inputs():
    r = rng_of(0x5EED)
    skew = np.concatenate([np.full(N * 9 // 10, 0x0000BEEF, np.uint32),
                           r.integers(0, 1 << 32, size=N - N * 9 // 10, dtype=np.uint32)])
    r.shuffle(skew)
    return {
        "uniform": r.integers(0, 1 << 32, size=N, dtype=np.uint32),
        "narrow": (np.uint32(0x12340000) + r.integers(0, 1 << 10, size=N)).astype(np.uint32),
        "presorted": np.arange(N, dtype=np.uint32) * np.uint32(7),
        "reversed": (np.arange(N, dtype=np.uint32) * np.uint32(13))[::-1].copy(),
        "all_equal": np.full(N, 0xABCD1234, np.uint32),
        "two_values": r.integers(0, 2, size=N, dtype=np.uint32),
        "skewed": skew,
        "ragged": r.integers(0, 1 << 32, size=NR, dtype=np.uint32),
        "ragged_max": np.concatenate([r.integers(0, 1 << 32, size=NR - 100, dtype=np.uint32),
                                      np.full(100, 0xFFFFFFFF, np.uint32)]),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name,exact", [(name, False) for name in INPUTS]
                         + [(name, True) for name in ("two_values", "skewed", "ragged_max")])
def test_shuffle_u32(name, exact):
    x = INPUTS[name]
    want = _jit(jpar.distributed_sort_u32, x, mesh=jmesh(), exact=exact)
    got = tpar.distributed_sort_u32(x, tmesh(), exact=exact)
    assert got[0][0].dtype == torch.uint32 and len(got[0]) == 8
    same_all(got, want)
    if int(host(got[2])[0]) == 0:
        assert np.array_equal(tpar.gather_sorted(*got), np.sort(x))


def test_shuffle_overflow_then_exact():
    # two values on 8 ranks: two ranks receive ~n/2 each, past the default
    # capacity; the flag says so, and exact=True sorts it
    x = INPUTS["two_values"]
    sp, counts, ovf = tpar.distributed_sort_u32(x, tmesh())
    assert int(host(ovf)[0]) != 0
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        tpar.gather_sorted(sp, counts, ovf)
    out = tpar.gather_sorted(*tpar.distributed_sort_u32(x, tmesh(), exact=True))
    assert np.array_equal(out, np.sort(x))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", ["uniform", "ragged", "skewed"])
def test_shuffle_u32_mesh_sizes(D, name):
    x = INPUTS[name]
    same_all(tpar.distributed_sort_u32(x, tmesh(D)),
             _jit(jpar.distributed_sort_u32, x, mesh=jmesh(D)))


@pytest.mark.parametrize("name", ["uniform", "ragged", "all_equal", "skewed"])
def test_shuffle_rdma_exchange(name):
    # the port's K13 route (its plain version here) against the JAX "xla"
    # exchange, which the JAX package's tests hold equal to its own "rdma"
    x = INPUTS[name]
    want = _jit(jpar.distributed_sort_u32, x, mesh=jmesh(), exact=False)
    same_all(tpar.distributed_sort_u32(x, tmesh(), exchange="rdma"), want)
    same_all(tpar.distributed_sort_u32(x, tmesh(), exchange="rdma", exact=True),
             _jit(jpar.distributed_sort_u32, x, mesh=jmesh(), exact=True))


def test_shuffle_too_small_and_bad_exchange():
    with pytest.raises(ValueError, match="too small"):
        tpar.distributed_sort_u32(np.zeros(63, np.uint32), tmesh())
    with pytest.raises(ValueError, match="exchange must be"):
        tpar.distributed_sort_u32(np.zeros(64, np.uint32), tmesh(), exchange="nccl")
    with pytest.raises(TypeError, match="does not accept"):
        tpar.distributed_sort(np.zeros(64, np.uint32), tmesh(), method="balanced", exact=True)
    with pytest.raises(ValueError, match="unknown method"):
        tpar.distributed_sort(np.zeros(64, np.uint32), tmesh(), method="radix")


def test_shuffle_argsort_and_pairs_u32():
    x = (INPUTS["ragged"] & np.uint32(0xFF)).astype(np.uint32)     # ties: stability shows
    pay = rng_of(3).integers(0, 1 << 32, size=NR, dtype=np.uint32)
    same_all(tpar.distributed_argsort_u32(x, tmesh()),
             jpar.distributed_argsort_u32(jnp.asarray(x), jmesh()))
    got = tpar.distributed_sort_pairs_u32(x, pay, tmesh())
    same_all(got, jpar.distributed_sort_pairs_u32(jnp.asarray(x), jnp.asarray(pay), jmesh()))
    order = np.argsort(x, kind="stable")
    assert np.array_equal(tpar.gather_sorted(got[1], got[2], got[3]), pay[order])


def _generic_keys():
    r = rng_of(64)
    f32 = r.standard_normal(NR).astype(np.float32)
    f32[::50] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)[
        np.arange(f32[::50].size) % 5]
    return {
        "u64": r.integers(0, 1 << 64, size=NR, dtype=np.uint64),
        "i64": r.integers(-2**63, 2**63 - 1, size=NR, dtype=np.int64),
        "i32": r.integers(-2**31, 2**31 - 1, size=NR, dtype=np.int64).astype(np.int32),
        "f32": f32,
        "u16": r.integers(0, 1 << 16, size=NR, dtype=np.uint16),
    }


GENERIC = _generic_keys()


_JITTED = {}


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` of the JAX package under jit, the keyword
    arguments (the mesh among them) static. One jitted function per (fn,
    kw), so that a second call of the same shapes compiles nothing."""
    key = (fn, tuple((k, tuple(v) if isinstance(v, list) else v)
                     for k, v in sorted(kw.items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda *a: fn(*a, **kw))
    return _JITTED[key](*(jnp.asarray(a) for a in args))


def _jax_sort(x, mesh, fn=jpar.distributed_sort, **kw):
    """The JAX entry point: jitted for 32-bit keys, eager for 64-bit numpy
    keys, which it splits on the host (x64 is off)."""
    if x.dtype.itemsize == 8:
        return fn(x, mesh, **kw)
    return _jit(fn, x, mesh=mesh, **kw)


@pytest.mark.parametrize("dtype,descending", [("u64", True), ("i32", True),
                                              ("f32", False), ("u16", True)])
def test_shuffle_generic_dtypes(dtype, descending):
    x = GENERIC[dtype]
    kw = dict(descending=descending, method="shuffle", exact=True)
    want = _jax_sort(x, jmesh(), **kw)
    got = tpar.distributed_sort(x, tmesh(), **kw)
    same_all(got, want)
    out = tpar.gather_sorted(*got)
    ref = np.sort(x)[::-1] if descending else np.sort(x)
    assert np.array_equal(bits(out), bits(ref)) or dtype == "f32"


def test_shuffle_generic_argsort_and_pytree_pairs():
    # i32 keys with ties (stability shows) and a payload tree; the 64-bit
    # payload leaves ride the balanced method's test (tests/test_torch_balanced.py)
    x = (GENERIC["i64"] % 50).astype(np.int32)
    r = rng_of(7)
    vals = {"a": r.integers(-2**31, 2**31 - 1, size=NR, dtype=np.int64).astype(np.int32),
            "b": (r.standard_normal(NR).astype(np.float32),
                  r.integers(-1000, 1000, size=NR).astype(np.int16))}
    kw = dict(method="shuffle", exact=True)
    same_all(tpar.distributed_argsort(x, tmesh(), descending=True, **kw),
             _jax_sort(x, jmesh(), jpar.distributed_argsort, descending=True, **kw))
    got = tpar.distributed_sort_pairs(x, vals, tmesh(), **kw)
    want = jax.jit(lambda k, v: jpar.distributed_sort_pairs(k, v, jmesh(), **kw))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, vals))   # a tree: jitted here
    same(got[0], want[0])
    same(got[1]["a"], want[1]["a"])
    same(got[1]["b"][0], want[1]["b"][0])
    same(got[1]["b"][1], want[1]["b"][1])
    same_all(got[2:], want[2:])
    order = np.argsort(x, kind="stable")
    assert np.array_equal(tpar.gather_sorted(got[1]["a"], got[2]), vals["a"][order])
    # tensor keys and payloads work the same, shard by shard
    got_t = tpar.distributed_sort_pairs(torch.from_numpy(x), {"a": torch.from_numpy(
        vals["a"])}, tmesh(), **kw)
    same(got_t[1]["a"], want[1]["a"])


def test_dryrun_multichip_on_cpu_ranks():
    from radix_sorting_tpu_torch.parallel.dryrun import dryrun_multichip
    records = dryrun_multichip(tmesh(4), n=20_000, n_rest=8_000, log=None,
                               default_mesh=False)
    assert len(records) == 17
    assert all(r["launches"] == {} and r["peak_mb"] is None for r in records)
