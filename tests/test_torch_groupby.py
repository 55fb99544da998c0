"""The group-by slice of the port against the JAX package.

K10 (``whist``) and K11 (``whist_f32``) as plain versions on CPU tensors,
against the Pallas kernels run in interpret mode and called directly:

  whist      vs  pk.weighted_histogram_tpu             (K10, planes recombined)
  whist_f32  vs  pk.weighted_histogram_f32_tpu         (K11, sums)
  whist_f32  vs  pk.weighted_histogram_f32_counts_tpu  (K11, counts and sums)

then ``group_reduce``, ``value_counts`` and ``unique_sorted``, each on the
JAX package's CPU routes and under ``RST_FORCE_TPU_ROUTES=1``, where both
packages take the kernels' routes and the routes are compared; the bench's
group-by case; and the non-finite values of ROADMAP.md §3, R2.

Tolerances: keys, counts, group counts, integer sums and min / max are
exact, and so are means of integer values (one division of an exact sum).
f32 sums of the dense tier (K11, or the JAX package's CPU ``segment_sum``)
are within sum|v| * 2^-14 + 1e-5 per group of a float64
sum; f32 sums of the sort-native route (prefix-sum differences, which torch
and XLA associate differently) within sum|v| * 2^-10 + sum|all v| * 2^-20 +
1e-5, the bound of tests/test_forced_routes.py; float64 sums within
sum|all v| * 2^-40. A mean is held to its sum's bound over the group's size,
plus 2^-22 of itself for the division.
"""

import ml_dtypes
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu import extras as jextras
from radix_sorting_tpu.ops import pallas_kernels as pk
from radix_sorting_tpu_torch import extras as textras
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import kdf as tkdf

from test_torch_kernels import plane
from test_torch_kdf import make_keys, raw
from test_torch_sort import forced_tpu_routes, jax_in  # noqa: F401  (class fixture)


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


def np_dtype(name):
    return np.dtype(getattr(ml_dtypes, name, None) or name)


# ---------------------------------------------------------------------------
# K10, K11: plain versions against the Pallas kernels


@pytest.mark.usefixtures("forced_tpu_routes")
class TestWeightedHistogramKernels:

    @pytest.mark.parametrize("value_bytes", [1, 2, 4])
    @pytest.mark.parametrize("radix_bits", [2, 10, 14, 16, 17])
    def test_whist_matches_pallas(self, radix_bits, value_bytes):
        n, bins = 30_011, 1 << radix_bits
        rng = rng_of(radix_bits * 8 + value_bytes)
        k = rng.integers(0, bins, size=n).astype(np.uint32)
        k[::37] = rng.integers(bins, 1 << 32, size=k[::37].size)  # past drop_ge
        drop_ge = bins - bins // 4                     # and the top quarter
        v = rng.integers(0, 1 << (8 * value_bytes), size=n, dtype=np.uint64).astype(np.uint32)
        planes = np.asarray(pk.weighted_histogram_tpu(jnp.asarray(k), jnp.asarray(v),
                                                      radix_bits, value_bytes, drop_ge))
        want = sum(planes[p + 1].astype(np.uint32) << np.uint32(8 * p)
                   for p in range(value_bytes)).astype(np.uint32)
        counts, sums = ck.whist(plane(k), plane(v), radix_bits, drop_ge)
        assert counts.dtype == sums.dtype == torch.int32
        assert np.array_equal(counts.numpy(), planes[0])
        assert np.array_equal(sums.numpy().view(np.uint32), want)
        keep = k < drop_ge
        assert int(counts.sum()) == int(keep.sum())
        assert np.array_equal(want, np.bincount(k[keep], weights=v[keep].astype(np.float64),
                                                minlength=bins).astype(np.uint64)
                              .astype(np.uint32))

    @pytest.mark.parametrize("with_counts", [False, True])
    @pytest.mark.parametrize("radix_bits", [2, 10])
    def test_whist_f32_matches_pallas(self, radix_bits, with_counts):
        n, bins = 40_000, 1 << radix_bits
        rng = rng_of(radix_bits + 100 * with_counts)
        k = rng.integers(0, bins + bins // 2, size=n).astype(np.uint32)
        w = (rng.standard_normal(n) * 100).astype(np.float32)
        drop_ge = bins - 1
        if with_counts:
            jc, js = pk.weighted_histogram_f32_counts_tpu(jnp.asarray(k), jnp.asarray(w),
                                                          radix_bits, drop_ge)
            c, s = ck.whist_f32(plane(k), torch.from_numpy(w), radix_bits, drop_ge, True)
            assert c.dtype == torch.int32 and np.array_equal(c.numpy(), np.asarray(jc))
        else:
            js = pk.weighted_histogram_f32_tpu(jnp.asarray(k), jnp.asarray(w), radix_bits,
                                               drop_ge)
            s = ck.whist_f32(plane(k), torch.from_numpy(w), radix_bits, drop_ge)
        keep = k < drop_ge
        ref = np.bincount(k[keep], weights=w[keep].astype(np.float64), minlength=bins)
        bound = np.bincount(k[keep], weights=np.abs(w[keep]).astype(np.float64),
                            minlength=bins) * 2**-14 + 1e-5
        assert s.dtype == torch.float32
        assert np.all(np.abs(s.numpy().astype(np.float64) - ref) <= bound)
        assert np.all(np.abs(np.asarray(js).astype(np.float64) - ref) <= bound)
        assert np.all(np.abs(s.numpy().astype(np.float64) - np.asarray(js)) <= 2 * bound)


def test_whist_plain_versions_count_no_launches():
    before = ck.launch_counts()
    k = plane(rng_of(1).integers(0, 1 << 10, size=5000).astype(np.uint32))
    ck.whist(k, k, 10, 1 << 10)
    ck.whist_f32(k, k.float(), 10, 1000)
    ck.whist_f32(k, k.float(), 10, 1000, with_counts=True)
    assert ck.launch_counts() == before


_I32 = torch.zeros(8, dtype=torch.int32)


@pytest.mark.parametrize("bad,exc", [
    (lambda: ck.whist(_I32, _I32, 1, 2), ValueError),
    (lambda: ck.whist(_I32, _I32, 18, 2), ValueError),
    (lambda: ck.whist(_I32, _I32, 4, 17), ValueError),
    (lambda: ck.whist(_I32, _I32, 4, -1), ValueError),
    (lambda: ck.whist(_I32, _I32[:7], 4, 16), ValueError),
    (lambda: ck.whist(_I32, _I32.float(), 4, 16), TypeError),
    (lambda: ck.whist(_I32.long(), _I32, 4, 16), TypeError),
    (lambda: ck.whist_f32(_I32, _I32, 4, 16), TypeError),
    (lambda: ck.whist_f32(_I32, torch.zeros(16)[::2], 4, 16), ValueError),
])
def test_whist_wrappers_reject_bad_inputs(bad, exc):
    with pytest.raises(exc):
        bad()


# ---------------------------------------------------------------------------
# group_reduce against the JAX package

# key dtype -> (how keys are drawn, groups): some keys fall outside [0, G)
KEYS = {"uint8": (lambda r, n: r.integers(0, 256, n), 200),
        "int16": (lambda r, n: r.integers(-40, 600, n), 512),
        "uint32": (lambda r, n: r.integers(0, 1100, n), 1024),
        "int32": (lambda r, n: r.integers(0, 300, n), 300),
        "bool": (lambda r, n: r.integers(0, 2, n), 2),
        "uint64": (lambda r, n: r.integers(0, 500, n).astype(np.uint64)
                   * np.uint64(0x9E3779B97F4A7C15), None)}
VALUES = ["int8", "uint16", "int32", "uint32", "bool", "float32", "float16", "bfloat16",
          "int64", "float64"]
REDUCES = ["sum", "mean", "min", "max"]


def group_keys(name, n, seed):
    draw, groups = KEYS[name]
    k = np.asarray(draw(rng_of(seed), n))
    return (k.astype(np.uint64) if name == "uint64" else k).astype(np_dtype(name)), groups


def group_values(name, n, seed):
    """Finite values: random bits for integers, scaled normals for floats."""
    dt, rng = np_dtype(name), rng_of(seed)
    if name in ("float16", "bfloat16", "float32", "float64"):
        return (rng.standard_normal(n) * 100).astype(dt)
    return make_keys(name, n, rng)


def oracle(k, v, ukeys):
    """float64 sum, sum|v| and size of each group, in ``ukeys``' order."""
    kr = raw(k).astype(np.uint64)
    uniq, inv = np.unique(kr, return_inverse=True)
    v64 = v.astype(np.float64)
    at = np.searchsorted(uniq, raw(ukeys).astype(np.uint64))
    return (np.bincount(inv, v64)[at], np.bincount(inv, np.abs(v64))[at],
            np.bincount(inv)[at])


def assert_float_close(got, want_sum, absum, size, total, dense, reduce, wide):
    """``got`` sums or means within the module's bounds of the oracle."""
    if wide:
        bound = total * 2**-40 + 1e-9
    elif dense:
        bound = absum * 2**-14 + 1e-5
    else:
        bound = absum * 2**-10 + total * 2**-20 + 1e-5
    got = got.astype(np.float64)
    if reduce == "mean":
        want = want_sum / size
        assert np.all(np.abs(got - want) <= bound / size + np.abs(want) * 2**-22)
    else:
        assert np.all(np.abs(got - want_sum) <= bound)


def check_group_reduce(k, v, reduce, groups=None, desc=False, size=None, **kw):
    """Both packages on the same keys and values: keys, group counts,
    integer results and min / max exact; float sums and means to bound."""
    jcfg, tcfg = rst.SortConfig(descending=desc), rt.SortConfig(descending=desc)
    ju, jr, jn = rst.group_reduce(jax_in(k), jax_in(v), reduce=reduce, groups=groups,
                                  size=size, config=jcfg, **kw)
    tu, tr, tn = rt.group_reduce(k, v, reduce=reduce, groups=groups, size=size,
                                 config=tcfg, device="cpu", **kw)
    ju, jr = np.asarray(ju), np.asarray(jr)
    assert isinstance(tu, np.ndarray) and isinstance(tr, np.ndarray)
    assert tu.dtype == ju.dtype and tr.dtype == jr.dtype and tr.shape == jr.shape
    assert np.array_equal(raw(tu), raw(ju))
    m = int(jn)
    assert int(tn) == m
    if reduce in ("min", "max") and tkdf.kind(np.asarray(v).dtype) == "f":
        # the JAX package's bf16 select canonicalises NaN payloads; the port
        # keeps them (test_min_max_follow_the_total_order holds its bits)
        with np.errstate(invalid="ignore"):
            nan = np.isnan(jr)
            assert np.array_equal(np.isnan(tr), nan)
        assert np.array_equal(raw(tr)[~nan], raw(jr)[~nan])
        return tu, tr, m
    if reduce in ("min", "max") or tkdf.kind(np.asarray(v).dtype) != "f":
        # integer sums wrap exactly, and a mean is one f32 (f64) division
        assert np.array_equal(raw(tr), raw(jr))
        return tu, tr, m
    assert np.all(tr[m:] == 0) and np.all(jr[m:] == 0)
    total = np.abs(np.asarray(v, np.float64)).sum()
    wide = np.asarray(v).dtype.itemsize == 8
    # more groups than slots: the last slot's run reaches the end of the
    # sorted array, in both packages
    kept = min(m, tr.shape[0] - 1) if m > tr.shape[0] else m
    if kept < min(m, tr.shape[0]):
        t, j = tr[kept:kept + 1].astype(np.float64), jr[kept:kept + 1].astype(np.float64)
        assert np.all(np.abs(t - j) <= total * (2**-40 if wide else 2**-20) + 1e-5)
    want, absum, sizes = oracle(k, v, tu[:kept])
    dense = groups is not None and np.asarray(v).dtype.itemsize < 8
    for got in (tr[:kept], jr[:kept]):
        assert_float_close(got, want, absum, sizes, total, dense, reduce, wide)
    return tu, tr, m


# every value dtype under u32 keys, an integer and a float under the others
PAIRS = ([("uint32", v) for v in VALUES]
         + [(k, v) for k in KEYS if k != "uint32" for v in ("int8", "float32")])
N = 3001             # one length for most cases: the JAX package compiles per shape


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("kname,vname", PAIRS)
def test_group_reduce_matches_jax(kname, vname, grouped):
    n = N
    k, groups = group_keys(kname, n, len(kname))
    v = group_values(vname, n, len(vname))
    if grouped and groups is None:          # numpy 64-bit keys: no dense promise
        for call in (lambda: rst.group_reduce(k, jax_in(v), groups=16),
                     lambda: rt.group_reduce(k, v, groups=16, device="cpu")):
            with pytest.raises(TypeError):
                call()
        return
    for reduce in REDUCES:
        check_group_reduce(k, v, reduce, groups if grouped else None)


@pytest.fixture
def groupby_routes(monkeypatch):
    """Record the tier each package takes (dense / dense_f32; nothing for
    the sort-native route) and the kernel contracts it reaches."""
    seen = {"jax": [], "port": []}

    def spy(module, attr, who, label):
        real = getattr(module, attr)

        def wrapped(*a, **k):
            seen[who].append(label(*a, **k) if callable(label) else label)
            return real(*a, **k)
        monkeypatch.setattr(module, attr, wrapped)

    for who, mod in (("jax", jextras), ("port", textras)):
        spy(mod, "_group_reduce_dense", who, "dense")
        spy(mod, "_group_reduce_dense_f32", who, "dense_f32")
    spy(pk, "weighted_histogram_tpu", "jax", "whist")
    spy(pk, "weighted_histogram_f32_counts_tpu", "jax", "whist_f32_counts")
    spy(pk, "weighted_histogram_f32_tpu", "jax", "whist_f32")
    spy(pk, "histogram_tpu", "jax", "hist")
    spy(ck, "whist", "port", "whist")
    spy(ck, "whist_f32", "port",
        lambda *a, **k: "whist_f32_counts" if (a[4:] or [k.get("with_counts")])[0]
        else "whist_f32")
    spy(ck, "hist", "port", "hist")
    return seen


TIERS = ("dense", "dense_f32")


@pytest.mark.parametrize("vname,tier", [("int8", "dense"), ("uint32", "dense"),
                                        ("bool", "dense"), ("float32", "dense_f32"),
                                        ("bfloat16", "dense_f32"), ("int64", None),
                                        ("float64", None)])
def test_group_reduce_routes_unforced(groupby_routes, vname, tier):
    k, groups = group_keys("uint32", N, 1)
    v = group_values(vname, N, 2)
    for reduce in REDUCES:
        check_group_reduce(k, v, reduce, groups)
    jax_tiers = [r for r in groupby_routes["jax"] if r in TIERS]
    port_tiers = [r for r in groupby_routes["port"] if r in TIERS]
    assert jax_tiers == port_tiers == ([tier] * 2 if tier else [])


@pytest.mark.usefixtures("forced_tpu_routes")
class TestForcedGroupBy:

    @pytest.mark.parametrize("kname,vname", [
        ("uint32", v) for v in ("int8", "uint16", "int32", "uint32", "bool", "float32",
                                "float16", "bfloat16")] + [
        (k, v) for k in ("uint8", "int16", "bool") for v in ("int8", "float32")])
    def test_dense_tiers(self, groupby_routes, kname, vname):
        n = 20_011
        k, groups = group_keys(kname, n, 7)
        v = group_values(vname, n, 8)
        for reduce in ("sum", "mean"):
            check_group_reduce(k, v, reduce, groups)
        f = np_dtype(vname).kind == "f" or vname == "bfloat16"
        tier, kernel = ("dense_f32", "whist_f32_counts") if f else ("dense", "whist")
        assert groupby_routes["port"] == groupby_routes["jax"] == [tier, kernel] * 2

    @pytest.mark.parametrize("reduce", REDUCES)
    def test_wide_promise_and_min_max_sort(self, groupby_routes, reduce):
        # u8 values at 2^16 groups fit the integer gate, i32 values do not
        k = rng_of(3).integers(0, 40_000, size=30_011).astype(np.uint32)
        for vname in ("uint8", "int32"):
            check_group_reduce(k, group_values(vname, k.size, 4), reduce, 40_000)
        want = ["dense", "whist"] if reduce in ("sum", "mean") else []
        assert groupby_routes["port"] == groupby_routes["jax"] == want

    @pytest.mark.parametrize("groups,route", [(3, []), (1000, ["hist"])])
    def test_value_counts_groups(self, groupby_routes, groups, route):
        k = rng_of(groups).integers(0, groups + 2, size=20_011).astype(np.int32)
        jv, jc, jn = rst.value_counts(jnp.asarray(k), groups=groups)
        tv, tc, tn = rt.value_counts(k, groups=groups, device="cpu")
        assert np.array_equal(tv, np.asarray(jv)) and np.array_equal(tc, np.asarray(jc))
        assert int(tn) == int(jn)
        assert groupby_routes["port"] == groupby_routes["jax"] == route

    def test_r2_forced_route_poisons_every_group(self):
        # the JAX package's TPU route: one inf makes every group's sum NaN
        # (the bf16x2 split's inf - inf), where the port keeps it to its own
        # group (test_r2_non_finite_values_stay_in_their_group)
        k, v = r2_input()
        _, jr, jn = rst.group_reduce(jnp.asarray(k), jnp.asarray(v), groups=64)
        assert np.isnan(np.asarray(jr)[: int(jn)]).all()


# ---------------------------------------------------------------------------
# the contract's edges


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("size", [5, 40, 400])
@pytest.mark.parametrize("desc", [False, True])
def test_group_reduce_descending_and_sizes(desc, size, grouped):
    k = rng_of(size).integers(0, 150, size=N).astype(np.int16)
    for vname in ("int32", "float32"):
        v = group_values(vname, k.size, 5)
        for reduce in REDUCES:
            check_group_reduce(k, v, reduce, 150 if grouped else None, desc=desc, size=size)


@pytest.mark.parametrize("kname", ["uint8", "int32", "uint64"])
@pytest.mark.parametrize("vname", ["int8", "uint16", "bool", "float32", "int64", "float64"])
def test_group_reduce_empty(kname, vname):
    k = np.zeros(0, np_dtype(kname))
    v = np.zeros(0, np_dtype(vname))
    groups = None if kname == "uint64" else 16
    for reduce in REDUCES:
        tu, tr, tn = check_group_reduce(k, v, reduce, groups, size=4)
        assert tn == 0 and tu.shape == tr.shape == (4,)


def test_group_reduce_validate():
    k = rng_of(5).integers(0, 9, size=N).astype(np.uint32)
    k[7] = 9
    v = np.ones(N, np.int32)
    for call in (lambda: rst.group_reduce(jnp.asarray(k), jnp.asarray(v), groups=9,
                                          validate=True),
                 lambda: rt.group_reduce(k, v, groups=9, validate=True, device="cpu"),
                 lambda: rt.group_reduce(torch.from_numpy(k.view(np.int32)), v, groups=4,
                                         validate=True)):
        with pytest.raises(ValueError, match="outside"):
            call()
    check_group_reduce(k, v, "sum", 10, validate=True)
    check_group_reduce(k.astype(np.int8) - 1, v, "sum", 8)    # -1 dropped


@pytest.mark.parametrize("call,exc", [
    (lambda m: m.group_reduce(np.zeros(3, np.uint8), np.zeros(3, np.int32), reduce="prod"),
     ValueError),
    (lambda m: m.group_reduce(np.zeros(3, np.uint8), np.zeros(3, np.int32), groups=0),
     ValueError),
    (lambda m: m.group_reduce(np.zeros(3, np.float32), np.zeros(3, np.int32), groups=4),
     TypeError),
    (lambda m: m.group_reduce(np.zeros(3, np.uint8), np.zeros(4, np.int32)), ValueError),
    (lambda m: m.value_counts(np.zeros((2, 2), np.uint8)), ValueError),
    (lambda m: m.value_counts(np.zeros(3, np.float32), groups=4), TypeError),
    (lambda m: m.unique_sorted(np.zeros((2, 2), np.uint8)), ValueError),
])
def test_errors_match_jax(call, exc):
    with pytest.raises(exc):
        call(rst)
    with pytest.raises(exc):
        call(PortOnCpu)


class PortOnCpu:
    """The port's entry points with ``device="cpu"``, for the error table."""

    @staticmethod
    def group_reduce(*a, **k):
        return rt.group_reduce(*a, device="cpu", **k)

    @staticmethod
    def value_counts(*a, **k):
        return rt.value_counts(*a, device="cpu", **k)

    @staticmethod
    def unique_sorted(*a, **k):
        return rt.unique_sorted(*a, device="cpu", **k)


def kdf_extreme(bits, reduce):
    """min or max of raw float bits under the KDF total order, as raw bits."""
    top = bits.dtype.type(1) << bits.dtype.type(8 * bits.dtype.itemsize - 1)
    key = np.where(bits & top, ~bits, bits | top)
    e = key.min() if reduce == "min" else key.max()
    return e ^ top if e & top else ~e


def test_min_max_follow_the_total_order():
    # +-0, +-inf and NaN payloads among the values: min / max are the KDF
    # order's boundary elements, bit for bit, NaN payloads included
    k = rng_of(9).integers(0, 40, size=N).astype(np.uint8)
    for vname in ("float32", "bfloat16", "float64"):
        v = make_keys(vname, k.size, rng_of(10))
        for reduce in ("min", "max"):
            check_group_reduce(k, v, reduce, 40)
            tu, tr, m = check_group_reduce(k, v, reduce)
            want = [kdf_extreme(raw(v)[k == g], reduce) for g in tu[:m]]
            assert np.array_equal(raw(tr)[:m], np.array(want, raw(v).dtype))


def test_tensor_inputs_give_tensors():
    k = rng_of(2).integers(0, 100, size=N).astype(np.int32)
    v = rng_of(3).integers(-9, 9, size=N).astype(np.int32)
    want = rt.group_reduce(k, v, groups=100, device="cpu")
    got = rt.group_reduce(torch.from_numpy(k), torch.from_numpy(v), groups=100)
    assert all(torch.is_tensor(t) for t in got)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    got = rt.group_reduce(torch.from_numpy(k), v, reduce="max")   # numpy values follow
    assert torch.is_tensor(got[1])
    with pytest.raises(ValueError, match="device"):
        rt.group_reduce(torch.from_numpy(k), torch.from_numpy(v).to("meta"))


# ---------------------------------------------------------------------------
# value_counts, unique_sorted


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("name", ["bool", "uint8", "int16", "uint16", "bfloat16", "uint32",
                                  "float32", "uint64", "float64", "S4"])
def test_value_counts_and_unique_sorted_match_jax(name, desc):
    x = make_keys(name, N, rng_of(len(name)))
    if x.dtype.kind in "biu" and x.dtype.itemsize > 1:
        x = (raw(x) % np.asarray(300, raw(x).dtype)).view(x.dtype)    # duplicates
    jcfg, tcfg = rst.SortConfig(descending=desc), rt.SortConfig(descending=desc)
    for size in (None, 7):
        want = rst.value_counts(jax_in(x), size=size, config=jcfg)
        got = rt.value_counts(x, size=size, config=tcfg, device="cpu")
        assert all(isinstance(g, np.ndarray) for g in got)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(raw(g), raw(w))
        if x.dtype.kind == "S":
            continue                     # the JAX package's unique_sorted: no S keys
        want = rst.unique_sorted(jax_in(x), size=size, config=jcfg)
        got = rt.unique_sorted(x, size=size, config=tcfg, device="cpu")
        assert np.array_equal(raw(got[0]), raw(np.asarray(want[0])))
        assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("groups", [2, 256, 1000, (1 << 17) + 1])
@pytest.mark.parametrize("desc", [False, True])
def test_value_counts_groups_match_jax(groups, desc):
    x = rng_of(groups).integers(0, min(groups, 2000) + 3, size=5003).astype(np.uint32)
    jcfg, tcfg = rst.SortConfig(descending=desc), rt.SortConfig(descending=desc)
    want = rst.value_counts(jnp.asarray(x), groups=groups, config=jcfg)
    got = rt.value_counts(x, groups=groups, config=tcfg, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("name", ["uint8", "uint16", "int32"])
def test_unique_sorted_empty_and_tensor(name):
    x = np.zeros(0, np_dtype(name))
    v, c = rt.unique_sorted(x, size=3, device="cpu")
    jv, jc = rst.unique_sorted(jnp.asarray(x), size=3)
    assert v.dtype == np.asarray(jv).dtype and np.array_equal(v, np.asarray(jv))
    assert int(c) == int(jc) == 0
    x = make_keys(name, N, rng_of(4))                # u8 / u16: the bitmap route
    tv, tc = rt.unique_sorted(torch.from_numpy(x.view(np.int16) if name == "uint16" else x)
                              .view(getattr(torch, name)), size=600)
    jv, jc = rst.unique_sorted(jnp.asarray(x), size=600)
    assert torch.is_tensor(tv) and int(tc) == int(jc)
    assert np.array_equal(tv.view(torch.int16 if name == "uint16" else tv.dtype).numpy()
                          .view(x.dtype), np.asarray(jv))


# ---------------------------------------------------------------------------
# the slice as a whole, and R2


def test_bench_group_by_case_matches_jax():
    # bench.py's group-by case (k = x & 1023, v = int32(x >> 10), 1,024
    # groups, size 1,024) at n = 200,000
    x = rng_of(20240601).integers(0, 1 << 32, size=200_000, dtype=np.uint32)
    k, v = x & np.uint32(1023), (x >> np.uint32(10)).astype(np.int32)
    ju, jr, jn = rst.group_reduce(jnp.asarray(k), jnp.asarray(v), reduce="sum",
                                  groups=1024, size=1024)
    tu, tr, tn = rt.group_reduce(k, v, reduce="sum", groups=1024, size=1024, device="cpu")
    assert np.array_equal(tu, np.asarray(ju)) and np.array_equal(tr, np.asarray(jr))
    assert int(tn) == int(jn) == 1024
    want = np.bincount(k, weights=v.astype(np.float64), minlength=1024)
    assert np.array_equal(tr, want.astype(np.int64).astype(np.uint32).view(np.int32))


def r2_input():
    k = rng_of(22).integers(0, 64, size=N).astype(np.uint32)
    v = (rng_of(23).standard_normal(k.size) * 10).astype(np.float32)
    k[:4] = [5, 5, 9, 17]
    v[:4] = [np.inf, -np.inf, np.nan, np.inf]      # group 5: inf - inf; 9: NaN; 17: inf
    return k, v


def test_r2_non_finite_values_stay_in_their_group():
    # ROADMAP.md §3, R2: the port's dense float tier poisons only the
    # groups that hold a non-finite value, as the JAX package's CPU route
    # (segment_sum) and np.add.at do; its TPU route poisons every group
    # (TestForcedGroupBy.test_r2_forced_route_poisons_every_group)
    k, v = r2_input()
    for reduce in ("sum", "mean"):
        ju, jr, jn = rst.group_reduce(jnp.asarray(k), jnp.asarray(v), reduce=reduce,
                                      groups=64)
        tu, tr, tn = rt.group_reduce(k, v, reduce=reduce, groups=64, device="cpu")
        jr = np.asarray(jr)
        assert np.array_equal(tu, np.asarray(ju)) and int(tn) == int(jn) == 64
        assert np.array_equal(np.isnan(tr), np.isnan(jr))
        assert np.array_equal(np.isinf(tr), np.isinf(jr))
        assert np.array_equal(tr[np.isinf(tr)], jr[np.isinf(jr)])
        assert np.flatnonzero(~np.isfinite(tr)).tolist() == [5, 9, 17]
        fin = np.isfinite(tr)
        assert np.allclose(tr[fin], jr[fin], rtol=1e-4, atol=1e-3)
