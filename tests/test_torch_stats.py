"""The port's ``stats`` against the JAX package (``radix_sorting_tpu.stats``).

``histogram`` (integer bins and edge arrays), ``histogram_bin_edges``,
``mode``, ``rankdata``, ``quantile`` / ``percentile`` / ``median``,
``digitize`` and ``partition`` / ``argpartition``. The same inputs (numpy,
from a seed) go to both packages, on the JAX package's CPU routes and under
``RST_FORCE_TPU_ROUTES=1``, where both take the kernels' routes (K1 for
counts, K11 for weighted sums) and the routes are compared. Tolerances:
edges, counts, densities of counts, modes, ranks, bin indices and
quantiles (interpolated ones too) are exact; weighted sums are within
sum|w| * 2^-14 + 1e-5 per bin of a float64 sum (K11: each bin a direct sum),
or sum|w| * 2^-10 + sum|all w| * 2^-20 + 1e-5 where the JAX package's CPU
route takes prefix-sum differences.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.stats as scipy_stats
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu import stats as jstats
from radix_sorting_tpu.ops import pallas_kernels as pk
from radix_sorting_tpu_torch.ops import cuda_kernels as ck

from test_torch_extras import jax_routes, routes, same  # noqa: F401  (fixtures)
from test_torch_groupby import N, rng_of
from test_torch_kdf import make_keys, raw
from test_torch_sort import forced_tpu_routes, jax_in  # noqa: F401  (class fixture)


def data(kind, seed, n=N):
    rng = rng_of(seed)
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "int":
        return rng.integers(-500, 500, size=n).astype(np.int32)
    if kind == "specials":
        x = (rng.standard_normal(n) * 3).astype(np.float32)
        x[:4] = [np.nan, np.inf, -np.inf, 0.0]
        return x
    return np.full(n, 2.5, np.float32)            # "constant": a degenerate range


def bin_index(x, edges, nb):
    """The bin of each value in numpy float32, as both packages compute it;
    nb for values outside the edges."""
    xf = x.astype(np.float32)
    lo, hi = np.float32(edges[0]), np.float32(edges[-1])
    with np.errstate(invalid="ignore"):
        idx = np.floor((xf - lo) * np.float32(nb / (edges[-1] - edges[0])))
        idx = np.where((xf >= lo) & (xf <= hi), np.minimum(idx, nb - 1), nb)
    return idx.astype(np.int64)


@pytest.mark.parametrize("range_", [None, (-2.0, 3.0)])
@pytest.mark.parametrize("bins", [1, 10, 256])
@pytest.mark.parametrize("kind", ["normal", "int", "constant"])
def test_bin_edges_match_jax(kind, bins, range_):
    x = data(kind, bins)
    want = jstats.histogram_bin_edges(jnp.asarray(x), bins, range_)
    got = rt.histogram_bin_edges(x, bins, range_, device="cpu")
    assert got.dtype == np.float64 and np.array_equal(got, want)


def test_bin_edges_of_nothing_and_errors():
    assert np.array_equal(rt.histogram_bin_edges(np.zeros(0, np.float32), 4, device="cpu"),
                          jstats.histogram_bin_edges(jnp.zeros(0), 4))
    for call in (lambda m: m(np.ones(3, np.float32), 0),
                 lambda m: m(np.ones(3, np.float32), 4, (1.0, 0.0))):
        with pytest.raises(ValueError):
            call(jstats.histogram_bin_edges)
        with pytest.raises(ValueError):
            call(lambda *a: rt.histogram_bin_edges(*a, device="cpu"))


@pytest.mark.parametrize("density", [False, True])
@pytest.mark.parametrize("bins,range_", [(10, None), (256, None), (3, (-1.0, 1.0)),
                                         (1000, (-4.0, 4.0))])
@pytest.mark.parametrize("kind", ["normal", "int", "specials"])
def test_histogram_counts_match_jax(kind, bins, range_, density):
    x = data(kind, bins + 1)
    if kind == "specials" and range_ is None:
        range_ = (-5.0, 5.0)             # NaN has no extent; the JAX package's is NaN
    jc, je = jstats.histogram(jnp.asarray(x), bins=bins, range=range_, density=density)
    c, e = rt.histogram(x, bins=bins, range=range_, density=density, device="cpu")
    jc = np.asarray(jc)
    assert np.array_equal(e, je) and c.dtype == jc.dtype and np.array_equal(c, jc)
    if not density:
        assert np.array_equal(c, np.bincount(bin_index(x, e, bins), minlength=bins + 1)[:-1])


def weighted_check(c, x, w, edges, nb, dense):
    idx = bin_index(x, edges, nb)
    w64 = w.astype(np.float64)
    ref = np.bincount(idx, w64, minlength=nb + 1)[:nb]
    absum = np.bincount(idx, np.abs(w64), minlength=nb + 1)[:nb]
    bound = absum * 2**-14 + 1e-5 if dense \
        else absum * 2**-10 + np.abs(w64).sum() * 2**-20 + 1e-5
    assert c.dtype == np.float32 and np.all(np.abs(c.astype(np.float64) - ref) <= bound)


@pytest.mark.parametrize("bins,range_", [(12, (-2.0, 2.0)), (1000, None), (70_000, None)])
def test_weighted_histogram_matches_jax(bins, range_):
    # 1000 bins: the port's K11 gate; 70,000: past it, group_reduce and an add
    x, w = data("normal", bins), data("normal", bins + 7) * 10
    jc, je = jstats.histogram(jnp.asarray(x), bins=bins, range=range_, weights=jnp.asarray(w))
    c, e = rt.histogram(x, bins=bins, range=range_, weights=w, device="cpu")
    assert np.array_equal(e, je)
    weighted_check(c, x, w, e, bins, dense=bins < 70_000)
    weighted_check(np.asarray(jc), x, w, e, bins, dense=False)
    jd, _ = jstats.histogram(jnp.asarray(x), bins=bins, range=range_, weights=jnp.asarray(w),
                             density=True)
    d, _ = rt.histogram(x, bins=bins, range=range_, weights=w, density=True, device="cpu")
    assert d.dtype == np.float32
    assert np.allclose(d, np.asarray(jd), rtol=1e-3, atol=1e-3 * np.abs(d).max())


def test_weighted_histogram_edges_and_tensors():
    x, w = data("normal", 3), data("normal", 4)
    c, _ = rt.histogram(x[:0], bins=5, weights=w[:0], device="cpu")
    jc, _ = jstats.histogram(jnp.asarray(x[:0]), bins=5, weights=jnp.asarray(w[:0]))
    assert np.array_equal(c, np.asarray(jc)) and c.dtype == np.float32
    with pytest.raises(ValueError):
        rt.histogram(x, bins=5, weights=w[:9], device="cpu")
    tc, te = rt.histogram(torch.from_numpy(x), bins=20, weights=torch.from_numpy(w))
    c, e = rt.histogram(x, bins=20, weights=w, device="cpu")
    assert torch.is_tensor(tc) and np.array_equal(te, e) and np.array_equal(tc.numpy(), c)
    tc, _ = rt.histogram(torch.from_numpy(x), bins=20)
    assert tc.dtype == torch.int32


@pytest.fixture
def hist_routes(monkeypatch):
    seen = {"jax": [], "port": []}

    def spy(module, attr, who, label):
        real = getattr(module, attr)

        def wrapped(*a, **k):
            seen[who].append(label)
            return real(*a, **k)
        monkeypatch.setattr(module, attr, wrapped)

    spy(pk, "histogram_tpu", "jax", "hist")
    spy(pk, "weighted_histogram_f32_tpu", "jax", "whist_f32")
    spy(ck, "hist", "port", "hist")
    spy(ck, "whist_f32", "port", "whist_f32")
    return seen


@pytest.mark.usefixtures("forced_tpu_routes")
class TestForcedHistogram:

    @pytest.mark.parametrize("bins", [12, 1000])
    def test_counts(self, hist_routes, bins):
        x = data("normal", bins)
        jc, je = jstats.histogram(jnp.asarray(x), bins=bins)
        c, e = rt.histogram(x, bins=bins, device="cpu")
        assert np.array_equal(e, je) and np.array_equal(c, np.asarray(jc))
        assert hist_routes["port"] == hist_routes["jax"] == ["hist"]

    @pytest.mark.parametrize("bins", [12, 1000])
    def test_weighted(self, hist_routes, bins):
        x, w = data("normal", bins), data("normal", bins + 1)
        jc, je = jstats.histogram(jnp.asarray(x), bins=bins, weights=jnp.asarray(w))
        c, e = rt.histogram(x, bins=bins, weights=w, device="cpu")
        assert np.array_equal(e, je)
        weighted_check(c, x, w, e, bins, dense=True)
        weighted_check(np.asarray(jc), x, w, e, bins, dense=True)
        assert hist_routes["port"] == hist_routes["jax"] == ["whist_f32"]

    @pytest.mark.parametrize("weighted", [False, True])
    def test_edge_array(self, hist_routes, weighted):
        x, w = edge_data(11), data("normal", 12)
        jw, tw = (jnp.asarray(w), w) if weighted else (None, None)
        jc, _ = jstats.histogram(jnp.asarray(x), bins=EDGES, weights=jw)
        c, _ = rt.histogram(x, bins=EDGES, weights=tw, device="cpu")
        if weighted:
            assert np.allclose(c, np.asarray(jc), rtol=0, atol=np.abs(w).sum() * 2**-13)
        else:
            same(c, jc)
        want = ["whist_f32" if weighted else "hist"]
        assert hist_routes["port"] == hist_routes["jax"] == want


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("name", ["uint8", "int16", "int32", "float32", "uint64"])
def test_mode_matches_jax(name, desc):
    x = make_keys(name, N, rng_of(len(name)))
    x = (raw(x) % np.asarray(97, raw(x).dtype)).view(x.dtype)     # ties likely
    jv, jc = rst.stats.mode(jax_in(x), config=rst.SortConfig(descending=desc))
    v, c = rt.mode(x, config=rt.SortConfig(descending=desc), device="cpu")
    assert np.asarray(v).dtype == np.asarray(jv).dtype
    assert raw(np.asarray(v)) == raw(np.asarray(jv)) and int(c) == int(jc)
    tv, tc = rt.mode(rt.as_tensor(x, "cpu"), config=rt.SortConfig(descending=desc))
    assert torch.is_tensor(tv) and tv.ndim == tc.ndim == 0 and tc.dtype == torch.int32
    assert raw(rt.to_numpy(tv.reshape(1)))[0] == raw(np.asarray(jv)) and int(tc) == int(jc)


def test_mode_errors_match_jax():
    for x in (np.zeros(0, np.int32), np.zeros((2, 2), np.int32)):
        with pytest.raises(ValueError):
            rst.stats.mode(jnp.asarray(x))
        with pytest.raises(ValueError):
            rt.mode(x, device="cpu")


# ---------------------------------------------------------------------------
# edge-array histogram, digitize


both_routes = pytest.mark.usefixtures("routes")
EDGES = np.array([-3.0, -1.0, -0.5, 0.0, 0.5, 1.0, 3.0])


def edge_data(seed):
    """Normal values, the edges themselves, NaN and values past both ends."""
    x = data("normal", seed, N - EDGES.size - 3)
    return np.concatenate([x, EDGES, [np.nan, 10.0, -10.0]]).astype(np.float32)


@both_routes
@pytest.mark.parametrize("density", [False, True])
def test_edge_array_histogram_matches_jax(density):
    x = edge_data(1)
    jc, je = jstats.histogram(jnp.asarray(x), bins=EDGES, density=density)
    c, e = rt.histogram(x, bins=EDGES, density=density, device="cpu")
    assert e.dtype == np.float64 and np.array_equal(e, je) and np.array_equal(e, EDGES)
    same(c, jc)
    if not density:
        assert np.array_equal(c, np.histogram(x, bins=EDGES)[0])


@both_routes
@pytest.mark.parametrize("edges", ["seven", "irregular 1,001", "40,001 (past K11's gate)"])
def test_edge_array_weighted_histogram_matches_jax(edges):
    rng = rng_of(len(edges))
    e = {"seven": EDGES,
         "irregular 1,001": np.sort(rng.standard_normal(1001) * 2),
         "40,001 (past K11's gate)": np.linspace(-4.0, 4.0, 40_001)}[edges]
    x, w = edge_data(2), data("normal", 3) * 10
    jc, _ = jstats.histogram(jnp.asarray(x), bins=e, weights=jnp.asarray(w))
    c, got_e = rt.histogram(x, bins=e, weights=w, device="cpu")
    assert np.array_equal(got_e, e)
    nb = e.size - 1
    pos = np.searchsorted(e.astype(np.float32), x, side="right")   # the f32 binning
    idx = np.where(x == np.float32(e[-1]), nb - 1, pos - 1)
    idx = np.where((pos == 0) | (x > np.float32(e[-1])) | np.isnan(x), nb, idx)
    w64 = w.astype(np.float64)
    ref = np.bincount(idx, w64, minlength=nb + 1)[:nb]
    absum = np.bincount(idx, np.abs(w64), minlength=nb + 1)[:nb]
    dense = 2 * (1 << max(2, nb.bit_length())) <= 1 << 17
    for got in (c, np.asarray(jc)):
        bound = absum * 2**-14 + 1e-5 if dense and got is c \
            else absum * 2**-10 + np.abs(w64).sum() * 2**-20 + 1e-5
        assert got.dtype == np.float32 and np.all(np.abs(got.astype(np.float64) - ref) <= bound)


def test_edge_array_histogram_errors_match_jax():
    x = data("normal", 4)
    for bins in (np.array([1.0, 0.0]), np.array([1.0]), np.zeros((2, 2))):
        with pytest.raises(ValueError):
            jstats.histogram(jnp.asarray(x), bins=bins)
        with pytest.raises(ValueError):
            rt.histogram(x, bins=bins, device="cpu")
    c, _ = rt.histogram(x[:0], bins=EDGES, device="cpu")
    same(c, jstats.histogram(jnp.asarray(x[:0]), bins=EDGES)[0])
    tc, _ = rt.histogram(torch.from_numpy(edge_data(5)), bins=EDGES)
    assert torch.is_tensor(tc) and tc.dtype == torch.int32


@both_routes
@pytest.mark.parametrize("right", [False, True])
@pytest.mark.parametrize("bins", ["increasing f32", "decreasing i32", "given descending"])
def test_digitize_matches_jax(bins, right):
    rng = rng_of(len(bins) + right)
    if bins == "increasing f32":
        b = np.array([-2.0, -1.0, -0.25, 0.0, 0.5, 1.75], np.float32)
        x = np.concatenate([data("normal", 6, N - b.size), b])
    else:
        b = np.array([9, 6, 4, 1, 0] if bins == "decreasing i32" else [50, 20, 10], np.int32)
        x = rng.integers(-2, 60, size=N).astype(np.int32)
    kw = dict(descending=True) if bins == "given descending" else {}
    got = rt.digitize(x, b, right=right, device="cpu", **kw)
    same(got, jstats.digitize(jnp.asarray(x), jnp.asarray(b), right=right, **kw))
    assert np.array_equal(got, np.digitize(x, b, right=right))
    tgot = rt.digitize(torch.from_numpy(x), torch.from_numpy(b), right=right, **kw)
    assert torch.is_tensor(tgot) and np.array_equal(tgot.numpy(), got)


# ---------------------------------------------------------------------------
# rankdata


def rank_keys(kind):
    rng = rng_of(len(kind))
    if kind == "i32 ties":
        return rng.integers(0, 25, size=N).astype(np.int32)
    if kind == "f32 ties":
        x = np.repeat(rng.standard_normal(N // 3 + 1).astype(np.float32), 3)[:N]
        return x[rng.permutation(N)]
    x = rng.integers(0, 1 << 63, size=N, dtype=np.uint64)     # "u64": ties across planes
    x[::7] = x[0]
    return x


@both_routes
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["i32 ties", "f32 ties", "u64"])
@pytest.mark.parametrize("method", ["average", "min", "max", "dense", "ordinal"])
def test_rankdata_matches_jax(method, kind, descending):
    x = rank_keys(kind)
    cfg = dict(config=rst.SortConfig(descending=True)) if descending else {}
    tcfg = dict(config=rt.SortConfig(descending=True)) if descending else {}
    got = rt.rankdata(x, method=method, device="cpu", **tcfg)
    same(got, jstats.rankdata(jax_in(x), method=method, **cfg))
    assert got.dtype == (np.float32 if method == "average" else np.int32)
    if kind != "u64":
        ref = scipy_stats.rankdata(-x.astype(np.float64) if descending else x, method=method)
        assert np.array_equal(got.astype(np.float64), ref)


@both_routes
def test_rankdata_edges_match_jax():
    x = np.full(N, 7, np.int32)
    for method, want in (("average", (N + 1) / 2), ("dense", 1), ("max", N), ("min", 1)):
        got = rt.rankdata(x, method=method, device="cpu")
        same(got, jstats.rankdata(jnp.asarray(x), method=method))
        assert np.all(got == want)
    for method in ("average", "ordinal"):
        same(rt.rankdata(x[:0], method=method, device="cpu"),
             jstats.rankdata(jnp.asarray(x[:0]), method=method))
    for m, kw in ((jstats, {}), (rt, dict(device="cpu"))):
        with pytest.raises(ValueError, match="method"):
            m.rankdata(np.arange(4, dtype=np.int32), method="median", **kw)
    t = rt.rankdata(torch.from_numpy(rank_keys("i32 ties")), method="dense")
    assert torch.is_tensor(t) and t.dtype == torch.int32


# ---------------------------------------------------------------------------
# quantile, percentile, median


def quantile_keys(kind):
    rng = rng_of(len(kind))
    return {"f32": data("specials", 7), "u32": rng.integers(0, 1000, size=N).astype(np.uint32),
            "u8 (counting)": rng.integers(0, 256, size=N).astype(np.uint8),
            "u16 (counting)": rng.integers(0, 1 << 16, size=N).astype(np.uint16),
            "f64": rng.standard_normal(N), "i64": rng.integers(-2**62, 2**62, size=N),
            "bf16": make_keys("bfloat16", N, rng)}[kind]


QS = [0.0, 0.1, 0.25, 1 / 3, 0.5, 0.75, 0.9, 1.0]


@both_routes
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["f32", "u32", "u8 (counting)", "u16 (counting)", "f64",
                                  "i64", "bf16"])
@pytest.mark.parametrize("method", ["linear", "lower", "higher", "nearest", "midpoint"])
def test_quantile_matches_jax(method, kind, descending):
    x = quantile_keys(kind)
    cfg = dict(config=rst.SortConfig(descending=True)) if descending else {}
    tcfg = dict(config=rt.SortConfig(descending=True)) if descending else {}
    got = rt.quantile(x, QS, method=method, device="cpu", **tcfg)
    same(got, jstats.quantile(jax_in(x), QS, method=method, **cfg))
    if kind in ("u32", "u8 (counting)", "f64") and not descending:
        assert np.allclose(got.astype(np.float64), np.quantile(x, QS, method=method),
                           rtol=1e-6 if kind != "f64" else 0, atol=0)


@both_routes
def test_quantile_dtype_follows_the_key_width():
    """Interpolated quantiles combine by key width: numpy float32 keys in
    float32 (as the JAX package combines its device arrays), 64-bit keys in
    float64 with numpy's rounding; tensors stay tensors either way."""
    x32, x64 = data("normal", 8), rng_of(9).standard_normal(N)
    for x, dt in ((x32, np.float32), (x64, np.float64), (x32.astype(np.int16), np.float32),
                  (x64.astype(np.int64), np.float64)):
        got = rt.quantile(x, [0.3, 0.62], device="cpu")
        same(got, jstats.quantile(jax_in(x), [0.3, 0.62]))
        assert got.dtype == dt
        t = rt.quantile(torch.from_numpy(x), [0.3, 0.62])
        assert torch.is_tensor(t) and t.numpy().tobytes() == got.tobytes()
    assert np.array_equal(rt.quantile(x64, [0.3, 0.62], device="cpu"),
                          np.quantile(x64, [0.3, 0.62]))
    low = rt.quantile(x32.view(np.uint32), [0.5], method="lower", device="cpu")
    assert low.dtype == np.uint32


@both_routes
def test_scalar_quantile_median_percentile_match_jax():
    x = data("normal", 10)
    for got, want in ((rt.median(x, device="cpu"), jstats.median(jnp.asarray(x))),
                      (rt.percentile(x, 75, device="cpu"), jstats.percentile(jnp.asarray(x), 75)),
                      (rt.quantile(x, 0.5, method="lower", device="cpu"),
                       jstats.quantile(jnp.asarray(x), 0.5, method="lower"))):
        assert np.ndim(got) == 0 and got.dtype == np.asarray(want).dtype
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    same(rt.percentile(x, [5, 50, 95], device="cpu"),
         jstats.percentile(jnp.asarray(x), [5, 50, 95]))
    t = rt.median(torch.from_numpy(x))
    assert torch.is_tensor(t) and t.ndim == 0


def test_quantile_errors_match_jax():
    for call in (lambda m, **k: m.quantile(np.zeros(0, np.float32), 0.5, **k),
                 lambda m, **k: m.quantile(np.arange(4.0, dtype=np.float32), 1.5, **k),
                 lambda m, **k: m.quantile(np.arange(4.0, dtype=np.float32), 0.5,
                                           method="cubic", **k),
                 lambda m, **k: m.quantile(np.zeros((2, 2), np.float32), 0.5, **k)):
        with pytest.raises(ValueError):
            call(jstats)
        with pytest.raises(ValueError):
            call(rt, device="cpu")


# ---------------------------------------------------------------------------
# partition, argpartition


@both_routes
@pytest.mark.parametrize("kind", ["u32", "f32", "u8 (counting)", "i64"])
def test_partitions_match_jax(kind):
    x = quantile_keys(kind)
    for kth in (0, 17, [3, 44], N - 1, -1):
        got = rt.partition(x, kth, device="cpu")
        same(got, jstats.partition(jax_in(x), kth))
        k = np.atleast_1d(kth)[0] % N
        assert kind == "f32" or np.array_equal(raw(got[k:k + 1]), raw(np.sort(x)[k:k + 1]))
    got = rt.argpartition(x, N // 2, device="cpu")
    same(got, jstats.argpartition(jax_in(x), N // 2))
    for m, kw in ((jstats, {}), (rt, dict(device="cpu"))):
        for kth in (N, [-N - 1]):
            with pytest.raises(ValueError, match="out of range"):
                m.partition(jax_in(x) if m is jstats else x, kth, **kw)
            with pytest.raises(ValueError, match="out of range"):
                m.argpartition(jax_in(x) if m is jstats else x, kth, **kw)
