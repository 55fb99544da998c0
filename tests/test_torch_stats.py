"""``histogram``, ``histogram_bin_edges`` and ``mode`` of the port against the
JAX package (``radix_sorting_tpu.stats``).

The same inputs (numpy, from a seed) go to both packages, on the JAX
package's CPU routes and under ``RST_FORCE_TPU_ROUTES=1``, where both take
the kernels' routes (K1 for counts, K11 for weighted sums) and the routes
are compared. Tolerances: edges, counts, densities of counts and modes are
exact; weighted sums are within sum|w| * 2^-14 + 1e-5 per bin of a float64
sum (K11: each bin a direct sum), or sum|w| * 2^-10 + sum|all w| * 2^-20 +
1e-5 where the JAX package's CPU route takes prefix-sum differences.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu import stats as jstats
from radix_sorting_tpu.ops import pallas_kernels as pk
from radix_sorting_tpu_torch.ops import cuda_kernels as ck

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


def test_edge_array_bins_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt.histogram(data("normal", 1), bins=[0.0, 1.0, 2.0], device="cpu")


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
