"""The dense-domain counting tier of the port against the JAX package.

K1 (``hist`` / ``hist_multi``) and K4 / K7 (``regen``) as plain versions on
CPU tensors, against the Pallas kernels run in interpret mode and called
directly:

  hist        vs  pk.histogram_tpu               (K1, one digit, drop_ge)
  hist_multi  vs  pk.multi_digit_histogram_tpu   (K1, every digit)
  regen       vs  pk.regenerate_tpu              (K4, <= 2^10 bins)
  regen       vs  pk.regenerate_windowed_tpu     (K7, 2^11 bins)

then what runs them: ``counting_sort_compact``, ``sort_word_counting``,
``probe_bins``, ``multi_digit_histogram``, ``bitmap_unique_sort`` and
``bincount``, each on the JAX package's CPU routes and under
``RST_FORCE_TPU_ROUTES=1``, where both packages take the kernels' routes
and the routes are compared. Tolerance: exact equality (integer outputs).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu.ops import bitmap as jbitmap
from radix_sorting_tpu.ops import counting_engine as jce
from radix_sorting_tpu.ops import histogram as jhist
from radix_sorting_tpu.ops import pallas_kernels as pk
from radix_sorting_tpu_torch.ops import counting_engine as tce
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import histogram as thist

from test_torch_kernels import digit_counters, hist_kernel_model, plane, u32
from test_torch_sort import forced_tpu_routes  # noqa: F401  (class fixture)


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


# ---------------------------------------------------------------------------
# K1, K4, K7: plain versions against the Pallas kernels


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("radix_bits,pass_index", [(8, 0), (8, 2), (10, 1),
                                                   (16, 0), (18, 0)])
def test_hist_matches_pallas(radix_bits, pass_index, drop):
    n = 70_003
    x = rng_of(radix_bits + pass_index).integers(0, 1 << 32, size=n, dtype=np.uint32)
    if drop:     # keys below 2^(r+1): about half are at or past drop_ge
        x &= np.uint32((2 << (radix_bits + pass_index * radix_bits)) - 1)
    drop_ge = 3 << (radix_bits + pass_index * radix_bits - 1) if drop else None
    want = np.asarray(pk.histogram_tpu(jnp.asarray(x), pass_index, radix_bits,
                                       drop_ge=drop_ge))
    got = ck.hist(plane(x), pass_index, radix_bits, drop_ge=drop_ge)
    assert got.dtype == torch.int32 and got.shape == (1 << radix_bits,)
    assert np.array_equal(got.numpy(), want)
    kept = x if drop_ge is None else x[x < drop_ge]
    assert int(got.sum()) == kept.size


@pytest.mark.parametrize("radix_bits", [8, 11])
def test_hist_multi_matches_pallas(radix_bits):
    x = rng_of(radix_bits).integers(0, 1 << 32, size=100_003, dtype=np.uint32)
    want = np.asarray(pk.multi_digit_histogram_tpu(jnp.asarray(x), radix_bits))
    got = ck.hist_multi(plane(x), radix_bits)
    assert got.shape == want.shape == (-(-32 // radix_bits), 1 << radix_bits)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("offset,drop_ge", [(0x9E3779B9, None), (0xFFFFFF00, 300),
                                            (0x7FFFFF80, 1 << 32)])
def test_hist_offset_is_the_unfused_composite(offset, drop_ge):
    # the range probe's fused ``w - min``: keys straddling 2^31 and 2^32
    x = (np.uint64(offset) + rng_of(5).integers(0, 512, size=20_011)
         .astype(np.uint64)).astype(np.uint32)
    u = (x - np.uint32(offset)).astype(np.uint32)
    kept = u if drop_ge is None else u[u < drop_ge]
    want = np.bincount(kept & 0x3FF, minlength=1024)
    got = ck.hist(plane(x), 0, 10, drop_ge=drop_ge, offset=offset)
    assert np.array_equal(got.numpy(), want)


# K1's launch shapes (csrc/hist.cu) in the numpy model of the kernel's index
# arithmetic (tests/test_torch_kernels.py), at 256 threads so that a few tens
# of thousands of keys fill several chunks: copies of 32-bit counters, 16-bit
# counters in one block and in 2, 4 and 8 grid rows
K1_MODEL_SHAPES = [(8, 1, ck.HistShape(256, 8, 1, 8, 0)),
                   (8, 4, ck.HistShape(256, 10, 1, 2, 0)),
                   (11, 3, ck.HistShape(256, 13, 1, 1, 1)),
                   (16, 1, ck.HistShape(256, 15, 2, 1, 1)),
                   (16, 1, ck.HistShape(256, 16, 1, 1, 1)),
                   (17, 1, ck.HistShape(256, 16, 2, 1, 1)),
                   (18, 1, ck.HistShape(256, 16, 4, 1, 1)),
                   (18, 2, ck.HistShape(256, 16, 8, 1, 1))]


@pytest.mark.parametrize("lo_words", [0, 1, 2, 3])
@pytest.mark.parametrize("bits,passes,shape", K1_MODEL_SHAPES,
                         ids=[f"r{b}p{p}r{s.ranges}h{s.half}" for b, p, s in K1_MODEL_SHAPES])
def test_hist_model_matches_plain(bits, passes, shape, lo_words):
    n = 30_011 + lo_words
    x = rng_of(bits * passes + lo_words).integers(0, 1 << 32, size=n, dtype=np.uint32)
    x[: n // 4] = 0x9E3779BE                        # a quarter of the keys one value
    if passes == 1:                                 # the range probe's offset, drop_ge
        drop_ge, offset = 0xC0000000, 0x9E3779B9
        want = ck.hist_plain(plane(x), 0, bits, drop_ge, offset).numpy()[None]
    else:
        drop_ge, offset = None, 0
        want = ck.hist_multi_plain(plane(x), bits).numpy()
    counters = digit_counters(0, bits, passes, drop_ge, offset)
    for blocks in (1, 3):
        got = hist_kernel_model(x, None, counters, passes << bits, shape, blocks, lo_words)
        assert np.array_equal(got.reshape(passes, -1), want), blocks


@pytest.mark.parametrize("radix_bits,passes", [(16, 1), (18, 1), (8, 4)])
def test_hist_model_of_the_picked_shape_matches_pallas(radix_bits, passes):
    n = 20_007
    x = rng_of(radix_bits).integers(0, 1 << 32, size=n, dtype=np.uint32)
    total = passes << radix_bits
    shape = ck.hist_shape(total)
    if passes == 1:
        drop_ge = 3 << 30
        want = np.asarray(pk.histogram_tpu(jnp.asarray(x), 0, radix_bits, drop_ge=drop_ge))
    else:
        drop_ge = None
        want = np.asarray(pk.multi_digit_histogram_tpu(jnp.asarray(x), radix_bits))
    got = hist_kernel_model(x, None, digit_counters(0, radix_bits, passes, drop_ge), total,
                            shape, 2, 1)
    assert np.array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("bins", [256, 1024])
def test_regen_matches_pallas(bins):
    n = 100_003
    c = rng_of(bins).integers(0, bins, size=n, dtype=np.uint32)
    hist = pk.histogram_tpu(jnp.asarray(c), 0, bins.bit_length() - 1)
    want = np.asarray(pk.regenerate_tpu(hist, n))
    cum = torch.cumsum(torch.from_numpy(np.asarray(hist).copy()), 0, dtype=torch.int32)
    got = ck.regen(cum, n)
    assert np.array_equal(u32(got), want)
    assert np.array_equal(want, np.sort(c))


def test_regen_windowed_matches_pallas():
    # 2^11 bins at n = 300K: the window fits, so the JAX package takes its
    # windowed kernel and not its sorter fallback
    bins, n = 1 << 11, 300_000
    assert ck.pick_window(n, bins) == pk.pick_window(n, bins) == 1024
    c = rng_of(11).integers(0, bins, size=n, dtype=np.uint32)
    jcum = jnp.cumsum(pk.histogram_tpu(jnp.asarray(c), 0, 11), dtype=jnp.int32)
    assert bool(pk.regen_windows_fit(jcum, n, 1024))
    want = np.asarray(pk.regenerate_windowed_tpu(jcum, n, bins, 1024))
    got = ck.regen(torch.from_numpy(np.asarray(jcum).copy()), n)
    assert np.array_equal(u32(got), want)
    assert np.array_equal(want, np.sort(c))


def test_regen_serves_sparse_domains():
    # blocks that overrun the JAX window (its sorter fallback's case): the
    # port's regeneration has no window, and adds the offset on the store
    bins, n, offset = 1 << 11, 400_009, 0xFFFFFC00
    c = np.concatenate([rng_of(12).permutation(bins)[:1500].astype(np.uint32),
                        np.full(n - 1500, bins - 3, np.uint32)])
    jcum = jnp.cumsum(jnp.asarray(np.bincount(c, minlength=bins).astype(np.int32)),
                      dtype=jnp.int32)
    assert not bool(pk.regen_windows_fit(jcum, n, pk.pick_window(n, bins)))
    got = ck.regen(torch.from_numpy(np.asarray(jcum).copy()), n, offset=offset)
    assert np.array_equal(u32(got), (np.sort(c) + np.uint32(offset)).astype(np.uint32))


def test_new_plain_versions_count_no_launches():
    before = ck.launch_counts()
    w = plane(rng_of(3).integers(0, 1 << 32, size=5000, dtype=np.uint32))
    cum = torch.cumsum(ck.hist(w, 0, 12, offset=7), 0, dtype=torch.int32)
    ck.regen(cum, 5000, offset=7)
    ck.hist_multi(w, 8)
    assert ck.launch_counts() == before


@pytest.mark.parametrize("bad,exc", [
    (lambda: ck.hist(torch.zeros(8, dtype=torch.int64), 0, 8), TypeError),
    (lambda: ck.hist(torch.zeros(8, dtype=torch.int32), 0, 19), ValueError),
    (lambda: ck.hist(torch.zeros(8, dtype=torch.int32), 0, 0), ValueError),
    (lambda: ck.hist(torch.zeros(8, dtype=torch.int32), 4, 8), ValueError),
    (lambda: ck.hist(torch.zeros(8, dtype=torch.int32), 0, 8, drop_ge=-1), ValueError),
    (lambda: ck.hist(torch.zeros(8, dtype=torch.int32), 0, 8,
                     drop_ge=(1 << 32) + 1), ValueError),
    (lambda: ck.hist_multi(torch.zeros(16, dtype=torch.int32)[::2], 8), ValueError),
    (lambda: ck.regen(torch.zeros(1 << 18, dtype=torch.int32), 4), ValueError),
    (lambda: ck.regen(torch.zeros(0, dtype=torch.int32), 4), ValueError),
    (lambda: ck.regen(torch.zeros(8, dtype=torch.int32), -1), ValueError),
])
def test_dense_wrappers_reject_bad_inputs(bad, exc):
    with pytest.raises(exc):
        bad()


# ---------------------------------------------------------------------------
# engine and entry points on the JAX package's CPU routes


def test_probe_bins_match_jax():
    for n in (2, 1000, 70_003, 262_144, 300_000, 500_000, 8_400_000,
              40_000_000, (1 << 17) * 512 - 1, (1 << 17) * 512, 100_000_000):
        assert tce.probe_bins(n) == jce.probe_bins(n), n
    assert tce.probe_bins(200_000) == 1 << 10
    assert tce.probe_bins(40_000_000) == 1 << 16
    assert tce.probe_bins((1 << 17) * 512) == 1 << 17


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("mask,n", [(0x3FF, 50_000), (0x3, 5000), (0x00FFE000, 300_000)])
def test_sort_word_counting_matches_jax(mask, n, descending):
    x = rng_of(mask).integers(0, 1 << 32, size=n, dtype=np.uint32) & np.uint32(mask)
    x |= np.uint32(0x80000001 & ~mask)
    want = np.asarray(jce.sort_word_counting(jnp.asarray(x), mask, descending))
    got = tce.sort_word_counting(plane(x), mask, descending)
    assert np.array_equal(u32(got), want)


@pytest.mark.parametrize("radix_bits", [8, 11])
@pytest.mark.parametrize("planes", [1, 2])
def test_multi_digit_histogram_matches_jax(planes, radix_bits):
    ws = rng_of(planes).integers(0, 1 << 32, size=(planes, 30_011), dtype=np.uint32)
    want = np.asarray(jhist.multi_digit_histogram([jnp.asarray(w) for w in ws],
                                                  radix_bits))
    got = thist.multi_digit_histogram([plane(w) for w in ws], radix_bits)
    assert np.array_equal(got.numpy(), want)
    for p in range(want.shape[0]):
        d = np.asarray(jhist.extract_digit([jnp.asarray(w) for w in ws], p, radix_bits))
        assert np.array_equal(u32(thist.extract_digit([plane(w) for w in ws], p,
                                                      radix_bits)), d)


def bitmap_input(dtype, n, seed):
    hi = 500 if dtype == np.uint16 else 200
    return rng_of(seed).integers(0, hi, size=n).astype(dtype)


@pytest.mark.parametrize("size,fill_value", [(None, None), (100, 7), (1000, -1)])
@pytest.mark.parametrize("n", [3000, 70_001])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_bitmap_unique_sort_matches_jax(dtype, n, size, fill_value):
    x = bitmap_input(dtype, n, n + dtype(0).itemsize)
    jv, jc = jbitmap.bitmap_unique_sort(jnp.asarray(x), size=size, fill_value=fill_value)
    v, c = rt.bitmap_unique_sort(x, size=size, fill_value=fill_value, device="cpu")
    assert v.dtype == x.dtype and np.array_equal(v, np.asarray(jv))
    assert int(c) == int(jc) == np.unique(x).size
    tv, tc = rt.bitmap_unique_sort(torch.from_numpy(x), size=size, fill_value=fill_value)
    assert torch.is_tensor(tv) and np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("x", [np.zeros(4, np.int16), np.zeros(4, np.uint32),
                               np.zeros(4, np.float32)])
def test_bitmap_unique_sort_type_errors_match_jax(x):
    with pytest.raises(TypeError):
        jbitmap.bitmap_unique_sort(jnp.asarray(x))
    with pytest.raises(TypeError):
        rt.bitmap_unique_sort(x, device="cpu")
    with pytest.raises(TypeError):
        rt.bitmap_unique_sort(torch.from_numpy(x))


def bincount_input(length, n, seed, out_of_range=0.01):
    """Values in [0, length), about ``out_of_range`` of them past it."""
    rng = rng_of(seed)
    x = rng.integers(0, length, size=n).astype(np.uint32)
    bad = rng.random(n) < out_of_range
    x[bad] = (length + rng.integers(0, 1 << 20, size=int(bad.sum()))).astype(np.uint32)
    return x


@pytest.mark.parametrize("length", [3, 4, 1000, 1 << 16, 1 << 18, (1 << 18) + 1])
def test_bincount_matches_jax_and_numpy(length):
    x = bincount_input(length, 50_021, length)
    want = np.asarray(rst.bincount(jnp.asarray(x), length=length))
    got = rt.bincount(x, length=length, device="cpu")
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, np.bincount(x[x < length], minlength=length))


@pytest.mark.parametrize("x,length", [
    ((np.arange(300) % 256).astype(np.uint8), None), (np.array([0, 1, 1], bool), None),
    (np.arange(70_000, dtype=np.uint32).astype(np.uint16), None),
    (np.array([-3, 0, 2, 5, 5], np.int32), 6), (np.array([-1, 7], np.int8), 8),
    (np.array([2, 3, 1 << 40], np.int64), 5), (np.zeros(0, np.uint8), 16),
])
def test_bincount_dtypes_and_defaults_match_jax(x, length):
    want = np.asarray(rst.bincount(x if x.dtype.itemsize == 8 else jnp.asarray(x),
                                   length=length))
    got = rt.bincount(x, length=length, device="cpu")
    assert np.array_equal(got, want)
    got_t = rt.bincount(torch.from_numpy(x), length=length)
    assert torch.is_tensor(got_t) and np.array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("x,kw,exc", [
    (np.array([0, 7], np.uint32), dict(length=7, validate=True), ValueError),
    (np.array([-1, 2], np.int32), dict(length=7, validate=True), ValueError),
    (np.array([1, 2], np.int32), dict(), ValueError),
    (np.array([1, 2], np.uint8), dict(length=0), ValueError),
    (np.array([1.0, 2.0], np.float32), dict(length=4), TypeError),
    (np.zeros((2, 2), np.uint8), dict(), ValueError),
])
def test_bincount_errors_match_jax(x, kw, exc):
    with pytest.raises(exc):
        rst.bincount(jnp.asarray(x), **kw)
    with pytest.raises(exc):
        rt.bincount(x, device="cpu", **kw)


def test_bincount_validate_passes_in_range():
    x = np.array([0, 6, 6, 2], np.uint32)
    assert np.array_equal(rt.bincount(x, length=7, validate=True, device="cpu"),
                          np.bincount(x, minlength=7))


# ---------------------------------------------------------------------------
# forced TPU routes: both packages take the kernels' routes


@pytest.fixture
def dense_routes(monkeypatch):
    """Record which dense-tier kernel contracts each package reaches. The
    JAX entry points are jitted, so their caches are cleared first: a
    cached trace would call no wrapper."""
    jax.clear_caches()
    seen = {"jax": [], "port": []}

    def spy(module, attr, who, label):
        real = getattr(module, attr)

        def wrapped(*a, **k):
            seen[who].append(label(*a, **k) if callable(label) else label)
            return real(*a, **k)
        monkeypatch.setattr(module, attr, wrapped)

    spy(pk, "histogram_tpu", "jax", "hist")
    spy(pk, "multi_digit_histogram_tpu", "jax", "hist_multi")
    spy(pk, "regenerate_tpu", "jax", "regen")
    spy(pk, "regenerate_windowed_tpu", "jax", "regen_win")
    spy(ck, "hist", "port", "hist")
    spy(ck, "hist_multi", "port", "hist_multi")
    spy(ck, "regen", "port",
        lambda cum, *a, **k: "regen" if cum.shape[0] <= 1 << 10 else "regen_win")
    return seen


@pytest.mark.usefixtures("forced_tpu_routes")
class TestForcedDenseRoutes:

    @pytest.mark.parametrize("bins,n,route", [
        (2, 5000, []), (4, 50_000, ["hist", "regen"]),
        (256, 50_000, ["hist", "regen"]), (1024, 100_003, ["hist", "regen"]),
        (1 << 11, 300_000, ["hist", "regen_win"]),
        (1 << 16, 70_003, []),            # the windowed gate refuses: sorter
    ])
    def test_counting_sort_compact(self, dense_routes, bins, n, route):
        c = rng_of(bins).integers(0, bins, size=n, dtype=np.uint32)
        want = np.asarray(jce.counting_sort_compact(jnp.asarray(c), bins))
        got = tce.counting_sort_compact(plane(c), bins)
        assert np.array_equal(u32(got), want)
        assert dense_routes["port"] == dense_routes["jax"] == route

    def test_sort_word_counting_descending(self, dense_routes):
        mask, n = 0x3FF << 12, 80_021
        x = rng_of(4).integers(0, 1 << 32, size=n, dtype=np.uint32) & np.uint32(mask)
        want = np.asarray(jce.sort_word_counting(jnp.asarray(x), mask, True))
        got = tce.sort_word_counting(plane(x), mask, True)
        assert np.array_equal(u32(got), want)
        assert np.array_equal(want, np.sort(x)[::-1])
        assert dense_routes["port"] == dense_routes["jax"] == ["hist", "regen"]

    @pytest.mark.parametrize("radix_bits", [8, 11])
    def test_multi_digit_histogram(self, dense_routes, radix_bits):
        w = rng_of(radix_bits).integers(0, 1 << 32, size=30_011, dtype=np.uint32)
        want = np.asarray(jhist.multi_digit_histogram([jnp.asarray(w)], radix_bits))
        got = thist.multi_digit_histogram([plane(w)], radix_bits)
        assert np.array_equal(got.numpy(), want)
        assert dense_routes["port"] == dense_routes["jax"] == ["hist_multi"]

    @pytest.mark.parametrize("dtype,n,route", [(np.uint8, 3000, []),
                                               (np.uint8, 70_001, ["hist"]),
                                               (np.uint16, 70_001, ["hist"])])
    def test_bitmap_unique_sort(self, dense_routes, dtype, n, route):
        x = bitmap_input(dtype, n, n)
        jv, jc = jbitmap.bitmap_unique_sort(jnp.asarray(x), size=600, fill_value=9)
        v, c = rt.bitmap_unique_sort(x, size=600, fill_value=9, device="cpu")
        assert np.array_equal(v, np.asarray(jv)) and int(c) == int(jc)
        assert dense_routes["port"] == dense_routes["jax"] == route

    @pytest.mark.parametrize("length,route", [(3, []), (4, ["hist"]), (1000, ["hist"]),
                                              (1 << 16, ["hist"]), (1 << 18, ["hist"]),
                                              ((1 << 18) + 1, [])])
    def test_bincount(self, dense_routes, length, route):
        x = bincount_input(length, 30_011, length + 1)
        want = np.asarray(rst.bincount(jnp.asarray(x), length=length))
        got = rt.bincount(x, length=length, device="cpu")
        assert np.array_equal(got, want)
        assert dense_routes["port"] == dense_routes["jax"] == route
