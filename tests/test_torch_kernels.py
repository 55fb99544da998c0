"""The port's counting-tier kernels against the JAX package's Pallas kernels.

On CPU tensors the wrappers of ``radix_sorting_tpu_torch.ops.cuda_kernels``
run their plain PyTorch versions; these are held, bit for bit, against the
Pallas kernels run in interpret mode and called directly, as
``tests/test_pallas_kernels.py`` calls them:

  hist_pext    vs  pk.histogram_pext_tpu             (K2)
  hist_pext2   vs  pk.histogram_pext2_tpu            (K3)
  regen_pdep   vs  pk.regenerate_pdep_tpu            (K5, <= 2^10 bins)
  regen_pdep2  vs  pk.regenerate_pdep2_tpu           (K6, <= 2^10 bins)
  regen_pdep   vs  pk.regenerate_pdep_windowed_tpu   (K8, 2^11 bins)
  regen_pdep2  vs  pk.regenerate_pdep2_windowed_tpu  (K9, 2^11 bins)

Tolerance: exact equality (integer outputs). The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from radix_sorting_tpu.ops import counting_engine as jce
from radix_sorting_tpu.ops import pallas_kernels as pk
from radix_sorting_tpu.ops import probes as jprobes
from radix_sorting_tpu_torch.ops import counting_engine as tce
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import probes as tprobes


def plane(x_u32: np.ndarray) -> torch.Tensor:
    """An int32 CPU plane carrying the bits of a u32 numpy array."""
    return torch.from_numpy(np.ascontiguousarray(x_u32).view(np.int32).copy())


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def masked_keys(seed, n, mask, dead):
    rng = np.random.Generator(np.random.PCG64(seed))
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32) & np.uint32(mask)
    return (x | np.uint32(dead & ~mask & 0xFFFFFFFF)).astype(np.uint32)


# (mask, dead bits, n): the masked-8-bit main-path mask, and a mid-word mask
# with dead bits on both sides of it
FUSED_CASES = [(0xF0F00000, 0x00000000, 200_000),
               (0xF0F00000, 0x0003000C, 131_073),
               (0x0000FF00, 0x40000001, 150_000)]


@pytest.mark.parametrize("mask,dead,n", FUSED_CASES)
def test_hist_pext_matches_pallas(mask, dead, n):
    x = masked_keys(n, n, mask, dead)
    want = np.asarray(pk.histogram_pext_tpu(jnp.asarray(x), mask))
    got = ck.hist_pext(plane(x), mask)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == n


@pytest.mark.parametrize("mask,dead,n", FUSED_CASES)
def test_regen_pdep_matches_pallas(mask, dead, n):
    x = masked_keys(n + 1, n, mask, dead)
    hist = pk.histogram_pext_tpu(jnp.asarray(x), mask)
    want = np.asarray(pk.regenerate_pdep_tpu(hist, n, mask, jnp.asarray(x)[0]))
    cum = torch.cumsum(torch.from_numpy(np.asarray(hist).copy()), 0,
                       dtype=torch.int32)
    got = ck.regen_pdep(cum, n, mask, plane(x))
    assert np.array_equal(u32(got), want)
    assert np.array_equal(want, np.sort(x))


def test_regen_pdep_windowed_matches_pallas():
    # 11 live bits (2^11 bins) at n = 300K: the window fits, so the JAX
    # package takes its windowed kernel and not its sorter fallback
    mask, dead, n = 0x0003FF80, 0x80000004, 300_000
    bins = 1 << 11
    assert ck.pick_window(n, bins) == pk.pick_window(n, bins) == 1024
    x = masked_keys(7, n, mask, dead)
    hist = pk.histogram_pext_tpu(jnp.asarray(x), mask)
    jcum = jnp.cumsum(hist, dtype=jnp.int32)
    assert bool(pk.regen_windows_fit(jcum, n, 1024))
    want = np.asarray(pk.regenerate_pdep_windowed_tpu(
        jcum, n, bins, mask, jnp.asarray(x)[0], 1024))
    cum = torch.from_numpy(np.asarray(jcum).copy())
    got = ck.regen_pdep(cum, n, mask, plane(x))
    assert np.array_equal(u32(got), want)
    assert np.array_equal(want, np.sort(x))


def test_regen_pdep_serves_sparse_domains():
    # a distribution whose blocks overrun the JAX window (the case its
    # sorter fallback exists for): the port's regeneration has no window
    bins, n = 1 << 11, 400_009
    rng = np.random.Generator(np.random.PCG64(11))
    c = np.concatenate([rng.permutation(bins)[:1500].astype(np.uint32),
                        np.full(n - 1500, bins - 3, np.uint32)])
    hist = np.bincount(c, minlength=bins).astype(np.int32)
    jcum = jnp.cumsum(jnp.asarray(hist), dtype=jnp.int32)
    assert not bool(pk.regen_windows_fit(jcum, n, pk.pick_window(n, bins)))
    cum = torch.from_numpy(np.asarray(jcum).copy())
    got = ck.regen_pdep(cum, n, bins - 1, plane(c))
    assert np.array_equal(u32(got), np.sort(c))


@pytest.mark.parametrize("mask", [0x1, 0x3, 0xFF, 0xF0F00000, 0x0003FF80,
                                  0xAAAAAAAA, 0x80000001, 0xFFFFFFFF])
def test_pext_pdep_match_jax_probes(mask):
    x = np.random.Generator(np.random.PCG64(mask)).integers(
        0, 1 << 32, size=4096, dtype=np.uint32)
    c_j = np.asarray(jprobes.compact_live_bits(jnp.asarray(x), mask))
    c_t = tprobes.compact_live_bits(plane(x), mask)
    assert np.array_equal(u32(c_t), c_j)
    e_j = np.asarray(jprobes.expand_live_bits(jnp.asarray(c_j), mask))
    assert np.array_equal(u32(tprobes.expand_live_bits(c_t, mask)), e_j)


def test_routing_gates_match_jax():
    assert ck._K5_MAX_BINS == tce._REGEN_MAX_BINS == jce._REGEN_MAX_BINS
    assert tce._REGEN_WIN_MAX_BINS == jce._REGEN_WIN_MAX_BINS
    assert tce._REGEN_WIDE_MAX_BINS == jce._REGEN_WIDE_MAX_BINS
    assert tce._WIDE_MIN_KEYS_PER_BIN == jce._WIDE_MIN_KEYS_PER_BIN
    for n in (2, 1000, 70_003, 300_000, 8_400_000, 40_000_000, 70_000_000):
        for bits in range(1, 19):
            assert ck.pick_window(n, 1 << bits) == pk.pick_window(n, 1 << bits)
            assert (tce._windowed_bins_ok(n, 1 << bits)
                    == jce._windowed_bins_ok(n, 1 << bits)), (n, bits)


def test_plain_versions_count_no_launches():
    before = ck.launch_counts()
    x = masked_keys(3, 1000, 0xFF, 0)
    cum = torch.cumsum(ck.hist_pext(plane(x), 0xFF), 0, dtype=torch.int32)
    ck.regen_pdep(cum, 1000, 0xFF, plane(x))
    cum2 = torch.cumsum(ck.hist_pext2(plane(x), plane(x), 0xF, 0xF0), 0,
                        dtype=torch.int32)
    ck.regen_pdep2(cum2, 1000, 0xF, 0xF0, plane(x), plane(x))
    assert ck.launch_counts() == before


@pytest.mark.parametrize("bad,exc", [
    (lambda: ck.hist_pext(torch.zeros(8, dtype=torch.int64), 0xFF), TypeError),
    (lambda: ck.hist_pext(torch.zeros((2, 4), dtype=torch.int32), 0xFF), TypeError),
    (lambda: ck.hist_pext(torch.zeros(16, dtype=torch.int32)[::2], 0xFF), ValueError),
    (lambda: ck.hist_pext(torch.zeros(8, dtype=torch.int32), 0), ValueError),
    (lambda: ck.hist_pext(torch.zeros(8, dtype=torch.int32), 0x3FFFF), ValueError),
    (lambda: ck.regen_pdep(torch.zeros(512, dtype=torch.int32), 4, 0xFF,
                           torch.zeros(4, dtype=torch.int32)), ValueError),
    (lambda: ck.regen_pdep(torch.zeros(256, dtype=torch.int32), 4, 0xFF,
                           torch.zeros(0, dtype=torch.int32)), ValueError),
    (lambda: ck.hist_pext2(torch.zeros(8, dtype=torch.int32),
                           torch.zeros(7, dtype=torch.int32), 0xF, 0xF), ValueError),
    (lambda: ck.hist_pext2(torch.zeros(8, dtype=torch.int32),
                           torch.zeros(8, dtype=torch.int64), 0xF, 0xF), TypeError),
    (lambda: ck.hist_pext2(torch.zeros(8, dtype=torch.int32),
                           torch.zeros(8, dtype=torch.int32), 0, 0), ValueError),
    (lambda: ck.hist_pext2(torch.zeros(8, dtype=torch.int32),
                           torch.zeros(8, dtype=torch.int32), 0x3FF, 0xFF), ValueError),
    (lambda: ck.hist_pext2(torch.zeros(8, dtype=torch.int32),
                           torch.zeros(8, dtype=torch.int32), 1 << 32, 1), ValueError),
    (lambda: ck.regen_pdep2(torch.zeros(512, dtype=torch.int32), 4, 0xF, 0xF,
                            torch.zeros(4, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32)), ValueError),
    (lambda: ck.regen_pdep2(torch.zeros(256, dtype=torch.int32), 4, 0xF, 0xF,
                            torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, dtype=torch.int32)), ValueError),
])
def test_wrappers_reject_bad_inputs(bad, exc):
    with pytest.raises(exc):
        bad()


def test_no_jax_in_the_port():
    # the port must import on a machine without JAX or the JAX package
    import ast
    import pathlib
    root = pathlib.Path(tce.__file__).resolve().parents[1]
    files = list(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    names = {p.relative_to(root).as_posix() for p in files if p.is_relative_to(root)}
    assert {"extras.py", "ops/bitmap.py", "ops/counting_engine.py",
            "ops/histogram.py", "api.py", "cli.py", "utils/keyfile.py",
            "utils/verify.py", "utils/timing.py", "scripts/exp_sol_probe.py",
            "scripts/exp_sol_round2.py", "scripts/profile_headline.py"} <= names
    for p in files:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "radix_sorting_tpu"), (p, name)


# ---------------------------------------------------------------------------
# engine pieces around the kernels, against their JAX counterparts


@pytest.mark.parametrize("bins", [2, 16, 1024, 2048])
def test_counting_sort_compact_matches_jax(bins):
    c = np.random.Generator(np.random.PCG64(bins)).integers(
        0, bins, size=20_011, dtype=np.uint32)
    want = np.asarray(jce.counting_sort_compact(jnp.asarray(c), bins))
    got = tce.counting_sort_compact(plane(c), bins)
    assert np.array_equal(u32(got), want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("mask,n", [(0x1, 5000), (0x80000000, 5000),
                                    (0xF0F00000, 40_009), (0x0FFFF000, 40_009)])
def test_sort_words_counting_matches_jax(mask, n, descending):
    x = masked_keys(mask & 0xFFFF, n, mask, 0x00000F0F)
    (want,) = jce.sort_words_counting((jnp.asarray(x),), (mask,), descending)
    (got,) = tce.sort_words_counting((plane(x),), (mask,), descending)
    assert np.array_equal(u32(got), np.asarray(want))


def test_word_lt_and_live_bit_mask_match_jax():
    rng = np.random.Generator(np.random.PCG64(5))
    a, b = (rng.integers(0, 1 << 32, size=(2, 3001), dtype=np.uint32)
            for _ in range(2))
    b[:, ::7] = a[:, ::7]                      # ties in the first plane too
    want = np.asarray(jprobes.word_lt(tuple(jnp.asarray(p) for p in a),
                                      tuple(jnp.asarray(p) for p in b)))
    got = tprobes.word_lt(tuple(plane(p) for p in a), tuple(plane(p) for p in b))
    assert np.array_equal(got.numpy(), want)
    x = (a[0] & np.uint32(0x00FF0F00)) | np.uint32(0x80000001)
    (jm,) = jprobes.live_bit_mask((jnp.asarray(x),))
    (tm,) = tprobes.live_bit_mask((plane(x),))
    assert int(tm) & 0xFFFFFFFF == int(jm) == 0x00FF0F00
    for w in (a[0], np.sort(a[0]), np.zeros(1, np.uint32)):
        assert bool(tprobes.is_sorted_words((plane(w),))) == bool(
            jprobes.is_sorted_words((jnp.asarray(w),)))


# ---------------------------------------------------------------------------
# two-plane (64-bit) kernels: K3, K6, K9


def masked_pair(seed, n, mask64, dead64):
    """(hi, lo) u32 planes of n 64-bit keys under ``mask64`` with the dead
    bits ``dead64`` outside it."""
    rng = np.random.Generator(np.random.PCG64(seed))
    x = rng.integers(0, 1 << 64, size=n, dtype=np.uint64) & np.uint64(mask64)
    x |= np.uint64(dead64 & ~mask64 & (2**64 - 1))
    return ((x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32))


# (64-bit mask, dead bits, n): masks split across the planes with dead bits
# in both, a 0 hi mask and a 0 lo mask
PAIR_CASES = [(0xF000000000000F00, 0x0001000300000001, 150_007),
              (0x00FF00000000000F, 0x8000000080000000, 131_072),
              (0x0000000000FF0F00, 0x4000000100000001, 100_003),
              (0x0F0F000000000000, 0x0000000200000007, 120_001)]


@pytest.mark.parametrize("mask,dead,n", PAIR_CASES)
def test_hist_pext2_matches_pallas(mask, dead, n):
    hi, lo = masked_pair(n, n, mask, dead)
    mh, ml = mask >> 32, mask & 0xFFFFFFFF
    want = np.asarray(pk.histogram_pext2_tpu(jnp.asarray(hi), jnp.asarray(lo),
                                             mh, ml))
    got = ck.hist_pext2(plane(hi), plane(lo), mh, ml)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == n


@pytest.mark.parametrize("mask,dead,n", PAIR_CASES)
def test_regen_pdep2_matches_pallas(mask, dead, n):
    hi, lo = masked_pair(n + 1, n, mask, dead)
    mh, ml = mask >> 32, mask & 0xFFFFFFFF
    hist = pk.histogram_pext2_tpu(jnp.asarray(hi), jnp.asarray(lo), mh, ml)
    whi, wlo = pk.regenerate_pdep2_tpu(hist, n, mh, ml, jnp.asarray(hi)[0],
                                       jnp.asarray(lo)[0])
    cum = torch.cumsum(torch.from_numpy(np.asarray(hist).copy()), 0,
                       dtype=torch.int32)
    ghi, glo = ck.regen_pdep2(cum, n, mh, ml, plane(hi), plane(lo))
    assert np.array_equal(u32(ghi), np.asarray(whi))
    assert np.array_equal(u32(glo), np.asarray(wlo))
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    s = np.sort(key)
    assert np.array_equal(np.asarray(whi), (s >> np.uint64(32)).astype(np.uint32))
    assert np.array_equal(np.asarray(wlo), s.astype(np.uint32))


def test_regen_pdep2_windowed_matches_pallas():
    # 11 live bits (2^11 bins) across both planes at n = 300K: the window
    # fits, so the JAX package takes its windowed kernel, not its fallback
    mask, dead, n = 0x0000000700FF0000, 0x8000000180000002, 300_000
    mh, ml = mask >> 32, mask & 0xFFFFFFFF
    bins = 1 << 11
    assert ck.pick_window(n, bins) == pk.pick_window(n, bins) == 1024
    hi, lo = masked_pair(9, n, mask, dead)
    hist = pk.histogram_pext2_tpu(jnp.asarray(hi), jnp.asarray(lo), mh, ml)
    jcum = jnp.cumsum(hist, dtype=jnp.int32)
    assert bool(pk.regen_windows_fit(jcum, n, 1024))
    whi, wlo = pk.regenerate_pdep2_windowed_tpu(
        jcum, n, bins, mh, ml, jnp.asarray(hi)[0], jnp.asarray(lo)[0], 1024)
    cum = torch.from_numpy(np.asarray(jcum).copy())
    ghi, glo = ck.regen_pdep2(cum, n, mh, ml, plane(hi), plane(lo))
    assert np.array_equal(u32(ghi), np.asarray(whi))
    assert np.array_equal(u32(glo), np.asarray(wlo))
    key = np.sort((hi.astype(np.uint64) << np.uint64(32)) | lo)
    assert np.array_equal(u32(glo), key.astype(np.uint32))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("mask,n", [(0x0000000100000000, 5000),
                                    (0xF000000000000F00, 40_009),
                                    (0x00FF00000000FF00, 40_009),
                                    (0x0000000000FFF000, 40_009)])
def test_sort_words_counting_two_planes_matches_jax(mask, n, descending):
    hi, lo = masked_pair(mask & 0xFFFF, n, mask, 0x0000F0F00000000F)
    masks = (mask >> 32, mask & 0xFFFFFFFF)
    want = jce.sort_words_counting((jnp.asarray(hi), jnp.asarray(lo)), masks,
                                   descending)
    got = tce.sort_words_counting((plane(hi), plane(lo)), masks, descending)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert np.array_equal(u32(g), np.asarray(w))


# plane masks of 2 and 3 planes, one of them 0
PLANE_MASKS = [(0xF0000000, 0x0000FF00), (0, 0x0003FF80), (0x00FF0000, 0),
               (0x3, 0, 0xC0000001), (0x80000000, 0x1, 0x0000F000)]


@pytest.mark.parametrize("masks", PLANE_MASKS)
def test_word_plane_compaction_matches_jax(masks):
    rng = np.random.Generator(np.random.PCG64(sum(masks)))
    planes = [(rng.integers(0, 1 << 32, size=3001, dtype=np.uint32)
               & np.uint32(m)) | np.uint32(0x10000 * i + 1 & ~m & 0xFFFFFFFF)
              for i, m in enumerate(masks)]
    jw = tuple(jnp.asarray(p) for p in planes)
    tw = tuple(plane(p) for p in planes)
    jc = np.asarray(jprobes.compact_word_planes(jw, masks))
    tc = tprobes.compact_word_planes(tw, masks)
    assert np.array_equal(u32(tc), jc)
    jc_sorted = jnp.sort(jnp.asarray(jc))
    want = jprobes.expand_word_planes(jc_sorted, jw, masks)
    got = tprobes.expand_word_planes(plane(np.asarray(jc_sorted)), tw, masks)
    for g, w in zip(got, want):
        assert np.array_equal(u32(g), np.asarray(w))
    for ws in (planes, [np.sort(p) for p in planes], [p[:1] for p in planes]):
        assert bool(tprobes.is_sorted_words(tuple(plane(p) for p in ws))) == bool(
            jprobes.is_sorted_words(tuple(jnp.asarray(p) for p in ws)))
