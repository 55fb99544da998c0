"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and nvcc (the kernels are built on first use); every
test here skips without a card. Imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Each kernel is held bit for bit against its plain PyTorch version on the
same CUDA tensors (the plain versions are held against the JAX package's
Pallas kernels by tests/test_torch_kernels.py), and ``sort`` on CUDA
tensors against a numpy oracle. Exact equality throughout.
"""

import numpy as np
import pytest
import torch

import radix_sorting_tpu_torch as rt
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops.kdf import i32

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_plane(n, seed, device, mask=0xFFFFFFFF, dead=0):
    x = np.random.Generator(np.random.PCG64(seed)).integers(
        0, 1 << 32, size=n, dtype=np.uint32)
    x = (x & np.uint32(mask)) | np.uint32(dead & ~mask & 0xFFFFFFFF)
    return torch.from_numpy(x.view(np.int32)).to(device)


@pytest.mark.parametrize("mask", [0x3, 0xFF, 0xF0F00000, 0x7FFF, 0xFFFF,
                                  0x1FFFF, 0xAAAA8000])
@pytest.mark.parametrize("n", [1, 7, 65_537, 1_000_003])
def test_hist_pext_matches_plain(cuda, mask, n):
    w = rand_plane(n, n ^ mask, cuda)
    before = ck.launch_counts()["hist_pext"]
    got = ck.hist_pext(w, mask)
    assert ck.launch_counts()["hist_pext"] == before + 1
    assert torch.equal(got, ck.hist_pext_plain(w, mask))


@pytest.mark.parametrize("mask", [0xFF, 0xFFFF])
def test_hist_pext_unaligned_and_skewed(cuda, mask):
    w = rand_plane(100_001, 3, cuda)[1:]          # 4-byte offset: no 16-byte loads
    assert torch.equal(ck.hist_pext(w, mask), ck.hist_pext_plain(w, mask))
    same = torch.full((300_000,), 0x1234, dtype=torch.int32, device=cuda)
    assert torch.equal(ck.hist_pext(same, mask), ck.hist_pext_plain(same, mask))


def _cum(plane, mask):
    return torch.cumsum(ck.hist_pext_plain(plane, mask), 0, dtype=torch.int32)


@pytest.mark.parametrize("mask,dead", [(0x3, 0), (0xF0F00000, 0x00010003),
                                       (0x3FF, 0x80000000), (0x0003FF80, 0x1),
                                       (0xFFFF, 0), (0x1FFFF, 0xC0000000)])
@pytest.mark.parametrize("n", [1, 5, 1023, 1025, 999_999])
def test_regen_pdep_matches_plain(cuda, mask, dead, n):
    plane = rand_plane(n, n + mask, cuda, mask, dead)
    cum = _cum(plane, mask)
    name = "regen_pdep" if cum.numel() <= 1 << 10 else "regen_pdep_windowed"
    before = ck.launch_counts()[name]
    got = ck.regen_pdep(cum, n, mask, plane)
    assert ck.launch_counts()[name] == before + 1
    assert torch.equal(got, ck.regen_pdep_plain(cum, n, mask, plane))
    assert torch.equal(got, torch.sort(plane ^ i32(1 << 31)).values ^ i32(1 << 31))


@pytest.mark.parametrize("bins", [256, 65_536])
def test_regen_pdep_skewed_and_sparse(cuda, bins):
    n = 2_000_003
    c = torch.full((n,), bins - 2, dtype=torch.int32, device=cuda)
    k = min(1500, bins)
    c[:k] = torch.randperm(bins, device=cuda)[:k].to(torch.int32)
    cum = _cum(c, bins - 1)
    assert torch.equal(ck.regen_pdep(cum, n, bins - 1, c),
                       ck.regen_pdep_plain(cum, n, bins - 1, c))


def test_cuda_inputs_never_fall_back(cuda):
    cum = torch.zeros(256, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ck.regen_pdep(cum, 4, 0xFF, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        ck.hist_pext(torch.zeros(8, dtype=torch.int64, device=cuda), 0xFF)


DTYPES = [torch.bool, torch.uint8, torch.int8, torch.uint16, torch.int16,
          torch.float16, torch.bfloat16, torch.uint32, torch.int32, torch.float32]


def _oracle(bits: np.ndarray, dtype) -> np.ndarray:
    """numpy sort of raw key bits by the reference's KDF order."""
    width = 8 * bits.dtype.itemsize
    b = bits.astype(np.uint64)
    top = np.uint64(1 << (width - 1))
    live = np.uint64((1 << width) - 1)
    if dtype in (torch.float16, torch.bfloat16, torch.float32):
        key = np.where(b & top, ~b & live, b | top)
    elif dtype in (torch.int8, torch.int16, torch.int32):
        key = b ^ top
    else:
        key = b
    return bits[np.argsort(key, kind="stable")]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_sort_matches_numpy_oracle(cuda, dtype, descending):
    n = 9_000_001          # 16-bit keys reach the 2^16-bin tier from ~8.4M
    size = torch.empty((), dtype=dtype).element_size()
    ut = {1: np.uint8, 2: np.uint16, 4: np.uint32}[size]
    bits = np.random.Generator(np.random.PCG64(size)).integers(
        0, 1 << (8 * size), size=n, dtype=ut)
    if dtype == torch.bool:
        bits &= ut(1)
    it = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[size]
    x = torch.from_numpy(bits.view({1: np.uint8, 2: np.int16, 4: np.int32}[size]))
    x = x.to(cuda)
    x = x.to(torch.bool) if dtype == torch.bool else x.view(dtype)
    rt.reset_launch_counts()
    out = rt.sort(x, config=rt.SortConfig(descending=descending))
    assert out.dtype == dtype and out.device == x.device
    want = _oracle(bits, dtype)
    if descending:
        want = want[::-1]
    got = (out.to(torch.uint8) if dtype == torch.bool else out.view(it)).cpu().numpy()
    assert np.array_equal(got.view(ut), want)
    counts = rt.launch_counts()
    if size <= 2 and dtype != torch.bool:
        assert counts["hist_pext"] == 1
        assert counts["regen_pdep" if size == 1 else "regen_pdep_windowed"] == 1


def test_masked_sort_on_card(cuda):
    mask = 0xF0F00000
    x = rand_plane(3_000_001, 17, cuda, mask).view(torch.uint32)
    rt.reset_launch_counts()
    out = rt.sort(x, value_mask=mask)
    want = np.sort(x.view(torch.int32).cpu().numpy().view(np.uint32))
    assert np.array_equal(out.view(torch.int32).cpu().numpy().view(np.uint32), want)
    assert rt.launch_counts()["hist_pext"] == 1 and rt.launch_counts()["regen_pdep"] == 1


# ---------------------------------------------------------------------------
# two-plane kernels: hist_pext2 (K3), regen_pdep2 (K6 / K9)


def rand_pair(n, seed, device, mask=2**64 - 1, dead=0):
    x = np.random.Generator(np.random.PCG64(seed)).integers(
        0, 1 << 64, size=n, dtype=np.uint64)
    x = (x & np.uint64(mask)) | np.uint64(dead & ~mask & (2**64 - 1))
    hi = (x >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = x.astype(np.uint32).view(np.int32)
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def mask64(nbits):
    """A 64-bit mask of nbits live bits split across the planes (hi gets
    nbits // 2 of them, at bit 52 and up; lo the rest, from bit 4)."""
    h = nbits // 2
    return (((1 << h) - 1) << 52) | (((1 << (nbits - h)) - 1) << 4)


# every bin count from 4 to 2^17, plus a 0 hi mask and a 0 lo mask
PAIR_MASKS = [mask64(b) for b in range(2, 18)] + [0x00000000FFFF0000,
                                                 0x0001FFFF00000000]


@pytest.mark.parametrize("mask", PAIR_MASKS, ids=hex)
@pytest.mark.parametrize("n", [7, 1_000_003])
def test_hist_pext2_matches_plain(cuda, mask, n):
    hi, lo = rand_pair(n, n ^ mask, cuda)
    mh, ml = mask >> 32, mask & 0xFFFFFFFF
    before = ck.launch_counts()["hist_pext2"]
    got = ck.hist_pext2(hi, lo, mh, ml)
    assert ck.launch_counts()["hist_pext2"] == before + 1
    assert torch.equal(got, ck.hist_pext2_plain(hi, lo, mh, ml))


def test_hist_pext2_unaligned_and_skewed(cuda):
    hi, lo = rand_pair(100_001, 5, cuda)
    hi, lo = hi[1:], lo[1:]                       # no 16-byte loads
    for mh, ml in ((0xFF, 0xFF00), (0, 0xFFFF), (0x1FFFF, 0)):
        assert torch.equal(ck.hist_pext2(hi, lo, mh, ml),
                           ck.hist_pext2_plain(hi, lo, mh, ml))
    same = torch.full((300_000,), 0x1234, dtype=torch.int32, device=cuda)
    assert torch.equal(ck.hist_pext2(same, same, 0xFF, 0xFF00),
                       ck.hist_pext2_plain(same, same, 0xFF, 0xFF00))


def _cum2(hi, lo, mh, ml):
    return torch.cumsum(ck.hist_pext2_plain(hi, lo, mh, ml), 0, dtype=torch.int32)


@pytest.mark.parametrize("mask", PAIR_MASKS, ids=hex)
@pytest.mark.parametrize("n", [1, 1025, 999_999])
def test_regen_pdep2_matches_plain(cuda, mask, n):
    hi, lo = rand_pair(n, n + mask, cuda, mask, dead=0x8000100000020003)
    mh, ml = mask >> 32, mask & 0xFFFFFFFF
    cum = _cum2(hi, lo, mh, ml)
    name = "regen_pdep2" if cum.numel() <= 1 << 10 else "regen_pdep2_windowed"
    before = ck.launch_counts()[name]
    ghi, glo = ck.regen_pdep2(cum, n, mh, ml, hi, lo)
    assert ck.launch_counts()[name] == before + 1
    phi, plo = ck.regen_pdep2_plain(cum, n, mh, ml, hi, lo)
    assert torch.equal(ghi, phi) and torch.equal(glo, plo)


@pytest.mark.parametrize("nbits", [8, 16, 17])
def test_regen_pdep2_skewed_and_sparse(cuda, nbits):
    n, mask = 2_000_003, mask64(nbits)
    mh, ml = mask >> 32, mask & 0xFFFFFFFF
    hi, lo = rand_pair(n, nbits, cuda, mask, dead=0x0000000100000001)
    k = min(1500, 1 << nbits)
    hi[k:] = hi[k].item()                         # one bin holds nearly all
    lo[k:] = lo[k].item()
    cum = _cum2(hi, lo, mh, ml)
    ghi, glo = ck.regen_pdep2(cum, n, mh, ml, hi, lo)
    phi, plo = ck.regen_pdep2_plain(cum, n, mh, ml, hi, lo)
    assert torch.equal(ghi, phi) and torch.equal(glo, plo)


def _u64(t):
    return t.cpu().numpy().view(np.uint64)


@pytest.mark.parametrize("mask,descending,counter", [
    (0xF000000000000F00, True, "regen_pdep2"),   # complemented: dead bits set
    (0x00FF00000000FF00, False, "regen_pdep2_windowed"),
])
def test_masked_u64_sort_on_card(cuda, mask, descending, counter):
    n = 9_000_001           # 2^16 bins reach the windowed tier from ~8.4M
    hi, lo = rand_pair(n, 23, cuda, mask)
    x = torch.stack([lo, hi], 1).view(torch.int64).view(-1).view(torch.uint64)
    rt.reset_launch_counts()
    out = rt.sort(x, value_mask=mask, config=rt.SortConfig(descending=descending))
    want = np.sort(_u64(x))
    assert np.array_equal(_u64(out), want[::-1] if descending else want)
    counts = rt.launch_counts()
    assert counts["hist_pext2"] == 1 and counts[counter] == 1


@pytest.mark.parametrize("dtype", [torch.uint64, torch.int64, torch.float64],
                         ids=str)
def test_wide_sort_and_argsort_on_card(cuda, dtype):
    bits = np.random.Generator(np.random.PCG64(3)).integers(
        0, 1 << 64, size=3_000_001, dtype=np.uint64)
    bits[:4] = [0x7FF8000000000000, 0xFFF8000000000001, 0x0, 0x8000000000000000]
    x = torch.from_numpy(bits.view(np.int64)).to(cuda).view(dtype)
    if dtype == torch.float64:
        key = np.where(bits >> np.uint64(63), ~bits, bits | np.uint64(1 << 63))
    else:
        key = bits ^ np.uint64(1 << 63) if dtype == torch.int64 else bits
    perm = np.argsort(key, kind="stable")
    assert np.array_equal(_u64(rt.sort(x)), bits[perm])
    assert np.array_equal(rt.argsort(x).view(torch.int32).cpu().numpy(),
                          perm.astype(np.int32))


# ---------------------------------------------------------------------------
# the dense-domain tier: hist / hist_multi (K1), regen (K4 / K7)


@pytest.mark.parametrize("drop_ge,offset", [(None, 0), (300, 0), (None, 0x9E3779B9),
                                            (1 << 17, 0x7FFFFF00)])
@pytest.mark.parametrize("bits", [1, 8, 10, 15, 16, 17, 18])
@pytest.mark.parametrize("n", [7, 1_000_003])
def test_hist_matches_plain(cuda, n, bits, drop_ge, offset):
    w = rand_plane(n, n ^ bits, cuda, mask=(1 << (bits + 1)) - 1) + i32(offset)
    before = ck.launch_counts()["hist"]
    got = ck.hist(w, 0, bits, drop_ge=drop_ge, offset=offset)
    assert ck.launch_counts()["hist"] == before + 1
    assert torch.equal(got, ck.hist_plain(w, 0, bits, drop_ge, offset))


@pytest.mark.parametrize("bits,pass_index", [(8, 3), (11, 2), (16, 1)])
def test_hist_upper_digits_match_plain(cuda, bits, pass_index):
    w = rand_plane(1_000_003, bits, cuda)
    assert torch.equal(ck.hist(w, pass_index, bits),
                       ck.hist_plain(w, pass_index, bits))


@pytest.mark.parametrize("bits", [1, 4, 8, 11, 16, 18])
@pytest.mark.parametrize("n", [7, 1_000_003])
def test_hist_multi_matches_plain(cuda, n, bits):
    w = rand_plane(n, n + bits, cuda)
    before = ck.launch_counts()["hist_multi"]
    got = ck.hist_multi(w, bits)
    assert ck.launch_counts()["hist_multi"] == before + 1
    assert torch.equal(got, ck.hist_multi_plain(w, bits))


@pytest.mark.parametrize("bits", [8, 16, 18])
def test_hist_skewed_single_value_and_unaligned(cuda, bits):
    n = 2_000_003
    w = rand_plane(n, bits, cuda, mask=(1 << bits) - 1)
    w[: n * 9 // 10] = 0x155                          # 90% of the keys one value
    assert torch.equal(ck.hist(w, 0, bits), ck.hist_plain(w, 0, bits))
    same = torch.full((n,), 0x2AA, dtype=torch.int32, device=cuda)
    assert torch.equal(ck.hist(same, 0, bits), ck.hist_plain(same, 0, bits))
    assert torch.equal(ck.hist(w[1:], 0, bits, drop_ge=1 << (bits - 1)),
                       ck.hist_plain(w[1:], 0, bits, 1 << (bits - 1)))
    assert torch.equal(ck.hist_multi(w[3:], 8), ck.hist_multi_plain(w[3:], 8))


def _dense_cum(n, bins, seed, device):
    c = rand_plane(n, seed, device, mask=bins - 1)
    return torch.cumsum(ck.hist_plain(c, 0, bins.bit_length() - 1), 0, dtype=torch.int32)


@pytest.mark.parametrize("offset", [0, 0xFFFFFF00])
@pytest.mark.parametrize("bins", [4, 256, 1024, 2048, 1 << 16, 1 << 17])
@pytest.mark.parametrize("n", [1, 5, 1025, 999_999])
def test_regen_matches_plain(cuda, n, bins, offset):
    cum = _dense_cum(n, bins, n + bins, cuda)
    name = "regen" if bins <= 1 << 10 else "regen_windowed"
    before = ck.launch_counts()[name]
    got = ck.regen(cum, n, offset)
    assert ck.launch_counts()[name] == before + 1
    assert torch.equal(got, ck.regen_plain(cum, n, offset))


@pytest.mark.parametrize("bins", [1024, 1 << 16, 1 << 17])
def test_regen_skewed_and_sparse(cuda, bins):
    n = 2_000_003
    c = torch.full((n,), bins - 2, dtype=torch.int32, device=cuda)
    k = min(1500, bins)
    c[:k] = torch.randperm(bins, device=cuda)[:k].to(torch.int32)
    cum = torch.cumsum(ck.hist_plain(c, 0, bins.bit_length() - 1), 0, dtype=torch.int32)
    assert torch.equal(ck.regen(cum, n, 77), ck.regen_plain(cum, n, 77))


@pytest.fixture
def no_plain(monkeypatch):
    """Make every plain version of K1, K4 and K7 raise: a CUDA input that
    reached one would fail the test."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    for name in ("hist_plain", "hist_multi_plain", "regen_plain"):
        monkeypatch.setattr(ck, name, boom)


def _u32(t):
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("base,span,n,counter", [
    (0x9E3779B9, 50_000, 9_000_001, "regen_windowed"),
    (0x7FFFFE00, 1000, 200_000, "regen"),
])
def test_device_probe_runs_the_kernels(cuda, no_plain, base, span, n, counter):
    x = (np.uint64(base) + np.random.Generator(np.random.PCG64(span)).integers(
        0, span, size=n).astype(np.uint64)).astype(np.uint32)
    t = torch.from_numpy(x.view(np.int32)).to(cuda).view(torch.uint32)
    rt.reset_launch_counts()
    out = rt.sort(t, config=rt.SortConfig(device_probe=True))
    assert np.array_equal(_u32(out), np.sort(x))
    counts = rt.launch_counts()
    assert counts["hist"] == 1 and counts[counter] == 1
    rt.reset_launch_counts()
    out = rt.sort(t, config=rt.SortConfig(device_probe=True, descending=True))
    assert np.array_equal(_u32(out), np.sort(x)[::-1])
    assert rt.launch_counts()[counter] == 1


def test_device_probe_u64_and_wide_keys_on_card(cuda, no_plain):
    rng = np.random.Generator(np.random.PCG64(5))
    ts = np.uint64(0x0000018F00000000) + rng.integers(0, 60_000, size=9_000_001
                                                      ).astype(np.uint64)
    wide = rng.integers(0, 1 << 64, size=3_000_001, dtype=np.uint64)
    cfg = rt.SortConfig(device_probe=True)
    for x, counter in ((ts, "regen_windowed"), (wide, None)):
        t = torch.from_numpy(x.view(np.int64)).to(cuda).view(torch.uint64)
        rt.reset_launch_counts()
        out = rt.sort(t, config=cfg)
        assert np.array_equal(out.view(torch.int64).cpu().numpy().view(np.uint64),
                              np.sort(x))
        counts = rt.launch_counts()
        assert counts["hist"] == (1 if counter else 0)
        if counter:
            assert counts[counter] == 1


def test_dense_entry_points_run_the_kernels(cuda, no_plain):
    from radix_sorting_tpu_torch.ops import counting_engine, histogram
    rng = np.random.Generator(np.random.PCG64(9))
    rt.reset_launch_counts()
    x = rng.integers(0, 1 << 32, size=1_000_003, dtype=np.uint32) & np.uint32(0x3FF)
    w = torch.from_numpy(x.view(np.int32)).to(cuda)
    assert np.array_equal(_u32(counting_engine.sort_word_counting(w, 0x3FF, True)),
                          np.sort(x)[::-1])
    c = rng.integers(0, 2048, size=300_000).astype(np.uint32)
    got = counting_engine.counting_sort_compact(
        torch.from_numpy(c.view(np.int32)).to(cuda), 2048)
    assert np.array_equal(_u32(got), np.sort(c))
    v = rng.integers(0, 1010, size=1_000_003).astype(np.int32)
    assert np.array_equal(rt.bincount(torch.from_numpy(v).to(cuda), length=1000).cpu().numpy(),
                          np.bincount(v[v < 1000], minlength=1000))
    u16 = rng.integers(0, 5000, size=200_000).astype(np.uint16)
    vals, count = rt.bitmap_unique_sort(u16, device=cuda)
    uniq = np.unique(u16)
    assert int(count) == uniq.size and np.array_equal(vals[: uniq.size], uniq)
    hm = histogram.multi_digit_histogram((w,), 8)
    assert np.array_equal(hm.cpu().numpy()[0], np.bincount(x & 0xFF, minlength=256))
    counts = rt.launch_counts()
    assert counts["hist"] == 4 and counts["hist_multi"] == 1
    assert counts["regen"] == 1 and counts["regen_windowed"] == 1


def test_dynamic_probe_on_card(cuda):
    x = rand_plane(3_000_001, 31, cuda, 0xF0F00000).view(torch.uint32)
    rt.reset_launch_counts()
    out = rt.sort(x, config=rt.SortConfig(dynamic_probe=True))
    assert np.array_equal(_u32(out), np.sort(_u32(x)))
    assert rt.launch_counts()["hist_pext"] == 1 and rt.launch_counts()["regen_pdep"] == 1


# ---------------------------------------------------------------------------
# the group-by tier: whist (K10), whist_f32 (K11)


def _f32_bound(keys, weights, bins, drop_ge):
    """Per-bin float64 sums and sum|w| * 2^-14 + 1e-5, the K11 bound."""
    k = keys.long() & 0xFFFFFFFF
    keep = k < drop_ge
    w64 = weights.double()[keep]
    ref = torch.zeros(bins, dtype=torch.float64, device=keys.device)
    ref.index_add_(0, k[keep], w64)
    absum = torch.zeros_like(ref).index_add_(0, k[keep], w64.abs())
    return ref, absum * 2.0 ** -14 + 1e-5


@pytest.mark.parametrize("bits,drop", [(2, 3), (10, 1000), (14, 1 << 14), (15, 30_000),
                                       (16, 1 << 16), (17, 100_000)])
@pytest.mark.parametrize("n", [7, 1_000_003])
def test_whist_matches_plain(cuda, n, bits, drop):
    keys = rand_plane(n, n ^ bits, cuda, mask=(1 << bits) - 1)
    vals = rand_plane(n, n + bits, cuda)
    before = ck.launch_counts()["whist"]
    counts, sums = ck.whist(keys, vals, bits, drop)
    assert ck.launch_counts()["whist"] == before + 1
    pc, ps = ck.whist_plain(keys, vals, bits, drop)
    assert torch.equal(counts, pc) and torch.equal(sums, ps)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("bits,drop", [(2, 4), (10, 1000), (14, 1 << 14), (15, 1 << 15),
                                       (16, 50_000)])
@pytest.mark.parametrize("n", [7, 1_000_003])
def test_whist_f32_matches_plain(cuda, n, bits, drop, with_counts):
    keys = rand_plane(n, n ^ bits, cuda, mask=(1 << bits) - 1)
    w = torch.from_numpy(np.random.Generator(np.random.PCG64(bits)).standard_normal(n)
                         .astype(np.float32) * 100).to(cuda)
    name = "whist_f32_counts" if with_counts else "whist_f32"
    before = ck.launch_counts()[name]
    got = ck.whist_f32(keys, w, bits, drop, with_counts)
    assert ck.launch_counts()[name] == before + 1
    plain = ck.whist_f32_plain(keys, w, bits, drop, with_counts)
    if with_counts:
        assert torch.equal(got[0], plain[0])
        got, plain = got[1], plain[1]
    ref, bound = _f32_bound(keys, w, 1 << bits, drop)
    assert bool(((got.double() - ref).abs() <= bound).all())
    assert bool(((plain.double() - ref).abs() <= bound).all())


def test_whist_skewed_unaligned_and_non_finite(cuda):
    n = 2_000_003
    keys = rand_plane(n, 1, cuda, mask=1023)
    keys[: n * 9 // 10] = 7                           # 90% of the rows one group
    vals = rand_plane(n, 2, cuda)
    for k, v in ((keys, vals), (keys[1:], vals[1:])):  # 4-byte offset: no 16-byte loads
        assert all(torch.equal(a, b) for a, b in
                   zip(ck.whist(k, v, 10, 1000), ck.whist_plain(k, v, 10, 1000)))
    w = torch.ones(n, dtype=torch.float32, device=cuda)
    w[5], w[6], w[8] = float("inf"), float("nan"), float("-inf")
    keys[5], keys[6], keys[8] = 3, 4, 3                # 3: inf - inf; 4: NaN
    counts, sums = ck.whist_f32(keys, w, 10, 1024, with_counts=True)
    pc, ps = ck.whist_f32_plain(keys, w, 10, 1024, with_counts=True)
    assert torch.equal(counts, pc)
    finite = torch.isfinite(ps)
    assert torch.equal(torch.isfinite(sums), finite) and int((~finite).sum()) == 2
    assert torch.equal(sums[finite], ps[finite])       # integer-valued sums: exact


def test_group_by_entry_points_run_the_kernels(cuda, no_plain, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a plain torch call ran on a CUDA tensor")
    monkeypatch.setattr(ck, "whist_plain", boom)
    monkeypatch.setattr(ck, "whist_f32_plain", boom)
    monkeypatch.setattr(torch.Tensor, "index_add_", boom)
    monkeypatch.setattr(torch, "bincount", boom)
    rng = np.random.Generator(np.random.PCG64(11))
    n, G = 1_000_003, 1000
    k = rng.integers(0, G, size=n).astype(np.int32)
    v = rng.integers(-1000, 1000, size=n).astype(np.int32)
    f = rng.standard_normal(n).astype(np.float32)
    kt, vt, ft = (torch.from_numpy(a).to(cuda) for a in (k, v, f))
    rt.reset_launch_counts()
    uk, s, ng = rt.group_reduce(kt, vt, groups=G)
    assert int(ng) == G and np.array_equal(uk.cpu().numpy(), np.arange(G))
    assert np.array_equal(s.cpu().numpy(), np.bincount(k, weights=v).astype(np.int32))
    _, m, _ = rt.group_reduce(kt, ft, reduce="mean", groups=G)
    want = np.bincount(k, weights=f) / np.bincount(k)
    assert np.allclose(m.cpu().numpy(), want, rtol=1e-4, atol=1e-4)
    uk, c, _ = rt.value_counts(kt, groups=G)
    assert np.array_equal(c.cpu().numpy(), np.bincount(k))
    x = ((rng.integers(0, 100, size=n) + 0.5) / 25 - 2).astype(np.float32)  # bin centres
    h, edges = rt.histogram(torch.from_numpy(x).to(cuda), bins=100, range=(-2, 2),
                            weights=ft)
    he, _ = np.histogram(x, bins=edges, weights=f.astype(np.float64))
    assert np.allclose(h.cpu().numpy(), he, rtol=1e-4, atol=1e-3)
    counts = rt.launch_counts()
    assert counts["whist"] == 1 and counts["whist_f32_counts"] == 1
    assert counts["whist_f32"] == 1 and counts["hist"] == 1
