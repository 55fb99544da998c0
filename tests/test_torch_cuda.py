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


# the histogram kernel's launch shapes (csrc/hist.cu): every shape the rule
# picks and every shape scripts/hist_shapes.py times, bit for bit

# (radix_bits, passes): totals from 256 to 2^19 counters, narrow and wide
HIST_TOTALS = [(8, 1), (8, 4), (11, 3), (15, 1), (14, 3), (16, 1), (15, 3), (17, 1),
               (16, 2), (18, 1), (17, 2), (18, 2)]


def _digits_plain(w, bits, passes, drop_ge=None, offset=0):
    return torch.stack([ck.hist_plain(w, p, bits, drop_ge, offset) for p in range(passes)])


def _digits_launch(w, bits, passes, shape, drop_ge=None, offset=0):
    return ck._hist_launch("rst_hist", w.device, passes << bits, shape, w.data_ptr(),
                           w.shape[0], offset & 0xFFFFFFFF, 0, bits, passes,
                           ck._drop_bound(drop_ge)).view(passes, -1)


@pytest.mark.parametrize("skew", ["uniform", "90% one value"])
@pytest.mark.parametrize("bits,passes", HIST_TOTALS)
def test_hist_every_shape_matches_plain(cuda, bits, passes, skew):
    w = rand_plane(1_000_003, bits * passes, cuda)[1:]       # a word off the 16-byte grid
    if skew != "uniform":
        w[: w.shape[0] * 9 // 10] = 0x5A5A5A5A
    want = _digits_plain(w, bits, passes)
    shapes = ck.hist_shape_candidates(passes << bits)
    assert shapes[0] == ck.hist_shape(passes << bits)
    for shape in shapes:
        assert torch.equal(_digits_launch(w, bits, passes, shape), want), shape.label()


@pytest.mark.parametrize("n", [0, 1, 7, 4097, 4098, 4099, 70_001])
@pytest.mark.parametrize("bits", [8, 16, 17, 18])
def test_hist_short_inputs_in_every_row_count(cuda, n, bits):
    w = rand_plane(n + 3, n + bits, cuda)
    for start in range(4):                      # planes 0 to 3 words off the grid
        v = w[start: start + n]
        before = ck.launch_counts()["hist"]
        got = ck.hist(v, 0, bits)
        assert ck.launch_counts()["hist"] == before + 1
        assert torch.equal(got, ck.hist_plain(v, 0, bits))
        got = ck.hist_multi(v, bits)
        assert torch.equal(got, ck.hist_multi_plain(v, bits))


@pytest.mark.parametrize("bits,passes", [(16, 1), (18, 1), (8, 2), (11, 3), (16, 2), (17, 2)])
@pytest.mark.parametrize("drop_ge,offset", [(1 << 17, 0x7FFFFF00), (0, 5),
                                            ((1 << 32) - 1, 0x9E3779B9)])
def test_hist_drop_and_offset_when_wide(cuda, bits, passes, drop_ge, offset):
    mask = (1 << min(32, bits * passes + 1)) - 1
    w = rand_plane(1_000_002, bits, cuda, mask=mask) + i32(offset)
    for shape in ck.hist_shape_candidates(passes << bits):
        got = _digits_launch(w[2:], bits, passes, shape, drop_ge, offset)
        want = _digits_plain(w[2:], bits, passes, drop_ge, offset)
        assert torch.equal(got, want), shape.label()


@pytest.mark.parametrize("share", [9, 10])
def test_hist_16_bit_hand_off_under_contention(cuda, share):
    # 16M keys, 90% or all of them one value: in every block the common
    # value's 16-bit counter crosses 2^15 several times, so its hand-offs to
    # the output run while every thread keeps adding to it
    n = 1 << 24
    w = rand_plane(n + 3, share, cuda)[3:]
    w[: n * share // 10] = 0x2A55
    hi = rand_plane(n + 3, share + 1, cuda)[:n]
    hi[: n * share // 10] = 0x1C0
    cases = [("hist", lambda: ck.hist(w, 0, 16), lambda: ck.hist_plain(w, 0, 16)),
             ("hist", lambda: ck.hist(w, 0, 18), lambda: ck.hist_plain(w, 0, 18)),
             ("hist_multi", lambda: ck.hist_multi(w, 16), lambda: ck.hist_multi_plain(w, 16)),
             ("hist_multi", lambda: ck.hist_multi(w, 18), lambda: ck.hist_multi_plain(w, 18)),
             ("hist_pext", lambda: ck.hist_pext(w, 0xFFFF),
              lambda: ck.hist_pext_plain(w, 0xFFFF)),
             ("hist_pext", lambda: ck.hist_pext(w, 0x1FFFF),
              lambda: ck.hist_pext_plain(w, 0x1FFFF)),
             ("hist_pext2", lambda: ck.hist_pext2(hi, w, 0xC0, 0x3FFF),
              lambda: ck.hist_pext2_plain(hi, w, 0xC0, 0x3FFF))]
    for name, kernel, plain in cases:
        before = ck.launch_counts()[name]
        got = kernel()
        assert ck.launch_counts()[name] == before + 1
        assert torch.equal(got, plain()), name


@pytest.mark.parametrize("bits", [8, 11, 16, 18])
def test_hist_multi_skewed_and_one_value(cuda, bits):
    n = 1_000_001
    w = rand_plane(n, bits, cuda)
    w[: n * 9 // 10] = 0x155
    before = ck.launch_counts()["hist_multi"]
    assert torch.equal(ck.hist_multi(w, bits), ck.hist_multi_plain(w, bits))
    assert ck.launch_counts()["hist_multi"] == before + 1
    same = torch.full((n,), -7, dtype=torch.int32, device=cuda)
    assert torch.equal(ck.hist_multi(same, bits), ck.hist_multi_plain(same, bits))


@pytest.mark.parametrize("mask", [0xFF, 0x7FFF, 0xFFFF, 0x1FFFF, 0xF0F00000])
def test_hist_pext_every_shape_matches_plain(cuda, mask):
    bins = 1 << bin(mask).count("1")
    w = rand_plane(1_000_005, mask & 0xFFFF, cuda)[3:]
    for keys in (w, torch.where(w & 7 != 0, i32(0x1234567), w)):
        want = ck.hist_pext_plain(keys, mask)
        for shape in ck.hist_shape_candidates(bins):
            got = ck._hist_launch("rst_hist_pext", cuda, bins, shape, keys.data_ptr(),
                                  keys.shape[0], mask)
            assert torch.equal(got, want), shape.label()


@pytest.mark.parametrize("mask_hi,mask_lo", [(0x1FFFF, 0), (0, 0x1FFFF), (0xF00, 0xFF00F),
                                             (0xF0000000, 0xF00), (0xFF, 0xFF00)])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 2), (3, 3)])
def test_hist_pext2_every_shape_matches_plain(cuda, mask_hi, mask_lo, offsets):
    bins = 1 << (bin(mask_hi).count("1") + bin(mask_lo).count("1"))
    hi = rand_plane(700_007, 1, cuda)[offsets[0]: 700_000 + offsets[0]]
    lo = rand_plane(700_007, 2, cuda)[offsets[1]: 700_000 + offsets[1]]
    before = ck.launch_counts()["hist_pext2"]
    want = ck.hist_pext2_plain(hi, lo, mask_hi, mask_lo)
    assert torch.equal(ck.hist_pext2(hi, lo, mask_hi, mask_lo), want)
    assert ck.launch_counts()["hist_pext2"] == before + 1
    for shape in ck.hist_shape_candidates(bins):
        got = ck._hist_launch("rst_hist_pext2", cuda, bins, shape, hi.data_ptr(),
                              lo.data_ptr(), hi.shape[0], mask_hi, mask_lo)
        assert torch.equal(got, want), shape.label()


def test_hist_refuses_shapes_the_rule_cannot_give(cuda):
    w = rand_plane(1000, 0, cuda)
    bad = [(ck.HistShape(1024, 16, 2, 1, 1), 18, 1),    # counters without an owner
           (ck.HistShape(1024, 16, 4, 1, 1), 17, 1),    # rows that own none
           (ck.HistShape(1024, 15, 2, 1, 0), 16, 1),    # rows of 32-bit counters
           (ck.HistShape(1024, 15, 1, 2, 0), 15, 1),    # 256 KB a block
           (ck.HistShape(1024, 16, 1, 1, 0), 16, 1),    # 2^16 32-bit counters
           (ck.HistShape(1024, 17, 1, 1, 1), 17, 1),    # 2^17 16-bit counters
           (ck.HistShape(1024, 16, 1, 2, 1), 16, 1),    # copies of 16-bit counters
           (ck.HistShape(768, 8, 1, 1, 0), 8, 1)]       # threads
    for shape, bits, passes in bad:
        assert not ck.hist_shape_ok(shape, passes << bits)
        with pytest.raises(RuntimeError):
            _digits_launch(w, bits, passes, shape)


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


@pytest.mark.parametrize("share", [9, 10])
@pytest.mark.parametrize("bits", [15, 16, 17])
def test_whist_16_bit_hand_off_under_contention(cuda, bits, share):
    # 16M rows, 90% or all of them in one group: in every block the group's
    # 16-bit count crosses 2^15 several times, so its hand-offs to the output
    # run while every thread keeps adding to it
    n = 1 << 24
    keys = rand_plane(n, bits + share, cuda, mask=(1 << bits) - 1)
    keys[: n * share // 10] = (1 << bits) - 3
    vals = rand_plane(n, bits, cuda)
    assert ck.whist_shape(bits, "u32", True).half
    before = ck.launch_counts()["whist"]
    counts, sums = ck.whist(keys, vals, bits, 1 << bits)
    assert ck.launch_counts()["whist"] == before + 1
    pc, ps = ck.whist_plain(keys, vals, bits, 1 << bits)
    assert torch.equal(counts, pc) and torch.equal(sums, ps)
    w = torch.from_numpy(np.random.Generator(np.random.PCG64(bits)).standard_normal(n)
                         .astype(np.float32)).to(cuda)
    counts, sums = ck.whist_f32(keys, w, bits, (1 << bits) - 1, with_counts=True)
    pc, _ = ck.whist_f32_plain(keys, w, bits, (1 << bits) - 1, with_counts=True)
    assert torch.equal(counts, pc)
    ref, bound = _f32_bound(keys, w, 1 << bits, (1 << bits) - 1)
    assert bool(((sums.double() - ref).abs() <= bound).all())


@pytest.mark.parametrize("key_words,val_words", [(1, 1), (2, 2), (3, 3), (0, 1), (1, 3),
                                                 (3, 0)])
@pytest.mark.parametrize("bits", [10, 16])
def test_whist_off_the_16_byte_grid(cuda, bits, key_words, val_words):
    # keys and values 0 to 3 words off the 16-byte grid, lying the same way
    # (16-byte loads of both after a head) or not (the values word by word)
    n = 1_000_003
    keys = rand_plane(n + 3, bits, cuda, mask=(1 << bits) - 1)[key_words: key_words + n]
    keys[: n // 2] = 5
    vals = rand_plane(n + 3, bits + 1, cuda)[val_words: val_words + n]
    got = ck.whist(keys, vals, bits, (1 << bits) - 7)
    want = ck.whist_plain(keys, vals, bits, (1 << bits) - 7)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    w = torch.from_numpy(np.random.Generator(np.random.PCG64(bits)).standard_normal(n + 3)
                         .astype(np.float32)).to(cuda)[val_words: val_words + n]
    for with_counts in (False, True):
        got = ck.whist_f32(keys, w, bits, 1 << bits, with_counts)
        want = ck.whist_f32_plain(keys, w, bits, 1 << bits, with_counts)
        if with_counts:
            assert torch.equal(got[0], want[0])
            got = got[1]
        ref, bound = _f32_bound(keys, w, 1 << bits, 1 << bits)
        assert bool(((got.double() - ref).abs() <= bound).all())


@pytest.mark.parametrize("skew", ["uniform", "90% one group"])
@pytest.mark.parametrize("bits", [2, 10, 14, 15, 16, 17])
def test_whist_every_shape_matches_plain(cuda, bits, skew):
    n = 1_000_001
    keys = rand_plane(n + 1, bits, cuda, mask=(1 << bits) - 1)[1:]
    if skew != "uniform":
        keys[: n * 9 // 10] = 1
    vals = rand_plane(n + 1, bits + 2, cuda)[1:]
    w = torch.from_numpy(np.random.Generator(np.random.PCG64(bits)).standard_normal(n)
                         .astype(np.float32)).to(cuda)
    drop = (1 << bits) - 1
    want = ck.whist_plain(keys, vals, bits, drop)
    for shape in ck.whist_shape_candidates(bits, "u32", True):
        got = ck._whist_launch("rst_whist", keys, vals, bits, drop, True, shape)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), shape.label()
    ref, bound = _f32_bound(keys, w, 1 << bits, drop)
    for with_counts in (False, True):
        counts = ck.whist_f32_plain(keys, w, bits, drop, True)[0]
        for shape in ck.whist_shape_candidates(bits, "f32", with_counts):
            got = ck._whist_launch("rst_whist_f32", keys, w, bits, drop, with_counts, shape)
            if with_counts:
                assert torch.equal(got[0], counts), shape.label()
                got = got[1]
            assert bool(((got.double() - ref).abs() <= bound).all()), shape.label()


def test_whist_refuses_shapes_the_rule_cannot_give(cuda):
    keys = rand_plane(1000, 0, cuda, mask=0xFFFF)
    w = keys.float()
    bad = [(ck.WhistShape(1024, 15, 1, 1, 2), 16, "u32", True),   # bins without an owner
           (ck.WhistShape(1024, 14, 8, 0, 2), 16, "u32", True),   # rows that own none
           (ck.WhistShape(1024, 15, 2, 0, 2), 16, "u32", True),   # 256 KB a block
           (ck.WhistShape(1024, 16, 1, 1, 2), 16, "u32", True),   # 2^16 16-bit counts
           (ck.WhistShape(1024, 15, 2, 1, 2), 16, "f32", False),  # 16-bit counts, no counts
           (ck.WhistShape(1024, 15, 2, 1, 3), 16, "f32", True),   # loads a chunk
           (ck.WhistShape(1024, 15, 2, 1, 4), 16, "f32", True),   # four loads beside counts
           (ck.WhistShape(1024, 15, 2, 0, 4), 16, "u32", True),
           (ck.WhistShape(768, 10, 1, 0, 2), 10, "u32", True),    # threads
           (ck.WhistShape(1024, 11, 1, 0, 2), 10, "u32", True)]   # more bins than the table
    for shape, bits, sums, counts in bad:
        assert not ck.whist_shape_ok(shape, bits, counts)
        with pytest.raises(RuntimeError):
            if sums == "u32":
                ck._whist_launch("rst_whist", keys, keys, bits, 1 << bits, True, shape)
            else:
                ck._whist_launch("rst_whist_f32", keys, w, bits, 1 << bits, counts, shape)
    with pytest.raises(RuntimeError):      # K10 always counts
        ck._whist_launch("rst_whist", keys, keys, 16, 1 << 16, False,
                         ck.whist_shape(16, "f32", False))


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


# ---------------------------------------------------------------------------
# the LSD passes: lsd_hist (L1), lsd_scatter (L2); K12 bitonic


def _tile(bits):
    from radix_sorting_tpu_torch.ops.lsd_engine import lsd_tile
    return lsd_tile(8192, bits)


@pytest.mark.parametrize("shift", [0, 21])
@pytest.mark.parametrize("bits", [1, 8, 11, 12, 13, 15, 16])
@pytest.mark.parametrize("n", [7, 1_000_003])
def test_lsd_hist_matches_plain(cuda, n, bits, shift):
    w = rand_plane(n, n ^ bits, cuda)
    before = ck.launch_counts()["lsd_hist"]
    got = ck.lsd_hist(w, shift, bits, _tile(bits))
    assert ck.launch_counts()["lsd_hist"] == before + 1
    assert torch.equal(got, ck.lsd_hist_plain(w, shift, bits, _tile(bits)))


def _bases(w, shift, bits, tile):
    from radix_sorting_tpu_torch.ops.scan import scatter_bases
    return scatter_bases(ck.lsd_hist_plain(w, shift, bits, tile))


@pytest.mark.parametrize("planes", [1, 3, 33])
@pytest.mark.parametrize("bits", [1, 8, 11, 12, 13, 16])
@pytest.mark.parametrize("n", [7, 1_000_003])
def test_lsd_scatter_matches_plain(cuda, n, bits, planes):
    w = rand_plane(n, n + bits, cuda)
    w[::5] = w[1]                                  # ties inside every tile
    extra = [rand_plane(n, p, cuda) for p in range(planes - 1)]
    tile = _tile(bits)
    bases = _bases(w, 3, bits, tile)
    before = ck.launch_counts()["lsd_scatter"]
    got = ck.lsd_scatter(w, [w] + extra, 3, bits, tile, bases)
    assert ck.launch_counts()["lsd_scatter"] == before + -(-planes // 32)
    want = ck.lsd_scatter_plain(w, [w] + extra, 3, bits, tile, bases)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_lsd_scatter_small_tiles_and_skew(cuda):
    n = 2_000_003
    w = rand_plane(n, 4, cuda, mask=0xFF)
    w[: n * 9 // 10] = 0x55                        # 90% of the keys one digit
    for tile in (256, 1000, 8192):
        bases = _bases(w, 0, 8, tile)
        assert torch.equal(ck.lsd_scatter(w, [w], 0, 8, tile, bases)[0],
                           ck.lsd_scatter_plain(w, [w], 0, 8, tile, bases)[0])


def _lsd_pass_matches_plain(w, planes, shift, bits, tile):
    """L1 and L2 of one pass against their plain versions, bit for bit,
    one launch each (L2: one a 32 planes)."""
    before = ck.launch_counts()
    hist = ck.lsd_hist(w, shift, bits, tile)
    assert torch.equal(hist, ck.lsd_hist_plain(w, shift, bits, tile))
    bases = _bases(w, shift, bits, tile)
    got = ck.lsd_scatter(w, planes, shift, bits, tile, bases)
    after = ck.launch_counts()
    assert after["lsd_hist"] == before["lsd_hist"] + 1
    assert after["lsd_scatter"] == before["lsd_scatter"] + -(-len(planes) // 32)
    want = ck.lsd_scatter_plain(w, planes, shift, bits, tile, bases)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("tile", [1, 3, 1000, 4096, 8191, 16384, 65536, None])
@pytest.mark.parametrize("bits", [1, 4, 8, 11, 12, 16])
def test_lsd_pass_at_every_tile_matches_plain(cuda, bits, tile):
    """Each staged shape serves some tile (1,000: 256 x 8;
    4,096: 256 x 16; 8,191: 256 x 32); tiles of 16,384 and 65,536 keys take
    several stages of the largest, the last one short (n is no multiple of
    a stage)."""
    tile = tile or _tile(bits)
    n = 1_001 if tile < 1000 else 100_003          # n % 4 != 0; tiles x 2^bits stay small
    w = rand_plane(n, bits * 7 + tile, cuda)
    w[::3] = w[2]                                  # ties inside every tile
    _lsd_pass_matches_plain(w, [rand_plane(n, 5, cuda), w], 2, bits, tile)


@pytest.mark.parametrize("share", [1.0, 0.9])
@pytest.mark.parametrize("bits", [8, 11, 16])
def test_lsd_pass_skewed_matches_plain(cuda, bits, share):
    n = 3 * 65_536 + 5                             # at r = 16: whole tiles in one bin
    w = rand_plane(n, bits, cuda)
    w[: int(n * share)] = 0x5A5A5A5A
    idx = torch.arange(n, dtype=torch.int32, device=cuda)
    _lsd_pass_matches_plain(w, [w, idx], 0, bits, _tile(bits))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("bits", [8, 11, 16])
def test_lsd_pass_on_views_matches_plain(cuda, bits, offset):
    n = 200_003
    w = rand_plane(n + 4, offset, cuda)[offset:offset + n]   # keys off the 16-byte grid
    views = [rand_plane(n + 4, 10 + k, cuda)[k:k + n] for k in (1, 2, 3)]
    _lsd_pass_matches_plain(w, [w] + views, 5, bits, _tile(bits))


def test_lsd_scatter_refuses_other_shapes(cuda):
    w = rand_plane(10_000, 1, cuda)
    bases = _bases(w, 0, 8, 8192)
    good = ck.lsd_scatter_shape(8, 8192)
    for shape in (ck.LsdStageShape(192, 16, ck.lsd_stage_smem(192, 16, 8)),
                  good._replace(smem=good.smem + 4), None):   # None: the direct form
        with pytest.raises(RuntimeError):
            ck._lsd_scatter_launch(w, (w,), 0, 8, 8192, bases, shape)
    bases13 = _bases(w, 0, 13, 8192)                 # past the staged form's digits
    with pytest.raises(RuntimeError):
        ck._lsd_scatter_launch(w, (w,), 0, 13, 8192, bases13,
                               good._replace(smem=ck.lsd_stage_smem(good.threads,
                                                                    good.keys, 13)))


def _bitonic_planes(n, planes, keys, seed, device, distinct=16):
    rng = np.random.Generator(np.random.PCG64(seed))
    out = [rng.integers(0, distinct, size=n).astype(np.uint32) for _ in range(keys)]
    out += [rng.integers(0, 1 << 32, size=n, dtype=np.uint32) for _ in range(planes - keys)]
    return [torch.from_numpy(p.view(np.int32)).to(device) for p in out]


@pytest.mark.parametrize("planes,keys", [(1, 1), (2, 2), (3, 2), (2, 1), (12, 3), (32, 1)])
@pytest.mark.parametrize("n", [1, 5, 1024, 4097, 65_536, 131_072])
def test_bitonic_matches_plain(cuda, n, planes, keys):
    if n * planes > 131_072 * 12:
        pytest.skip("past the gate's plane budget")
    xs = _bitonic_planes(n, planes, keys, n + planes, cuda)
    before = ck.launch_counts()["bitonic"]
    got = ck.bitonic(xs, keys)
    assert ck.launch_counts()["bitonic"] == before + 1
    want = ck.bitonic_plain(xs, keys)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bitonic_at_the_plane_budget_edge(cuda):
    from radix_sorting_tpu_torch.ops.vmem_sort import sort_planes_vmem, vmem_sort_ok
    n = 1 << 17
    assert vmem_sort_ok(n, 12) and not vmem_sort_ok(n, 13)
    xs = _bitonic_planes(n, 12, 2, 7, cuda, distinct=1 << 20)
    got = sort_planes_vmem(xs, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ck.bitonic_plain(xs, 2)))
    k = torch.stack([x.long() & 0xFFFFFFFF for x in got[:2]])
    assert bool(((k[0, 1:] > k[0, :-1]) | ((k[0, 1:] == k[0, :-1])
                                           & (k[1, 1:] >= k[1, :-1]))).all())


@pytest.mark.parametrize("n,planes,keys", [(100, 33, 1), (1024, 40, 34), (1024, 1536, 2),
                                           (2048, 700, 1), (131_072, 12, 12)])
def test_bitonic_sorts_every_plane_count_the_gate_admits(cuda, n, planes, keys):
    from radix_sorting_tpu_torch.ops.vmem_sort import sort_planes_vmem, vmem_sort_ok
    assert vmem_sort_ok(n, planes)
    xs = _bitonic_planes(n, planes, keys, n + planes, cuda)
    if keys < planes:
        xs[keys] = torch.arange(n, dtype=torch.int32, device=cuda)
    before = ck.launch_counts()["bitonic"]
    got = sort_planes_vmem(xs, keys)
    assert ck.launch_counts()["bitonic"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ck.bitonic_plain(xs, keys)))
    if keys < planes:           # R1: the index plane is a permutation, records whole
        perm = got[keys].long()
        assert torch.equal(torch.sort(perm).values, torch.arange(n, device=cuda))
        assert all(torch.equal(x[perm], g) for x, g in zip(xs, got))


@pytest.mark.parametrize("planes,keys", [(1, 1), (2, 1), (2, 2), (3, 2), (4, 3)])
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 8191, 8193, (1 << 14) - 1, (1 << 14) + 1,
                               (1 << 17) - 3, 1 << 17])
def test_bitonic_routes_match_plain_with_ties(cuda, n, planes, keys):
    # key words of 4 values: ties decide where the payloads go
    xs = _bitonic_planes(n, planes, keys, 3 * n + planes, cuda, distinct=4)
    blocks = ck.bitonic_route(n, planes)
    size = ck.bitonic_pad_len(n)
    # one cluster from 8,192 keys, one block below; 4 planes of 2^17 fill no cluster
    assert blocks == (0 if (size, planes) == (1 << 17, 4) else 8 if size >= 8192 else 1)
    before = ck.launch_counts()["bitonic"]
    got = ck.bitonic(xs, keys)
    assert ck.launch_counts()["bitonic"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ck.bitonic_plain(xs, keys)))


@pytest.mark.parametrize("n,planes,keys,blocks", [
    (1 << 17, 3, 1, 8), (1 << 17, 3, 3, 8),      # the last plane count in one cluster
    (1 << 17, 4, 3, 0), (1 << 17, 12, 12, 0),    # past it: tiles and device-memory steps
    (1 << 16, 4, 2, 8), (1 << 16, 7, 2, 0),      # past 4 planes: tiles
    (4096, 4, 4, 1), (1024, 35, 34, 0), (4096, 14, 5, 0),
    ((1 << 17) + 1, 1, 1, 0), (1 << 18, 1, 1, 0)])   # past 2^17 padded keys: tiles
def test_bitonic_route_edges(cuda, n, planes, keys, blocks):
    assert ck.bitonic_route(n, planes) == blocks
    xs = _bitonic_planes(n, planes, keys, n + planes, cuda, distinct=4)
    before = ck.launch_counts()["bitonic"]
    got = ck.bitonic(xs, keys)
    assert ck.launch_counts()["bitonic"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ck.bitonic_plain(xs, keys)))


def test_lsd_and_bitonic_entry_points_run_the_kernels(cuda, no_plain, monkeypatch):
    from radix_sorting_tpu_torch.ops.vmem_sort import sort_planes_vmem

    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    for name in ("lsd_hist_plain", "lsd_scatter_plain", "bitonic_plain", "dma_copy_plain"):
        monkeypatch.setattr(ck, name, boom)
    rng = np.random.Generator(np.random.PCG64(12))
    n = 1_000_003
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    t = torch.from_numpy(x.view(np.int32)).to(cuda).view(torch.uint32)
    lsd = rt.SortConfig(strategy="lsd")
    rt.reset_launch_counts()
    assert np.array_equal(_u32(rt.sort(t, config=lsd)), np.sort(x))
    assert rt.launch_counts()["lsd_hist"] == 4 and rt.launch_counts()["lsd_scatter"] == 4
    dups = x & np.uint32(0xFF00)
    td = torch.from_numpy(dups.view(np.int32)).to(cuda).view(torch.uint32)
    perm = rt.argsort(td, config=lsd, index_dtype=torch.int64)
    assert np.array_equal(perm.cpu().numpy(), np.argsort(dups, kind="stable"))
    v = torch.arange(n, dtype=torch.int64, device=cuda)
    sk, sv = rt.sort_pairs(td, {"v": v, "f": v.float()}, config=lsd.replace(radix_bits=11))
    order = np.argsort(dups, kind="stable")
    assert np.array_equal(sv["v"].cpu().numpy(), order)
    assert np.array_equal(sv["f"].cpu().numpy(), order.astype(np.float32))
    m = x & np.uint32(0xF0F00000)
    tm = torch.from_numpy(m.view(np.int32)).to(cuda).view(torch.uint32)
    rt.reset_launch_counts()
    assert np.array_equal(_u32(rt.sort(tm, config=lsd, value_mask=0xF0F00000)), np.sort(m))
    assert rt.launch_counts()["lsd_scatter"] == 2           # two live digits
    k = torch.from_numpy(x[:4097].view(np.int32)).to(cuda)
    rt.reset_launch_counts()
    sk, si = sort_planes_vmem((k, torch.arange(4097, dtype=torch.int32, device=cuda)), 2)
    assert np.array_equal(si.cpu().numpy(), np.argsort(x[:4097], kind="stable"))
    assert rt.launch_counts()["bitonic"] == 1
    assert torch.equal(ck.dma_copy(k), k) and torch.equal(ck.dma_copy(k[3:]), k[3:])
    assert rt.launch_counts()["dma_copy"] == 2


@pytest.mark.parametrize("n", [1, 5, 8191, 8192, 8193, 1 << 24, (1 << 24) + 12_345])
def test_dma_copy_matches_plain(cuda, n):
    x = rand_plane(n, n, cuda)
    before = ck.launch_counts()["dma_copy"]
    got = ck.dma_copy(x)
    assert ck.launch_counts()["dma_copy"] == before + 1
    assert torch.equal(got, ck.dma_copy_plain(x)) and got.data_ptr() != x.data_ptr()


def _ring_words():
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ck.DMA_BULK_STAGES * ck.DMA_BULK_CHUNK_WORDS


@pytest.mark.parametrize("n", [1, 3, 4, 5, 8191, 8192, 8193, "ring-1", "ring", "ring+1",
                               1 << 24, 40_000_000, (1 << 24) + 12_345])
def test_dma_copy_sizes(cuda, n):
    # below one 16-byte vector; chunk counts below, at and past SMs x stages
    ring = _ring_words()
    n = {"ring-1": ring - ck.DMA_BULK_CHUNK_WORDS, "ring": ring,
         "ring+1": ring + ck.DMA_BULK_CHUNK_WORDS + 5}.get(n, n)
    x = rand_plane(n, n + 1, cuda)
    before = ck.launch_counts()["dma_copy"]
    got = ck.dma_copy(x)
    assert ck.launch_counts()["dma_copy"] == before + 1
    assert torch.equal(got, x)


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [5, 8193, 1_000_003])
def test_dma_copy_offset_views(cuda, offset, n):
    # offsets 1-3 words: misaligned, word by word; 4 words: aligned again
    x = rand_plane(n + offset, offset, cuda)[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 4)
    before = ck.launch_counts()["dma_copy"]
    got = ck.dma_copy(x)
    assert ck.launch_counts()["dma_copy"] == before + 1
    assert torch.equal(got, x)


def test_dma_copy_unaligned(cuda):
    x = rand_plane(100_003, 2, cuda)[1:]           # 4-byte offset: word by word
    assert torch.equal(ck.dma_copy(x), x)
    assert ck.dma_copy(x[:0]).numel() == 0


def _msd_operands(n, R, K, capr, seed, device, mask=0xFFFFFFFF):
    from radix_sorting_tpu_torch.scripts import exp_sol_round2
    _, shapes, st = exp_sol_round2.build_msd(n, R, K, capr)
    xs = st["row_sort"](rand_plane(n, seed, device, mask))
    s128, xp = st["spread_inputs"](xs, st["starts"](xs))
    return s128, xp, shapes["m"], shapes["d"]


@pytest.mark.parametrize("n,R,K,capr", [(1 << 16, 16, 16, 4), (1 << 20, 64, 32, 8),
                                        (40_000_000, 128, 128, 24), (999_936, 128, 2, 40)])
def test_msd_spread_matches_plain(cuda, n, R, K, capr):
    s128, xp, m, d = _msd_operands(n, R, K, capr, n, cuda)
    before = ck.launch_counts()["msd_spread"]
    got = ck.msd_spread(s128, xp, m, d, capr)
    assert ck.launch_counts()["msd_spread"] == before + 1
    assert torch.equal(got, ck.msd_spread_plain(s128, xp, m, d, capr))


def test_msd_spread_any_window(cuda):
    # windows that start anywhere, past the rows too, and d = 32
    s128, xp, m, d = _msd_operands(1 << 16, 16, 16, 4, 3, cuda)
    W = xp.shape[1]
    s = torch.randint(-6, W + 2, s128.shape, dtype=torch.int32, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(5))
    for dd in (d, 32, 1):
        assert torch.equal(ck.msd_spread(s, xp, m, dd, 4), ck.msd_spread_plain(s, xp, m, dd, 4))


def test_measurement_entry_points_run_the_kernels(cuda, monkeypatch, capsys):
    from radix_sorting_tpu_torch import cli
    from radix_sorting_tpu_torch.scripts import exp_sol_probe, exp_sol_round2
    from radix_sorting_tpu_torch.utils import keyfile

    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    for name in ("hist_pext_plain", "regen_pdep_plain", "dma_copy_plain", "msd_spread_plain",
                 "hist_plain", "regen_plain"):
        monkeypatch.setattr(ck, name, boom)
    rt.reset_launch_counts()
    assert cli.main(["1000000", "u32", "0xF0F00000"]) == 0
    assert '"verified": true' in capsys.readouterr().out
    assert rt.launch_counts()["hist_pext"] == 2 and rt.launch_counts()["regen_pdep"] == 2
    assert cli.main(["1000000", "f32"], device="cuda") == 0
    assert '"verified": true' in capsys.readouterr().out
    assert exp_sol_probe.probe_dma(cuda, n=1 << 20) > 0
    assert rt.launch_counts()["dma_copy"] == 60          # a warm run and two timed, of 20
    keys = keyfile.generate_keys(1 << 20)
    assert exp_sol_round2.check_msd(keys, cuda, 64, 32, 8)["bit_exact"]
    assert rt.launch_counts()["msd_spread"] == 1


# ---------------------------------------------------------------------------
# K13: the exchange of the distributed tier, D ranks on one card


def _rank_sends(D, m, dtype, cuda, seed, offset=0):
    """D per-rank (D, m) sends; ``offset`` elements past a fresh allocation,
    so that the rows start off the 16-byte grid."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    lim = 1 << min(8 * torch.tensor([], dtype=dtype).element_size() - 1, 62)
    out = []
    for _ in range(D):
        buf = torch.randint(-lim, lim, (D * m + offset,), dtype=dtype, device=cuda, generator=g)
        out.append(buf[offset:].view(D, m))
    return out


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("m,dtype,offset", [(1, torch.int32, 0), (37, torch.int32, 0),
                                            (4096, torch.int32, 0), (4096, torch.int32, 1),
                                            (1_250_001, torch.int32, 3), (37, torch.int16, 0),
                                            (37, torch.int16, 1), (5, torch.int64, 0),
                                            (0, torch.int32, 0)])
def test_rdma_exchange_matches_plain(cuda, D, m, dtype, offset):
    sends = _rank_sends(D, m, dtype, cuda, D * m + offset, offset)
    before = ck.launch_counts()["rdma_exchange"]
    got = ck.rdma_exchange(sends)
    assert ck.launch_counts()["rdma_exchange"] == before + (D if m else 0)
    for g, p in zip(got, ck.rdma_exchange_plain(sends)):
        assert g.dtype == dtype and torch.equal(g, p)
    for d in range(D):
        for s in range(D):
            assert torch.equal(got[d][s], sends[s][d])


def test_rdma_exchange_refuses_a_mixed_mesh(cuda):
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="all on CUDA or all on the CPU"):
        ck.rdma_exchange([a, a.to(cuda)])


@pytest.mark.parametrize("overlap", [False, True])
def test_distributed_sorts_take_k13(cuda, overlap, monkeypatch):
    from radix_sorting_tpu_torch import parallel as tpar

    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(ck, "rdma_exchange_plain", boom)
    mesh = tpar.make_sort_mesh(devices=[cuda] * 4)
    x = np.random.default_rng(7).integers(0, 1 << 32, size=1_000_003, dtype=np.uint32)
    x[: 400_000] = 0xBEEF                        # skew: uneven runs, many rounds
    before = ck.launch_counts()["rdma_exchange"]
    # a small chunk: many rounds, each shipping other data, so a receive
    # buffer reused before its placement would show
    out = tpar.distributed_sort(x, mesh, exchange="rdma", overlap=overlap, chunk=20_000)
    assert np.array_equal(tpar.gather_sorted(*out), np.sort(x))
    balanced = ck.launch_counts()["rdma_exchange"] - before
    assert balanced >= 4 * 10 and balanced % 4 == 0
    out = tpar.distributed_sort(x, mesh, method="shuffle", exchange="rdma", exact=True)
    assert np.array_equal(tpar.gather_sorted(*out), np.sort(x))
    assert ck.launch_counts()["rdma_exchange"] - before == balanced + 4   # one exchange
    assert all(s.device.type == "cuda" for s in out[0])


def test_dryrun_multichip_on_the_card(cuda):
    from radix_sorting_tpu_torch import parallel as tpar
    from radix_sorting_tpu_torch.parallel.dryrun import dryrun_multichip
    records = dryrun_multichip(tpar.make_sort_mesh(devices=[cuda] * 4), n=2_000_000,
                               n_rest=1 << 16, log=None)
    assert all(r["peak_mb"] is not None for r in records)
    assert records[1]["launches"].get("rdma_exchange", 0) > 0
    assert "rdma_exchange" not in records[0]["launches"]
