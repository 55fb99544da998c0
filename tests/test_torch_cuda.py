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

import functools

import numpy as np
import pytest
import torch

import radix_sorting_tpu_torch as rt
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import kdf
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


# Patterns of the 8-bit digits a warp step of K0's sweep ranks together
# (csrc/lsd.cu: a step is 32 keys that start at a multiple of 32).
RANK_PATTERNS = ("uniform", "entropy", "one digit a step", "two digits alternating",
                 "32 distinct a step")


def rank_keys(pattern: str, n: int, seed: int) -> np.ndarray:
    """``n`` u32 keys from ``seed`` whose bytes (the digits at shifts 0, 8,
    16 and 24) follow ``pattern`` in every step of 32 keys from a multiple
    of 32 (the last step may be short):

    - ``uniform``: uniform words;
    - ``entropy``: the AND of 3 uniform words (a bit is 1 with p = 1/8;
      about a third of the keys share digit 0 at each shift);
    - ``one digit a step``: every key of a step alike;
    - ``two digits alternating``: two digits a step, lane by lane, different
      in every byte;
    - ``32 distinct a step``: 32 different digits a step in every byte.
    """
    rng = np.random.Generator(np.random.PCG64(seed))
    words = lambda m: rng.integers(0, 1 << 32, size=m, dtype=np.uint32)  # noqa: E731
    if pattern == "uniform":
        return words(n)
    if pattern == "entropy":
        return words(n) & words(n) & words(n)
    step = np.arange(n) // 32
    lane = (np.arange(n) % 32).astype(np.uint32)
    steps = int(step[-1]) + 1 if n else 0
    if pattern == "one digit a step":
        return words(steps)[step]
    if pattern == "two digits alternating":
        a = words(steps)
        flip = rng.integers(1, 256, size=(steps, 4), dtype=np.uint32)   # no byte stays
        b = a ^ (flip << np.arange(0, 32, 8, dtype=np.uint32)).sum(1, dtype=np.uint32)
        return np.where(lane % 2 == 0, a[step], b[step])
    if pattern == "32 distinct a step":
        out = np.zeros(n, np.uint32)
        for shift in range(0, 32, 8):     # an odd multiplier: lanes 0..31 land apart mod 256
            base = rng.integers(0, 256, size=steps, dtype=np.uint32)
            odd = rng.integers(0, 128, size=steps, dtype=np.uint32) * 2 + 1
            out |= ((base[step] + lane * odd[step]) & 0xFF) << np.uint32(shift)
        return out
    raise ValueError(f"unknown rank pattern {pattern!r}")


# Orders of (hi, lo) keys for the presorted guard of the live-digit read
# (``ck.live_digits``): a descent is a key below the one before it in
# unsigned (hi, lo) order.
ORDER_CASES = ("random", "sorted", "all equal", "descent at 0", "descent at n - 1",
               "descent at a tile edge", "equal hi, descent in lo",
               "descent in hi, lo rising", "descent in lo, hi rising")


def rising(n: int, seed: int, bits: int = 32) -> np.ndarray:
    """``n`` strictly increasing keys of ``bits`` bits (uint32 up to 32
    bits, else uint64)."""
    dtype = np.uint32 if bits <= 32 else np.uint64
    x = np.unique(np.random.Generator(np.random.PCG64(seed)).integers(
        0, 1 << bits, size=n + 64, dtype=dtype))
    assert x.size >= n
    return x[:n]


def swapped(x: np.ndarray, i: int) -> np.ndarray:
    """``x`` with keys i - 1 and i swapped: one descent, at i, in a rising run."""
    y = x.copy()
    y[i - 1], y[i] = x[i], x[i - 1]
    return y


def order_keys(case: str, n: int, seed: int):
    """(hi, lo) uint32 planes of ``n`` >= 2 keys in the order ``case`` of
    :data:`ORDER_CASES` names (the tile: K0's, 8,192 keys). As one plane,
    lo alone: in order where the case's keys are, but for the last two
    cases (a descent in lo only where hi rises, none in lo)."""
    split = lambda k: ((k >> np.uint64(32)).astype(np.uint32), k.astype(np.uint32))  # noqa: E731
    rng = np.random.Generator(np.random.PCG64(seed))
    if case == "random":
        return split(rng.integers(0, 1 << 64, size=n, dtype=np.uint64))
    if case == "sorted":                            # ties, and both words vary
        return split(np.sort(rng.integers(0, n // 2 + 1, size=n)).astype(np.uint64)
                     * np.uint64(0x100000001))
    if case == "all equal":
        return split(np.full(n, 0xDEADBEEF01234567, np.uint64))
    at = {"descent at 0": 1, "descent at n - 1": n - 1,
          "descent at a tile edge": min(ck.K0_SWEEP_TILE, n - 1)}.get(case, n // 2)
    up = rising(n, seed)
    if case.startswith("descent at"):              # both words rise but at `at`
        return swapped(up, at), swapped(rising(n, seed + 1), at)
    if case == "equal hi, descent in lo":
        return np.full(n, 0x7FFFFFFF, np.uint32), swapped(up, at)
    if case == "descent in hi, lo rising":
        return swapped(up, at), rising(n, seed + 1)
    if case == "descent in lo, hi rising":
        return up, swapped(rising(n, seed + 1), at)
    raise ValueError(f"unknown order case {case!r}")


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
          torch.float16, torch.bfloat16, torch.uint32, torch.int32, torch.float32,
          torch.float8_e4m3fn]
FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float8_e4m3fn)


def _oracle(bits: np.ndarray, dtype) -> np.ndarray:
    """numpy sort of raw key bits by the reference's KDF order."""
    width = 8 * bits.dtype.itemsize
    b = bits.astype(np.uint64)
    top = np.uint64(1 << (width - 1))
    live = np.uint64((1 << width) - 1)
    if dtype in FLOATS:
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


@pytest.mark.parametrize("mask,descending,n,launched", [
    (0xF000000000000F00, True, 9_000_001, ("hist_pext2", "regen_pdep2")),  # dead bits set
    (0xF000000000000F00, False, 9_000_001, ("hist_pext2", "regen_pdep2")),
    # 2^16 bins reach the windowed tier from ~8.4M
    (0x00FF00000000FF00, False, 9_000_001, ("hist_pext2", "regen_pdep2_windowed")),
    # 24 live bits: one compacted plane, past K0's gate
    (0x0FFF00000000FFF0, False, 40_000_000, ("lsd_sort", "live_digits")),
])
def test_masked_u64_sort_on_card(cuda, mask, descending, n, launched):
    hi, lo = rand_pair(n, 23, cuda, mask)
    x = torch.stack([lo, hi], 1).view(torch.int64).view(-1).view(torch.uint64)
    rt.reset_launch_counts()
    out = rt.sort(x, value_mask=mask, config=rt.SortConfig(descending=descending))
    want = np.sort(_u64(x))
    assert out.device == x.device and out.dtype == x.dtype
    assert np.array_equal(_u64(out), want[::-1] if descending else want)
    counts = rt.launch_counts()
    assert all(counts[k] == 1 for k in launched), counts


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
    """One digit through ``rst_hist``; every digit of the word (no drop, no
    offset) through ``rst_live_digits``, as ``hist_multi`` launches it."""
    if passes > 1:
        assert passes == -(-32 // bits) and drop_ge is None and offset == 0
        return ck._live_launch((w,), bits, False, shape)[0]
    return ck._hist_launch("rst_hist", w.device, 1 << bits, shape, w.data_ptr(),
                           w.shape[0], offset & 0xFFFFFFFF, 0, bits,
                           ck._drop_bound(drop_ge)).view(1, -1)


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


# one digit: rst_hist drops and offsets (every digit of the word does neither)
@pytest.mark.parametrize("bits,passes", [(16, 1), (18, 1), (8, 1), (11, 1), (15, 1), (17, 1)])
@pytest.mark.parametrize("drop_ge,offset", [(1 << 17, 0x7FFFFF00), (0, 5),
                                            ((1 << 32) - 1, 0x9E3779B9)])
def test_hist_drop_and_offset_when_wide(cuda, bits, passes, drop_ge, offset):
    mask = (1 << min(32, bits * passes + 1)) - 1
    w = rand_plane(1_000_002, bits, cuda, mask=mask) + i32(offset)
    for shape in ck.hist_shape_candidates(passes << bits):
        got = _digits_launch(w[2:], bits, passes, shape, drop_ge, offset)
        want = _digits_plain(w[2:], bits, passes, drop_ge, offset)
        assert torch.equal(got, want), shape.label()


@pytest.mark.parametrize("n", [1 << 24, 40_000_000])
@pytest.mark.parametrize("share", [9, 10])
def test_hist_16_bit_hand_off_under_contention(cuda, share, n):
    # 16M and 40M keys, 90% or all of them one value: in every block the
    # common value's 16-bit counter crosses 2^15 several times, so its
    # hand-offs to the output run while every thread keeps adding to it
    w = rand_plane(n + 3, share, cuda)[3:]
    w[: n * share // 10] = 0x2A55
    hi = rand_plane(n + 3, share + 1, cuda)[:n]
    hi[: n * share // 10] = 0x1C0
    cases = [("hist", lambda: ck.hist(w, 0, 16), lambda: ck.hist_plain(w, 0, 16)),
             ("hist", lambda: ck.hist(w, 0, 18), lambda: ck.hist_plain(w, 0, 18)),
             ("hist", lambda: ck.hist(w, 0, 17, drop_ge=0xC0000000),
              lambda: ck.hist_plain(w, 0, 17, 0xC0000000)),
             ("hist_multi", lambda: ck.hist_multi(w, 16), lambda: ck.hist_multi_plain(w, 16)),
             ("hist_multi", lambda: ck.hist_multi(w, 18), lambda: ck.hist_multi_plain(w, 18)),
             ("hist_pext", lambda: ck.hist_pext(w, 0xFFFF),
              lambda: ck.hist_pext_plain(w, 0xFFFF)),
             ("hist_pext", lambda: ck.hist_pext(w, 0x1FFFF),
              lambda: ck.hist_pext_plain(w, 0x1FFFF)),
             ("hist_pext2", lambda: ck.hist_pext2(hi, w, 0xC0, 0x3FFF),
              lambda: ck.hist_pext2_plain(hi, w, 0xC0, 0x3FFF)),
             ("hist_pext2", lambda: ck.hist_pext2(hi, w, 0x1FF, 0xFF00),
              lambda: ck.hist_pext2_plain(hi, w, 0x1FF, 0xFF00))]
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


# K1's live-digit read (live_digits): every plane's digit histograms and the
# descent flag in one launch, against its plain version


def _live_matches_plain(words, bits, order=True):
    """One live_digits launch against live_digits_plain, bit for bit; its flag."""
    before = ck.launch_counts()["live_digits"]
    hists, descent = ck.live_digits(words, bits, order)
    assert ck.launch_counts()["live_digits"] == before + 1
    want, flag = ck.live_digits_plain(words, bits, order)
    assert torch.equal(hists, want)
    if not order:
        assert descent is None and flag is None
        return None
    assert descent.dtype == torch.int32 and descent.shape == ()
    assert int(descent) == int(flag)
    return int(descent)


# the whole-step read's chunk: 16-byte loads a thread (4 for one plane, 2 a
# plane for two) times 1,024 threads, four keys each (csrc/hist.cu)
LIVE_N = 3 * 16384 + 4003


def _live_descent_at(where, planes, lead):
    """Index i of the one descent (key i below key i - 1) of a LIVE_N-key
    read whose head is ``lead`` words: at an edge of the kernel's read."""
    chunk = 4 * (4 if planes == 1 else 2) * 1024
    quads = (LIVE_N - lead) // 4
    short = lead + 4 * (quads // (chunk // 4)) * (chunk // 4)
    return {"in order": None, "key 1": 1, "head to the groups": max(lead, 1),
            "warp edge": lead + 128, "a thread's next group": lead + 4 * 1024,
            "chunk edge": lead + chunk, "short chunk": short,
            "inside the short chunk": short + 4 * 37 + 2,
            "tail": min(lead + 4 * quads, LIVE_N - 1), "last key": LIVE_N - 1}[where]


def _live_planes(planes, at, offsets, device):
    """``planes`` planes (most significant first) of LIVE_N rising keys, key
    ``at`` below key ``at - 1`` (None: none), hi in runs of 37 equal words
    (a descent in lo alone inside a run, in hi across one); each plane a
    view ``offsets[p]`` words into a fresh buffer."""
    hi = (np.arange(LIVE_N) // 37).astype(np.uint32)
    lo = rising(LIVE_N, at or 0)
    if at is not None:
        hi, lo = swapped(hi, at), swapped(lo, at)
    out = []
    for a, off in zip((hi, lo)[2 - planes:], offsets[2 - planes:]):
        buf = torch.zeros(LIVE_N + 4, dtype=torch.int32, device=device)
        buf[off:off + LIVE_N] = torch.from_numpy(a.view(np.int32)).to(device)
        out.append(buf[off:off + LIVE_N])
    return tuple(out)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("where", ["in order", "key 1", "head to the groups", "warp edge",
                                   "a thread's next group", "chunk edge", "short chunk",
                                   "inside the short chunk", "tail", "last key"])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (2, 2), (3, 3), (1, 0)],
                         ids=["aligned", "1 word in", "2 words in", "3 words in",
                              "hi 1 word in"])
@pytest.mark.parametrize("planes", [1, 2])
def test_live_digits_finds_a_descent_at_every_edge_of_the_read(cuda, planes, offsets, where,
                                                              bits):
    """One descent at an edge of the read (the 16-byte head, a warp's lane
    0, a thread's next group, a block's chunk, the short chunk, the tail),
    the planes 0 to 3 words off the 16-byte grid; r = 8 (32-bit counters)
    and 16 (16-bit counters in grid rows, the flag from row 0)."""
    lead = (4 - offsets[1]) % 4
    at = _live_descent_at(where, planes, lead)
    words = _live_planes(planes, at, offsets, cuda)
    assert words[-1].data_ptr() % 16 == 4 * offsets[1]
    assert _live_matches_plain(words, bits) == (at is not None)
    _live_matches_plain(words, bits, order=False)


@pytest.mark.parametrize("where", ["in order", "key 1", "head to the groups", "warp edge",
                                   "a thread's next group", "chunk edge", "short chunk",
                                   "inside the short chunk", "tail", "last key"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "one key in"])
def test_live_digits_pair_finds_a_descent_at_every_edge_of_the_read(cuda, offset, where):
    """The pair read (two planes as the halves of one 64-bit buffer, r = 8)
    with one descent at each edge of the read, the buffer on the 16-byte
    grid or one key off it (a head of one key): the plain version's flag
    and histograms, and the dense planes' read of the same keys."""
    at = _live_descent_at(where, 2, offset)
    hi, lo = _live_planes(2, at, (0, 0), cuda)
    words = torch.zeros(2 * (LIVE_N + 1), dtype=torch.int32, device=cuda)
    keys = words[2 * offset:2 * (offset + LIVE_N)]
    keys[0::2], keys[1::2] = lo, hi
    pair = kdf.halves(keys.view(torch.int64))
    assert pair[1].data_ptr() % 16 == 8 * offset
    assert _live_matches_plain(pair, 8) == (at is not None)
    _live_matches_plain(pair, 8, order=False)
    got, dense = ck.live_digits(pair, 8), ck.live_digits((hi, lo), 8)
    assert torch.equal(got[0], dense[0]) and int(got[1]) == int(dense[1])


@pytest.mark.parametrize("case", ORDER_CASES)
@pytest.mark.parametrize("n", [2, 3, 5, 4097, 8193])
@pytest.mark.parametrize("planes", [1, 2])
def test_live_digits_order_cases_match_plain(cuda, planes, n, case):
    hi, lo = order_keys(case, n, n + planes)
    words = tuple(torch.from_numpy(a.view(np.int32)).to(cuda)
                  for a in ((hi, lo) if planes == 2 else (lo,)))
    _live_matches_plain(words, 8)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("keys", ["uniform", "ordered", "one swap"])
@pytest.mark.parametrize("planes", [1, 2])
def test_live_digits_at_40m(cuda, planes, keys, bits):
    """The benchmark's size: 40M keys, uniform (a descent), ordered, and
    ordered but for one swapped pair at the middle (one descent); r = 8
    and 16 (16-bit counters in grid rows); one plane without the flag is
    hist_multi's launch, bit for bit."""
    n = 40_000_000
    words = tuple(rand_plane(n, 90 + p, cuda) for p in range(planes))
    if keys != "uniform":   # rising keys: 53 i (one plane), i * 2^20 + i % 7 (two)
        wrap = lambda v: ((v + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)  # noqa: E731
        i = torch.arange(n, device=cuda, dtype=torch.int64)
        key = (i << 20) | (i % 7)
        words = (wrap(i * 53),) if planes == 1 else (wrap(key >> 32), wrap(key))
        if keys == "one swap":
            for w in words:
                w[[n // 2 - 1, n // 2]] = w[[n // 2, n // 2 - 1]]
    assert _live_matches_plain(words, bits) == (keys != "ordered")
    if planes == 1:
        hists, none = ck.live_digits(words, bits, order=False)
        assert none is None and torch.equal(hists, ck.hist_multi(words[0], bits))


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


@pytest.mark.parametrize("keys", ["u64, constant hi, lo in a 60,000 range", "u64 full entropy",
                                  "u32 full entropy at 40M", "u64, constant hi, full lo at 40M"])
def test_device_probe_u64_and_wide_keys_on_card(cuda, no_plain, keys):
    """A narrow range takes K1 + K7; a wide one the sorter: torch.sort
    below K0's gates, K0 at 40M (the constant hi word of the last leaves
    one int32 operand)."""
    rng = np.random.Generator(np.random.PCG64(5))
    hi = np.uint64(0x0000018F00000000)
    x, launched = {
        "u64, constant hi, lo in a 60,000 range": lambda: (
            hi + rng.integers(0, 60_000, size=9_000_001).astype(np.uint64),
            {"hist": 1, "regen_windowed": 1, "lsd_sort": 0}),
        "u64 full entropy": lambda: (
            rng.integers(0, 1 << 64, size=3_000_001, dtype=np.uint64), {"hist": 0, "lsd_sort": 0}),
        "u32 full entropy at 40M": lambda: (
            rng.integers(0, 1 << 32, size=40_000_000, dtype=np.uint32), {"hist": 0, "lsd_sort": 1}),
        "u64, constant hi, full lo at 40M": lambda: (
            hi | rng.integers(0, 1 << 32, size=40_000_000, dtype=np.uint32).astype(np.uint64),
            {"hist": 0, "lsd_sort": 1}),
    }[keys]()
    signed = np.int64 if x.dtype == np.uint64 else np.int32
    t = torch.from_numpy(x.view(signed)).to(cuda).view(torch.uint64 if signed == np.int64
                                                        else torch.uint32)
    rt.reset_launch_counts()
    out = rt.sort(t, config=rt.SortConfig(device_probe=True))
    assert out.dtype == t.dtype and out.device == t.device
    assert np.array_equal(out.view(torch.int64 if signed == np.int64 else torch.int32)
                          .cpu().numpy().view(x.dtype), np.sort(x))
    counts = rt.launch_counts()
    assert {k: counts[k] for k in launched} == launched


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


@pytest.mark.parametrize("n", [1 << 24, 40_000_000])
@pytest.mark.parametrize("share", [9, 10])
@pytest.mark.parametrize("bits", [15, 16, 17])
def test_whist_16_bit_hand_off_under_contention(cuda, bits, share, n):
    # 16M and 40M rows, 90% or all of them in one group: in every block the
    # group's 16-bit count crosses 2^15 several times, so its hand-offs to
    # the output run while every thread keeps adding to it
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
    cnt = np.bincount(k)
    want = np.bincount(k, weights=f.astype(np.float64)) / cnt
    absum = np.bincount(k, weights=np.abs(f.astype(np.float64)))
    # K11's bound over the group's size, and 2^-22 of the mean for the division
    assert np.all(np.abs(m.cpu().numpy().astype(np.float64) - want)
                  <= (absum * 2**-14 + 1e-5) / cnt + np.abs(want) * 2**-22)
    k16 = rng.integers(0, 1 << 16, size=n).astype(np.uint32)
    v8 = rng.integers(0, 256, size=n).astype(np.uint8)
    uk, s8, ng = rt.group_reduce(torch.from_numpy(k16.view(np.int32)).to(cuda).view(torch.uint32),
                                 torch.from_numpy(v8).to(cuda), groups=1 << 16)
    assert int(ng) == 1 << 16
    assert np.array_equal(s8.view(torch.int32).cpu().numpy().view(np.uint32),
                          np.bincount(k16, weights=v8, minlength=1 << 16).astype(np.uint32))
    uk, c, _ = rt.value_counts(kt, groups=G)
    assert np.array_equal(c.cpu().numpy(), np.bincount(k))
    h, edges = rt.histogram(ft, bins=256)
    lo, hi = np.float32(edges[0]), np.float32(edges[-1])
    idx = np.floor((f - lo) * np.float32(256 / (edges[-1] - edges[0])))
    idx = np.where((f >= lo) & (f <= hi), np.minimum(idx, 255), 256).astype(np.int64)
    assert np.array_equal(edges, np.linspace(float(f.min()), float(f.max()), 257))
    assert np.array_equal(h.cpu().numpy(), np.bincount(idx, minlength=257)[:256])
    x = ((rng.integers(0, 100, size=n) + 0.5) / 25 - 2).astype(np.float32)  # bin centres
    h, edges = rt.histogram(torch.from_numpy(x).to(cuda), bins=100, range=(-2, 2),
                            weights=ft)
    he, _ = np.histogram(x, bins=edges, weights=f.astype(np.float64))
    assert np.allclose(h.cpu().numpy(), he, rtol=1e-4, atol=1e-3)
    counts = rt.launch_counts()
    assert counts["whist"] == 2 and counts["whist_f32_counts"] == 1
    assert counts["whist_f32"] == 1 and counts["hist"] == 2


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


@pytest.mark.parametrize("tile", [None, 7000, 16384], ids=["tile", "tiles of 7,000",
                                                         "stages"])
@pytest.mark.parametrize("bits,shift", [(4, 30), (8, 24), (11, 24), (12, 21)])
def test_lsd_pass_sentinel_digit_at_the_top(cuda, bits, shift, tile):
    """Short stages (a tile's last, n no multiple of a stage; every stage at
    tiles of 7,000) rank whole steps on csrc/lsd.cu's kSentinel past their
    end, also where the digit runs past bit 31; a third of the keys equal
    the sentinel."""
    tile = tile or _tile(bits)
    n = 100_003
    w = rand_plane(n, bits + shift, cuda)
    w[::3] = -1
    _lsd_pass_matches_plain(w, [w, rand_plane(n, 6, cuda)], shift, bits, tile)


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


# ---------------------------------------------------------------------------
# K0: one plane of AUTO / HW_SORT on the card through the LSD radix sort


def _gate_sizes():
    from radix_sorting_tpu_torch.ops.hw_engine import LSD_MIN_KEYS
    return {"below the gate": LSD_MIN_KEYS - 1, "at the gate": LSD_MIN_KEYS,
            "above the gate": max(3_000_017, LSD_MIN_KEYS + 12_345), "40M": 40_000_000}


@pytest.fixture
def sort_spy(monkeypatch):
    """The torch.sort calls made (the function and the method)."""
    calls = [0]
    real, real_method = torch.sort, torch.Tensor.sort

    def spy(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    def spy_method(self, *a, **k):
        calls[0] += 1
        return real_method(self, *a, **k)
    monkeypatch.setattr(torch, "sort", spy)
    monkeypatch.setattr(torch.Tensor, "sort", spy_method)
    return calls


@pytest.mark.parametrize("keys", ["ties", "16-bit values"])
@pytest.mark.parametrize("where", ["below the gate", "at the gate", "above the gate", "40M"])
def test_k0_matches_torch_sort_on_both_sides_of_the_gate(cuda, where, keys):
    """Keys-only, argsort with int64 and uint32 indices, and the guarded
    sort with an 8- and a 4-byte payload, against torch.sort(stable=True);
    16-bit values leave two live digits, so two sweeps a call, the index
    born in the first and written by the second."""
    from radix_sorting_tpu_torch.ops import hw_engine
    n = _gate_sizes()[where]
    calls = 0 if where == "below the gate" else 4
    live = 4 if keys == "ties" else 2
    w = rand_plane(n, n, cuda, mask=0xFFFFFFFF if keys == "ties" else 0xFFFF)
    w[::7] = w[3]                                  # ties: stability shows
    key = w ^ i32(1 << 31)
    ref = torch.sort(key, stable=True)
    pay = (torch.arange(n, dtype=torch.int64, device=cuda) * 3,
           rand_plane(n, 5, cuda).view(torch.float32))
    rt.reset_launch_counts()
    (s,), _ = hw_engine.sort_words((w,), stable=False)
    sw, perm = hw_engine.argsort_words((w,), torch.int64)
    _, perm32 = hw_engine.argsort_words((w,), torch.uint32)
    (gs,), (p8, p4) = hw_engine.sort_words_presort_guard((w,), pay)
    counts = rt.launch_counts()
    assert counts["lsd_sort"] == calls
    assert counts["live_digits"] == calls and counts["k0_sweep"] == live * calls
    assert counts["hist_multi"] == 0
    assert counts["lsd_hist"] == counts["lsd_scatter"] == 0
    for got in (s, sw[0], gs):
        assert torch.equal(got ^ i32(1 << 31), ref.values)
    assert perm.dtype == torch.int64 and perm32.dtype == torch.uint32
    assert torch.equal(perm, ref.indices)
    assert torch.equal(perm32.view(torch.int32).long(), ref.indices)
    assert torch.equal(p8, pay[0][ref.indices])
    assert torch.equal(p4.view(torch.int32), pay[1].view(torch.int32)[ref.indices])


@pytest.mark.parametrize("size", ["above the gate", "40M"])
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32], ids=str)
def test_one_plane_sorts_above_the_gate_call_no_torch_sort(cuda, sort_spy, dtype, size):
    """The headline's path: sort, argsort (int64 and uint32 indices) and
    sort_pairs of one plane take K0 alone, one live-digit read and four
    sweeps a call, no torch.sort; float specials (signed zeros, infinities,
    NaNs with payloads) among the keys."""
    n = _gate_sizes()[size]
    bits = np.random.Generator(np.random.PCG64(21)).integers(
        0, 1 << 32, size=n, dtype=np.uint32)
    bits[::11] = bits[5]
    bits[1:7] = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0xFFC00001, 0x7F800123]
    x = torch.from_numpy(bits.view(np.int32)).to(cuda).view(dtype)
    want = _oracle(bits, dtype)
    perm_want = np.argsort(bits, kind="stable") if dtype == torch.uint32 else None
    rt.reset_launch_counts()
    got = rt.sort(x)
    perm = rt.argsort(x, index_dtype=torch.int64)
    perm32 = rt.argsort(x)
    sk, sv = rt.sort_pairs(x, {"i": torch.arange(n, device=cuda, dtype=torch.int32)})
    counts = rt.launch_counts()
    assert sort_spy[0] == 0
    assert counts["lsd_sort"] == counts["live_digits"] == 4 and counts["k0_sweep"] == 16
    assert counts["hist_multi"] == counts["lsd_hist"] == counts["lsd_scatter"] == 0
    assert got.dtype == dtype and got.device == x.device
    assert np.array_equal(got.view(torch.int32).cpu().numpy().view(np.uint32), want)
    assert np.array_equal(sk.view(torch.int32).cpu().numpy().view(np.uint32), want)
    assert torch.equal(sv["i"].long(), perm)
    assert perm32.dtype == torch.uint32 and torch.equal(perm32.view(torch.int32).long(), perm)
    if perm_want is not None:
        assert np.array_equal(perm.cpu().numpy(), perm_want)


def test_40m_sort_pairs_of_a_float32_payload_takes_k0_alone(cuda, sort_spy):
    """The ``u32_sort_pairs`` cell's call at its size: 40M u32 keys (every
    eleventh one value, so stability shows) carrying a bare float32 payload
    through AUTO take one live-digit read and four sweeps, no torch.sort;
    both outputs bit for bit the configuration's ``expected``, the inputs
    left as they were."""
    from sortbench import manifest
    ref = manifest.load_module(manifest.HERE / "configs" / "u32_sort_pairs.py",
                               "u32_sort_pairs_reference")
    n = 40_000_000
    gen = torch.Generator(device=cuda).manual_seed(26)
    keys = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, device=cuda,
                         generator=gen)
    keys[::11] = keys[5]
    inputs = {"keys": keys.view(torch.uint32),
              "payload": torch.rand(n, device=cuda, generator=gen)}
    kept = {k: v.clone() for k, v in inputs.items()}
    rt.reset_launch_counts()
    got = ref.call(rt.sort_pairs, inputs)
    counts = rt.launch_counts()
    assert sort_spy[0] == 0
    assert counts["lsd_sort"] == counts["live_digits"] == 1 and counts["k0_sweep"] == 4
    assert counts["hist_multi"] == counts["lsd_hist"] == counts["lsd_scatter"] == 0
    assert isinstance(got, tuple) and [t.dtype for t in got] == [torch.uint32, torch.float32]
    for g, w in zip(got, ref.expected(inputs)):
        assert g.device == w.device and torch.equal(g.view(torch.int32), w.view(torch.int32))
    for k, v in inputs.items():
        assert torch.equal(v.view(torch.int32), kept[k].view(torch.int32))


def test_presorted_one_plane_launches_no_pass(cuda):
    n = _gate_sizes()["above the gate"]
    x = (torch.sort(rand_plane(n, 4, cuda) ^ i32(1 << 31)).values ^ i32(1 << 31)
         ).view(torch.uint32)                      # ascending as u32
    rt.reset_launch_counts()
    assert torch.equal(rt.sort(x), x)
    counts = rt.launch_counts()
    assert counts["lsd_sort"] == 1 and counts["live_digits"] == 1 and counts["hist_multi"] == 0
    assert counts["lsd_hist"] == counts["lsd_scatter"] == counts["k0_sweep"] == 0


@pytest.mark.parametrize("entry", ["sort", "sort presorted", "argsort", "argsort int64"])
def test_every_sync_of_a_k0_call_is_a_read_span(cuda, entry, tmp_path):
    """Under ``torch.cuda.set_sync_debug_mode("warn")`` each synchronizing
    operation warns: a 2^24-key K0 call warns as often as it records
    ``rst.read`` spans (one), so every host sync of the path is a read span,
    and each kernel's enqueue is one ``rst.launch``."""
    import json
    import warnings

    from radix_sorting_tpu_torch.utils import timing
    x = rand_plane(1 << 24, 9, cuda)
    if entry == "sort presorted":
        x = torch.sort(x ^ i32(1 << 31)).values ^ i32(1 << 31)
    x = x.view(torch.uint32)
    call = {"sort": lambda: rt.sort(x), "sort presorted": lambda: rt.sort(x),
            "argsort": lambda: rt.argsort(x),
            "argsort int64": lambda: rt.argsort(x, index_dtype=torch.int64)}[entry]
    call()                                         # the kernels built and loaded
    torch.cuda.synchronize()
    with timing.trace(tmp_path):
        rt.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counts = rt.launch_counts()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    assert counts["lsd_sort"] == 1
    assert len(syncs) == spans.count(timing.READ) == 1, [str(w.message) for w in syncs]
    assert spans.count(timing.LAUNCH) == counts["live_digits"] + counts["k0_sweep"]
    assert spans.count(timing.K0) == counts["live_digits"] == 1
    assert spans.count(timing.GUARD) == 0       # the guard is the live-digit launch


def test_k0_raises_and_never_falls_back(cuda, sort_spy, monkeypatch):
    def refused(*a, **k):
        raise RuntimeError("launch refused")
    monkeypatch.setattr(ck, "_launch", refused)
    x = rand_plane(_gate_sizes()["above the gate"], 8, cuda).view(torch.uint32)
    for call in (lambda: rt.sort(x), lambda: rt.argsort(x),
                 lambda: rt.sort(x, config=rt.SortConfig(detect_presorted=False))):
        with pytest.raises(RuntimeError):
            call()
    assert sort_spy[0] == 0


# ---------------------------------------------------------------------------
# K0 over two planes: 64-bit keys from the two-plane gate


def _two_plane_gate_sizes():
    from radix_sorting_tpu_torch.ops.hw_engine import K0_TWO_PLANE_MIN_KEYS as gate
    return {"below the gate": gate - 1, "at the gate": gate,
            "above the gate": max(3_000_017, gate + 12_345)}


def _u64_keys(n, seed, dtype, device, ties=0):
    """``n`` uniform 64-bit keys of ``dtype`` from ``seed`` on ``device``
    (``ties``: every ``ties``-th key equal to key 5, so stability shows),
    and the plain reference's stable order of them (the KDF's order:
    floats by sign and magnitude, NaNs above +inf)."""
    from sortbench import reference
    gen = torch.Generator(device=device).manual_seed(seed)
    b = torch.randint(-(1 << 31), 1 << 31, (2 * n,), dtype=torch.int32, device=device,
                      generator=gen).view(torch.int64)
    if ties:
        b[::ties] = b[5]
    if dtype == torch.float64:     # signed zeros, infinities, NaNs with payloads
        b[:7] = torch.from_numpy(np.array(
            [0x0, 0x8000000000000000, 0x7FF0000000000000, 0xFFF0000000000000,
             0x7FF8000000000000, 0xFFF8000000000007, 0x7FF0000000000123],
            np.uint64).view(np.int64)).to(device)
        order = torch.where(b < 0, ~b, b ^ (-(1 << 63)))       # unsigned order as bits
    elif dtype == torch.int64:
        order = b ^ (-(1 << 63))
    else:
        order = b
    return b.view(dtype), reference.stable_order(order.view(torch.uint64))


@pytest.mark.parametrize("descending", [False, True], ids=["ascending", "descending"])
@pytest.mark.parametrize("dtype", [torch.uint64, torch.int64, torch.float64], ids=str)
def test_40m_64_bit_sort_runs_k0_alone(cuda, sort_spy, dtype, descending):
    """A default sort of 40M 64-bit keys: K0 over two planes, eight passes,
    no torch.sort; bit for bit the plain reference's, the input unchanged.
    An ascending u64 key enters K0 as a pair and leaves it as one (the
    live-digit read and the first pass read the input where it lies, the
    last pass writes the output): one launch of each pair form; the signed,
    float and descending keys none."""
    x, order = _u64_keys(40_000_000, 41, dtype, cuda)
    if descending:
        order = order.flip(0)       # keys alone: ties are equal words
    want = x.view(torch.int64)[order]
    kept = x.clone()
    before = sort_spy[0]
    rt.reset_launch_counts()
    got = rt.sort(x, config=rt.SortConfig(descending=descending))
    counts = rt.launch_counts()
    assert sort_spy[0] == before
    assert counts["lsd_sort"] == 1 and counts["k0_sweep"] == 8 and counts["live_digits"] == 1
    assert counts["hist_multi"] == 0
    assert counts["lsd_hist"] == counts["lsd_scatter"] == 0
    pair = int(dtype == torch.uint64 and not descending)
    assert [counts[k] for k in ("live_digits_pair", "k0_sweep_pair_in",
                                "k0_sweep_pair_out")] == [pair] * 3
    assert got.dtype == dtype and torch.equal(got.view(torch.int64), want)
    assert torch.equal(x.view(torch.int64), kept.view(torch.int64))
    assert got.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


@pytest.mark.parametrize("where", ["below the gate", "at the gate", "above the gate"])
def test_u64_argsort_and_sort_pairs_around_the_two_plane_gate(cuda, sort_spy, where):
    """From the two-plane gate the u64 argsort (uint32 and int64 indices)
    and sort_pairs with an f32 payload take K0, eight passes each, and no
    torch.sort; below it torch.sort. Bit for bit the plain reference's."""
    n = _two_plane_gate_sizes()[where]
    k0 = where != "below the gate"
    x, order = _u64_keys(n, 43, torch.uint64, cuda, ties=7)
    pay = torch.rand(n, generator=torch.Generator(device=cuda).manual_seed(44), device=cuda)
    before = sort_spy[0]
    rt.reset_launch_counts()
    perm32 = rt.argsort(x)
    perm64 = rt.argsort(x, index_dtype=torch.int64)
    sk, sv = rt.sort_pairs(x, pay)
    counts = rt.launch_counts()
    assert counts["lsd_sort"] == (3 if k0 else 0) and counts["k0_sweep"] == (24 if k0 else 0)
    assert (sort_spy[0] == before) == k0
    assert perm32.dtype == torch.uint32 and perm64.dtype == torch.int64
    assert torch.equal(perm32.view(torch.int32).long(), order) and torch.equal(perm64, order)
    assert torch.equal(sk.view(torch.int64), x.view(torch.int64)[order])
    assert torch.equal(sv.view(torch.int32), pay.view(torch.int32)[order])


# K0's pair layout (kdf.halves): the two key planes as the halves of one
# 64-bit buffer, read where they lie by live_digits and a first pass,
# written as one by a last pass; each form against its plain version

PAIR_N = [(1 << 23) + 7, 40_000_000]


def _pair_keys(n, seed, device, ties=7, offset=0):
    """``n`` uniform u64 keys as an int64 tensor, every ``ties``-th equal
    to key 3, and their (hi, lo) halves (a pair); ``offset``: the keys a
    slice that many keys into a fresh buffer (one: 8 bytes off the 16-byte
    grid)."""
    buf = torch.randint(-(1 << 31), 1 << 31, (2 * (n + offset),), dtype=torch.int32,
                        device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    buf = buf.view(torch.int64)[offset:]
    assert buf.data_ptr() % 16 == 8 * (offset % 2)
    buf[::ties] = buf[3]
    return buf, kdf.halves(buf)


PAIR_AT = pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "one key in"])


@PAIR_AT
@pytest.mark.parametrize("order", [True, False], ids=["flag", "no flag"])
@pytest.mark.parametrize("keys", ["uniform", "ordered"])
@pytest.mark.parametrize("n", PAIR_N)
def test_live_digits_reads_a_pair_as_the_dense_planes(cuda, n, keys, order, offset):
    """K1's pair read: 16 bytes for two keys, the same histograms, digit
    order and descent flag as its plain version and as the dense two-plane
    read of the same keys; one key in, the read's head takes the first key
    alone."""
    buf, pair = _pair_keys(n, n, cuda, offset=offset)
    if keys == "ordered":                       # ascending as unsigned words
        buf.copy_(torch.sort(buf ^ (-(1 << 63))).values ^ (-(1 << 63)))
    before = ck.launch_counts()
    got = _live_matches_plain(pair, 8, order)
    after = ck.launch_counts()
    assert after["live_digits_pair"] == before["live_digits_pair"] + 1
    dense = kdf.split64(buf)
    hists, flag = ck.live_digits(dense, 8, order)
    assert torch.equal(hists, ck.live_digits(pair, 8, order)[0])
    if order:
        assert int(flag) == got


@PAIR_AT
@pytest.mark.parametrize("form", ["pair in", "pair out", "pair in and out",
                                  "pair in, index int64", "pair out, index born"])
@pytest.mark.parametrize("shift", [0, 24])
@pytest.mark.parametrize("n", PAIR_N)
def test_k0_sweep_pair_forms_match_plain(cuda, n, shift, form, offset):
    """Each pair form of the sweep against its plain version, bit for bit:
    the digit in lo (shift 0) and in hi (shift 24 of hi), with an argsort's
    index, the pair in at and one key off the 16-byte grid; a pair out is
    the halves of one fresh buffer, the input left as it was."""
    buf, pair = _pair_keys(n, n + shift, cuda, offset=offset)
    kept = buf.clone()
    hi, lo = pair if "pair in" in form else kdf.split64(buf)
    planes = [hi, lo]
    w = lo if shift == 0 else hi
    kw = {"pair_out": "pair out" in form}
    if form == "pair in, index int64":
        planes.append(torch.randperm(n, device=cuda).to(torch.int32))
        kw["index_dtype"] = torch.int64
    elif form == "pair out, index born":
        kw["position"] = True
    starts = _sweep_starts(w, shift)
    status = ck.k0_sweep_status(n, cuda)
    before = ck.launch_counts()
    got = ck.k0_sweep(w, planes, shift, 8, ck.K0_SWEEP_TILE, starts, status, 1, **kw)
    torch.cuda.synchronize()
    after = ck.launch_counts()
    want = ck.k0_sweep_plain(w, planes, shift, 8, ck.K0_SWEEP_TILE, starts, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [g.dtype for g in got] == [x.dtype for x in want]
    assert after["k0_sweep_pair_in"] - before["k0_sweep_pair_in"] == ("pair in" in form)
    assert after["k0_sweep_pair_out"] - before["k0_sweep_pair_out"] == kw["pair_out"]
    if kw["pair_out"]:
        out = kdf.pair_of(got[0], got[1])
        assert out is not None and out.untyped_storage().data_ptr() != buf.untyped_storage().data_ptr()
    assert torch.equal(buf, kept)


def test_k0_sweep_refuses_what_is_not_a_pair(cuda):
    """A stride of 3, swapped halves and halves one word off the 8-byte
    grid are no pair: the wrapper refuses them as planes that are not dense."""
    n = 100_003
    _, (hi, lo) = _pair_keys(n, 5, cuda)
    third = torch.zeros(3 * n, dtype=torch.int32, device=cuda)
    off = torch.zeros(2 * n + 2, dtype=torch.int32, device=cuda)[1:]
    status = ck.k0_sweep_status(n, cuda)
    for bad in ((third[1::3], third[0::3]), (lo, hi), (off[1::2][:n], off[0::2][:n])):
        starts = _sweep_starts(bad[1], 0)
        with pytest.raises((TypeError, ValueError)):
            ck.k0_sweep(bad[1], bad, 0, 8, ck.K0_SWEEP_TILE, starts, status, 1)
        with pytest.raises((TypeError, ValueError)):
            ck.live_digits(bad, 8)


@pytest.mark.parametrize("entry", ["sort", "argsort", "argsort int64", "sort_pairs",
                                   "int64", "float64", "descending", "sort, one key in"])
def test_40m_64_bit_entry_points_match_torch_sort(cuda, entry):
    """The u64 sort, argsort (uint32 and int64 indices) and sort_pairs, and
    the int64, float64 and descending u64 sorts at 40M keys, bit for bit
    against torch.sort of the keys' order (stable), the input unchanged;
    the u64 sort of a slice one key in (a pair 8 bytes off the 16-byte
    grid) too."""
    from sortbench import reference
    n = 40_000_000
    dtype = {"int64": torch.int64, "float64": torch.float64}.get(entry, torch.uint64)
    one_in = entry == "sort, one key in"
    x, order = _u64_keys(n + one_in, 47, dtype, cuda, ties=9)
    if one_in:
        x = x[1:]
        assert x.data_ptr() % 16 == 8
        order = reference.stable_order(x)
    kept = x.clone()
    rt.reset_launch_counts()
    key = x.view(torch.int64)
    if entry == "descending":                    # keys alone: ties are equal words
        got = rt.sort(x, config=rt.SortConfig(descending=True))
        assert torch.equal(got.view(torch.int64), key[order.flip(0)])
    elif entry.startswith("argsort"):
        idt = torch.int64 if entry == "argsort int64" else torch.uint32
        perm = rt.argsort(x, index_dtype=idt)
        assert perm.dtype == idt and torch.equal(perm.view(torch.int32).long()
                                                 if idt == torch.uint32 else perm, order)
    elif entry == "sort_pairs":
        pay = torch.arange(n, device=cuda, dtype=torch.int32)
        sk, sv = rt.sort_pairs(x, pay)
        assert torch.equal(sk.view(torch.int64), key[order]) and torch.equal(sv.long(), order)
    else:
        got = rt.sort(x)
        assert got.dtype == dtype and torch.equal(got.view(torch.int64), key[order])
        pair = int(dtype == torch.uint64)
        assert [rt.launch_counts()[k] for k in ("live_digits_pair", "k0_sweep_pair_in",
                                                "k0_sweep_pair_out")] == [pair] * 3
    assert torch.equal(x.view(torch.int64), kept.view(torch.int64))


def _sweep_starts(w, shift):
    """The exclusive scan of the 8-bit digit's global histogram."""
    h = torch.bincount(((w >> shift) & 0xFF).long(), minlength=256)
    return (torch.cumsum(h, 0) - h).to(torch.int32)


def _sweep_matches_plain(w, planes, shift, position=False, index_dtype=torch.int32):
    """One k0_sweep launch against its plain version, bit for bit."""
    starts = _sweep_starts(w, shift)
    status = ck.k0_sweep_status(w.shape[0], w.device)
    before = ck.launch_counts()["k0_sweep"]
    got = ck.k0_sweep(w, planes, shift, 8, ck.K0_SWEEP_TILE, starts, status, 1,
                      position=position, index_dtype=index_dtype)
    torch.cuda.synchronize()
    assert ck.launch_counts()["k0_sweep"] == before + 1
    want = ck.k0_sweep_plain(w, planes, shift, 8, ck.K0_SWEEP_TILE, starts,
                             position=position, index_dtype=index_dtype)
    assert [g.dtype for g in got] == [x.dtype for x in want]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


SWEEP_N = [1, 8191, 8193, 3 * 8192 + 5, 20_000_003]   # past 20M: ~2,400 tiles, 264 resident
# the rank's key patterns: uniform keys with ties inside every tile, and
# RANK_PATTERNS' others (a third of the keys on one digit; a step's
# lanes on one digit, on two, on 32)
SWEEP_KEYS = ["ties", *RANK_PATTERNS[1:]]


def _rank_plane(keys, n, seed, device):
    if keys == "ties":
        w = rand_plane(n, seed, device)
        w[::7] = int(w[3 % n])
        return w
    return torch.from_numpy(rank_keys(keys, n, seed).view(np.int32)).to(device)


@pytest.mark.parametrize("index", ["none", "position int32", "position int64",
                                   "plane int64"])
@pytest.mark.parametrize("n", SWEEP_N)
@pytest.mark.parametrize("keys", SWEEP_KEYS)
def test_k0_sweep_matches_plain(cuda, keys, n, index):
    w = _rank_plane(keys, n, n, cuda)
    pay = rand_plane(n, n + 1, cuda)
    idx = torch.randperm(n, device=cuda).to(torch.int32)
    planes, kw = {"none": ((w, pay), {}),
                  "position int32": ((w, pay), {"position": True}),
                  "position int64": ((w, pay), {"position": True, "index_dtype": torch.int64}),
                  "plane int64": ((pay, w, idx), {"index_dtype": torch.int64})}[index]
    _sweep_matches_plain(w, planes, 8, **kw)


@pytest.mark.parametrize("shift", [0, 24])
def test_k0_sweep_keys_equal_to_the_sentinel(cuda, shift):
    """A third of the keys equal csrc/lsd.cu's kSentinel, which fills the
    last tile past its end: they keep their slots before it."""
    n = 3 * 8192 + 5
    w = rand_plane(n, 29 + shift, cuda)
    w[::3] = -1
    _sweep_matches_plain(w, (w,), shift, position=True)


@pytest.mark.parametrize("share,keys", [(1.0, "uniform"),
                                        *((0.9, k) for k in RANK_PATTERNS)])
def test_k0_sweep_one_digit_spins_on_one_column(cuda, share, keys):
    """Every tile's keys in one digit: each look-back waits on one status
    column, and the other digits' counts are zero all the way back; the
    tiles past ``share`` in one of the rank's patterns."""
    n = 20_000_003
    w = _rank_plane(keys, n, 17, cuda)
    w[: int(n * share)] = 0x5A5A5A5A
    _sweep_matches_plain(w, (w,), 16, position=True, index_dtype=torch.int64)


@pytest.mark.parametrize("keys", ["ties", "entropy"])
def test_k0_sweep_passes_share_one_status_by_epoch(cuda, keys):
    """Four passes on one status buffer (epochs 1 to 4) sort the plane and
    bear its stable permutation, as torch.sort(stable=True)."""
    n = 5_000_011
    if keys == "ties":
        w = rand_plane(n, 23, cuda)
        w[::5] = w[2]
    else:
        w = _rank_plane(keys, n, 23, cuda)
    ref = torch.sort(w ^ i32(1 << 31), stable=True)
    status = ck.k0_sweep_status(n, cuda)
    planes = (w,)
    for e in range(1, 5):
        planes = ck.k0_sweep(planes[0], planes, 8 * (e - 1), 8, ck.K0_SWEEP_TILE,
                             _sweep_starts(w, 8 * (e - 1)), status, e, position=e == 1,
                             index_dtype=torch.int64 if e == 4 else torch.int32)
    assert torch.equal(planes[0] ^ i32(1 << 31), ref.values)
    assert torch.equal(planes[1], ref.indices)


def test_k0_sweep_refuses_other_shapes(cuda):
    w = rand_plane(100_000, 1, cuda)
    status = ck.k0_sweep_status(w.shape[0], cuda)
    starts = _sweep_starts(w, 0)
    starts11 = torch.zeros(1 << 11, dtype=torch.int32, device=cuda)
    for bits, tile, st, planes, kw in (
            (11, ck.K0_SWEEP_TILE, starts11, (w,), {}),        # digits of another width
            (8, 4096, starts, (w,), {}),                         # another tile
            (8, ck.K0_SWEEP_TILE, starts, (w,), {"index_dtype": torch.int64})):  # a wide key
        with pytest.raises(RuntimeError):
            ck._k0_sweep_launch(w, planes, 0, bits, tile, st, status, 1,
                                kw.get("position", False), kw.get("index_dtype", torch.int32))
    with pytest.raises(ValueError):                # the wrapper refuses before any launch
        ck.k0_sweep(w, (w,), 0, 11, ck.K0_SWEEP_TILE, starts11, status, 1)


# Strategy.LSD cases: (dtype, mask of the random keys, radix bits,
# descending, live digits, a configured sorter of models/ or None)
LSD_CASES = {
    "u32 masked": (torch.uint32, 0xF0F0FFFF, 8, False, 4, None),
    "u64 masked": (torch.uint64, 0xF0F00000F0F0FFFF, 8, False, 6, None),  # hi: two live digits
    "u64 full entropy": (torch.uint64, (1 << 64) - 1, 8, False, 8, None),
    "u32 r=11": (torch.uint32, 0xFFFFFFFF, 11, False, 3, None),
    "f32 specials": (torch.float32, 0xFFFFFFFF, 8, False, 4, None),
    "u16 descending": (torch.uint16, 0xFFFF, 8, True, 2, None),
    "models.RadixSorterU32": (torch.uint32, 0xFFFFFFFF, 8, False, 4, "RadixSorterU32"),
    "models.GenericRadixSorter, f32 specials": (torch.float32, 0xFFFFFFFF, 8, False, 4,
                                                "GenericRadixSorter"),
}


@pytest.mark.parametrize("case", LSD_CASES)
def test_lsd_live_digits_come_from_one_k1_launch(cuda, monkeypatch, case):
    """Strategy.LSD reads its live digits from one K1 launch over every
    plane (``live_digits``; ``hist_multi`` is that launch for one plane),
    then one L1 and one L2 a live digit: the live-bit folds are never
    called on that path. Against numpy's sort in the KDF order."""
    from radix_sorting_tpu_torch.ops import probes

    def folds(*a, **k):
        raise AssertionError("probes.live_bit_mask ran on the LSD path")
    monkeypatch.setattr(probes, "live_bit_mask", folds)
    dtype, mask, radix_bits, descending, live, model = LSD_CASES[case]
    n = 2_000_003
    size = torch.empty((), dtype=dtype).element_size()
    ut = {2: np.uint16, 4: np.uint32, 8: np.uint64}[size]
    st = {2: np.int16, 4: np.int32, 8: np.int64}[size]
    it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[size]
    bits = np.random.Generator(np.random.PCG64(8 * size)).integers(
        0, 1 << (8 * size), size=n, dtype=ut) & ut(mask)
    if dtype == torch.float32:
        bits[1:7] = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0xFFC00001, 0x7F800123]
    x = torch.from_numpy(bits.view(st)).to(cuda).view(dtype)
    cfg = rt.SortConfig(strategy="lsd", radix_bits=radix_bits, descending=descending)
    rt.reset_launch_counts()
    got = getattr(rt.models, model)(cfg)(x) if model else rt.sort(x, config=cfg)
    counts = rt.launch_counts()
    want = _oracle(bits, dtype)
    assert got.dtype == dtype and got.device == x.device
    assert np.array_equal(got.view(it).cpu().numpy().view(ut), want[::-1] if descending else want)
    assert counts["live_digits"] == 1 and counts["hist_multi"] == 0
    assert counts["lsd_hist"] == counts["lsd_scatter"] == live


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
    names = rng.integers(0, 256, size=(n, 6), dtype=np.uint8)
    sk, sv = rt.sort_pairs(td, {"v": v, "f": v.float(), "name": torch.from_numpy(names).to(cuda)},
                           config=lsd.replace(radix_bits=11))
    order = np.argsort(dups, kind="stable")
    assert np.array_equal(_u32(sk), dups[order])
    assert np.array_equal(sv["v"].cpu().numpy(), order)
    assert np.array_equal(sv["f"].cpu().numpy(), order.astype(np.float32))
    assert np.array_equal(sv["name"].cpu().numpy(), names[order])
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
    from radix_sorting_tpu_torch.utils import keyfile, verify

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
    rt.reset_launch_counts()                       # past K0's gates: K0, twice a call
    assert cli.main(["40000000", "u32"]) == 0
    assert '"verified": true' in capsys.readouterr().out
    assert rt.launch_counts()["lsd_sort"] == 2
    assert cli.main(["20000000", "u64", "0x0000F0F000000000"]) == 0
    assert '"verified": true' in capsys.readouterr().out
    # utils.verify on the card's outputs above K0's gate, and on broken ones
    w = rand_plane(_gate_sizes()["above the gate"], 31, cuda)
    x, dups = w.view(torch.uint32), (w & 0xFFFF).view(torch.uint32)
    out, perm = rt.sort(x), rt.argsort(dups)
    lsd_perm = rt.argsort(dups, config=rt.SortConfig(strategy="lsd"))
    swapped, doubled = perm.view(torch.int32).clone(), perm.view(torch.int32).clone()
    swapped[[0, 1]] = swapped[[1, 0]]
    doubled[1] = doubled[0]
    assert verify.is_sorted(out) and verify.same_multiset(out, _u32(x))
    assert not verify.is_sorted(x)
    assert verify.is_permutation(perm) and not verify.is_permutation(doubled)
    assert verify.rank_is_stable_sort(dups, perm) and verify.rank_is_stable_sort(dups, lsd_perm)
    assert not verify.rank_is_stable_sort(dups, swapped)


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


@pytest.mark.parametrize("n", [2_000_000, 40_000_000])
def test_dryrun_multichip_on_the_card(cuda, n):
    """Every distributed entry point on four ranks of the card against
    numpy (the dry run raises on the first that differs): the balanced
    distributed_sort of n keys with each exchange, the rest at 2^16."""
    from radix_sorting_tpu_torch import parallel as tpar
    from radix_sorting_tpu_torch.parallel.dryrun import dryrun_multichip
    records = dryrun_multichip(tpar.make_sort_mesh(devices=[cuda] * 4), n=n,
                               n_rest=1 << 16, log=None)
    assert all(r["peak_mb"] is not None for r in records)
    assert records[1]["launches"].get("rdma_exchange", 0) > 0
    assert "rdma_exchange" not in records[0]["launches"]


# ---------------------------------------------------------------------------
# the group mesh on the card: processes over torch.distributed


def _mp_workers(nproc, local, backend, tmp_path, extra=()):
    """``scripts.mp_worker`` in ``nproc`` processes on cuda:0, ``local`` ranks
    each, at 2^20 keys with K13; each one's stats (launches, times)."""
    import json
    import os
    import sys
    from radix_sorting_tpu_torch.ops import _build
    from radix_sorting_tpu_torch.utils import mpharness
    _build.build()          # the parent builds; the workers only load
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = mpharness.free_port()
    env = mpharness.worker_env(local, {"PYTHONPATH": repo})
    outs = [str(tmp_path / f"w{pid}.npz") for pid in range(nproc)]
    res = mpharness.run_workers(
        [[sys.executable, "-m", "radix_sorting_tpu_torch.scripts.mp_worker", str(pid),
          str(nproc), str(port), "--backend", backend, "--device", "cuda", "--exchange",
          "rdma", "--n", str(1 << 20), "--out", outs[pid], *extra] for pid in range(nproc)],
        env=env, cwd=repo, timeout_s=600)
    for pid, (rc, text) in enumerate(res):
        assert rc == 0 and f"MP_OK {pid}" in text, text[-4000:]
    return [json.loads(str(np.load(o)["stats"])) for o in outs], [t for _, t in res]


@pytest.mark.parametrize("main_n", [4_000_000, 40_000_000])
def test_group_mesh_four_processes_on_one_card(cuda, tmp_path, main_n):
    # K13 across processes through CUDA IPC handles, the control tensors over
    # gloo in host copies, the bulk exchange over gloo refused; a second mesh
    # over the group opens its own handles; each worker holds its shards of
    # the checked balanced sort of main_n keys against np.sort
    stats, texts = _mp_workers(4, 1, "gloo", tmp_path, ("--main-n", str(main_n)))
    for st, text in zip(stats, texts):
        launches = st["launches"]
        assert launches["rdma_exchange"] > 0 and launches["hist"] > 0 and launches["whist"] > 0
        # the main path's checked sort alone: K13 once a round on the one rank
        assert st["main_launches"]["rdma_exchange"] > 0
        assert st["k13_max_abs_err"] == 0 and st["opens"] == 3
        assert "a second mesh opens fresh handles, closed with it: ok" in text
        assert "exchange='xla' of CUDA tensors over gloo refused: ok" in text
        assert "gather_sorted without mesh= refused: ok" in text


def test_group_mesh_nccl_world_of_one(cuda, tmp_path):
    # every group collective over NCCL; four ranks of the one process on cuda:0
    stats, texts = _mp_workers(1, 4, "nccl", tmp_path)
    assert stats[0]["launches"]["rdma_exchange"] > 0
    assert "exchange='rdma' equals 'xla': ok (nccl" in texts[0]


# ---------------------------------------------------------------------------
# the sorter composites of extras and stats on the card


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_query_blocks_on_the_card(cuda, side):
    from radix_sorting_tpu_torch import extras
    rng = np.random.Generator(np.random.PCG64(21))
    a = np.sort(rng.integers(0, 1 << 64, size=1_000_003, dtype=np.uint64))
    q = extras._SEARCHSORTED_QBLOCK + 12_345          # two blocks, the last ragged
    v = np.concatenate([a[rng.integers(0, a.size, size=q // 2)],
                        rng.integers(0, 1 << 64, size=q - q // 2, dtype=np.uint64)])
    at = torch.from_numpy(a.view(np.int64)).to(cuda).view(torch.uint64)
    vt = torch.from_numpy(v.view(np.int64)).to(cuda).view(torch.uint64)
    got = rt.searchsorted(at, vt, side=side)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert np.array_equal(got.cpu().numpy(), np.searchsorted(a, v, side=side))
    a32, v32 = (a >> np.uint64(40)).astype(np.uint32), (v >> np.uint64(40)).astype(np.uint32)
    for method in ("sort", "scan"):                   # one int64 sort a block; torch
        got = rt.searchsorted(a32, v32, side=side, method=method)
        assert np.array_equal(got, np.searchsorted(a32, v32, side=side))


def test_top_k_batched_on_the_card(cuda):
    rng = np.random.Generator(np.random.PCG64(22))
    x = rng.integers(0, 1000, size=(512, 4096), dtype=np.uint32)         # ties
    vals, idx = rt.top_k_batched(torch.from_numpy(x.view(np.int32)).to(cuda)
                                 .view(torch.uint32), 16)
    assert vals.device.type == "cuda" and vals.shape == (512, 16) and idx.dtype == torch.uint32
    order = np.argsort(-x.astype(np.int64), axis=-1, kind="stable")[:, :16]
    assert np.array_equal(idx.cpu().numpy(), order.astype(np.uint32))
    assert np.array_equal(_u32(vals), np.take_along_axis(x, order, -1))
    xf = rng.standard_normal((4096, 64)).astype(np.float32)
    vals, idx = rt.top_k_batched(torch.from_numpy(xf).to(cuda), 5, axis=0, largest=False)
    order = np.argsort(xf, axis=0, kind="stable")[:5]
    assert np.array_equal(vals.cpu().numpy(), np.take_along_axis(xf, order, 0))
    x64 = rng.integers(0, 1 << 64, size=(64, 1000), dtype=np.uint64)
    vals, idx = rt.top_k_batched(x64, 7)
    order = np.argsort(~x64, axis=-1, kind="stable")[:, :7]
    assert np.array_equal(vals, np.take_along_axis(x64, order, -1))
    assert np.array_equal(idx, order.astype(np.uint32))


def test_edge_array_histogram_runs_k1_and_k11(cuda, no_plain, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(ck, "whist_f32_plain", boom)
    rng = np.random.Generator(np.random.PCG64(23))
    x = rng.standard_normal(2_000_003).astype(np.float32)
    x[:3] = [np.nan, 10.0, -10.0]
    w = rng.standard_normal(x.size).astype(np.float32)
    edges = np.linspace(-4.0, 4.0, 1001).astype(np.float32).astype(np.float64)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    rt.reset_launch_counts()
    c, e = rt.histogram(xt, bins=edges)
    assert c.device.type == "cuda" and np.array_equal(e, edges)
    assert np.array_equal(c.cpu().numpy(), np.histogram(x, bins=edges)[0])
    s, _ = rt.histogram(xt, bins=edges, weights=wt)
    ref = np.histogram(x, bins=edges, weights=w.astype(np.float64))[0]
    absum = np.histogram(x, bins=edges, weights=np.abs(w.astype(np.float64)))[0]
    assert np.all(np.abs(s.cpu().numpy().astype(np.float64) - ref) <= absum * 2**-14 + 1e-5)
    counts = rt.launch_counts()
    assert counts["hist"] >= 1 and counts["whist_f32"] == 1


def _no_cummax(*a, **k):
    # one block for a 1-D tensor: 110.8 ms at 40M (PERF.md run BX)
    raise AssertionError("torch.cummax ran in the sets slice")


def test_unique_u16_counts_take_k2_and_k8_on_the_card(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(ck, "hist_pext_plain", boom)
    monkeypatch.setattr(ck, "regen_pdep_plain", boom)
    x = np.random.Generator(np.random.PCG64(24)).integers(0, 1 << 16, size=9_000_001,
                                                         dtype=np.uint16)
    rt.reset_launch_counts()
    r = rt.unique(torch.from_numpy(x.view(np.int16)).to(cuda).view(torch.uint16),
                  return_counts=True)
    counts = rt.launch_counts()
    assert counts["hist_pext"] == 1 and counts["regen_pdep_windowed"] == 1
    uq, cnt = np.unique(x, return_counts=True)
    k = int(r.num_unique)
    assert r.num_unique.device.type == "cuda" and k == len(uq)
    vals = r.values.view(torch.int16).cpu().numpy().view(np.uint16)
    assert np.array_equal(vals[:k], uq) and np.all(vals[k:] == 0xFFFF)
    assert np.array_equal(r.counts.cpu().numpy()[:k], cnt)


@pytest.mark.parametrize("size", ["3M", "above the gate"])
def test_sets_on_the_card_match_numpy(cuda, monkeypatch, size):
    monkeypatch.setattr(torch, "cummax", _no_cummax)
    monkeypatch.setattr(torch.Tensor, "cummax", _no_cummax)
    rng = np.random.Generator(np.random.PCG64(25))
    n = 3_000_001 if size == "3M" else _gate_sizes()[size]
    x = rng.integers(0, 1 << 20, size=n, dtype=np.uint32)
    xt = torch.from_numpy(x.view(np.int32)).to(cuda).view(torch.uint32)
    r = rt.unique_all(xt)
    uq, idx, inv, cnt = np.unique(x, return_index=True, return_inverse=True,
                                  return_counts=True)
    k = int(r.num_unique)
    assert all(f.device.type == "cuda" for f in r) and k == len(uq)
    assert np.array_equal(_u32(r.values)[:k], uq)
    assert np.array_equal(r.indices.view(torch.int32).cpu().numpy()[:k], idx)
    assert np.array_equal(r.inverse_indices.cpu().numpy(), inv)
    assert np.array_equal(r.counts.cpu().numpy()[:k], cnt)
    b = np.concatenate([x[rng.integers(0, x.size, size=1_000_000)],
                        rng.integers(0, 1 << 20, size=1_000_000, dtype=np.uint32)])
    bt = torch.from_numpy(b.view(np.int32)).to(cuda).view(torch.uint32)
    vals, c1, c2, cnt = rt.intersect1d(xt, bt, return_indices=True)
    wv, w1, w2 = np.intersect1d(x, b, return_indices=True)
    k = int(cnt)
    assert k == len(wv) and np.array_equal(_u32(vals)[:k], wv)
    assert np.array_equal(c1.cpu().numpy()[:k], w1) and np.array_equal(c2.cpu().numpy()[:k], w2)
    for invert in (False, True):
        got = rt.isin(xt, bt, invert=invert)
        assert got.device.type == "cuda"
        assert np.array_equal(got.cpu().numpy(), np.isin(x, b, invert=invert))
    x64 = rng.integers(0, 1 << 40, size=1_000_003).astype(np.uint64)
    b64 = np.concatenate([x64[:300_000], rng.integers(0, 1 << 40, size=300_000).astype(np.uint64)])
    vals, c1, c2, cnt = rt.intersect1d(x64, b64, return_indices=True)      # numpy in, out
    wv, w1, w2 = np.intersect1d(x64, b64, return_indices=True)
    k = int(cnt)
    assert np.array_equal(vals[:k], wv) and np.array_equal(c1[:k], w1)
    assert np.array_equal(c2[:k], w2)


# ---------------------------------------------------------------------------
# the entry points above K0's gate: the sorter composites, the sets and the
# rest of the slice that sorts through the sorter, against numpy


def _float_order(bits: np.ndarray, width: int) -> np.ndarray:
    """Raw float bit patterns sorted by the reference's float KDF, in numpy:
    -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN."""
    ut = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}[width]
    b = bits.astype(ut)
    top = ut(1) << ut(width - 1)
    key = np.sort(np.where(b & top, ~b, b | top))
    return np.where(key & top, key ^ top, ~key)


def _order_key(bits: np.ndarray) -> np.ndarray:
    """The KDF's unsigned key of float bit patterns (f32 as u32, f64 as u64)."""
    top = bits.dtype.type(1) << bits.dtype.type(8 * bits.dtype.itemsize - 1)
    return np.where(bits & top, ~bits, bits | top)


def _stable_perm(a: np.ndarray) -> np.ndarray:
    """np.argsort(a, kind="stable") along the last axis; unsigned keys of 32
    or 64 bits by 16-bit digits from the least significant, each a stable
    (radix) sort in numpy: the same permutation in less time."""
    if a.dtype.kind != "u" or a.dtype.itemsize <= 2:
        return np.argsort(a, axis=-1, kind="stable")
    perm = None
    for shift in range(0, 8 * a.dtype.itemsize, 16):
        d = (a >> a.dtype.type(shift)).astype(np.uint16)
        if perm is not None:
            d = np.take_along_axis(d, perm, -1)
        p = np.argsort(d, axis=-1, kind="stable")
        perm = p if perm is None else np.take_along_axis(perm, p, -1)
    return perm


def _padded(a: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full((size,) + a.shape[1:], fill, a.dtype)
    out[: min(len(a), size)] = a[:size]
    return out


def _runs(s: np.ndarray):
    """(firsts, starts, run lengths, run of each position) of a sorted
    array (rows: equal along the last axis)."""
    neq = s[1:] != s[:-1]
    is_new = np.concatenate([[True], neq.any(axis=-1) if neq.ndim > 1 else neq])
    starts = np.flatnonzero(is_new)
    return s[starts], starts, np.diff(np.append(starts, len(s))), np.cumsum(is_new) - 1


def _unique_all(a: np.ndarray, perm: np.ndarray, fill):
    """np.unique(a) with every flag from a stable sorting permutation, padded
    to len(a) as the port's unique returns it: (values, index, inverse,
    counts, [count])."""
    vals, starts, lens, run = _runs(a[perm])
    inverse = np.empty(len(a), np.int32)
    inverse[perm] = run
    m = len(a)
    return (_padded(vals, m, fill), _padded(perm[starts].astype(np.uint32), m, 0), inverse,
            _padded(lens.astype(np.int32), m, 0), np.array([len(vals)]))


def _top_k(order_key: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest order keys, ties to the lower index."""
    key = ~order_key.astype(np.uint64)
    kth = np.partition(key, k - 1)[k - 1]
    cand = np.flatnonzero(key <= kth)
    return cand[np.lexsort((cand, key[cand]))][:k]


def _wrapped_sums(k, v, bins):
    """Exact per-group sums mod 2^32 (float64 is exact below 2^53)."""
    return np.bincount(k, weights=v.astype(np.float64), minlength=bins).astype(
        np.int64).astype(np.uint32)


QS5 = [0.01, 0.25, 0.5, 0.75, 0.99]
F32_SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)


class _Slice:
    """The inputs of the entry-point cases (numpy, made once from one seed
    at ``n`` keys), their numpy results that several cases share, and the
    moves to and from ``device`` (every output read back must be there)."""

    def __init__(self, n: int, device, seed: int = 20240601):
        rng = np.random.Generator(np.random.PCG64(seed))
        self.n, self.device, self.rng = n, torch.device(device), rng
        self.keys = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        self.keys64 = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
        self.dups = self.keys & np.uint32(0xFFFF)
        self.u16 = self.dups.astype(np.uint16)
        self.pay_i64 = rng.integers(-2**62, 2**62, size=n, dtype=np.int64)
        self.pay_f32 = rng.standard_normal(n).astype(np.float32)
        idx = rng.integers(0, n, size=4096)
        f32 = rng.standard_normal(n).astype(np.float32)
        f32[idx] = F32_SPECIALS[np.arange(idx.size) % F32_SPECIALS.size]
        self.f32b = f32.view(np.uint32).copy()
        self.f32b[idx[:64]] = 0xFFC00001               # negative NaN with a payload
        self.f32b[idx[64:128]] = 0x7F800123            # signalling NaN with a payload
        self.f64b = rng.standard_normal(n).view(np.uint64).copy()
        self.f64b[idx] = np.array([0x0, 0x8000000000000000, 0x7FF0000000000000,
                                   0xFFF0000000000000, 0x7FF8000000000000,
                                   0xFFF8000000000007, 0x7FF0000000000123],
                                  np.uint64)[np.arange(idx.size) % 7]
        self.k1024 = self.keys & np.uint32(1023)
        self.v_bench = (self.keys >> np.uint32(10)).astype(np.int32)
        self.seg16 = (self.keys >> np.uint32(22)).astype(np.uint16)      # 1,024 segments
        rows = n // 4096
        self.rows_u32 = self.keys[: rows * 4096].reshape(rows, 4096)
        self.rows_dups = self.dups[: rows * 4096].reshape(rows, 4096)
        self.rows_f32 = self.pay_f32[: rows * 4096].reshape(rows, 4096)
        self.edges32 = np.sort(rng.standard_normal(1001).astype(np.float32))
        self.set_b = np.concatenate([self.keys[rng.integers(0, n, size=n // 2)],
                                     self.rand32(n - n // 2)])
        half = n // 2
        self.set_a64 = self.keys64[:half]
        self.set_b64 = np.concatenate([self.set_a64[rng.integers(0, half, size=half // 2)],
                                       rng.integers(0, 1 << 64, size=half - half // 2,
                                                    dtype=np.uint64)])
        self.tests = np.concatenate([self.keys[rng.integers(0, n, size=n // 8)],
                                     self.rand32(n // 4 - n // 8)])

    def rand32(self, m):
        return self.rng.integers(0, 1 << 32, size=m, dtype=np.uint32)

    def hits(self, src, q, random):
        """q queries, half of them keys of ``src``."""
        return np.concatenate([src[: q // 2], random(q - q // 2)])

    def cu(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device, bit for bit, in the torch dtype of its numpy
        dtype (unsigned words through a signed view)."""
        signed = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize]
        t = torch.from_numpy(np.ascontiguousarray(a) if a.dtype.kind == "b"
                             else np.ascontiguousarray(a).view(signed)).to(self.device)
        want = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
                np.dtype(np.uint32): torch.uint32, np.dtype(np.uint64): torch.uint64,
                np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
                np.dtype(bool): torch.bool}.get(a.dtype)
        return t.view(want) if want is not None and want != torch.bool else t

    def host(self, t, np_dtype=None) -> np.ndarray:
        """A result on the host: a tensor (which must be on the device) by
        its bits as ``np_dtype``, else as it is; a numpy result as it is."""
        if not torch.is_tensor(t):
            return np.asarray(t)
        assert t.device == self.device, t.device
        if np_dtype is None:
            return t.cpu().numpy()
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}[np.dtype(np_dtype).itemsize]
        return t.contiguous().view(width).cpu().numpy().view(np_dtype)

    def fields(self, out, names, dtype=np.uint32):
        """The named fields of a set routine's result on the host: values by
        their bits as ``dtype``, uint32 indices by theirs, the count as a
        1-element array."""
        def one(f, v):
            if f == "num_unique":
                return np.array([int(v)])
            if torch.is_tensor(v) and (f == "values" or v.dtype == torch.uint32):
                return self.host(v, dtype if f == "values" else np.uint32)
            return self.host(v)
        return tuple(one(f, getattr(out, f)) for f in names)

    @functools.cached_property
    def sorted_keys(self):
        return np.sort(self.keys)

    @functools.cached_property
    def sorted64(self):
        return np.sort(self.keys64)

    @functools.cached_property
    def stable_keys(self):
        return _stable_perm(self.keys)

    @functools.cached_property
    def keys_unique(self):
        return _unique_all(self.keys, self.stable_keys, 0xFFFFFFFF)

    @functools.cached_property
    def unique_halves(self):
        return np.unique(self.keys), np.unique(self.set_b)

    @functools.cached_property
    def isin(self):
        return np.isin(self.keys, self.tests)

    @functools.cached_property
    def rows8(self):
        return self.rng.integers(0, 8, size=(10_000_000, 4)).astype(np.int32)

    def seg_perm(self, descending):
        """The stable order of (segment, key), the key complemented when
        descending."""
        k = np.uint16(0xFFFF) - self.u16 if descending else self.u16
        return _stable_perm((self.seg16.astype(np.uint32) << np.uint32(16)) | k)

    def pairs(self, a):
        p = _stable_perm(a)
        return a[p], self.pay_i64[p], self.pay_f32[p]

    def searched(self, a, q, side):
        return np.searchsorted(a, q, side=side).astype(np.int32)

    def extremes(self, k, v):
        """min and max of v per 16-bit group, by a stable sort."""
        perm = _stable_perm(k)
        vs, starts = v[perm], np.searchsorted(k[perm], np.arange(1 << 16, dtype=np.uint32))
        return np.minimum.reduceat(vs, starts), np.maximum.reduceat(vs, starts)

    def quantile_check(self, a):
        """The port's float32 interpolation of numpy's order statistics (in
        numpy float32 arithmetic: the same operations), that oracle within
        2^-20 of np.quantile."""
        def check(got):
            h = np.asarray(QS5) * (len(a) - 1)
            lo, hi = np.floor(h).astype(np.int64), np.ceil(h).astype(np.int64)
            part = np.partition(a, np.unique(np.concatenate([lo, hi])))
            f = (h - lo).astype(np.float32)
            want = part[lo].astype(np.float32) * (np.float32(1) - f) \
                + part[hi].astype(np.float32) * f
            assert np.allclose(want, np.quantile(a, QS5), rtol=2**-20, atol=1e-12)
            got = self.host(got)
            assert got.dtype == np.float32 and np.array_equal(got, want), (got, want)
        return check

    def rows_unique(self):
        rows = self.rows8
        code = (rows[:, 0] << 9) | (rows[:, 1] << 6) | (rows[:, 2] << 3) | rows[:, 3]
        perm = np.argsort(code.astype(np.uint16), kind="stable")
        _, index, inverse, counts, num = _unique_all(code, perm, 0)
        return (_padded(rows[perm[_runs(code[perm])[1]]], len(rows), np.int32(0x7FFFFFFF)),
                index, inverse, counts, num)

    def f32_counts(self, equal_nan):
        bits = self.f32b
        if equal_nan:
            bits = np.where(np.isnan(bits.view(np.float32)), np.uint32(0x7FC00000), bits)
        vals, _, lens, _ = _runs(_float_order(bits, 32))
        return (_padded(vals, self.n, np.uint32(0x7FFFFFFF)),     # all-ones planes: a NaN
                _padded(lens.astype(np.int32), self.n, 0), np.array([vals.size]))

    def set_op(self, op):
        ua, ub = self.unique_halves
        ref = getattr(np, op)
        v = ref(ua, ub) if op == "union1d" else ref(ua, ub, assume_unique=True)
        size = 2 * self.n if op in ("union1d", "setxor1d") else self.n
        return _padded(v, size, 0xFFFFFFFF), np.array([v.size])

    def intersect_indices(self, a, b, ones):
        v, c1, c2 = np.intersect1d(a, b, return_indices=True)
        m = len(a)
        return (_padded(v, m, ones), _padded(c1.astype(np.int32), m, len(a)),
                _padded(c2.astype(np.int32), m, len(b)), np.array([v.size]))

    def set_values(self, out, dtype=np.uint32):
        return (self.host(out[0], dtype), *(self.host(o) for o in out[1:-1]),
                np.array([int(out[-1])]))


# Each case, given a _Slice d, returns (args, call, oracle): the entry
# point's inputs (on d's device, or numpy where the case says so), the call
# (call(*args) is what chip_smoke.py times), and oracle(out): (the result on
# the host, numpy's result or a check of the result).
DESCENDING = rt.SortConfig(descending=True)


def _q_scan(d):
    return 100_000


def _q_cross(d):
    return -(-d.n // 32)             # 'auto' takes the tagged-union sort from 32 q >= n


def _searchsorted_u32(d, q, side):
    qs = d.hits(d.keys, q(d), d.rand32)
    return ((d.cu(qs), d.cu(d.sorted_keys)), lambda x, a: rt.searchsorted(a, x, side=side),
            lambda out: (d.host(out, np.int32), d.searched(d.sorted_keys, qs, side)))


def _searchsorted_u64(d):
    qs = d.hits(d.keys64, min(4_000_000, d.n),
                lambda m: d.rng.integers(0, 1 << 64, size=m, dtype=np.uint64))
    return ((d.cu(qs), d.cu(d.sorted64)), lambda x, a: rt.searchsorted(a, x),
            lambda out: (d.host(out, np.int32), d.searched(d.sorted64, qs, "left")))


def _searchsorted_f32(d):
    a = _float_order(d.f32b, 32)
    qs = d.hits(d.f32b, min(1_000_000, d.n), lambda m: np.concatenate(
        [F32_SPECIALS.view(np.uint32),
         d.rng.standard_normal(m - 5).astype(np.float32).view(np.uint32)]))
    return ((d.cu(qs.view(np.float32)), d.cu(a.view(np.float32))),
            lambda x, s: rt.searchsorted(s, x, side="right"),
            lambda out: (d.host(out, np.int32), np.searchsorted(
                _order_key(a), _order_key(qs), side="right").astype(np.int32)))


def _searchsorted_descending(d):
    qs = d.hits(d.keys, _q_cross(d), d.rand32)
    return ((d.cu(qs), d.cu(d.sorted_keys[::-1].copy())),
            lambda x, s: rt.searchsorted(s, x, config=DESCENDING),
            lambda out: (d.host(out, np.int32), d.searched(~d.sorted_keys[::-1], ~qs, "left")))


def _searchsorted_sorter(d):
    qs, keys = d.hits(d.keys, _q_cross(d), d.rand32), d.cu(d.keys)
    return ((d.cu(qs), keys, rt.argsort(keys)),
            lambda x, a, perm: rt.searchsorted(a, x, sorter=perm),
            lambda out: (d.host(out, np.int32), d.searched(d.sorted_keys, qs, "left")))


def _lexsort_packed(d):
    planes = (d.cu(d.keys.astype(np.uint8)), d.cu((d.keys >> np.uint32(8)).astype(np.uint8)),
              d.cu((d.keys >> np.uint32(16)).astype(np.uint16)))
    return (planes, lambda *p: rt.lexsort(list(p)),
            lambda out: (d.host(out, np.uint32), d.stable_keys.astype(np.uint32)))


def _lexsort_chained(d):
    def oracle(out):
        packed = ((d.k1024.astype(np.uint64) << np.uint64(48))
                  | (d.dups.astype(np.uint64) << np.uint64(32)) | d.keys.astype(np.uint64))
        return d.host(out, np.uint32), _stable_perm(packed).astype(np.uint32)
    return ((d.cu(d.keys), d.cu(d.dups), d.cu(d.k1024)), lambda *p: rt.lexsort(list(p)),
            oracle)


def _segmented_sort(d, desc):
    config = rt.SortConfig(descending=desc)

    def oracle(out):
        p = d.seg_perm(desc)
        return (d.host(out[0], np.uint16), d.host(out[1], np.uint16)), (d.u16[p], d.seg16[p])
    return ((d.cu(d.u16), d.cu(d.seg16)),
            lambda k, s: rt.segmented_sort(k, s, config=config), oracle)


def _segmented_argsort(d, desc):
    config = rt.SortConfig(descending=desc)
    return ((d.cu(d.u16), d.cu(d.seg16)),
            lambda k, s: rt.segmented_argsort(k, s, config=config),
            lambda out: (d.host(out, np.uint32), d.seg_perm(desc).astype(np.uint32)))


def _merge_sorted(d):
    halves = (rt.sort(d.cu(d.keys[: d.n // 2])), rt.sort(d.cu(d.keys[d.n // 2:])))
    return halves, rt.merge_sorted, lambda out: (d.host(out, np.uint32), d.sorted_keys)


def _nth_element(d):
    ranks = [0, 1, d.n // 4, d.n // 2, d.n - 1]
    return ((d.cu(d.keys),), lambda x: rt.nth_element(x, ranks),
            lambda out: (d.host(out, np.uint32), d.sorted_keys[ranks]))


def _top_k_case(d, bits, key):
    """top_k of the keys whose bits are ``bits`` (u32, or f64's as u64),
    ordered by ``key``."""
    def oracle(out):
        i = _top_k(key, 1000)
        return ((d.host(out[0], bits.dtype), d.host(out[1], np.uint32)),
                (bits[i], i.astype(np.uint32)))
    keys = bits.view(np.float64) if bits.dtype == np.uint64 else bits
    return (d.cu(keys),), lambda x: rt.top_k(x, 1000), oracle


def _stable_partition(d):
    pred = (d.keys & np.uint32(1)).astype(bool)

    def oracle(out):
        return ((d.host(out[0]), np.array([int(out[1])])),
                (d.pay_f32[_stable_perm(pred)], np.array([int(np.count_nonzero(~pred))])))
    return (d.cu(pred), d.cu(d.pay_f32)), rt.stable_partition, oracle


def _rankdata(d, method):
    def oracle(out):
        import scipy.stats
        want = scipy.stats.rankdata(d.u16, method=method)
        return d.host(out), want.astype(np.float32 if method == "average" else np.int32)
    return (d.cu(d.dups),), lambda x: rt.rankdata(x, method=method), oracle


def _quantile(d, a):
    return (d.cu(a),), lambda x: rt.quantile(x, QS5), lambda out: (out, d.quantile_check(a))


def _partition(d):
    return ((d.cu(d.keys),), lambda x: rt.partition(x, d.n // 2),
            lambda out: (d.host(out, np.uint32), d.sorted_keys))


def _argpartition(d):
    return ((d.cu(d.keys),), lambda x: rt.argpartition(x, [7, d.n // 2]),
            lambda out: (d.host(out, np.uint32), d.stable_keys.astype(np.uint32)))


def _digitize(d, decreasing):
    edges = d.cu(d.edges32).flip(0) if decreasing else d.cu(d.edges32)
    return ((d.cu(d.pay_f32), edges), lambda x, e: rt.digitize(x, e, right=decreasing),
            lambda out: (d.host(out).astype(np.int64), np.digitize(
                d.pay_f32, d.edges32[::-1] if decreasing else d.edges32, right=decreasing)))


def _sort_complex(d):
    z = (d.rng.integers(-1000, 1000, size=4_000_000).astype(np.float64)   # real-part ties
         + 1j * d.rng.standard_normal(4_000_000))
    return ((z,), lambda x: rt.sort_complex(x, device=d.device),
            lambda out: (out, np.sort_complex(z)))


def _sort_s12(d):
    s12 = np.ascontiguousarray(d.rng.integers(0, 4, size=(4_000_000, 12), dtype=np.uint8)
                               * np.uint8(60)).view("S12").reshape(-1)
    return (s12,), lambda x: rt.sort(x, device=d.device), lambda out: (out, np.sort(s12))


def _argsort_dups(d):
    return ((d.cu(d.dups),), rt.argsort,
            lambda out: (d.host(out, np.uint32), _stable_perm(d.dups).astype(np.uint32)))


def _with_payload(d, entry, keys):
    """sort_pairs or counting_sort of ``keys`` with the {i64, f32} payload."""
    def oracle(out):
        return ((d.host(out[0], keys.dtype), d.host(out[1]["i64"]), d.host(out[1]["f32"])),
                d.pairs(keys))
    return (d.cu(keys), {"i64": d.cu(d.pay_i64), "f32": d.cu(d.pay_f32)}), entry, oracle


def _sort_u64_multipass(d):
    return ((d.cu(d.keys64),), rt.sort_u64_multipass,
            lambda out: (d.host(out, np.uint64), d.sorted64))


def _sort_batched(d):
    return ((d.cu(d.rows_u32),), rt.sort_batched,
            lambda out: (d.host(out, np.uint32), np.sort(d.rows_u32, axis=-1)))


def _argsort_batched(d):
    return ((d.cu(d.rows_dups),), rt.argsort_batched,
            lambda out: (d.host(out, np.uint32),
                         np.argsort(d.rows_dups, axis=-1, kind="stable").astype(np.uint32)))


def _sort_pairs_batched(d):
    def oracle(out):
        perm = np.argsort(d.rows_dups, axis=-1, kind="stable")
        return ((d.host(out[0], np.uint32), d.host(out[1])),
                (np.sort(d.rows_dups, axis=-1), np.take_along_axis(d.rows_f32, perm, -1)))
    return (d.cu(d.rows_dups), d.cu(d.rows_f32)), rt.sort_pairs_batched, oracle


def _group_reduce(d, op):
    def oracle(out):
        want = (_wrapped_sums(d.dups, d.v_bench, 1 << 16) if op == "sum"
                else d.extremes(d.dups, d.v_bench)[op == "max"])
        return ((d.host(out[0], np.uint32), d.host(out[1], np.uint32 if op == "sum" else np.int32),
                 np.array([int(out[2])])),
                (np.arange(1 << 16, dtype=np.uint32), want, np.array([1 << 16])))
    return ((d.cu(d.dups), d.cu(d.v_bench)),
            lambda k, v: rt.group_reduce(k, v, reduce=op, size=1 << 16), oracle)


def _value_counts(d):
    def oracle(out):
        return ((d.host(out[0], np.uint32), d.host(out[1], np.int32), np.array([int(out[2])])),
                (np.arange(1024, dtype=np.uint32),
                 np.bincount(d.k1024, minlength=1024).astype(np.int32), np.array([1024])))
    return (d.cu(d.k1024),), lambda k: rt.value_counts(k, size=1024), oracle


def _unique_u32(d, entry, fields, want):
    """A unique of the u32 keys: its ``fields`` against ``want(d)``."""
    return (d.cu(d.keys),), entry, lambda out: (d.fields(out, fields), want(d))


def _unique_descending(d):
    vals, num = d.keys_unique[0], d.keys_unique[4]
    return _padded(vals[: int(num[0])][::-1], d.n, 0), num


def _unique_f32(d, equal_nan):
    return ((d.cu(d.f32b.view(np.float32)),),
            lambda x: rt.unique(x, return_counts=True, equal_nan=equal_nan),
            lambda out: (d.fields(out, ("values", "counts", "num_unique")),
                         d.f32_counts(equal_nan)))


def _unique_inverse_u64(d):
    def oracle(out):
        vals = _runs(d.sorted64)[0]
        return (d.fields(out, ("values", "inverse_indices", "num_unique")),
                (_padded(vals, d.n, np.uint64(2**64 - 1)),
                 np.searchsorted(vals, d.keys64).astype(np.int32), np.array([vals.size])))
    return (d.keys64,), lambda x: rt.unique_inverse(x, device=d.device), oracle


def _unique_rows(d):
    def oracle(out):
        return ((d.host(out.values), d.host(out.index, np.uint32), d.host(out.inverse),
                 d.host(out.counts), np.array([int(out.num_unique)])), d.rows_unique())
    return ((d.cu(d.rows8),),
            lambda x: rt.unique(x, axis=0, return_index=True, return_inverse=True,
                                return_counts=True), oracle)


def _set_op(d, op):
    return ((d.cu(d.keys), d.cu(d.set_b)), getattr(rt, op),
            lambda out: (d.set_values(out), d.set_op(op)))


def _intersect_indices(d, wide):
    """intersect1d(return_indices=True) of two u32 tensors, or (``wide``) of
    two u64 numpy arrays."""
    if wide:
        a, b, ones, dtype, device = d.set_a64, d.set_b64, np.uint64(2**64 - 1), np.uint64, d.device
        args = (a, b)
    else:
        a, b, ones, dtype, device = d.keys, d.set_b, 0xFFFFFFFF, np.uint32, None
        args = (d.cu(a), d.cu(b))         # on the device already: no device=
    return (args, lambda x, y: rt.intersect1d(x, y, return_indices=True, device=device),
            lambda out: (d.set_values(out, dtype), d.intersect_indices(a, b, ones)))


def _isin(d, entry, invert):
    return ((d.cu(d.keys), d.cu(d.tests)), entry,
            lambda out: (d.host(out), ~d.isin if invert else d.isin))


ENTRY_CASES = {
    **{f"searchsorted u32, q = {label} ('auto': {route}), {side}": functools.partial(
        _searchsorted_u32, q=q, side=side)
       for label, q, route in (("100,000", _q_scan, "scan"),
                               ("n / 32", _q_cross, "sort"))
       for side in ("left", "right")},
    "searchsorted u64, q = 4,000,000 (tagged union)": _searchsorted_u64,
    "searchsorted f32 with specials, q = 1,000,000, right": _searchsorted_f32,
    "searchsorted u32 descending, q = n / 32": _searchsorted_descending,
    "searchsorted u32 with sorter=, q = n / 32": _searchsorted_sorter,
    "lexsort (u8, u8, u16): one packed plane": _lexsort_packed,
    "lexsort (u32, u32, u32): chained sorts": _lexsort_chained,
    **{f"segmented_{kind} u16 keys in 1,024 u16 segments{label}": functools.partial(
        case, desc=desc)
       for kind, case in (("sort", _segmented_sort), ("argsort", _segmented_argsort))
       for label, desc in (("", False), (", descending", True))},
    "merge_sorted of two sorted halves": _merge_sorted,
    "nth_element u32 at 5 ranks": _nth_element,
    "top_k u32, k = 1,000": lambda d: _top_k_case(d, d.keys, d.keys),
    "top_k f64 with specials, k = 1,000": lambda d: _top_k_case(d, d.f64b, _order_key(d.f64b)),
    "stable_partition by u32 & 1, f32 payload": _stable_partition,
    **{f"rankdata u32 with duplicates, '{method}'": functools.partial(_rankdata, method=method)
       for method in ("average", "dense")},
    "quantile f32 at 5 probabilities": lambda d: _quantile(d, d.pay_f32),
    "quantile u16 at 5 probabilities (K2 + K8)": lambda d: _quantile(d, d.u16),
    "partition u32": _partition,
    "argpartition u32": _argpartition,
    "digitize f32, 1,001 increasing edges": functools.partial(_digitize, decreasing=False),
    "digitize f32, 1,001 decreasing edges, right=True": functools.partial(
        _digitize, decreasing=True),
    "sort_complex of 4,000,000 complex128 (numpy)": _sort_complex,
    "sort of 4,000,000 S12 byte strings (numpy)": _sort_s12,
    "argsort u32 with duplicates": _argsort_dups,
    "sort_pairs u32 with duplicates, {i64, f32}": lambda d: _with_payload(
        d, rt.sort_pairs, d.dups),
    "counting_sort u16 with a payload": lambda d: _with_payload(d, rt.counting_sort, d.u16),
    "sort_u64_multipass": _sort_u64_multipass,
    "sort_batched of 4,096-key rows": _sort_batched,
    "argsort_batched of 4,096-key rows with duplicates": _argsort_batched,
    "sort_pairs_batched of 4,096-key rows with duplicates, f32 payload": _sort_pairs_batched,
    **{f"group_reduce {op}, no groups (sort-native)": functools.partial(_group_reduce, op=op)
       for op in ("sum", "min", "max")},
    "value_counts, no groups (sorter)": _value_counts,
    # the sets (each with torch.cummax refused)
    "sets: unique u32": lambda d: _unique_u32(
        d, rt.unique, ("values", "num_unique"), lambda d: d.keys_unique[::4]),
    "sets: unique u32, return_counts=True": lambda d: _unique_u32(
        d, functools.partial(rt.unique, return_counts=True), ("values", "counts", "num_unique"),
        lambda d: tuple(d.keys_unique[i] for i in (0, 3, 4))),
    "sets: unique_all u32": lambda d: _unique_u32(
        d, rt.unique_all, ("values", "indices", "inverse_indices", "counts", "num_unique"),
        lambda d: d.keys_unique),
    "sets: unique u32, descending": lambda d: _unique_u32(
        d, functools.partial(rt.unique, config=DESCENDING), ("values", "num_unique"),
        _unique_descending),
    **{f"sets: unique f32 with specials, return_counts=True, equal_nan={eq}": functools.partial(
        _unique_f32, equal_nan=eq) for eq in (False, True)},
    "sets: unique_inverse u64 (numpy)": _unique_inverse_u64,
    "sets: unique(axis=0, every flag) of 10,000,000 rows of 4 int32 in [0, 8)": _unique_rows,
    **{f"sets: {op} of two u32 arrays sharing about half their values": functools.partial(
        _set_op, op=op) for op in ("union1d", "intersect1d", "setdiff1d", "setxor1d")},
    "sets: intersect1d(return_indices=True) of the two u32 arrays": functools.partial(
        _intersect_indices, wide=False),
    "sets: intersect1d(return_indices=True) of two u64 arrays (numpy)": functools.partial(
        _intersect_indices, wide=True),
    **{f"sets: {label} of the keys against n / 4 tests, half of them keys": functools.partial(
        _isin, entry=entry, invert=invert)
       for label, entry, invert in (("isin", rt.isin, False),
                                    ("isin(invert=True)",
                                     functools.partial(rt.isin, invert=True), True),
                                    ("in1d", rt.in1d, False))},
}


@pytest.fixture(scope="module")
def entry_slice():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _Slice(_gate_sizes()["above the gate"], torch.device("cuda", torch.cuda.current_device()))


def _matches(got, want):
    """Every array of ``got`` equal to ``want``'s (a tuple or one array),
    a dtype of the same width read as ``got``'s."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype != w.dtype and g.dtype.itemsize == w.dtype.itemsize:
            w = w.view(g.dtype)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        bad = np.flatnonzero((g != w).reshape(-1))
        assert bad.size == 0, f"output {i} differs from numpy first at {bad[0]}"


@pytest.mark.parametrize("case", ENTRY_CASES)
def test_entry_points_above_the_k0_gate_match_numpy(cuda, entry_slice, monkeypatch, case):
    """The sorter composites of extras and stats, the sets and the slice's
    other sorter calls at n = LSD_MIN_KEYS + 12,345 keys, so their 1-D
    sorts take K0 (one plane, and two planes past K0_TWO_PLANE_MIN_KEYS),
    against numpy bit for bit; every output on the card; the sets never
    call torch.cummax."""
    if case.startswith("sets: "):
        monkeypatch.setattr(torch, "cummax", _no_cummax)
        monkeypatch.setattr(torch.Tensor, "cummax", _no_cummax)
    args, call, oracle = ENTRY_CASES[case](entry_slice)
    got, want = oracle(call(*args))
    if callable(want):
        want(got)
    else:
        _matches(got, want)
