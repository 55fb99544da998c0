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

import re
from pathlib import Path

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
# the histogram kernel's launch shapes (csrc/hist.cu): the rule, and a numpy
# model of the kernel's index arithmetic held against the plain versions


def _hist_totals():
    """Every total a wrapper sends: K1's P * 2^r for P = 1 (hist) and P =
    ceil(32 / r) (hist_multi), K2 / K3's 2^nbits."""
    totals = {1 << b: 1 for b in range(1, 19)}
    totals.update({-(-32 // r) << r: -(-32 // r) for r in range(1, 19)})
    return sorted(totals.items())


def test_hist_shape_rule_gives_each_counter_one_owner():
    sent = _hist_totals()
    for total, passes in sent + [(t, 1) for t in range(2, 1 << 19, 997)]:
        shapes = [ck.hist_shape(total)]
        if (total, passes) in sent:
            shapes += ck.hist_shape_candidates(total)
        for shape in shapes:
            assert ck.hist_shape_ok(shape, total), (total, shape)
            # row y owns [y << local_bits, (y + 1) << local_bits) of [0, total)
            rows = np.arange(shape.ranges + 1) << shape.local_bits
            owned = np.diff(np.minimum(total, rows))
            assert owned.sum() == total and owned.min() >= 1, (total, shape)
            assert shape.smem(total) <= 232_448
        picked = shapes[0]
        if total <= 1 << 15:                           # 32-bit counters in one block
            assert picked.ranges == 1 and not picked.half
        else:                                          # 16-bit counters, 2^16 a row
            assert picked.half and picked.ranges == -(-total >> 16)
        if total <= 1 << 16:
            assert picked.ranges == 1                  # each key read once
    assert ck.hist_shape(1 << 19).ranges == 8
    with pytest.raises(ValueError):
        ck.hist_shape((1 << 19) + 1)


def _pext_np(x, mask):
    out = np.zeros(x.shape, np.int64)
    k = 0
    for b in range(32):
        if mask >> b & 1:
            out |= ((x.astype(np.int64) >> b) & 1) << k
            k += 1
    return out


# The 16-bit counters' hand-off (csrc/half_counter.cuh) and the rounds the
# kernels count in, read from the sources the card builds, so that the models
# below follow what the kernels compile: a counter that reaches
# HALF_HAND_OFF hands it to the output, and none carries into its neighbour
# while threads * (the most keys a thread reads a round) <= HALF_HAND_OFF.
CSRC = Path(ck.__file__).resolve().parents[1] / "csrc"


def _source_ints(name, pattern):
    found = re.search(pattern, (CSRC / name).read_text(), re.S)
    assert found, (name, pattern)
    return tuple(int(g, 0) for g in found.groups())


(HALF_HAND_OFF,) = _source_ints("half_counter.cuh", r"kHalfHandOff = (0x[0-9A-Fa-f]+)u;")
# hist.cu: 16-byte loads a plane a chunk, and chunks a round, for two planes
# (K3) and one (K2; K1's DigitCount loads as many)
_TWO_UNROLL, _ONE_UNROLL = _source_ints(
    "hist.cu", r"struct PextCount \{.*?unroll = kTwo \? (\d+) : (\d+);")
(_DIGIT_UNROLL,) = _source_ints("hist.cu", r"struct DigitCount \{.*?unroll = (\d+);")
_TWO_ROUND, _ONE_ROUND = _source_ints("hist.cu", r"kRound = Count::two \? (\d+) : (\d+);")
HIST_ROUNDS = ((_ONE_UNROLL, _ONE_ROUND), (_TWO_UNROLL, _TWO_ROUND))
# whist.cu: rounds of one chunk; a thread reads at most 4 * unroll + 2 rows a round
WHIST_ROUND_ADDS = _source_ints(
    "whist.cu", r"half_round_ok\(kMaxThreads, (\d+) \* kUnroll \+ (\d+)\)")


def half_round_adds(unroll, chunks=1):
    """The most keys a thread reads in a round: ``chunks`` chunks of
    ``unroll`` 16-byte groups, or in the last round the short chunk with one
    head and one tail key."""
    return max(4 * unroll * chunks, 4 * unroll + 2)


def half_round_ok(threads, keys_a_round):
    """``rst::half_round_ok``: while a hand-off is pending its counter holds
    at most 2^15 - 1 + threads * keys_a_round, below 2^16."""
    return keys_a_round >= 1 and threads * keys_a_round <= HALF_HAND_OFF


def test_hand_off_mirrors_read_the_kernel_sources():
    assert HALF_HAND_OFF == 1 << 15
    assert _DIGIT_UNROLL == _ONE_UNROLL
    # the rounds the proof in half_counter.cuh names: two chunks of one
    # plane, one of two planes; whist.cu's rounds of one chunk
    assert HIST_ROUNDS == ((4, 2), (2, 1))
    assert WHIST_ROUND_ADDS == (4, 2)
    assert all(half_round_adds(u) == WHIST_ROUND_ADDS[0] * u + WHIST_ROUND_ADDS[1]
               for u in (2, 4))
    assert "static_cast<long long>(threads) * keys_a_round <= kHalfHandOff" in \
        (CSRC / "half_counter.cuh").read_text()
    hist_cu = (CSRC / "hist.cu").read_text()
    assert "rst::half_round_ok(kMaxThreads, 4 * kUnroll * kRound)" in hist_cu
    for name in ("hist.cu", "whist.cu"):
        (threads,) = _source_ints(name, r"constexpr int kMaxThreads = (\d+);")
        assert threads == 1024
        for unroll, chunks in (HIST_ROUNDS if name == "hist.cu" else ((2, 1), (4, 1))):
            assert half_round_ok(threads, half_round_adds(unroll, chunks))


def read_plan(n, threads, unroll, blocks, words=0, round_chunks=1):
    """Which block and thread of a grid row read each of ``n`` words, and in
    which of the block's rounds (``round_chunks`` chunks and the barrier
    after them), from the kernels' index arithmetic (csrc/hist.cu,
    csrc/whist.cu). ``words``: the plane's address in words mod 4. A head
    of up to 3 words and the tail go to block 0 (thread t reads word t of
    each), whole chunks of unroll * threads 16-byte groups to the blocks in
    turn (chunk j: block j % blocks, the block's (j // blocks)-th), the
    short chunk to the next block; the short chunk, the head and the tail
    fall in a last round of their own."""
    lead = min((4 - words) & 3, n)
    quads = (n - lead) >> 2
    chunk = unroll * threads
    whole = quads // chunk
    rounds = -(-np.array([len(range(b, whole, blocks)) for b in range(blocks)]) // round_chunks)
    i = np.arange(n)
    block = np.zeros(n, np.int64)
    thread = i.copy()                                   # head: thread t reads word t
    rnd = np.full(n, rounds[0])
    body = slice(lead, lead + 4 * quads)
    q = (i[body] - lead) >> 2
    j = q // chunk
    block[body] = np.where(j < whole, j % blocks, whole % blocks)
    thread[body] = np.where(j < whole, q - j * chunk, q - whole * chunk) % threads
    rnd[body] = np.where(j < whole, j // blocks // round_chunks, rounds[block[body]])
    thread[lead + 4 * quads:] -= lead + 4 * quads        # tail: thread t reads tail word t
    assert thread.max(initial=0) < threads
    return block, thread, rnd


def hand_off_model(block, rnd, thread, counter, threads, keys_a_round, blocks, counters):
    """The 16-bit counters' hand-off (csrc/half_counter.cuh) in numpy, one
    add per entry: (2^15s handed off, what is left) per (block, counter).

    Asserts what the proof by count rests on: no thread reads more than
    ``keys_a_round`` keys of one counter in a round, and threads *
    keys_a_round <= 2^15;
    every round starts with the counter below 2^15; and the most it can hold
    while a hand-off is pending (every other add of the round landing before
    the subtract, whether a key's or a warp's sum of keys) stays below 2^16."""
    bits = max(1, (counters - 1).bit_length())
    rounds = int(rnd.max(initial=0)) + 1
    key = (((block * rounds + rnd) * threads + thread) << bits) | counter
    _, per_thread = np.unique(key, return_counts=True)
    assert per_thread.max(initial=0) <= keys_a_round
    assert half_round_ok(threads, keys_a_round)
    total = np.zeros((blocks, rounds, counters), np.int64)
    np.add.at(total, (block, rnd, counter), 1)
    held = np.zeros((blocks, counters), np.int64)
    handed = np.zeros((blocks, counters), np.int64)
    for r in range(rounds):
        assert (held < HALF_HAND_OFF).all()
        peak = held + total[:, r]
        assert (peak < 1 << 16).all()
        crossed = peak >= HALF_HAND_OFF
        handed += crossed
        held = peak - crossed * HALF_HAND_OFF
    return handed, held


def hist_kernel_model(lo, hi, counters_of, total, shape, blocks, lo_words=0, unroll=4):
    """What ``hist_kernel`` computes, from its index arithmetic, in numpy.

    ``lo`` (and ``hi``, or None) are the planes as u32; ``counters_of(h, l)``
    gives each key's counters as a (P, n) int64 array, -1 for none (a
    dropped key); ``blocks`` the blocks of a grid row; ``lo_words`` the lo
    plane's address in words mod 4; ``unroll`` the 16-byte groups a thread
    loads a chunk. The keys are read as :func:`read_plan` deals them; a
    key's counters go to the reading block of the row that owns them (``c >>
    local_bits``), in the reading warp's copy, 16-bit counters through
    :func:`hand_off_model`, and every block adds its counters into the
    output."""
    threads = shape.threads
    round_chunks = dict(HIST_ROUNDS)[unroll]
    block, thread, rnd = read_plan(lo.size, threads, unroll, blocks, lo_words, round_chunks)
    stride = min(1 << shape.local_bits, total)
    smem = np.zeros((shape.ranges, blocks, shape.copies, stride), np.int64)
    out = np.zeros(total, np.int64)
    copy = (thread >> 5) % shape.copies
    adds = []
    for c in counters_of(hi, lo):
        ok = c >= 0
        row = c[ok] >> shape.local_bits
        assert row.max(initial=0) < shape.ranges
        local = c[ok] & ((1 << shape.local_bits) - 1)
        adds.append((row, block[ok], rnd[ok], thread[ok], local))
        if not shape.half:
            np.add.at(smem, (row, block[ok], copy[ok], local), 1)
    if shape.half:
        row, blk, rd, th, local = (np.concatenate(a) for a in zip(*adds))
        for y in range(shape.ranges):
            mine = row == y
            handed, held = hand_off_model(blk[mine], rd[mine], th[mine], local[mine], threads,
                                          half_round_adds(unroll, round_chunks), blocks,
                                          stride)
            smem[y, :, 0] = held
            first = y << shape.local_bits
            size = min(stride, total - first)
            out[first:first + size] += (handed.sum(axis=0) * HALF_HAND_OFF)[:size]
    owned = np.zeros(total, np.int64)
    for y in range(shape.ranges):
        first = y << shape.local_bits
        size = min(stride, total - first)
        assert size > 0
        for b in range(blocks):
            out[first:first + size] += smem[y, b].sum(axis=0)[:size]
            assert not smem[y, b][:, size:].any()      # nothing past the row's counters
            owned[first:first + size] += 1
    assert (owned == blocks).all()                      # one owner a counter in each block
    return out


def whist_kernel_model(keys, vals, bits, drop_ge, shape, blocks, key_words=0):
    """What ``whist_kernel`` computes, from its bin arithmetic, in numpy:
    (counts, u32 sums) of 2^bits bins. The rows are read as
    :func:`read_plan` deals them (the values at the keys' indices, whether
    they are read in 16-byte groups or word by word); grid row y keeps the
    bins ``[y << local_bits, (y + 1) << local_bits)``, and a kept key (``<
    drop_ge``) goes to the reading block's table in the row that owns it,
    its count through :func:`hand_off_model` with 16-bit counts; every
    block adds its table into the outputs, the sums mod 2^32."""
    lb, bins = shape.local_bits, 1 << bits
    assert shape.ranges << lb == bins
    block, thread, rnd = read_plan(keys.size, shape.threads, shape.unroll, blocks, key_words)
    k = keys.astype(np.int64)
    ok = k < drop_ge
    row, local = k[ok] >> lb, k[ok] & ((1 << lb) - 1)
    assert row.max(initial=0) < shape.ranges
    table = np.zeros((shape.ranges, blocks, 1 << lb), np.int64)
    np.add.at(table, (row, block[ok], local), vals[ok].astype(np.int64))
    counts = np.zeros((shape.ranges, blocks, 1 << lb), np.int64)
    handed = np.zeros_like(counts)
    if shape.half:
        for y in range(shape.ranges):
            mine = row == y
            handed[y], counts[y] = hand_off_model(
                block[ok][mine], rnd[ok][mine], thread[ok][mine], local[mine],
                shape.threads, half_round_adds(shape.unroll), blocks, 1 << lb)
    else:
        np.add.at(counts, (row, block[ok], local), 1)
    out_counts = (counts + handed * HALF_HAND_OFF).sum(axis=1).reshape(bins)
    out_sums = (table.sum(axis=1) & 0xFFFFFFFF).reshape(bins).astype(np.uint32)
    return out_counts, out_sums


def pext_counters(mask_hi, mask_lo):
    nb_lo = bin(mask_lo).count("1")

    def counters_of(h, l):
        v = _pext_np(l, mask_lo)
        if h is not None:
            v |= _pext_np(h, mask_hi) << nb_lo
        return v[None]
    return counters_of


def digit_counters(shift, bits, passes, drop_ge=None, offset=0):
    def counters_of(h, l):
        u = (l.astype(np.int64) - offset) & 0xFFFFFFFF
        ok = u < (1 << 32 if drop_ge is None else drop_ge)
        return np.stack([np.where(ok, (p << bits) | ((u >> (shift + p * bits)) & ((1 << bits) - 1)),
                                  -1) for p in range(passes)])
    return counters_of


# shapes at 256 threads (chunks of 4,096 keys) so that a few tens of
# thousands of keys fill several: copies of 32-bit counters, 16-bit counters
# in one block and in grid rows
MODEL_SHAPES = {
    1 << 8: [ck.HistShape(256, 8, 1, 8, 0), ck.HistShape(256, 8, 1, 3, 0)],
    1 << 16: [ck.HistShape(256, 16, 1, 1, 1), ck.HistShape(256, 15, 2, 1, 1)],
    1 << 17: [ck.HistShape(256, 16, 2, 1, 1), ck.HistShape(1024, 16, 2, 1, 1)],
}


@pytest.mark.parametrize("lo_words", [0, 1, 2, 3])
@pytest.mark.parametrize("mask", [0xF0F00000, 0xFFFF, 0x1FFFF])
def test_hist_pext_model_matches_plain(mask, lo_words):
    n = 24_007 + lo_words
    x = masked_keys(lo_words, n, 0xFFFFFFFF, 0)
    x[: n // 3] = 0x00012345                            # a third of the keys one value
    bins = 1 << bin(mask).count("1")
    want = ck.hist_pext_plain(plane(x), mask).numpy()
    for shape in MODEL_SHAPES[bins] + [ck.hist_shape(bins)]:
        for blocks in (1, 3):
            got = hist_kernel_model(x, None, pext_counters(0, mask), bins, shape, blocks,
                                    lo_words)
            assert np.array_equal(got, want), (shape, blocks)
    if bins == 1 << 16:
        assert np.array_equal(np.asarray(pk.histogram_pext_tpu(jnp.asarray(x), mask)), want)


@pytest.mark.parametrize("masks", [(0x1FFFF, 0), (0, 0xFFFF), (0xFF00, 0xFF00), (0xF, 0xF0)])
def test_hist_pext2_model_matches_plain(masks):
    mh, ml = masks
    n = 20_003
    hi, lo = masked_keys(1, n, 0xFFFFFFFF, 0), masked_keys(2, n, 0xFFFFFFFF, 0)
    bins = 1 << (bin(mh).count("1") + bin(ml).count("1"))
    want = ck.hist_pext2_plain(plane(hi), plane(lo), mh, ml).numpy()
    if mh and ml:   # two planes, lo 2 words off the grid, two 16-byte loads a plane a step
        got = hist_kernel_model(lo, hi, pext_counters(mh, ml), bins, ck.hist_shape(bins), 2, 2,
                                unroll=2)
    else:           # one mask 0: the other plane alone, as K2 reads it
        live = hi if mh else lo
        got = hist_kernel_model(live, None, pext_counters(0, mh | ml), bins,
                                ck.hist_shape(bins), 2, 1)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the weighted histogram's launch shapes (csrc/whist.cu) and the 16-bit
# counters' hand-off (csrc/half_counter.cuh) that it shares with hist.cu


def test_whist_shape_rule_gives_each_bin_one_owner():
    for bits in range(2, ck.WHIST_MAX_BITS + 1):
        for sums, counts in (("u32", True), ("f32", True), ("f32", False)):
            picked = ck.whist_shape(bits, sums, counts)
            shapes = ck.whist_shape_candidates(bits, sums, counts)
            assert shapes[0] == picked
            for shape in shapes:
                assert ck.whist_shape_ok(shape, bits, counts), (bits, shape)
                # row y owns [y << local_bits, (y + 1) << local_bits) of [0, 2^bits)
                rows = np.arange(shape.ranges + 1) << shape.local_bits
                owned = np.diff(np.minimum(1 << bits, rows))
                assert owned.sum() == 1 << bits and owned.min() >= 1, (bits, shape)
                assert shape.smem(counts) <= 232_448
            assert picked.half == (counts and bits > 14)         # 32-bit counts while they fit
            assert picked.ranges == 1 << max(0, bits - 15)       # 2^15 bins a block
            assert picked.unroll == (4 if not counts and bits > 15 else 2)
    for sums in ("u32", "f32"):      # counts past 2^15 bins: 2 rows at 2^16, 4 at 2^17
        assert [ck.whist_shape(b, sums, True).ranges for b in (15, 16, 17)] == [1, 2, 4]
    assert not ck.whist_shape_ok(ck.WhistShape(1024, 16, 1, 1, 2), 16, True)   # 384 KB
    assert not ck.whist_shape_ok(ck.WhistShape(1024, 15, 2, 0, 2), 16, True)   # 256 KB
    assert not ck.whist_shape_ok(ck.WhistShape(1024, 15, 1, 1, 2), 16, True)   # no owner
    assert not ck.whist_shape_ok(ck.WhistShape(1024, 15, 2, 1, 2), 16, False)  # counts
    assert not ck.whist_shape_ok(ck.WhistShape(1024, 15, 2, 1, 4), 16, True)   # 4 loads
    assert ck.whist_shape_ok(ck.WhistShape(1024, 15, 2, 0, 4), 16, False)
    for bad in ((18, "u32", True), (1, "u32", True), (10, "u32", False), (10, "f64", True)):
        with pytest.raises(ValueError):
            ck.whist_shape(*bad)


def test_hand_off_stays_below_the_carry_for_every_shape():
    # just after the crossing add the counter holds at most 2^15 - 1 + A (A:
    # the most a thread adds to one counter a round); what the other threads
    # can add before the subtract must stay below 2^16 - (2^15 - 1 + A),
    # 32,753 at A = 16
    def check(threads, unroll, chunks=1):
        a = half_round_adds(unroll, chunks)
        assert (threads - 1) * a < (1 << 16) - (HALF_HAND_OFF - 1 + a), (threads, unroll)
        assert half_round_ok(threads, a)
    half_shapes = 0
    for total, _ in _hist_totals():
        for shape in ck.hist_shape_candidates(total):
            if shape.half:
                half_shapes += 1
                for unroll, chunks in HIST_ROUNDS:
                    check(shape.threads, unroll, chunks)
    for bits in range(2, ck.WHIST_MAX_BITS + 1):
        for sums, counts in (("u32", True), ("f32", True), ("f32", False)):
            for shape in ck.whist_shape_candidates(bits, sums, counts):
                if shape.half:
                    half_shapes += 1
                    check(shape.threads, shape.unroll)
    assert half_shapes > 50
    for threads in ck.HIST_THREADS:    # every shape the entries take, whatever the rule picks
        for unroll, chunks in HIST_ROUNDS + ((2, 1), (4, 1)):
            check(threads, unroll, chunks)
    assert half_round_adds(4, 2) == 32       # one plane: at the bound at 1,024 threads
    assert half_round_ok(1024, 32) and not half_round_ok(1024, 33)


# shapes at 256 and 512 threads (chunks of 2,048 to 8,192 rows) so that a
# few tens of thousands of rows fill several: 32-bit and 16-bit counts, one
# block and grid rows
WHIST_MODEL_SHAPES = {
    10: [ck.WhistShape(256, 10, 1, 0, 2), ck.WhistShape(256, 10, 1, 1, 2)],
    16: [ck.WhistShape(256, 15, 2, 1, 2), ck.WhistShape(256, 14, 4, 0, 2)],
    17: [ck.WhistShape(256, 15, 4, 1, 2), ck.WhistShape(512, 15, 4, 1, 2)],
}


@pytest.mark.parametrize("key_words", [0, 3])
@pytest.mark.parametrize("bits", [10, 16, 17])
def test_whist_model_matches_plain(bits, key_words):
    n = 24_007 + key_words
    rng = np.random.Generator(np.random.PCG64(bits + key_words))
    keys = rng.integers(0, 1 << bits, size=n).astype(np.uint32)
    keys[: n // 3] = (1 << bits) - 2                    # a third of the rows one group
    keys[::41] = rng.integers(1 << bits, 1 << 32, size=keys[::41].size)   # past drop_ge
    vals = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    drop = (1 << bits) - 1
    want = [t.numpy().view(np.uint32) for t in ck.whist_plain(plane(keys), plane(vals), bits,
                                                               drop)]
    for shape in WHIST_MODEL_SHAPES[bits] + [ck.whist_shape(bits)]:
        for blocks in (1, 3):
            counts, sums = whist_kernel_model(keys, vals, bits, drop, shape, blocks, key_words)
            assert np.array_equal(counts, want[0]) and np.array_equal(sums, want[1]), shape


@pytest.mark.parametrize("kernel", ["hist_pext", "whist"])
def test_hand_off_model_with_most_keys_one_value(kernel):
    # 100,003 keys, all but every seventh one value: in one block the
    # value's 16-bit counter crosses 2^15 twice, in two once each
    n = 100_003
    rng = np.random.Generator(np.random.PCG64(17))
    keys = np.full(n, 0x12A55, np.uint32)
    keys[::7] = rng.integers(0, 1 << 17, size=keys[::7].size)
    for bits in (16, 17):
        bins = 1 << bits
        k = keys & np.uint32(bins - 1)
        if kernel == "hist_pext":
            mask = bins - 1
            want = ck.hist_pext_plain(plane(k), mask).numpy()
            shapes = [ck.HistShape(256, 16, bins >> 16, 1, 1), ck.hist_shape(bins)]
            for shape in shapes:
                for blocks in (1, 2):
                    got = hist_kernel_model(k, None, pext_counters(0, mask), bins, shape,
                                            blocks)
                    assert np.array_equal(got, want), (shape, blocks)
        else:
            vals = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
            want = [t.numpy().view(np.uint32)
                    for t in ck.whist_plain(plane(k), plane(vals), bits, bins)]
            for shape in [ck.WhistShape(256, 15, bins >> 15, 1, 2), ck.whist_shape(bits)]:
                for blocks in (1, 2):
                    counts, sums = whist_kernel_model(k, vals, bits, bins, shape, blocks)
                    assert np.array_equal(counts, want[0]), (shape, blocks)
                    assert np.array_equal(sums, want[1]), (shape, blocks)
            assert want[0].max() > 2 * HALF_HAND_OFF


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
