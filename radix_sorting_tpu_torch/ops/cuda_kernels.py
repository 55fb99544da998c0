"""Hopper kernels of the counting, group-by and sort tiers, their plain
versions and launch counts.

The counterpart of ``radix_sorting_tpu.ops.pallas_kernels`` for the kernels
ported so far. Each wrapper checks its inputs, then

* on a CUDA tensor launches its hand-written kernel (``csrc/``, built by
  :mod:`._build`) on the current stream, or raises;
* on a CPU tensor runs its plain PyTorch version, the counterpart of Pallas
  interpret mode, so the CPU tests run the dispatch graph the GPU runs.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one where it
launches its kernel and nowhere else; the plain versions count nothing.

======================  ==============  =====================================
wrapper / counter       CUDA source     replaces (pallas_kernels.py)
======================  ==============  =====================================
hist                    csrc/hist.cu    K1 ``_hist_kernel`` (one digit)
hist_multi              csrc/hist.cu    K1 ``_hist_kernel`` (every digit)
live_digits             csrc/hist.cu    K1 ``_hist_kernel`` (every digit of one
                                        or two planes, with an order flag)
(live_digits_pair)      csrc/hist.cu    the same, two planes read as a pair
hist_pext               csrc/hist.cu    K2 ``_hist_pext_kernel``
hist_pext2              csrc/hist.cu    K3 ``_hist_pext2_kernel``
regen                   csrc/regen.cu   K4 ``_regen_kernel``
(regen_windowed)        csrc/regen.cu   K7 ``_regen_win_kernel``
regen_pdep              csrc/regen.cu   K5 ``_regen_pdep_kernel``
(regen_pdep_windowed)   csrc/regen.cu   K8 ``_regen_pdep_win_kernel``
regen_pdep2             csrc/regen.cu   K6 ``_regen_pdep2_kernel``
(regen_pdep2_windowed)  csrc/regen.cu   K9 ``_regen_pdep2_win_kernel``
whist                   csrc/whist.cu   K10 ``_whist_kernel``
whist_f32               csrc/whist.cu   K11 ``_whist_f32_kernel`` (sums)
(whist_f32_counts)      csrc/whist.cu   K11 ``_whist_f32_kernel`` (counts too)
bitonic                 csrc/bitonic.cu K12 ``vmem_sort._bitonic_kernel``
lsd_hist                csrc/lsd.cu     L1, no Pallas kernel (LSD pass)
lsd_scatter             csrc/lsd.cu     L2, no Pallas kernel (LSD pass)
k0_sweep                csrc/lsd.cu     K0's pass, no Pallas kernel (``lax.sort``)
(k0_sweep_pair_in)      csrc/lsd.cu     the same, its key planes read as a pair
(k0_sweep_pair_out)     csrc/lsd.cu     the same, its key planes written as one
lsd_sort                csrc/lsd.cu,    K0, no Pallas kernel: ``lax.sort`` of one
                        csrc/hist.cu    plane (``hw_engine``: K1 + sweeps)
dma_copy                csrc/sol.cu     E1 ``scripts/exp_sol_probe.py``
msd_spread              csrc/sol.cu     E2 ``scripts/exp_sol_round2.py``
rdma_exchange           csrc/exchange.cu K13 ``parallel/rdma.py::_exchange_kernel``
======================  ==============  =====================================

One histogram kernel counts digits (K1) or the PEXT-compacted live bits of
one plane (K2) or two (K3), and one regeneration kernel writes dense values
(K4, K7) or masked keys into one plane or two, and meets the <= 2^10-bin
(K4, K5, K6) and the 2^11 to 2^17-bin (K7, K8, K9) contracts alike;
launches are counted under the contract's name. One weighted histogram
kernel sums integer values (K10) or f32 weights (K11) per key. K12 sorts a
few planes with a bitonic network. L1 and L2 are one pass of the LSD radix
sort (per-tile digit histograms, stable scatter); the JAX package's LSD
engine is XLA with no Pallas kernel, so they replace none. ``lsd_sort``
counts the calls of K0, the port's sorter of one or two planes on the card
(:mod:`.hw_engine`), which launches ``live_digits`` once (every plane's
digit histograms and the presorted guard's flag in one read) and
``k0_sweep`` (L2's staged form with a decoupled look-back in place of L1
and the scan) once a live digit; it replaces ``lax.sort``, which is no
Pallas kernel either. K0's two key planes may be a *pair*, the two halves
of one dense 64-bit buffer (:func:`.kdf.halves`): ``live_digits`` and the
first live ``k0_sweep`` read an ascending u64 key where it lies, and the
last live ``k0_sweep`` writes both halves into one fresh buffer; the
parenthesized counters count those launches among their kernel's. Every
other wrapper refuses a pair, as it refuses any plane that is not dense.
E1 and E2 are the kernels of the speed-of-light scripts (:mod:`..scripts`):
a staged device-memory copy and the spread step of the two-level MSD sort.
K13 is the
all-to-all of the distributed tier (:mod:`..parallel.rdma`), one launch a
rank of the mesh, each writing its rows into every rank's output. The source
notes in ``csrc/`` say what bounds each kernel on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from ..utils.timing import LAUNCH, span
from . import probes
from .kdf import INT32_MIN, halves, i32, pair_of

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts",
           "use_gpu_routes", "pick_window", "MAX_BITS", "HIST_MAX_BITS",
           "HistShape", "hist_shape", "hist_shape_ok", "hist_shape_candidates",
           "HIST_BLOCK_BITS", "HIST_HALF_BITS", "HIST_THREADS",
           "hist", "hist_plain", "hist_multi", "hist_multi_plain",
           "live_digits", "live_digits_plain", "live_digits_fit",
           "regen", "regen_plain",
           "hist_pext", "hist_pext_plain", "regen_pdep", "regen_pdep_plain",
           "hist_pext2", "hist_pext2_plain", "regen_pdep2", "regen_pdep2_plain",
           "whist", "whist_plain", "whist_f32", "whist_f32_plain", "low32",
           "WHIST_MAX_BITS", "WhistShape", "whist_shape", "whist_shape_ok",
           "whist_shape_candidates", "lsd_hist", "lsd_hist_plain", "lsd_scatter",
           "lsd_scatter_plain", "LSD_MAX_BITS", "LSD_STAGE_MAX_BITS", "LSD_STAGE_SHAPES",
           "LSD_SLOT_BITS", "LsdStageShape", "lsd_stage_smem", "lsd_stage_shapes",
           "lsd_scatter_shape", "k0_sweep", "k0_sweep_plain", "k0_sweep_status",
           "K0_SWEEP_BITS", "K0_SWEEP_TILE", "K0_SWEEP_MAX_PLANES",
           "bitonic", "bitonic_plain",
           "bitonic_pad_len", "BITONIC_MIN_PAD", "bitonic_route", "bitonic_trips",
           "bitonic_swizzle", "bitonic_trip_dims", "BITONIC_REGISTER_PLANES",
           "BITONIC_TRIP_WORDS", "BITONIC_RESIDENT_MAX_PAD",
           "dma_copy", "dma_copy_plain",
           "DMA_BULK_CHUNK_WORDS", "DMA_BULK_STAGES", "DMA_BULK_STORE_LAG",
           "msd_spread", "msd_spread_plain", "rdma_exchange", "rdma_exchange_plain",
           "RDMA_MAX_RANKS"]

LAUNCHES = {"hist": 0, "hist_multi": 0, "live_digits": 0, "regen": 0, "regen_windowed": 0,
            "hist_pext": 0, "regen_pdep": 0, "regen_pdep_windowed": 0,
            "hist_pext2": 0, "regen_pdep2": 0, "regen_pdep2_windowed": 0,
            "whist": 0, "whist_f32": 0, "whist_f32_counts": 0,
            "bitonic": 0, "lsd_hist": 0, "lsd_scatter": 0, "k0_sweep": 0, "lsd_sort": 0,
            "dma_copy": 0, "msd_spread": 0, "rdma_exchange": 0, "live_digits_pair": 0,
            "k0_sweep_pair_in": 0, "k0_sweep_pair_out": 0}

MAX_BITS = 17            # widest counting domain the kernels take (2^17 bins)
HIST_MAX_BITS = 18       # widest K1 digit: extras.bincount sends up to 2^18 bins
_HIST_MAX_COUNTERS = 1 << 19   # K1: passes * 2^radix_bits
_K5_MAX_BINS = 1 << 10   # counting_engine._REGEN_MAX_BINS: the K4/K7, K5/K8, K6/K9 split
_NO_DROP = 1 << 32       # K1's drop_ge when no key is dropped
_BLOCK_BYTES = 227 * 1024     # a block's shared memory on the H100


def launch_counts() -> dict:
    """A copy of the launch counters."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def use_gpu_routes(t: torch.Tensor) -> bool:
    """True when a wrapper launches its kernel for ``t``: ``t`` is on CUDA.

    Takes the place of ``use_tpu_routes``. The routes themselves are the
    same on every device; only the implementation under a wrapper differs.
    """
    return t.is_cuda


# Windowed-tier gate of the JAX package, kept verbatim so that the same
# (n, bins) takes the same route in both packages. The Hopper regeneration
# kernel needs no window; only the routing decision uses this.
_SUB_W, _BLOCK_SUBS_W = 4096, 16
_REGEN_WINDOW_MIN, _REGEN_WINDOW_MAX = 128, 1024


def pick_window(n: int, bins: int) -> int:
    """Power of two covering 2x the uniform-case per-64K-block bin span,
    clamped to [128, 1024]; 0 when even 1024 cannot cover it."""
    span = _BLOCK_SUBS_W * _SUB_W * bins // max(n, 1) + 1
    w = _REGEN_WINDOW_MIN
    while w < 2 * span:
        w *= 2
        if w > _REGEN_WINDOW_MAX:
            return 0
    return w


def _check_plane(name: str, t: torch.Tensor) -> None:
    if not torch.is_tensor(t) or t.dtype != torch.int32 or t.ndim != 1:
        raise TypeError(f"{name}: expected a 1-D int32 tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: at most 2^31 - 1 elements")


def _popcount_checked(mask: int) -> int:
    mask = int(mask)
    nbits = bin(mask).count("1")
    if not 0 <= mask <= 0xFFFFFFFF or not 1 <= nbits <= MAX_BITS:
        raise ValueError(f"mask 0x{mask:X}: need 1 to {MAX_BITS} set bits "
                         "of a 32-bit word")
    return nbits


def _popcount2_checked(mask_hi: int, mask_lo: int) -> int:
    mask_hi, mask_lo = int(mask_hi), int(mask_lo)
    nbits = bin(mask_hi).count("1") + bin(mask_lo).count("1")
    if not (0 <= mask_hi <= 0xFFFFFFFF and 0 <= mask_lo <= 0xFFFFFFFF
            and 1 <= nbits <= MAX_BITS):
        raise ValueError(f"masks 0x{mask_hi:X}, 0x{mask_lo:X}: need 1 to "
                         f"{MAX_BITS} set bits in all, each in a 32-bit word")
    return nbits


def _launch(fn_name: str, device: torch.device, *args) -> None:
    from ._build import load_library
    with span(LAUNCH):
        lib = load_library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{lib.rst_error_string(err).decode()}")


# ---------------------------------------------------------------------------
# The launch shape of the histogram kernel (K1, K2, K3: csrc/hist.cu)

HIST_BLOCK_BITS = 15       # a block's 32-bit counters: 2^15, 128 KB of shared memory
HIST_HALF_BITS = 16        # a block's 16-bit counters: 2^16, 128 KB
HIST_THREADS = (256, 512, 1024)


class HistShape(NamedTuple):
    """One launch shape of ``csrc/hist.cu``: blocks of ``threads`` threads;
    grid row y owns counters ``[y << local_bits, (y + 1) << local_bits)``
    and reads every key (``ranges`` rows). A block keeps ``copies``
    sub-histograms of 32-bit counters (one row), or one histogram of 16-bit
    counters (``half``, two a word, so 2^16 fit a block)."""
    threads: int
    local_bits: int
    ranges: int
    copies: int
    half: int

    def smem(self, total: int) -> int:
        """Shared-memory bytes of one block (``smem_bytes`` in csrc/hist.cu)."""
        counters = min(1 << self.local_bits, total)
        return 4 * ((counters + 1) // 2) if self.half else 4 * self.copies * counters

    def label(self) -> str:
        return (f"t{self.threads} b{self.local_bits} r{self.ranges} x{self.copies}"
                f"{' half' if self.half else ''}")


def hist_shape_ok(shape: HistShape, total: int) -> bool:
    """The checks ``rst_hist`` and ``rst_live_digits`` make before a launch (``shape_ok`` in
    csrc/hist.cu): every counter of ``[0, total)`` has exactly one owner, no
    row owns none, the block fits 232,448 bytes; 32-bit counters in one
    row, 16-bit counters in one copy. (Every shape meets the 16-bit
    hand-off's bound of csrc/half_counter.cuh: the kernel asserts it when it
    is compiled.)"""
    per = 1 << shape.local_bits
    return (shape.threads in HIST_THREADS and shape.half in (0, 1)
            and shape.ranges >= 1 and shape.copies >= 1
            and (shape.copies == 1 if shape.half else shape.ranges == 1)
            and 1 <= shape.local_bits <= HIST_BLOCK_BITS + shape.half
            and (shape.ranges - 1) * per < total <= shape.ranges * per
            and shape.smem(total) <= _BLOCK_BYTES)


def _ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


def hist_shape(total: int) -> HistShape:
    """The launch shape for a histogram of ``total`` counters
    (``passes * 2^radix_bits`` for K1, ``2^nbits`` for K2 / K3), chosen from
    the shape alone before the launch.

    Up to 2^15 counters: one block of 1,024 threads holds the whole
    histogram in two sub-histograms of 32-bit counters (one past 2^14
    counters). More: 16-bit counters, up to 2^16 in one block, so each key
    is read once, past that ``ceil(total / 2^16)`` grid rows of 2^16, each
    reading every key; a warp whose chunk repeats counters adds a thread's
    runs once. On the H100 (``scripts/hist_shapes.py``) the copies and 512
    threads against 1,024 moved the narrow rows by a few percent; 16-bit
    counters beat rows of 32-bit ones and both cluster forms, and without
    the runs 90% of the keys on one value serialise on one counter."""
    if not 1 <= total <= _HIST_MAX_COUNTERS:
        raise ValueError(f"hist_shape: {total} counters; 1 to {_HIST_MAX_COUNTERS} are taken")
    if total <= 1 << HIST_BLOCK_BITS:
        copies = 2 if 8 * total <= _BLOCK_BYTES else 1
        return HistShape(1024, max(1, _ceil_log2(total)), 1, copies, 0)
    ranges = -(-total >> HIST_HALF_BITS)
    return HistShape(1024, HIST_HALF_BITS if ranges > 1 else _ceil_log2(total), ranges, 1, 1)


def hist_shape_candidates(total: int) -> list:
    """Every shape ``scripts/hist_shapes.py`` times for ``total`` counters,
    :func:`hist_shape`'s first: 512 or 1,024 threads; up to 2^15 counters,
    1 to 32 copies of 32-bit counters that fit; past 2^13, 16-bit counters
    in one block or in grid rows of 2^16."""
    out = [hist_shape(total)]
    lb = max(1, _ceil_log2(total))
    for threads in (512, 1024):
        if total <= 1 << HIST_BLOCK_BITS:
            for copies in (1, 2, 4, 8, 32):
                if copies <= threads // 32 and 4 * copies * total <= _BLOCK_BYTES:
                    out.append(HistShape(threads, lb, 1, copies, 0))
        if total > 1 << 13:
            rows = -(-total >> HIST_HALF_BITS)
            out.append(HistShape(threads, HIST_HALF_BITS if rows > 1 else lb, rows, 1, 1))
    seen = set()
    return [s for s in out if hist_shape_ok(s, total) and not (s in seen or seen.add(s))]


def _hist_launch(fn_name: str, device: torch.device, total: int, shape: HistShape,
                 *args) -> torch.Tensor:
    """Launch one histogram entry in ``shape``; its (total,) int32 output."""
    out = torch.empty(total, dtype=torch.int32, device=device)
    _launch(fn_name, device, *args, out.data_ptr(), *shape)
    return out


# ---------------------------------------------------------------------------
# K1: digit histograms, one digit or every digit in one read


def _check_digits(name: str, shift: int, radix_bits: int, passes: int) -> None:
    if not 1 <= radix_bits <= HIST_MAX_BITS:
        raise ValueError(f"{name}: radix_bits must be in [1, {HIST_MAX_BITS}]")
    if passes << radix_bits > _HIST_MAX_COUNTERS:
        raise ValueError(f"{name}: {passes} passes of {radix_bits}-bit digits "
                         f"exceed {_HIST_MAX_COUNTERS} counters")
    if not 0 <= shift + (passes - 1) * radix_bits < 32:
        raise ValueError(f"{name}: digits must start inside the 32-bit word")


def _drop_bound(drop_ge) -> int:
    if drop_ge is None:
        return _NO_DROP
    if not 0 <= int(drop_ge) <= _NO_DROP:
        raise ValueError("drop_ge must be in [0, 2^32]")
    return int(drop_ge)


def hist_plain(w: torch.Tensor, pass_index: int, radix_bits: int,
               drop_ge=None, offset: int = 0) -> torch.Tensor:
    """(2^radix_bits,) int32 counts of digit ``pass_index`` of ``w - offset``
    (mod 2^32), keys with ``w - offset >= drop_ge`` (unsigned) left out:
    subtract, shift, mask, bincount with a spill bin for the dropped keys."""
    shift = pass_index * radix_bits
    _check_digits("hist", shift, radix_bits, 1)
    bins = 1 << radix_bits
    u = w - i32(offset) if offset & 0xFFFFFFFF else w
    d = probes.shift_right(u, shift) & (bins - 1)
    bound = _drop_bound(drop_ge)
    if bound < _NO_DROP:      # unsigned u < bound, compared sign-flipped
        d = torch.where((u ^ INT32_MIN) < i32(bound ^ (1 << 31)), d, bins)
    return torch.bincount(d, minlength=bins + 1)[:bins].to(torch.int32)


def hist(w: torch.Tensor, pass_index: int, radix_bits: int, drop_ge=None,
         offset: int = 0) -> torch.Tensor:
    """Histogram of one ``radix_bits``-bit digit of the plane ``w`` in one
    read (the contract of ``histogram_tpu``, digit ``pass_index`` counted
    from the least significant). ``drop_ge``: keys at or above it (unsigned)
    are counted nowhere. ``offset`` is subtracted from every key first (mod
    2^32), on the read: the dense range probe's ``w - min``."""
    _check_plane("hist", w)
    _check_digits("hist", pass_index * radix_bits, radix_bits, 1)
    bound = _drop_bound(drop_ge)
    if not use_gpu_routes(w):
        return hist_plain(w, pass_index, radix_bits, drop_ge, offset)
    out = _hist_launch("rst_hist", w.device, 1 << radix_bits, hist_shape(1 << radix_bits),
                       w.data_ptr(), w.shape[0], offset & 0xFFFFFFFF,
                       pass_index * radix_bits, radix_bits, bound)
    LAUNCHES["hist"] += 1
    return out


def _num_passes(radix_bits: int) -> int:
    return -(-32 // max(radix_bits, 1))


def hist_multi_plain(w: torch.Tensor, radix_bits: int) -> torch.Tensor:
    """(ceil(32 / radix_bits), 2^radix_bits) int32: :func:`hist_plain` of
    every digit, one after the other."""
    return torch.stack([hist_plain(w, p, radix_bits)
                        for p in range(_num_passes(radix_bits))])


def hist_multi(w: torch.Tensor, radix_bits: int) -> torch.Tensor:
    """The histograms of every ``radix_bits``-bit digit of ``w`` in ONE read
    of the keys (the contract of ``multi_digit_histogram_tpu``; the fused
    first pass of `radix_sort_u32.c:24-37`): (passes, 2^radix_bits) int32.
    The launch is :func:`live_digits`' of one plane with no order flag."""
    _check_plane("hist_multi", w)
    passes = _num_passes(radix_bits)
    _check_digits("hist_multi", 0, radix_bits, passes)
    if not use_gpu_routes(w):
        return hist_multi_plain(w, radix_bits)
    hists, _ = _live_launch((w,), radix_bits, False)
    LAUNCHES["hist_multi"] += 1
    return hists


def live_digits_fit(planes: int, radix_bits: int) -> bool:
    """Whether :func:`live_digits` takes ``planes`` planes at
    ``radix_bits``: one or two planes whose every digit's counter fits one
    K1 launch (2^19 counters; always at ``SortConfig``'s r <= 16)."""
    return (planes in (1, 2) and 1 <= radix_bits <= HIST_MAX_BITS
            and planes * _num_passes(radix_bits) << radix_bits <= _HIST_MAX_COUNTERS)


def _check_live(words: Sequence[torch.Tensor], radix_bits: int) -> bool:
    """Raise on what ``rst_live_digits`` refuses; True where the two planes
    are a pair (:func:`.kdf.pair_of`), taken at K0's 8-bit digits only."""
    pair = len(words) == 2 and pair_of(*words) is not None
    if pair:
        if radix_bits != K0_SWEEP_BITS or words[0].shape[0] >= 1 << 31:
            raise ValueError(f"live_digits: a pair is read at {K0_SWEEP_BITS}-bit digits, "
                             "of at most 2^31 - 1 keys")
    elif len(words) == 2:
        _check_pair("live_digits", *words)
    elif len(words) == 1:
        _check_plane("live_digits", words[0])
    if not live_digits_fit(len(words), radix_bits):
        raise ValueError(f"live_digits: {len(words)} planes of {radix_bits}-bit digits; "
                         f"one or two planes of at most {_HIST_MAX_COUNTERS} counters "
                         "are taken")
    return pair


def live_digits_plain(words: Sequence[torch.Tensor], radix_bits: int,
                      order: bool = True):
    """:func:`hist_multi_plain` of each plane, least significant plane
    first, and ``order``'s descent flag: 1 (int32, 0-d) where some key is
    below the one before it in the planes' unsigned lexicographic order
    (``not probes.is_sorted_words(words)``), else 0; None without ``order``."""
    words = tuple(words)
    _check_live(words, radix_bits)
    hists = torch.cat([hist_multi_plain(w, radix_bits) for w in reversed(words)])
    if not order:
        return hists, None
    descent = torch.any(probes.word_lt([w[1:] for w in words], [w[:-1] for w in words]))
    return hists, descent.to(torch.int32)


def live_digits(words: Sequence[torch.Tensor], radix_bits: int, order: bool = True):
    """K0's and the LSD engine's live-digit read: every ``radix_bits``-bit
    digit's histogram of one plane or two (most significant first), least
    significant digit first across the planes, in ONE read of every key
    (the order of one :func:`hist_multi` a plane, concatenated), and with
    ``order`` the presorted guard's flag from the same read:
    ((digits, 2^radix_bits) int32, 0-d int32 that is 1 where some key is
    below the one before it, else 0; None without ``order``). On the card
    both are views of one buffer that the launch zeroes with one memset.
    Two planes may be a pair (:func:`.kdf.halves`) at 8-bit digits: the
    launch reads the 64-bit words where they lie, 16 bytes for two keys."""
    words = tuple(words)
    pair = _check_live(words, radix_bits)
    if not use_gpu_routes(words[0]):
        return live_digits_plain(words, radix_bits, order)
    out = _live_launch(words, radix_bits, order, pair=pair)
    LAUNCHES["live_digits"] += 1
    LAUNCHES["live_digits_pair"] += pair
    return out


def _live_launch(words: tuple, radix_bits: int, order: bool, shape=None, pair=False):
    """One ``rst_live_digits`` launch (``hist_multi``'s and
    :func:`live_digits`'), in ``shape`` or the rule's: the (digits,
    2^radix_bits) view and the 0-d flag (None without ``order``), views of
    one buffer; ``pair``: the two planes read as a pair."""
    total = len(words) * _num_passes(radix_bits) << radix_bits
    out = torch.empty(total + 1, dtype=torch.int32, device=words[0].device)
    _launch("rst_live_digits", words[0].device, words[0].data_ptr(), words[-1].data_ptr(),
            words[0].shape[0], len(words), radix_bits, int(bool(order)), int(pair),
            out.data_ptr(), *(shape or hist_shape(total)))
    return out[:total].view(-1, 1 << radix_bits), out[total] if order else None


# ---------------------------------------------------------------------------
# K4 / K7: regeneration of dense values


def regen_plain(cum: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """``searchsorted(cum, arange(n), right=True) + offset`` (mod 2^32)."""
    j = torch.arange(n, dtype=torch.int32, device=cum.device)
    v = torch.searchsorted(cum, j, right=True).to(torch.int32)
    return v + i32(offset) if offset & 0xFFFFFFFF else v


def regen(cum: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """The n sorted dense values rebuilt from the inclusive cumulative
    histogram ``cum``, ``out[j] = #{b : cum[b] <= j} + offset`` (mod 2^32;
    ``offset`` added on the store: the dense range probe's ``+ min``).

    The contract of ``regenerate_tpu`` (which takes the histogram and does
    this cumsum itself) and of ``regenerate_windowed_tpu``.
    """
    _check_plane("regen cum", cum)
    if not 1 <= cum.shape[0] <= 1 << MAX_BITS:
        raise ValueError(f"regen: {cum.shape[0]} bins; 1 to 2^{MAX_BITS} are taken")
    if not 0 <= n < 1 << 31:
        raise ValueError("regen: n must be in [0, 2^31)")
    if not use_gpu_routes(cum):
        return regen_plain(cum, n, offset)
    out = torch.empty(n, dtype=torch.int32, device=cum.device)
    if n == 0:
        return out
    _launch("rst_regen", cum.device, cum.data_ptr(), cum.shape[0], n,
            offset & 0xFFFFFFFF, out.data_ptr())
    LAUNCHES["regen" if cum.shape[0] <= _K5_MAX_BINS else "regen_windowed"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: PEXT histogram


def hist_pext_plain(w: torch.Tensor, mask: int) -> torch.Tensor:
    """(2^popcount(mask),) int32 counts of ``pext(w, mask)``: PEXT, bincount."""
    bins = 1 << _popcount_checked(mask)
    c = probes.compact_live_bits(w, mask)
    return torch.bincount(c, minlength=bins).to(torch.int32)


def hist_pext(w: torch.Tensor, mask: int) -> torch.Tensor:
    """Histogram of the PEXT-compacted live bits of the plane ``w`` in one
    read (the contract of ``histogram_pext_tpu``)."""
    _check_plane("hist_pext", w)
    nbits = _popcount_checked(mask)
    if not use_gpu_routes(w):
        return hist_pext_plain(w, mask)
    out = _hist_launch("rst_hist_pext", w.device, 1 << nbits, hist_shape(1 << nbits),
                       w.data_ptr(), w.shape[0], int(mask))
    LAUNCHES["hist_pext"] += 1
    return out


# ---------------------------------------------------------------------------
# K5 / K8: regeneration with PDEP and the dead bits


def _check_regen(cum: torch.Tensor, n: int, mask: int, plane: torch.Tensor):
    _check_plane("regen_pdep cum", cum)
    _check_plane("regen_pdep plane", plane)
    nbits = _popcount_checked(mask)
    if not 1 <= cum.shape[0] <= 1 << nbits:
        raise ValueError(f"regen_pdep: {cum.shape[0]} bins for a mask of "
                         f"{nbits} bits")
    if not 0 <= n < 1 << 31:
        raise ValueError("regen_pdep: n must be in [0, 2^31)")
    if plane.shape[0] < 1 or plane.device != cum.device:
        raise ValueError("regen_pdep: plane must hold a key on cum's device")


def regen_pdep_plain(cum: torch.Tensor, n: int, mask: int,
                     plane: torch.Tensor) -> torch.Tensor:
    """``pdep(searchsorted(cum, arange(n), right=True), mask) | dead``."""
    j = torch.arange(n, dtype=torch.int32, device=cum.device)
    v = torch.searchsorted(cum, j, right=True).to(torch.int32)
    return probes.expand_live_bits(v, mask) | (plane[0] & i32(~int(mask)))


def regen_pdep(cum: torch.Tensor, n: int, mask: int,
               plane: torch.Tensor) -> torch.Tensor:
    """The n sorted masked keys rebuilt from the inclusive cumulative
    histogram ``cum`` of their compacted values, with the dead bits taken
    from ``plane[0]`` on the device (no host sync).

    The contract of ``regenerate_pdep_tpu`` (which takes the histogram and
    does this cumsum itself) and of ``regenerate_pdep_windowed_tpu``.
    """
    _check_regen(cum, n, mask, plane)
    if not use_gpu_routes(cum):
        return regen_pdep_plain(cum, n, mask, plane)
    out = torch.empty(n, dtype=torch.int32, device=cum.device)
    if n == 0:
        return out
    _launch("rst_regen_pdep", cum.device, cum.data_ptr(), cum.shape[0], n,
            int(mask), plane.data_ptr(), out.data_ptr())
    LAUNCHES["regen_pdep" if cum.shape[0] <= _K5_MAX_BINS
             else "regen_pdep_windowed"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: PEXT histogram of two-plane (64-bit) keys


def _check_pair(name: str, hi: torch.Tensor, lo: torch.Tensor) -> None:
    _check_plane(f"{name} hi", hi)
    _check_plane(f"{name} lo", lo)
    if hi.shape != lo.shape or hi.device != lo.device:
        raise ValueError(f"{name}: hi and lo must match in length and device")


def hist_pext2_plain(hi: torch.Tensor, lo: torch.Tensor, mask_hi: int,
                     mask_lo: int) -> torch.Tensor:
    """(2^nbits,) int32 counts of ``(pext(hi, mask_hi) << popcount(mask_lo))
    | pext(lo, mask_lo)``: merge the planes' live bits, bincount."""
    bins = 1 << _popcount2_checked(mask_hi, mask_lo)
    c = probes.compact_word_planes((hi, lo), (mask_hi, mask_lo))
    return torch.bincount(c, minlength=bins).to(torch.int32)


def hist_pext2(hi: torch.Tensor, lo: torch.Tensor, mask_hi: int,
               mask_lo: int) -> torch.Tensor:
    """Histogram of the live bits of two-plane keys, merged (hi's above
    lo's), in one read of both planes (the contract of
    ``histogram_pext2_tpu``). Either mask may be 0."""
    _check_pair("hist_pext2", hi, lo)
    nbits = _popcount2_checked(mask_hi, mask_lo)
    if not use_gpu_routes(hi):
        return hist_pext2_plain(hi, lo, mask_hi, mask_lo)
    out = _hist_launch("rst_hist_pext2", hi.device, 1 << nbits, hist_shape(1 << nbits),
                       hi.data_ptr(), lo.data_ptr(), hi.shape[0], int(mask_hi), int(mask_lo))
    LAUNCHES["hist_pext2"] += 1
    return out


# ---------------------------------------------------------------------------
# K6 / K9: two-plane regeneration with PDEP and the dead bits


def regen_pdep2_plain(cum: torch.Tensor, n: int, mask_hi: int, mask_lo: int,
                      hi: torch.Tensor, lo: torch.Tensor):
    """``v = searchsorted(cum, arange(n), right=True)``, then ``v``'s high
    bits PDEP-ed into ``hi`` and its low ``popcount(mask_lo)`` into ``lo``,
    each with its plane's dead bits."""
    j = torch.arange(n, dtype=torch.int32, device=cum.device)
    v = torch.searchsorted(cum, j, right=True).to(torch.int32)
    return probes.expand_word_planes(v, (hi, lo), (mask_hi, mask_lo))


def regen_pdep2(cum: torch.Tensor, n: int, mask_hi: int, mask_lo: int,
                hi: torch.Tensor, lo: torch.Tensor):
    """The n sorted masked two-plane keys ``(hi, lo)`` rebuilt from the
    inclusive cumulative histogram ``cum`` of their merged live bits, with
    the dead bits taken from ``hi[0]`` and ``lo[0]`` on the device.

    The contract of ``regenerate_pdep2_tpu`` (which takes the histogram and
    does this cumsum itself) and of ``regenerate_pdep2_windowed_tpu``.
    """
    _check_plane("regen_pdep2 cum", cum)
    _check_pair("regen_pdep2", hi, lo)
    nbits = _popcount2_checked(mask_hi, mask_lo)
    if not 1 <= cum.shape[0] <= 1 << nbits:
        raise ValueError(f"regen_pdep2: {cum.shape[0]} bins for masks of "
                         f"{nbits} bits")
    if not 0 <= n < 1 << 31:
        raise ValueError("regen_pdep2: n must be in [0, 2^31)")
    if hi.shape[0] < 1 or hi.device != cum.device:
        raise ValueError("regen_pdep2: the planes must hold a key on cum's device")
    if not use_gpu_routes(cum):
        return regen_pdep2_plain(cum, n, mask_hi, mask_lo, hi, lo)
    out_hi = torch.empty(n, dtype=torch.int32, device=cum.device)
    out_lo = torch.empty(n, dtype=torch.int32, device=cum.device)
    if n == 0:
        return out_hi, out_lo
    _launch("rst_regen_pdep2", cum.device, cum.data_ptr(), cum.shape[0], n,
            int(mask_hi), int(mask_lo), hi.data_ptr(), lo.data_ptr(),
            out_hi.data_ptr(), out_lo.data_ptr())
    LAUNCHES["regen_pdep2" if cum.shape[0] <= _K5_MAX_BINS
             else "regen_pdep2_windowed"] += 1
    return out_hi, out_lo


# ---------------------------------------------------------------------------
# K10 / K11: weighted histograms, the dense group-by tier

WHIST_MAX_BITS = 17      # widest table the group-by gates ask for (2^17 bins)
WHIST_WORD_BITS = 14     # a block's bins of 32-bit counts and sums: 2^14, 128 KB
WHIST_BLOCK_BITS = 15    # with 16-bit counts (6 bytes a bin) or sums alone: 2^15
WHIST_THREADS = (256, 512, 1024)


class WhistShape(NamedTuple):
    """One launch shape of ``csrc/whist.cu``: blocks of ``threads`` threads;
    grid row y owns bins ``[y << local_bits, (y + 1) << local_bits)`` and
    reads every row (``ranges`` rows). A block's table holds a 32-bit sum
    and, with counts, a 32-bit count a bin, or a 16-bit count two to a word
    (``half``); a thread loads ``unroll`` 16-byte groups of each plane a
    chunk: 2, or 4 for sums alone."""
    threads: int
    local_bits: int
    ranges: int
    half: int
    unroll: int

    def smem(self, counts: bool) -> int:
        """Shared-memory bytes of one block (``smem_bytes`` in csrc/whist.cu)."""
        per_row = 1 << self.local_bits
        count_bytes = 0 if not counts else 4 * ((per_row + 1) // 2) if self.half else 4 * per_row
        return 4 * per_row + count_bytes

    def label(self) -> str:
        return (f"t{self.threads} b{self.local_bits} r{self.ranges} u{self.unroll}"
                f"{' half' if self.half else ''}")


def whist_shape_ok(shape: WhistShape, radix_bits: int, counts: bool) -> bool:
    """The checks ``rst_whist`` / ``rst_whist_f32`` make before a launch
    (``shape_ok`` in csrc/whist.cu): every bin of ``[0, 2^radix_bits)`` has
    exactly one owner, the block fits 232,448 bytes; 16-bit counts only
    beside counts; four loads of each plane a chunk only for sums alone.
    (Every shape meets the 16-bit hand-off's bound: the kernel asserts it
    when it is compiled.)"""
    return (shape.threads in WHIST_THREADS and shape.unroll in ((2, 4) if not counts else (2,))
            and shape.half in (0, 1) and (counts or not shape.half)
            and 1 <= shape.local_bits <= radix_bits
            and shape.ranges == 1 << (radix_bits - shape.local_bits)
            and shape.smem(counts) <= _BLOCK_BYTES)


@functools.lru_cache(maxsize=None)
def whist_shape(radix_bits: int, sums: str = "u32", counts: bool = True) -> WhistShape:
    """The launch shape of K10 (``sums="u32"``) or K11 (``"f32"``) for
    2^radix_bits bins, with or without counts, chosen from the shape alone
    before the launch.

    Up to 2^14 bins with counts, 32-bit counts and sums (8 bytes a bin) in
    one block; more, 16-bit counts beside the sums (6 bytes a bin), 2^15
    bins in one block and ``2^radix_bits / 2^15`` grid rows past that, each
    reading every row (2 at 2^16 bins, 4 at 2^17). Sums alone: 2^15 bins a
    block. Two 16-byte loads of each plane a thread a chunk, four for sums
    alone past 2^15 bins; blocks of 512 threads where four blocks' tables
    fit an SM, else 1,024. On the H100 (``scripts/whist_shapes.py``) 512
    threads took K11 at 1,024 bins 7% less time than 1,024 and K10 the
    same, 1,024 threads beat 512 by 44 to 54% where the table fills most of
    the SM, and four loads beat two by 6 to 12% for sums alone past 2^15
    bins, but for 90% of the rows in one group at 2^16 lost by 4 to 5%
    (with counts they spill registers)."""
    if sums not in ("u32", "f32") or (sums == "u32" and not counts):
        raise ValueError(f"whist_shape: sums {sums!r} with counts={counts}: K10 takes 'u32' "
                         "with counts, K11 'f32' with or without")
    if not 2 <= radix_bits <= WHIST_MAX_BITS:
        raise ValueError(f"whist_shape: radix_bits must be in [2, {WHIST_MAX_BITS}]")
    half = int(counts and radix_bits > WHIST_WORD_BITS)
    local = min(radix_bits, WHIST_BLOCK_BITS)
    unroll = 4 if not counts and radix_bits > WHIST_BLOCK_BITS else 2
    shape = WhistShape(512, local, 1 << (radix_bits - local), half, unroll)
    return shape if 4 * shape.smem(counts) <= _BLOCK_BYTES else shape._replace(threads=1024)


def whist_shape_candidates(radix_bits: int, sums: str = "u32", counts: bool = True) -> list:
    """Every shape ``scripts/whist_shapes.py`` times for 2^radix_bits bins,
    :func:`whist_shape`'s first: 512 or 1,024 threads; sums alone, two or
    four loads of each plane a chunk; with counts, 16-bit counts also where
    32-bit ones fit."""
    out = [whist_shape(radix_bits, sums, counts)]
    local = min(radix_bits, WHIST_BLOCK_BITS)
    for threads in (512, 1024):
        for unroll in ((2, 4) if not counts else (2,)):
            for half in ((0, 1) if counts else (0,)):
                lb = local if half or not counts else min(radix_bits, WHIST_WORD_BITS)
                out.append(WhistShape(threads, lb, 1 << (radix_bits - lb), half, unroll))
    seen = set()
    return [s for s in out if whist_shape_ok(s, radix_bits, counts)
            and not (s in seen or seen.add(s))]


def _check_whist(name: str, keys: torch.Tensor, values: torch.Tensor,
                 value_dtype: torch.dtype, radix_bits: int, drop_ge: int) -> None:
    _check_plane(f"{name} keys", keys)
    if not torch.is_tensor(values) or values.dtype != value_dtype or values.ndim != 1:
        raise TypeError(f"{name}: expected 1-D {value_dtype} values")
    if not values.is_contiguous():
        raise ValueError(f"{name}: expected contiguous values")
    if values.shape != keys.shape or values.device != keys.device:
        raise ValueError(f"{name}: keys and values must match in length and device")
    if not 2 <= radix_bits <= WHIST_MAX_BITS:
        raise ValueError(f"{name}: radix_bits must be in [2, {WHIST_MAX_BITS}]")
    if not 0 <= int(drop_ge) <= 1 << radix_bits:
        raise ValueError(f"{name}: drop_ge must be in [0, 2^radix_bits]")


def _bin_index(keys: torch.Tensor, bins: int, drop_ge: int) -> torch.Tensor:
    """int64 bin of each key; keys at or past ``drop_ge`` go to spill bin ``bins``."""
    k = keys.long() & 0xFFFFFFFF
    return torch.where(k < drop_ge, k, bins)


def low32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as the int32 that carries them."""
    return ((x & 0xFFFFFFFF) ^ (1 << 31)).sub_(1 << 31).to(torch.int32)


def whist_plain(keys: torch.Tensor, values: torch.Tensor, radix_bits: int,
                drop_ge: int):
    """(counts, sums) int32 of 2^radix_bits bins: bincount and an int64
    ``index_add_`` into a spill bin, the sums cut to their low 32 bits."""
    bins = 1 << radix_bits
    idx = _bin_index(keys, bins, drop_ge)
    counts = torch.bincount(idx, minlength=bins + 1)[:bins].to(torch.int32)
    sums = torch.zeros(bins + 1, dtype=torch.int64, device=keys.device)
    sums.index_add_(0, idx, values.long())
    return counts, low32(sums[:bins])


def whist(keys: torch.Tensor, values: torch.Tensor, radix_bits: int, drop_ge: int):
    """Per-key counts and value sums of u32 keys in one read (the contract of
    ``weighted_histogram_tpu``, its byte planes recombined).

    ``values`` is the int32 plane of the values' u32 conversion; keys at or
    past ``drop_ge`` (at most 2^radix_bits) are counted nowhere. Returns
    ``(counts, sums)``, int32 each of 2^radix_bits bins, the sums mod 2^32.
    """
    _check_whist("whist", keys, values, torch.int32, radix_bits, drop_ge)
    if not use_gpu_routes(keys):
        return whist_plain(keys, values, radix_bits, drop_ge)
    out = _whist_launch("rst_whist", keys, values, radix_bits, drop_ge, True,
                        whist_shape(radix_bits, "u32", True))
    LAUNCHES["whist"] += 1
    return out


def _whist_launch(fn_name: str, keys: torch.Tensor, values: torch.Tensor, radix_bits: int,
                  drop_ge: int, with_counts: bool, shape: WhistShape):
    """Launch one weighted-histogram entry in ``shape``: ``(counts, sums)``,
    or the sums alone without counts; sums int32 for K10, float32 for K11."""
    bins, dev = 1 << radix_bits, keys.device
    sums = torch.empty(bins, dtype=values.dtype, device=dev)
    counts = torch.empty(bins, dtype=torch.int32, device=dev) if with_counts else None
    _launch(fn_name, dev, keys.data_ptr(), values.data_ptr(), keys.shape[0], radix_bits,
            int(drop_ge), counts.data_ptr() if with_counts else None, sums.data_ptr(), *shape)
    return (counts, sums) if with_counts else sums


def whist_f32_plain(keys: torch.Tensor, weights: torch.Tensor, radix_bits: int,
                    drop_ge: int, with_counts: bool = False):
    """f32 sums of 2^radix_bits bins (``index_add_`` into a spill bin), and
    the bincount before them when ``with_counts``."""
    bins = 1 << radix_bits
    idx = _bin_index(keys, bins, drop_ge)
    sums = torch.zeros(bins + 1, dtype=torch.float32, device=keys.device)
    sums = sums.index_add_(0, idx, weights)[:bins]
    if not with_counts:
        return sums
    return torch.bincount(idx, minlength=bins + 1)[:bins].to(torch.int32), sums


def whist_f32(keys: torch.Tensor, weights: torch.Tensor, radix_bits: int,
              drop_ge: int, with_counts: bool = False):
    """Per-key sums of f32 weights in one read (the contract of
    ``weighted_histogram_f32_tpu``; with ``with_counts``, of
    ``weighted_histogram_f32_counts_tpu``: ``(counts, sums)``).

    Keys at or past ``drop_ge`` (at most 2^radix_bits) count nowhere. The
    kernel adds with float atomics, so the order of the additions, and the
    last bits of the sums, vary from run to run; the counts are exact.
    """
    _check_whist("whist_f32", keys, weights, torch.float32, radix_bits, drop_ge)
    if not use_gpu_routes(keys):
        return whist_f32_plain(keys, weights, radix_bits, drop_ge, with_counts)
    out = _whist_launch("rst_whist_f32", keys, weights, radix_bits, drop_ge, with_counts,
                        whist_shape(radix_bits, "f32", with_counts))
    LAUNCHES["whist_f32_counts" if with_counts else "whist_f32"] += 1
    return out


# ---------------------------------------------------------------------------
# L1 / L2: one pass of the LSD radix sort (Strategy.LSD)

LSD_MAX_BITS = 16        # SortConfig's widest digit
_MAX_PLANES = 32         # planes one L2 launch takes (csrc/lsd.cu)
LSD_STAGE_MAX_BITS = 12  # csrc/lsd.cu: the staged L2 takes digits of up to 12 bits, the
                         # direct form the wider ones
# (threads, keys a thread) of the staged L2, as csrc/lsd.cu's RST_LSD_SHAPES
# compiles them; the C entry refuses any other
LSD_STAGE_SHAPES = ((256, 8), (256, 16), (256, 32))
LSD_SLOT_BITS = 16       # a thread keeps its keys' slots two to a register


class LsdStageShape(NamedTuple):
    """The launch shape of the staged L2: a block of ``threads`` threads
    takes one tile, in stages of ``threads * keys`` keys (``keys`` a thread
    in registers), with ``smem`` bytes of dynamic shared memory."""
    threads: int
    keys: int
    smem: int

    @property
    def stage(self) -> int:
        return self.threads * self.keys


def lsd_stage_smem(threads: int, keys: int, radix_bits: int) -> int:
    """Shared-memory bytes of a staged L2 block (``stage_smem`` in
    csrc/lsd.cu), all 4-byte words: per-warp digit counters, three
    per-digit rows (first slots, destination offsets, running bases), 32
    warp sums and the stage's slots."""
    return 4 * ((threads // 32 + 3) * (1 << radix_bits) + 32 + threads * keys)


def lsd_stage_shapes(radix_bits: int) -> list:
    """The staged L2's shapes, in the order of ``LSD_STAGE_SHAPES``, whose
    block fits 232,448 bytes of shared memory at ``radix_bits``-bit digits;
    none past ``LSD_STAGE_MAX_BITS``."""
    if radix_bits > LSD_STAGE_MAX_BITS:
        return []
    shapes = (LsdStageShape(t, k, lsd_stage_smem(t, k, radix_bits)) for t, k in LSD_STAGE_SHAPES)
    return [s for s in shapes if s.smem <= _BLOCK_BYTES]


def lsd_scatter_shape(radix_bits: int, tile: int):
    """The staged L2's launch shape for ``radix_bits``-bit digits and tiles
    of ``tile`` keys, or None: digits past ``LSD_STAGE_MAX_BITS`` take the
    direct form (per-warp counters of 2^13 bins and more leave no room).
    Chosen from the shape alone, among :func:`lsd_stage_shapes`: the
    smallest stage that holds the whole tile, else the largest (a long tile
    in several stages); among stages of one size, the first of
    ``LSD_STAGE_SHAPES``. On the H100 (``scripts/lsd_shapes.py`` at tiles
    of 1,000 to 16,384 keys and 8- to 12-bit digits) this shape was the
    fastest in all but one case: a whole tile in one stage beat two blocks
    an SM of half-tile stages, also at 11-bit digits where its 123 KB leave
    room for one block, and a stage much larger than the tile leaves warps
    with no keys. Raises ValueError for a digit outside 1 to 16 bits or a
    tile below one key."""
    if not 1 <= radix_bits <= LSD_MAX_BITS:
        raise ValueError(f"lsd_scatter_shape: radix_bits must be in [1, {LSD_MAX_BITS}]")
    if tile < 1:
        raise ValueError("lsd_scatter_shape: tile must be positive")
    fits = lsd_stage_shapes(radix_bits)
    if not fits:
        return None
    whole = [s.stage for s in fits if s.stage >= tile]
    size = min(whole) if whole else max(s.stage for s in fits)
    return next(s for s in fits if s.stage == size)


def _check_lsd(name: str, w: torch.Tensor, shift: int, radix_bits: int, tile: int) -> None:
    _check_plane(name, w)
    _check_lsd_digit(name, shift, radix_bits, tile)


def _check_lsd_digit(name: str, shift: int, radix_bits: int, tile: int) -> None:
    if not 1 <= radix_bits <= LSD_MAX_BITS:
        raise ValueError(f"{name}: radix_bits must be in [1, {LSD_MAX_BITS}]")
    if not 0 <= shift < 32:
        raise ValueError(f"{name}: the digit must start inside the 32-bit word")
    if tile < 1:
        raise ValueError(f"{name}: tile must be positive")


def _tile_ids(n: int, tile: int, bins: int, digits: torch.Tensor) -> torch.Tensor:
    """int64 ``tile_id * bins + digit`` of every key."""
    tid = torch.arange(n, dtype=torch.int64, device=digits.device) // tile
    return tid * bins + digits


def lsd_hist_plain(w: torch.Tensor, shift: int, radix_bits: int,
                   tile: int) -> torch.Tensor:
    """``bincount(tile_id * bins + digit)`` as (tiles, bins) int32."""
    _check_lsd("lsd_hist", w, shift, radix_bits, tile)
    n, bins = w.shape[0], 1 << radix_bits
    tiles = -(-n // tile)
    g = _tile_ids(n, tile, bins, probes.shift_right(w, shift) & (bins - 1))
    return torch.bincount(g, minlength=tiles * bins).view(tiles, bins).to(torch.int32)


def lsd_hist(w: torch.Tensor, shift: int, radix_bits: int, tile: int) -> torch.Tensor:
    """Per-tile histograms of the ``radix_bits``-bit digit at bit ``shift``
    of the plane ``w``: (ceil(n / tile), 2^radix_bits) int32, tile t
    counting keys [t * tile, (t + 1) * tile) (the last tile short)."""
    _check_lsd("lsd_hist", w, shift, radix_bits, tile)
    if not use_gpu_routes(w):
        return lsd_hist_plain(w, shift, radix_bits, tile)
    n = w.shape[0]
    out = torch.empty((-(-n // tile), 1 << radix_bits), dtype=torch.int32, device=w.device)
    if n == 0:
        return out
    _launch("rst_lsd_hist", w.device, w.data_ptr(), n, shift, radix_bits, tile,
            out.data_ptr())
    LAUNCHES["lsd_hist"] += 1
    return out


def _check_planes(name: str, planes: Sequence[torch.Tensor], n: int,
                  device: torch.device) -> None:
    for p in planes:
        _check_plane(name, p)
        if p.shape[0] != n or p.device != device:
            raise ValueError(f"{name}: planes must match the keys in length and device")


def _check_bases(w: torch.Tensor, bases: torch.Tensor, radix_bits: int, tile: int) -> None:
    shape = (-(-w.shape[0] // tile), 1 << radix_bits)
    if not torch.is_tensor(bases) or bases.dtype != torch.int32 \
            or tuple(bases.shape) != shape or not bases.is_contiguous() \
            or bases.device != w.device:
        raise ValueError(f"lsd_scatter: bases must be a contiguous {shape} int32 "
                         "tensor on the keys' device")


def lsd_scatter_plain(w: torch.Tensor, planes: Sequence[torch.Tensor], shift: int,
                      radix_bits: int, tile: int, bases: torch.Tensor) -> tuple:
    """Each key's rank among the earlier keys of its tile with its digit,
    from a stable ``torch.sort`` of ``tile_id * bins + digit``; every plane
    scattered to ``bases[tile, digit] + rank``."""
    _check_lsd("lsd_scatter", w, shift, radix_bits, tile)
    _check_planes("lsd_scatter", planes, w.shape[0], w.device)
    _check_bases(w, bases, radix_bits, tile)
    n, bins = w.shape[0], 1 << radix_bits
    g = _tile_ids(n, tile, bins, probes.shift_right(w, shift) & (bins - 1))
    order = torch.sort(g, stable=True).indices
    counts = torch.bincount(g, minlength=bases.numel())
    first = torch.cumsum(counts, 0) - counts      # each group's start in `order`
    gs = g[order]
    dest = torch.empty_like(order)
    dest[order] = bases.reshape(-1).long()[gs] + torch.arange(n, device=w.device) - first[gs]
    out = []
    for p in planes:
        o = torch.empty_like(p)
        o[dest] = p
        out.append(o)
    return tuple(out)


def _pointers(planes: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))


def lsd_scatter(w: torch.Tensor, planes: Sequence[torch.Tensor], shift: int,
                radix_bits: int, tile: int, bases: torch.Tensor) -> tuple:
    """One stable LSD scatter: key i of tile t, with digit d of ``w`` (the
    ``radix_bits`` bits at ``shift``) and rank r among the earlier keys of
    tile t with digit d, sends every plane's element i to ``bases[t, d] +
    r``. ``bases`` (tiles, 2^radix_bits) int32, as ``scan.scatter_bases``
    gives them. Returns the new planes.

    On the card: the staged form in the shape :func:`lsd_scatter_shape`
    picks (each plane of a tile read once, written in digit runs), the
    direct form past ``LSD_STAGE_MAX_BITS``; 32 planes a launch."""
    _check_lsd("lsd_scatter", w, shift, radix_bits, tile)
    _check_planes("lsd_scatter", planes, w.shape[0], w.device)
    _check_bases(w, bases, radix_bits, tile)
    if not use_gpu_routes(w):
        return lsd_scatter_plain(w, planes, shift, radix_bits, tile, bases)
    return _lsd_scatter_launch(w, planes, shift, radix_bits, tile, bases,
                               lsd_scatter_shape(radix_bits, tile))


def _lsd_scatter_launch(w: torch.Tensor, planes: Sequence[torch.Tensor], shift: int,
                        radix_bits: int, tile: int, bases: torch.Tensor, shape) -> tuple:
    """L2's launches on the card: the staged form in ``shape``, or the direct
    form (digits past ``LSD_STAGE_MAX_BITS``) where ``shape`` is None, its
    running counters a device-memory copy of ``bases``; 32 planes a launch."""
    n = w.shape[0]
    out = tuple(torch.empty_like(p) for p in planes)
    if n == 0:
        return out
    counters = torch.empty_like(bases) if shape is None else None
    threads, keys, smem = (0, 0, 0) if shape is None else (shape.threads, shape.keys,
                                                            shape.smem)
    for g in range(0, len(planes), _MAX_PLANES):
        group = slice(g, g + _MAX_PLANES)
        _launch("rst_lsd_scatter", w.device, w.data_ptr(), _pointers(planes[group]),
                _pointers(out[group]), len(planes[group]), n, shift, radix_bits, tile,
                bases.data_ptr(), None if counters is None else counters.data_ptr(),
                threads, keys, smem)
        LAUNCHES["lsd_scatter"] += 1
    return out


# ---------------------------------------------------------------------------
# K0's sweep: one launch a live digit of K0 (hw_engine), the look-back in
# place of L1 and the scan

K0_SWEEP_BITS = 8         # csrc/lsd.cu rst_k0_sweep: 8-bit digits, a digit a thread
K0_SWEEP_TILE = 8192      # tiles of one stage of 256 x 32 keys
K0_SWEEP_MAX_PLANES = 32  # planes one launch takes, the index among them
_SWEEP_INDEX_DTYPES = (torch.int32, torch.int64)


def k0_sweep_status(n: int, device) -> torch.Tensor:
    """The zeroed status words of one K0 call of ``n`` keys: (tiles x 256)
    words and the ticket counter, int64, one zero fill a call. Every pass
    of the call uses it with its own ``epoch``, 1, 2, ... in order."""
    tiles = -(-int(n) // K0_SWEEP_TILE)
    return torch.zeros(tiles * (1 << K0_SWEEP_BITS) + 1, dtype=torch.int64, device=device)


def _check_sweep(w: torch.Tensor, planes: Sequence[torch.Tensor], shift: int,
                 radix_bits: int, tile: int, starts: torch.Tensor, position: bool,
                 index_dtype, pair_out: bool) -> bool:
    """Raise on what the sweep refuses; True where ``planes[0]`` and
    ``planes[1]`` are a pair (:func:`.kdf.pair_of`), read as one."""
    planes = tuple(planes)
    pair_in = len(planes) >= 2 and pair_of(planes[0], planes[1]) is not None
    if pair_in or pair_out:
        if len(planes) < 2 or not any(w is p for p in planes[:2]):
            raise ValueError("k0_sweep: a pass that reads or writes a pair takes its digit "
                             "from one of the pair's planes, planes 0 and 1")
        if pair_out and index_dtype == torch.int64 and not position and len(planes) == 2:
            raise ValueError("k0_sweep: planes 0 and 1 written as a pair, not the index")
    if pair_in:             # the pair's planes, as pair_of took them
        if w.shape[0] >= 1 << 31:
            raise ValueError("k0_sweep: at most 2^31 - 1 elements")
    else:
        _check_plane("k0_sweep", w)
    _check_lsd_digit("k0_sweep", shift, radix_bits, tile)
    _check_planes("k0_sweep", planes[2:] if pair_in else planes, w.shape[0], w.device)
    if not 1 <= len(planes) + bool(position) <= K0_SWEEP_MAX_PLANES:
        raise ValueError(f"k0_sweep: 1 to {K0_SWEEP_MAX_PLANES} planes a launch, "
                         "the position among them")
    if not torch.is_tensor(starts) or starts.dtype != torch.int32 \
            or tuple(starts.shape) != (1 << radix_bits,) or not starts.is_contiguous() \
            or starts.device != w.device:
        raise ValueError(f"k0_sweep: starts must be a contiguous ({1 << radix_bits},) int32 "
                         "tensor on the keys' device")
    if index_dtype not in _SWEEP_INDEX_DTYPES:
        raise ValueError("k0_sweep: the index is written as int32 or int64")
    if index_dtype == torch.int64 and not position and planes[-1] is w:
        raise ValueError("k0_sweep: the last plane, written as int64, is the index, "
                         "not the digit plane")
    return pair_in


def _sweep_out(n: int, dtypes, pair_out: bool, device) -> list:
    """The pass's output planes; ``pair_out``: the first two the halves of
    one fresh 64-bit buffer (:func:`.kdf.halves`)."""
    out = [torch.empty(n, dtype=dt, device=device) for dt in dtypes[2 * pair_out:]]
    if pair_out:
        out[:0] = halves(torch.empty(n, dtype=torch.int64, device=device))
    return out


def k0_sweep_plain(w: torch.Tensor, planes: Sequence[torch.Tensor], shift: int,
                   radix_bits: int, tile: int, starts: torch.Tensor,
                   position: bool = False, index_dtype=torch.int32,
                   pair_out: bool = False) -> tuple:
    """One stable pass: key i with digit d of ``w`` (the ``radix_bits``
    bits at ``shift``) in tile t goes to ``starts[d]`` + (keys of digit d
    in the tiles before t) + (its rank among the keys of d in tile t, from a
    stable sort, as :func:`lsd_scatter_plain`), and every plane with it.
    ``position``: one more plane, the index as each key's position.
    ``index_dtype`` int64: the last plane (the index) comes out as int64,
    its words zero-extended. ``planes[0]`` and ``planes[1]`` may be a pair
    (:func:`.kdf.halves`), read where they lie; ``pair_out``: they come out
    as the halves of one fresh 64-bit buffer (so :func:`.kdf.join64` of
    them is that buffer)."""
    _check_sweep(w, planes, shift, radix_bits, tile, starts, position, index_dtype, pair_out)
    n, bins = w.shape[0], 1 << radix_bits
    tiles = -(-n // tile)
    g = _tile_ids(n, tile, bins, probes.shift_right(w, shift) & (bins - 1))
    counts = torch.bincount(g, minlength=tiles * bins)
    earlier = (torch.cumsum(counts.view(tiles, bins), 0) - counts.view(tiles, bins)).view(-1)
    order = torch.sort(g, stable=True).indices
    first = torch.cumsum(counts, 0) - counts      # each (tile, digit) group's start in `order`
    gs = g[order]
    dest = torch.empty_like(order)
    dest[order] = (starts.long()[gs % bins] + earlier[gs]
                   + torch.arange(n, device=w.device) - first[gs])
    planes = list(planes)
    if position:
        planes.append(torch.arange(n, dtype=torch.int32, device=w.device))
    wide = index_dtype == torch.int64
    out = _sweep_out(n, [torch.int32] * (len(planes) - 1) + [index_dtype], pair_out, w.device)
    for i, (p, o) in enumerate(zip(planes, out)):
        o[dest] = p.long() & 0xFFFFFFFF if wide and i == len(planes) - 1 else p
    return tuple(out)


def k0_sweep(w: torch.Tensor, planes: Sequence[torch.Tensor], shift: int,
             radix_bits: int, tile: int, starts: torch.Tensor, status: torch.Tensor,
             epoch: int, position: bool = False, index_dtype=torch.int32,
             pair_out: bool = False) -> tuple:
    """The contract of :func:`k0_sweep_plain` in one launch: all planes of
    the pass, the look-back over ``status`` (:func:`k0_sweep_status`, the
    call's buffer; ``epoch`` the pass's number in the call, from 1) in
    place of per-tile histograms and their scan. Built for 8-bit digits and
    tiles of 8,192 keys only: anything else raises, as does a launch that
    fails; nothing falls back. A pair in (``planes[0]``, ``planes[1]``)
    and ``pair_out`` each take their own instance of the kernel (one
    8-byte access a key), chosen at the launch from what the planes are."""
    pair_in = _check_sweep(w, planes, shift, radix_bits, tile, starts, position, index_dtype,
                           pair_out)
    if radix_bits != K0_SWEEP_BITS or tile != K0_SWEEP_TILE:
        raise ValueError(f"k0_sweep: built for {K0_SWEEP_BITS}-bit digits and tiles of "
                         f"{K0_SWEEP_TILE} keys")
    words = -(-w.shape[0] // tile) * (1 << radix_bits) + 1
    if not torch.is_tensor(status) or status.dtype != torch.int64 \
            or tuple(status.shape) != (words,) or not status.is_contiguous() \
            or status.device != w.device:
        raise ValueError(f"k0_sweep: status must be a contiguous ({words},) int64 tensor "
                         "on the keys' device (k0_sweep_status)")
    if int(epoch) < 1:
        raise ValueError("k0_sweep: epoch counts the call's passes from 1")
    if not use_gpu_routes(w):
        return k0_sweep_plain(w, planes, shift, radix_bits, tile, starts, position,
                              index_dtype, pair_out)
    return _k0_sweep_launch(w, planes, shift, radix_bits, tile, starts, status, epoch,
                            position, index_dtype, pair_in, pair_out)


def _k0_sweep_launch(w: torch.Tensor, planes: Sequence[torch.Tensor], shift: int,
                     radix_bits: int, tile: int, starts: torch.Tensor, status: torch.Tensor,
                     epoch: int, position: bool, index_dtype, pair_in: bool = False,
                     pair_out: bool = False) -> tuple:
    """The sweep's launch: a null input pointer for the position, the last
    output int64 where ``index_dtype`` asks for it, the pair's forms."""
    n = w.shape[0]
    ins = list(planes) + ([None] if position else [])
    dtypes = [torch.int32] * (len(ins) - 1) + [index_dtype]
    out = _sweep_out(n, dtypes, pair_out, w.device)
    wide = 1 << (len(out) - 1) if index_dtype == torch.int64 else 0
    if n == 0:
        return tuple(out)
    in_ptrs = (ctypes.c_void_p * len(ins))(*(None if p is None else p.data_ptr() for p in ins))
    _launch("rst_k0_sweep", w.device, w.data_ptr(), in_ptrs, _pointers(out), len(out), wide,
            n, shift, radix_bits, tile, starts.data_ptr(), status.data_ptr(), int(epoch),
            int(pair_in) | 2 * int(pair_out))
    LAUNCHES["k0_sweep"] += 1
    LAUNCHES["k0_sweep_pair_in"] += pair_in
    LAUNCHES["k0_sweep_pair_out"] += pair_out
    return tuple(out)


# ---------------------------------------------------------------------------
# K12: the bitonic network of sort_planes_vmem

BITONIC_MIN_PAD = 1024   # the JAX package's VMEM_SORT_MIN_PAD


def bitonic_pad_len(n: int) -> int:
    """Size of the network for n keys: max(1024, the next power of two)."""
    return max(BITONIC_MIN_PAD, 1 << max(0, (n - 1).bit_length()))


def _check_bitonic(planes: Sequence[torch.Tensor], num_keys: int) -> None:
    if not planes:
        raise ValueError("bitonic: no planes")
    _check_planes("bitonic", planes, planes[0].shape[0], planes[0].device)
    if not 1 <= num_keys <= len(planes):
        raise ValueError(f"num_keys must be in [1, {len(planes)}]")


def _exchange(x: torch.Tensor, num_keys: int, lo: torch.Tensor, hi: torch.Tensor) -> None:
    """Swap, in place, the records (columns of the stacked planes ``x``) of
    each pair (lo, hi) whose key(lo) > key(hi)."""
    a, b = x[:, lo], x[:, hi]
    gt = probes.word_lt(b[:num_keys].unbind(0), a[:num_keys].unbind(0))
    x[:, lo] = torch.where(gt, b, a)
    x[:, hi] = torch.where(gt, a, b)


_CLUSTER = 8                  # blocks of the cluster route: a portable cluster
_CLUSTER_MIN_PAD = 8 * 1024   # at least 1,024 records a block
BITONIC_REGISTER_PLANES = 4   # the resident route's planes; more take tiles
BITONIC_TRIP_WORDS = 19       # head, coset bits, a code per basis vector and coset bit
BITONIC_RESIDENT_MAX_PAD = 1 << (BITONIC_TRIP_WORDS - 2)   # a trip of 2^17 records fills 19 words


def bitonic_route(n: int, nplanes: int) -> int:
    """Blocks that run the whole network of n keys and ``nplanes`` planes
    in one launch, every plane resident in their shared memory: 8 (one
    cluster) when the padded size is at least 8 x 1,024, else 1; 0, and
    the sort takes tiles plus steps through device memory, past 4 planes,
    when the planes do not fit, or past a padded size of 2^17 (the gate's
    largest, and the largest whose trips fit the kernel's table). Chosen
    from the shape alone."""
    size = bitonic_pad_len(n)
    if nplanes > BITONIC_REGISTER_PLANES or size > BITONIC_RESIDENT_MAX_PAD:
        return 0
    blocks = _CLUSTER if size >= _CLUSTER_MIN_PAD else 1
    return blocks if nplanes * (size // blocks) * 4 <= _BLOCK_BYTES else 0


def bitonic_trip_dims(n: int, nplanes: int) -> int:
    """Dimensions of a trip of the resident route: 2^5 records a thread
    for one plane whose slice keeps 512 threads busy (2^14 records a
    block), else 2^4. On the H100 the longer trips (fewer of them) won
    only there; two planes, and smaller slices (fewer threads), ran faster
    in 4."""
    blocks = bitonic_route(n, nplanes)
    return 5 if nplanes == 1 and blocks and bitonic_pad_len(n) // blocks >= 1 << 14 else 4


def bitonic_swizzle(i: int) -> int:
    """Shared-memory word of a block's record i: bits 5-9 and 10-14
    folded into the bank bits (bijective below 2^15, and linear)."""
    return i ^ ((i >> 5) & 31) ^ ((i >> 10) & 31)


def _reduced_basis(vecs):
    """The reduced row echelon basis of ``vecs`` over GF(2), as {pivot: vector}."""
    basis = {}
    for v in vecs:
        for p, b in basis.items():
            if v >> p & 1:
                v ^= b
        if not v:
            return None
        p = v.bit_length() - 1
        for q in basis:
            if basis[q] >> p & 1:
                basis[q] ^= v
        basis[p] = v
    return basis


@functools.lru_cache(maxsize=None)
def bitonic_trips(log_n: int, blocks: int, dims: int) -> tuple:
    """The network of 2^log_n records cut into trips for the kernel's
    resident route, as int32 words (``BITONIC_TRIP_WORDS`` a trip).

    A trip is a run of consecutive steps whose masks (i ^ (2^k - 1) for a
    mirror, 2^j for a stride) are linearly independent over GF(2), at most
    ``dims``, padded with unit vectors to a ``dims``-dimensional space V.
    The records split into cosets r + V, closed under every step of the
    trip, so one thread loads a coset's 2^dims records into registers, runs
    the trip's steps on them in order and stores them: the same pairs in the
    same order. In the reduced echelon basis w_0, w_1, .. of V (pivots
    ascending), record e of a coset is r ^ (xor of the w_b with bit b of e
    set); a stride is then the pair (e, e ^ 2^b) and a mirror (e, e ^
    (2^(b+1) - 1)), lo the record with bit b clear, b the step's lead. A
    trip whose cosets span blocks has no pivot below bit 5. Coset
    representatives have zeros at the pivots; coset c sets the other bits
    from c's bits, its five lowest on positions below the block size whose
    bank bits (after :func:`bitonic_swizzle`) are independent where they can
    be, so that a warp's 32 loads fall in 32 banks (and, crossing blocks, on
    bits 0-4).

    Words of a trip: the head (step s in bits 5s to 5s + 4: 1 | mirror << 1
    | b << 2; bit 31: the trip crosses blocks), the number of coset bits,
    then the codes of the w_b and of the coset bits, a code being (block <<
    16) | swizzled word of the block's slice; codes are linear, so a
    record's code is the xor of its bits' codes."""
    log_s = log_n - (blocks.bit_length() - 1)
    slice_mask = (1 << log_s) - 1

    def code(v):
        return (v >> log_s) << 16 | bitonic_swizzle(v & slice_mask)

    steps = []
    for k in range(1, log_n + 1):
        steps.append((True, k - 1))
        steps += [(False, j) for j in range(k - 2, -1, -1)]

    def one_trip(run):
        basis = _reduced_basis([v for _, _, v in run])
        # a trip that crosses blocks keeps bits 0-4 for the lanes, so that
        # a warp's remote reads are 128 contiguous bytes
        return basis is not None and (max(basis) < log_s or min(basis) >= 5)

    runs, cur = [], []
    for mirror, lead in steps:
        step = (mirror, lead, (2 << lead) - 1 if mirror else 1 << lead)
        if len(cur) == dims or not one_trip(cur + [step]):
            runs.append(cur)
            cur = []
        cur.append(step)
    runs.append(cur)
    words = []
    for run in runs:
        pivots = set(_reduced_basis([v for _, _, v in run]))
        free = [q for q in range(min(log_s, 15)) if q not in pivots]
        lanes = []
        for q in free:                     # distinct bank bits first
            if len(lanes) < 5 and q % 5 not in {p % 5 for p in lanes}:
                lanes.append(q)
        lanes += [q for q in free if q not in lanes][:5 - len(lanes)]
        pads = [q for q in free if q not in lanes][:dims - len(run)]
        basis = _reduced_basis([v for _, _, v in run] + [1 << q for q in pads])
        order = sorted(basis)
        head = 0
        for s, (mirror, lead, _) in enumerate(run):
            head |= (1 | mirror << 1 | order.index(lead) << 2) << (5 * s)
        if order[-1] >= log_s:
            head |= 1 << 31
        coset_bits = lanes + sorted(set(range(log_n)) - set(order) - set(lanes))
        trip = [head, len(coset_bits)] + [code(basis[p]) for p in order] + \
            [code(1 << q) for q in coset_bits]
        if len(trip) > BITONIC_TRIP_WORDS:
            raise ValueError(f"bitonic_trips: 2^{log_n} records need {len(trip)} words "
                             f"a trip, the kernel takes {BITONIC_TRIP_WORDS}")
        words += trip + [0] * (BITONIC_TRIP_WORDS - len(trip))
    return tuple(i32(w) for w in words)


@functools.lru_cache(maxsize=None)
def _bitonic_plan(size: int, nplanes: int):
    """The route's blocks for a network of ``size`` and, on the resident
    route, its trips as a ctypes array (else None): what the launch needs
    besides pointers and n."""
    blocks = bitonic_route(size, nplanes)
    if not blocks:
        return blocks, None
    words = bitonic_trips(size.bit_length() - 1, blocks, bitonic_trip_dims(size, nplanes))
    return blocks, (ctypes.c_int32 * len(words))(*words)


def bitonic_plain(planes: Sequence[torch.Tensor], num_keys: int) -> tuple:
    """The network of csrc/bitonic.cu in torch, pair for pair: the planes
    stacked and padded to :func:`bitonic_pad_len` (all-ones keys, zero
    payloads), then for each size 2^k the mirror step (pairs (i, i ^ (2^k -
    1))) and the steps at strides 2^(k-2) .. 1, each pair swapped iff
    key(lo) > key(hi), unsigned and lexicographic over the first
    ``num_keys`` planes."""
    planes = tuple(planes)
    _check_bitonic(planes, num_keys)
    n = planes[0].shape[0]
    if n == 0:
        return tuple(p.clone() for p in planes)
    size = bitonic_pad_len(n)
    x = torch.stack([torch.cat([p, p.new_full((size - n,), -1 if i < num_keys else 0)])
                     for i, p in enumerate(planes)])
    q = torch.arange(size // 2, dtype=torch.int64, device=planes[0].device)
    for k in range(1, size.bit_length()):
        block, off = (q >> (k - 1)) << k, q & ((1 << (k - 1)) - 1)
        _exchange(x, num_keys, block + off, block + (1 << k) - 1 - off)
        for j in range(k - 2, -1, -1):
            lo = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1))
            _exchange(x, num_keys, lo, lo + (1 << j))
    return tuple(x[:, :n].unbind(0))


def bitonic(planes: Sequence[torch.Tensor], num_keys: int) -> tuple:
    """K12: the planes sorted ascending, unsigned and lexicographic over the
    first ``num_keys`` (most significant first), every plane moving with its
    key; equal key tuples keep a permutation of their records (the network
    of :func:`bitonic_plain`).

    On the card the key planes go to the kernel as one stacked (planes, n)
    array, so one call takes every plane count the gate admits: one launch
    where the planes fit the shared memory of one block or one cluster
    (:func:`bitonic_route`), tiles and steps through device memory past
    that, the route chosen from the shape before the launch. Two or
    more payload planes ride one index plane through the network and are
    gathered once after it: the swaps depend on the keys alone, so the
    output is the same, and each exchange moves one word in place of
    every payload's."""
    planes = tuple(planes)
    _check_bitonic(planes, num_keys)
    if not use_gpu_routes(planes[0]):
        return bitonic_plain(planes, num_keys)
    n = planes[0].shape[0]
    payloads = planes[num_keys:]
    ride = len(payloads) >= 2
    if ride:
        planes = planes[:num_keys] + (torch.arange(n, dtype=torch.int32, device=planes[0].device),)
    src = planes[0] if len(planes) == 1 else torch.stack(planes)
    out = torch.empty_like(src)
    if n:
        blocks, words = _bitonic_plan(bitonic_pad_len(n), len(planes))
        _launch("rst_bitonic", src.device, src.data_ptr(), out.data_ptr(), len(planes),
                num_keys, n, blocks, words, len(words) if words is not None else 0)
        LAUNCHES["bitonic"] += 1
    if len(planes) == 1:
        return (out,)
    if ride:
        return tuple(out[:num_keys].unbind(0)) + \
            tuple(torch.stack(payloads)[:, out[num_keys].long()].unbind(0))
    return tuple(out.unbind(0))


# ---------------------------------------------------------------------------
# E1 / E2: the kernels of the speed-of-light scripts


DMA_BULK_CHUNK_WORDS = 4096   # E1's bulk copies: 16 KB chunks (csrc/sol.cu)
DMA_BULK_STAGES = 12          # the ring's stages, one block per SM
DMA_BULK_STORE_LAG = 4        # stores in flight before a stage is refilled


def dma_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x``."""
    return x.clone()


def dma_copy(x: torch.Tensor) -> torch.Tensor:
    """E1: a copy of the plane ``x`` staged through shared memory in chunks
    (the contract of ``exp_sol_probe.probe_dma``'s DMA round trip, device
    memory to on-chip memory and back); any length. On the card, TMA bulk
    copies through a ring of stages where both pointers are 16 bytes
    aligned, word by word where one is not (``csrc/sol.cu``)."""
    _check_plane("dma_copy", x)
    if not use_gpu_routes(x):
        return dma_copy_plain(x)
    out = torch.empty_like(x)
    if x.shape[0]:
        _launch("rst_dma_copy", x.device, x.data_ptr(), out.data_ptr(), x.shape[0])
        LAUNCHES["dma_copy"] += 1
    return out


def _check_spread(s128: torch.Tensor, xp: torch.Tensor, m: int, d: int, capr: int) -> None:
    for name, t, ndim in (("s128", s128, 2), ("xp", xp, 3)):
        if not torch.is_tensor(t) or t.dtype != torch.int32 or t.ndim != ndim:
            raise TypeError(f"msd_spread: {name} must be a {ndim}-D int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"msd_spread: {name} must be contiguous")
    (R, K), (Rx, W, lanes) = s128.shape, xp.shape
    if Rx != R or lanes != 128 or s128.device != xp.device:
        raise ValueError("msd_spread: xp must be (R, W, 128) beside s128 (R, K), on one device")
    if not 1 <= d <= 32 or capr < 1 or not 0 <= m <= W * 128:
        raise ValueError("msd_spread: need 1 <= d <= 32, capr >= 1 and 0 <= m <= W * 128")
    if R * K >= 1 << 31:
        raise ValueError("msd_spread: at most 2^31 - 1 cells")


def msd_spread_plain(s128: torch.Tensor, xp: torch.Tensor, m: int, d: int,
                     capr: int) -> torch.Tensor:
    """Every window gathered at once: for each (r, k) the rows
    ``s128[r, k] + [0, capr)`` of ``xp[r]``, positions ``row * 128 + lane``
    at or past m (or before 0) and keys whose top d bits are not k replaced
    by all-ones, then (R, K) moved to (K, R)."""
    _check_spread(s128, xp, m, d, capr)
    R, K = s128.shape
    W = xp.shape[1]
    dev = xp.device
    sub = s128.long()[:, :, None] + torch.arange(capr, device=dev)           # (R, K, capr)
    pos = sub[..., None] * 128 + torch.arange(128, device=dev)               # (R, K, capr, 128)
    valid = (sub[..., None] >= 0) & (pos < m)
    w = torch.gather(xp.reshape(R, W * 128), 1,
                     pos.clamp(0, W * 128 - 1).reshape(R, -1)).view(pos.shape)
    bucket = probes.shift_right(w, 32 - d)
    keep = valid & (bucket == torch.arange(K, device=dev)[None, :, None, None])
    return torch.where(keep, w, -1).permute(1, 0, 2, 3).contiguous()


def msd_spread(s128: torch.Tensor, xp: torch.Tensor, m: int, d: int,
               capr: int) -> torch.Tensor:
    """E2: the spread step of the two-level MSD sort (the contract of
    ``exp_sol_round2.build_msd``'s ``spread_kernel``).

    ``xp`` (R, W, 128) holds R row-sorted rows of m keys (u32 in int32
    carriers, padded to W * 128); ``s128`` (R, K) the first 128-key row of
    each row's bucket k. Cell (k, r) of the (K, R, capr, 128) output is the
    window of ``capr`` such rows from ``s128[r, k]``, holding the keys of
    bucket k (top d bits equal to k) at positions below m and all-ones
    elsewhere."""
    _check_spread(s128, xp, m, d, capr)
    if not use_gpu_routes(xp):
        return msd_spread_plain(s128, xp, m, d, capr)
    (R, K), W = s128.shape, xp.shape[1]
    out = torch.empty((K, R, capr, 128), dtype=torch.int32, device=xp.device)
    if R * K:
        _launch("rst_msd_spread", xp.device, s128.data_ptr(), xp.data_ptr(), out.data_ptr(),
                R, K, W, m, d, capr)
        LAUNCHES["msd_spread"] += 1
    return out


# ---------------------------------------------------------------------------
# K13: the all-to-all exchange of the distributed tier

RDMA_MAX_RANKS = 128     # csrc/exchange.cu: the pointer table's length
# (device, peer) pairs with peer access on: a state of the process's CUDA
# context, which enabling twice would report as an error
_PEERS_ENABLED = set()


def _check_exchange(sends: Sequence[torch.Tensor], peers=None) -> Tuple[int, int]:
    """(D, m) of per-rank (D, m) sends of one dtype, or raise: D of them, or
    with ``peers`` one a local rank of the group mesh."""
    D = len(sends) if peers is None else peers.size
    if not 1 <= D <= RDMA_MAX_RANKS:
        raise ValueError(f"rdma_exchange: 1 to {RDMA_MAX_RANKS} ranks, got {D}")
    if peers is not None and len(sends) != len(peers.ranks):
        raise ValueError(f"rdma_exchange: {len(sends)} sends for this process's "
                         f"{len(peers.ranks)} ranks")
    first = sends[0]
    for s in sends:
        if not torch.is_tensor(s) or s.ndim != 2 or s.shape[0] != D:
            raise ValueError(f"rdma_exchange: every send must be a ({D}, m) tensor")
        if s.shape != first.shape or s.dtype != first.dtype:
            raise ValueError("rdma_exchange: the sends must share shape and dtype")
        if not s.is_contiguous():
            raise ValueError("rdma_exchange: expected contiguous sends")
    return D, first.shape[1]


def rdma_exchange_plain(sends: Sequence[torch.Tensor], peers=None) -> list:
    """``out[d][s] = sends[s][d]`` by indexing, ``out[d]`` on ``sends[d]``'s
    device: the function of :func:`..parallel._mesh.all_to_all`, written
    apart so that the kernel has an oracle of its own.

    With ``peers`` (a group mesh's :class:`..parallel.rdma.IpcPeers`) the
    sends are this process's ranks' and the function is the group's
    ``all_to_all_single`` of them (:meth:`IpcPeers.all_to_all`)."""
    if peers is not None:
        _check_exchange(sends, peers)
        return peers.all_to_all(sends)
    D, _ = _check_exchange(sends)
    return [torch.stack([sends[s][d].to(sends[d].device) for s in range(D)])
            for d in range(D)]


def _enable_peers(devices) -> None:
    """Peer access between every pair of distinct CUDA devices of the mesh,
    or RuntimeError: a pair that cannot reach each other is never staged
    through the host."""
    from ._build import load_library
    ids = sorted({d.index for d in devices})
    for a in ids:
        for b in ids:
            if a == b or (a, b) in _PEERS_ENABLED:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f"rdma_exchange: cuda:{a} cannot write to cuda:{b} "
                                   "(no peer access)")
            err = load_library().rst_enable_peer_access(a, b)
            if err:
                raise RuntimeError(f"rdma_exchange: enabling peer access cuda:{a} -> "
                                   f"cuda:{b}: CUDA error {err}")
            _PEERS_ENABLED.add((a, b))


def _cross_barrier(streams) -> None:
    """Every stream waits for what every other stream has enqueued so far
    (nothing to do when the ranks share one stream)."""
    if len(streams) < 2:
        return
    events = []
    for st in streams:
        ev = torch.cuda.Event()
        ev.record(st)
        events.append(ev)
    for st in streams:
        for ev in events:
            st.wait_event(ev)


def rdma_exchange(sends: Sequence[torch.Tensor], peers=None) -> list:
    """K13: the all-to-all of D per-rank (D, m) tensors, rank d's on
    ``sends[d].device``: ``out[d][s] = sends[s][d]``, any dtype.

    On CUDA, one launch a rank on that rank's device and current stream,
    each copying its D rows into the D outputs (its own row first, then the
    ring (d + k) % D). The streams of the ranks meet in a barrier of events
    before the launches and after them, so no write lands in a buffer its
    owner still uses and no output is read before every write into it is
    done. Distinct cards write to each other through peer access. CPU sends
    take the plain version; a mesh that mixes the two raises.

    With ``peers`` (a group mesh's :class:`..parallel.rdma.IpcPeers`) the
    sends are this process's ranks' (global ranks ``peers.ranks``). Each
    launch writes into the D ranks' receive buffers, the other processes'
    opened from their CUDA IPC handles; the streams synchronise and the
    group meets before the launches and after them (events do not cross
    processes), then each rank's buffer is copied into its output."""
    D, m = _check_exchange(sends, peers)
    on_gpu = [s.is_cuda for s in sends]
    if not any(on_gpu):
        return rdma_exchange_plain(sends, peers)
    if not all(on_gpu):
        raise ValueError("rdma_exchange: the sends of one call are all on CUDA or all on the CPU")
    outs = [torch.empty_like(s) for s in sends]
    row_bytes = m * sends[0].element_size()
    if row_bytes == 0:
        return outs
    devices = [s.device for s in sends]
    _enable_peers(devices)
    if peers is None:
        streams = list({(st.device, st.cuda_stream): st for st in
                        (torch.cuda.current_stream(d) for d in devices)}.values())
        _cross_barrier(streams)
        table, ranks = _pointers(outs), range(D)
    else:
        table, ranks = peers.begin(D * row_bytes), peers.ranks
    for s, rank in zip(sends, ranks):
        _launch("rst_rdma_exchange", s.device, s.data_ptr(), row_bytes, table, D, rank)
        LAUNCHES["rdma_exchange"] += 1
    if peers is None:
        _cross_barrier(streams)
    else:
        peers.end(outs)
    return outs
