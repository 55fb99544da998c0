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
dma_copy                csrc/sol.cu     E1 ``scripts/exp_sol_probe.py``
msd_spread              csrc/sol.cu     E2 ``scripts/exp_sol_round2.py``
======================  ==============  =====================================

One histogram kernel counts digits (K1) or the PEXT-compacted live bits of
one plane (K2) or two (K3), and one regeneration kernel writes dense values
(K4, K7) or masked keys into one plane or two, and meets the <= 2^10-bin
(K4, K5, K6) and the 2^11 to 2^17-bin (K7, K8, K9) contracts alike;
launches are counted under the contract's name. One weighted histogram
kernel sums integer values (K10) or f32 weights (K11) per key. K12 sorts a
few planes with a bitonic network. L1 and L2 are one pass of the LSD radix
sort (per-tile digit histograms, stable scatter); the JAX package's LSD
engine is XLA with no Pallas kernel, so they replace none. E1 and E2 are
the kernels of the speed-of-light scripts (:mod:`..scripts`): a staged
device-memory copy and the spread step of the two-level MSD sort. The source
notes in ``csrc/`` say what bounds each kernel on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import probes
from .kdf import INT32_MIN, i32

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts",
           "use_gpu_routes", "pick_window", "MAX_BITS", "HIST_MAX_BITS",
           "hist", "hist_plain", "hist_multi", "hist_multi_plain",
           "regen", "regen_plain",
           "hist_pext", "hist_pext_plain", "regen_pdep", "regen_pdep_plain",
           "hist_pext2", "hist_pext2_plain", "regen_pdep2", "regen_pdep2_plain",
           "whist", "whist_plain", "whist_f32", "whist_f32_plain", "low32",
           "WHIST_MAX_BITS", "lsd_hist", "lsd_hist_plain", "lsd_scatter",
           "lsd_scatter_plain", "LSD_MAX_BITS", "bitonic", "bitonic_plain",
           "bitonic_pad_len", "BITONIC_MIN_PAD", "dma_copy", "dma_copy_plain",
           "msd_spread", "msd_spread_plain"]

LAUNCHES = {"hist": 0, "hist_multi": 0, "regen": 0, "regen_windowed": 0,
            "hist_pext": 0, "regen_pdep": 0, "regen_pdep_windowed": 0,
            "hist_pext2": 0, "regen_pdep2": 0, "regen_pdep2_windowed": 0,
            "whist": 0, "whist_f32": 0, "whist_f32_counts": 0,
            "bitonic": 0, "lsd_hist": 0, "lsd_scatter": 0,
            "dma_copy": 0, "msd_spread": 0}

MAX_BITS = 17            # widest counting domain the kernels take (2^17 bins)
HIST_MAX_BITS = 18       # widest K1 digit: extras.bincount sends up to 2^18 bins
_HIST_MAX_COUNTERS = 1 << 19   # K1: passes * 2^radix_bits
_K5_MAX_BINS = 1 << 10   # counting_engine._REGEN_MAX_BINS: the K4/K7, K5/K8, K6/K9 split
_NO_DROP = 1 << 32       # K1's drop_ge when no key is dropped


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
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{lib.rst_error_string(err).decode()}")


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
    out = torch.empty(1 << radix_bits, dtype=torch.int32, device=w.device)
    _launch("rst_hist", w.device, w.data_ptr(), w.shape[0], offset & 0xFFFFFFFF,
            pass_index * radix_bits, radix_bits, 1, bound, out.data_ptr())
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
    first pass of `radix_sort_u32.c:24-37`): (passes, 2^radix_bits) int32."""
    _check_plane("hist_multi", w)
    passes = _num_passes(radix_bits)
    _check_digits("hist_multi", 0, radix_bits, passes)
    if not use_gpu_routes(w):
        return hist_multi_plain(w, radix_bits)
    out = torch.empty((passes, 1 << radix_bits), dtype=torch.int32, device=w.device)
    _launch("rst_hist", w.device, w.data_ptr(), w.shape[0], 0, 0, radix_bits,
            passes, _NO_DROP, out.data_ptr())
    LAUNCHES["hist_multi"] += 1
    return out


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
    out = torch.empty(1 << nbits, dtype=torch.int32, device=w.device)
    _launch("rst_hist_pext", w.device, w.data_ptr(), w.shape[0], int(mask),
            out.data_ptr())
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
    out = torch.empty(1 << nbits, dtype=torch.int32, device=hi.device)
    _launch("rst_hist_pext2", hi.device, hi.data_ptr(), lo.data_ptr(),
            hi.shape[0], int(mask_hi), int(mask_lo), out.data_ptr())
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
    counts = torch.empty(1 << radix_bits, dtype=torch.int32, device=keys.device)
    sums = torch.empty_like(counts)
    _launch("rst_whist", keys.device, keys.data_ptr(), values.data_ptr(), keys.shape[0],
            radix_bits, int(drop_ge), counts.data_ptr(), sums.data_ptr())
    LAUNCHES["whist"] += 1
    return counts, sums


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
    sums = torch.empty(1 << radix_bits, dtype=torch.float32, device=keys.device)
    counts = torch.empty(1 << radix_bits, dtype=torch.int32, device=keys.device) \
        if with_counts else None
    _launch("rst_whist_f32", keys.device, keys.data_ptr(), weights.data_ptr(),
            keys.shape[0], radix_bits, int(drop_ge),
            counts.data_ptr() if with_counts else None, sums.data_ptr())
    LAUNCHES["whist_f32_counts" if with_counts else "whist_f32"] += 1
    return (counts, sums) if with_counts else sums


# ---------------------------------------------------------------------------
# L1 / L2: one pass of the LSD radix sort (Strategy.LSD)

LSD_MAX_BITS = 16        # SortConfig's widest digit
_LSD_SHARED_MAX_BITS = 12  # csrc/lsd.cu: L2 counters in shared memory up to 2^12 bins
_MAX_PLANES = 32         # planes one L2 launch takes (csrc/lsd.cu)


def _check_lsd(name: str, w: torch.Tensor, shift: int, radix_bits: int, tile: int) -> None:
    _check_plane(name, w)
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
    gives them. Returns the new planes."""
    _check_lsd("lsd_scatter", w, shift, radix_bits, tile)
    _check_planes("lsd_scatter", planes, w.shape[0], w.device)
    _check_bases(w, bases, radix_bits, tile)
    if not use_gpu_routes(w):
        return lsd_scatter_plain(w, planes, shift, radix_bits, tile, bases)
    n = w.shape[0]
    out = tuple(torch.empty_like(p) for p in planes)
    if n == 0:
        return out
    counters = torch.empty_like(bases) if radix_bits > _LSD_SHARED_MAX_BITS else None
    for g in range(0, len(planes), _MAX_PLANES):
        group = slice(g, g + _MAX_PLANES)
        _launch("rst_lsd_scatter", w.device, w.data_ptr(), _pointers(planes[group]),
                _pointers(out[group]), len(planes[group]), n, shift, radix_bits, tile,
                bases.data_ptr(), None if counters is None else counters.data_ptr())
        LAUNCHES["lsd_scatter"] += 1
    return out


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
    array, so one launch takes every plane count the gate admits. Two or
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
    out = torch.empty((len(planes), n), dtype=torch.int32, device=src.device)
    if n:
        _launch("rst_bitonic", src.device, src.data_ptr(), out.data_ptr(), len(planes),
                num_keys, n)
        LAUNCHES["bitonic"] += 1
    if ride:
        return tuple(out[:num_keys].unbind(0)) + \
            tuple(torch.stack(payloads)[:, out[num_keys].long()].unbind(0))
    return tuple(out.unbind(0))


# ---------------------------------------------------------------------------
# E1 / E2: the kernels of the speed-of-light scripts


def dma_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x``."""
    return x.clone()


def dma_copy(x: torch.Tensor) -> torch.Tensor:
    """E1: a copy of the plane ``x`` staged through shared memory in chunks
    (the contract of ``exp_sol_probe.probe_dma``'s DMA round trip, device
    memory to on-chip memory and back); any length."""
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
