"""Hopper kernels of the counting tier, their plain versions and launch counts.

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
======================  ==============  =====================================

One histogram kernel counts digits (K1) or the PEXT-compacted live bits of
one plane (K2) or two (K3), and one regeneration kernel writes dense values
(K4, K7) or masked keys into one plane or two, and meets the <= 2^10-bin
(K4, K5, K6) and the 2^11 to 2^17-bin (K7, K8, K9) contracts alike;
launches are counted under the contract's name. The source notes in
``csrc/`` say what bounds each kernel on the card.
"""

from __future__ import annotations

import torch

from . import probes
from .kdf import INT32_MIN, i32

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts",
           "use_gpu_routes", "pick_window", "MAX_BITS", "HIST_MAX_BITS",
           "hist", "hist_plain", "hist_multi", "hist_multi_plain",
           "regen", "regen_plain",
           "hist_pext", "hist_pext_plain", "regen_pdep", "regen_pdep_plain",
           "hist_pext2", "hist_pext2_plain", "regen_pdep2", "regen_pdep2_plain"]

LAUNCHES = {"hist": 0, "hist_multi": 0, "regen": 0, "regen_windowed": 0,
            "hist_pext": 0, "regen_pdep": 0, "regen_pdep_windowed": 0,
            "hist_pext2": 0, "regen_pdep2": 0, "regen_pdep2_windowed": 0}

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
