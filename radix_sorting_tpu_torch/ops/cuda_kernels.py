"""Hopper kernels of the counting tier, their plain versions and launch counts.

The counterpart of ``radix_sorting_tpu.ops.pallas_kernels`` for the kernels
ported so far. Each wrapper checks its inputs, then

* on a CUDA tensor launches its hand-written kernel (``csrc/``, built by
  :mod:`._build`) on the current stream, or raises;
* on a CPU tensor runs its plain PyTorch version, the counterpart of Pallas
  interpret mode, so the CPU tests run the dispatch graph the GPU runs.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one where it
launches its kernel and nowhere else; the plain versions count nothing.

======================  ===================  ================================
wrapper / counter       CUDA source          replaces (pallas_kernels.py)
======================  ===================  ================================
hist_pext               csrc/hist_pext.cu    K2 ``_hist_pext_kernel``
hist_pext2              csrc/hist_pext.cu    K3 ``_hist_pext2_kernel``
regen_pdep              csrc/regen_pdep.cu   K5 ``_regen_pdep_kernel``
(regen_pdep_windowed)   csrc/regen_pdep.cu   K8 ``_regen_pdep_win_kernel``
regen_pdep2             csrc/regen_pdep.cu   K6 ``_regen_pdep2_kernel``
(regen_pdep2_windowed)  csrc/regen_pdep.cu   K9 ``_regen_pdep2_win_kernel``
======================  ===================  ================================

One histogram kernel reads one plane (K2) or two (K3), and one
regeneration kernel writes one plane or two and meets the <= 2^10-bin (K5,
K6) and the 2^11 to 2^17-bin (K8, K9) contracts alike; launches are counted
under the contract's name. The source notes in ``csrc/`` say what bounds
each kernel on the card.
"""

from __future__ import annotations

import torch

from . import probes
from .kdf import i32

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts",
           "use_gpu_routes", "pick_window", "MAX_BITS",
           "hist_pext", "hist_pext_plain", "regen_pdep", "regen_pdep_plain",
           "hist_pext2", "hist_pext2_plain", "regen_pdep2", "regen_pdep2_plain"]

LAUNCHES = {"hist_pext": 0, "regen_pdep": 0, "regen_pdep_windowed": 0,
            "hist_pext2": 0, "regen_pdep2": 0, "regen_pdep2_windowed": 0}

MAX_BITS = 17            # widest counting domain the kernels take (2^17 bins)
_K5_MAX_BINS = 1 << 10   # counting_engine._REGEN_MAX_BINS: the K5/K8, K6/K9 split


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
