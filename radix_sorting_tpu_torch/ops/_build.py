"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by its own ``nvcc``, all at once, and
the objects are linked into one shared library with a plain C interface,
loaded with :mod:`ctypes` (no PyTorch headers, so a build takes seconds). The
library lands in the package's ``build/``
directory under a name that carries a hash of the sources and flags, so an
edited source is rebuilt on first use and an unchanged one is reused. A
failed build raises with the compiler's output.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then in
the toolkit's default prefix ``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

__all__ = ["build", "load_library", "library_path", "require_built", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)   # a host array of device pointers
_I = ctypes.c_int
# a histogram's launch shape (cuda_kernels.HistShape: threads, local_bits,
# ranges, copies, half)
_HIST_SHAPE = (_I, _I, _I, _I, _I)
# a weighted histogram's launch shape (cuda_kernels.WhistShape: threads,
# local_bits, ranges, half, unroll)
_WHIST_SHAPE = (_I, _I, _I, _I, _I)
_SIGNATURES = {
    # keys, n, offset, shift, bits, drop_ge, hist, shape, stream
    "rst_hist": (_P, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                 ctypes.c_ulonglong, _P, *_HIST_SHAPE, _P),
    # hi, lo, n, planes, bits, order, pair, out, shape, stream
    "rst_live_digits": (_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _P, *_HIST_SHAPE, _P),
    # cum, bins, n, offset, out, stream
    "rst_regen": (_P, ctypes.c_int, ctypes.c_int, ctypes.c_uint, _P, _P),
    # keys, n, mask, hist, shape, stream
    "rst_hist_pext": (_P, ctypes.c_longlong, ctypes.c_uint, _P, *_HIST_SHAPE, _P),
    # hi, lo, n, mask_hi, mask_lo, hist, shape, stream
    "rst_hist_pext2": (_P, _P, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                       _P, *_HIST_SHAPE, _P),
    # cum, bins, n, mask, plane, out, stream
    "rst_regen_pdep": (_P, ctypes.c_int, ctypes.c_int, ctypes.c_uint, _P, _P, _P),
    # cum, bins, n, mask_hi, mask_lo, plane_hi, plane_lo, out_hi, out_lo, stream
    "rst_regen_pdep2": (_P, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                        ctypes.c_uint, _P, _P, _P, _P, _P),
    # keys, values, n, bits, drop_ge, counts, sums, shape, stream
    "rst_whist": (_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, _P, _P,
                  *_WHIST_SHAPE, _P),
    # keys, weights, n, bits, drop_ge, counts (null: none), sums, shape, stream
    "rst_whist_f32": (_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, _P, _P,
                      *_WHIST_SHAPE, _P),
    # keys, n, shift, bits, tile, hist, stream
    "rst_lsd_hist": (_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                     _P, _P),
    # keys, in planes, out planes, planes, n, shift, bits, tile, bases, counters,
    # threads, keys a thread, shared-memory bytes, stream
    "rst_lsd_scatter": (_P, _PP, _PP, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _P),
    # keys, in planes (a null: the position), out planes, planes, wide mask, n, shift,
    # bits, tile, starts, status, epoch, pair (1 in, 2 out), stream
    "rst_k0_sweep": (_P, _PP, _PP, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P, _P, ctypes.c_int,
                     ctypes.c_int, _P),
    # (planes, n) in, (planes, n) out, planes, keys, n, blocks, trip words, words, stream
    "rst_bitonic": (_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    _P, ctypes.c_int, _P),
    # in, out, n, stream
    "rst_dma_copy": (_P, _P, ctypes.c_longlong, _P),
    # s128, xp, out, R, K, W, m, d, capr, stream
    "rst_msd_spread": (_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P),
    # src, row bytes, output bases, ranks, rank, stream
    "rst_rdma_exchange": (_P, ctypes.c_longlong, _PP, ctypes.c_int, ctypes.c_int, _P),
    # device, peer
    "rst_enable_peer_access": (ctypes.c_int, ctypes.c_int),
    # bytes, out pointer, out handle (rst_ipc_handle_bytes() bytes)
    "rst_ipc_alloc": (ctypes.c_longlong, _PP, _P),
    # handle, out pointer
    "rst_ipc_open": (_P, _PP),
    # pointer (opened / allocated)
    "rst_ipc_close": (_P,),
    "rst_ipc_free": (_P,),
    "rst_ipc_handle_bytes": (),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library of the current sources and flags lives once built."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in cu + cuh:
        digest.update(p.name.encode() + b"\0" + p.read_bytes())
    return _BUILD / f"librst_kernels_{digest.hexdigest()[:16]}.so"


def require_built() -> Path:
    """The built library's path, or RuntimeError: for processes that share
    one build (the workers of a group mesh), which must not each start one."""
    lib = library_path()
    if not lib.exists():
        raise RuntimeError(f"no kernel library at {lib}: build it once first "
                           "(radix_sorting_tpu_torch.ops._build.build())")
    return lib


def build() -> Tuple[Path, str]:
    """Compile ``csrc/*.cu`` unless a library of the same sources exists.

    One ``nvcc -c`` per source, all started together, then one link.
    Returns the library's path and the compiler's log (``-Xptxas -v``:
    registers and shared memory of every kernel; empty when reused).
    """
    cu, _ = _sources()
    lib = library_path()
    if lib.exists():
        return lib, ""
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in cu]
    procs = []
    try:
        for p, o in zip(cu, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [proc.communicate()[0] for proc in procs]
        for proc, log in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(proc.args)}\n{log}")
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}): "
                               f"{' '.join(cmd)}\n{link.stdout}{link.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        for proc in procs:      # none is left running, whatever failed
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return lib, "".join(logs) + link.stdout + link.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rst_error_string.argtypes = (ctypes.c_int,)
    lib.rst_error_string.restype = ctypes.c_char_p
    return lib
