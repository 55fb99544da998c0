"""Experiment CLI of the port: the counterpart of ``radix_sorting_tpu.cli``
and of the reference's ``radix`` harness.

Reference usage: ``./radix <count> [<use_mmap> <use_huge> <type> <hex-mask>]``
(`radix_experiment.cpp:250`): load keys from the 40M key file, optionally
apply a hex value mask to force column skipping (`:188-198`), time one sort
(`:200-206`), verify it (`:208-212`), print head, tail and timing
(`:214-228`).

Here:

* the keys go to the CUDA device (``main(argv, device=...)`` names another
  for the tests) and are sorted there; ``first_call_ms`` is the first call
  with the copy of the result to the host, and includes the kernels' build
  only when ``build/`` holds no library of these sources (there is no
  compilation cache to enable); ``ms`` is a warm second call on the same
  input, closed by a CUDA synchronize;
* ``use_mmap=1`` reads the key file through ``keyfile.read_keyfile``'s
  ``np.memmap`` and says so (the JAX CLI reads through its native runtime,
  which the port does not import: ROADMAP.md §3); ``use_huge`` is accepted
  and ignored, a host-allocator knob;
* the fourteen type names are the JAX CLI's: the reference's eight plus
  f16, bf16, f8e4m3 and f8e5m2;
* verification is always on (the reference builds its CLI with
  ``-DVERIFY_SORT``, `Makefile:61`): sortedness on the device, and the
  output a permutation of the input on the host (:mod:`.utils.verify`).

Usage:
  python -m radix_sorting_tpu_torch.cli <count> [type] [hexmask]
  python -m radix_sorting_tpu_torch.cli 40000000 u32 0xF0F00000
  python -m radix_sorting_tpu_torch.cli <count> <use_mmap> <use_huge> <type> [hexmask]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

_TYPES = {
    # the reference's runtime type-name dispatch (`radix_experiment.cpp:264-279`)
    "u8": np.uint8, "u16": np.uint16, "u32": np.uint32, "u64": np.uint64,
    "i8": np.int8, "i16": np.int16, "i32": np.int32, "i64": np.int64,
    "f32": np.float32, "f64": np.float64,
    # the JAX CLI's extras
    "f16": np.float16, "bf16": "bfloat16",
    "f8e4m3": "float8_e4m3fn", "f8e5m2": "float8_e5m2",
}


def _parse(argv):
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    count = int(argv[0])
    rest = argv[1:]
    use_mmap = False
    # the reference's positional (use_mmap, use_huge) pair, when present
    if len(rest) >= 2 and rest[0] in ("0", "1") and rest[1] in ("0", "1"):
        use_mmap = rest[0] == "1"
        if rest[1] == "1":
            print("# note: hugepage placement is a host-allocator knob; "
                  "keys live in device memory (accepted, ignored)")
        rest = rest[2:]
    tname = rest[0] if rest else "u32"
    if tname not in _TYPES:
        sys.exit(f"unknown type {tname!r}; one of {sorted(_TYPES)}")
    mask = int(rest[1], 16) if len(rest) > 1 else None
    return count, tname, mask, use_mmap


def _key_dtype(tname: str) -> np.dtype:
    dt = _TYPES[tname]
    if isinstance(dt, str):             # ml_dtypes: bfloat16, float8
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, dt))
    return np.dtype(dt)


def main(argv=None, *, device=None) -> int:
    count, tname, mask, use_mmap = _parse(sys.argv[1:] if argv is None else argv)

    import torch

    import radix_sorting_tpu_torch as rt
    from radix_sorting_tpu_torch.ops import kdf
    from radix_sorting_tpu_torch.utils import keyfile, verify

    dev = kdf.input_device(device)
    dt = _key_dtype(tname)
    itemsize = dt.itemsize
    # the key file's bytes read as the requested type (`radix_experiment.cpp:78`)
    words_needed = -(-count * itemsize // 4)
    if use_mmap:
        keyfile.load_or_create(words_needed)     # the file exists and covers the request
        raw = keyfile.read_keyfile(keyfile.default_keyfile(), words_needed)
        print("# allocation: numpy memmap read")
    else:
        raw = keyfile.load_or_create(words_needed)
    raw = raw.view(np.uint8)
    if raw.size < count * itemsize:
        sys.exit(f"dataset too small for {count} x {tname}")
    unsigned = np.dtype(f"u{itemsize}")
    u = raw[: count * itemsize].view(unsigned)
    # a type-punned bitwise mask, as the memcpy mask of `:188-198`; either
    # way a writable copy of the file's bytes
    u = u & unsigned.type(mask & ((1 << (8 * itemsize)) - 1)) if mask is not None else u.copy()
    x_np = u.view(dt)
    x = kdf.as_tensor(x_np, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # The reference times only the sort (`radix_experiment.cpp:204-206`).
    # The first call also pays the build of the kernels, on a cold build/,
    # and brings the result to the host for the checks; `ms` is a warm
    # second call on the same input.
    sync()
    t0 = time.perf_counter()
    out = rt.sort(x, value_mask=mask)
    out_np = kdf.to_numpy(out)
    first_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    rt.sort(x, value_mask=mask)
    sync()
    dt_s = time.perf_counter() - t0

    ok = verify.is_sorted(out) and verify.same_multiset(out_np, x_np)

    head = ", ".join(str(v) for v in out_np[:4])
    tail = ", ".join(str(v) for v in out_np[-4:])
    print(f"# head: {head}")
    print(f"# tail: {tail}")
    rec = {
        "n": count,
        "type": tname,
        "mask": f"0x{mask:08X}" if mask is not None else None,
        "ms": round(dt_s * 1e3, 2),
        "first_call_ms": round(first_ms, 2),
        "Mkeys_per_s": round(count / dt_s / 1e6, 1),
        "bytes_per_s": round(count * itemsize / dt_s, 0),
        "verified": bool(ok),
    }
    print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
