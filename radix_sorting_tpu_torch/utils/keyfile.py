"""Benchmark dataset handling: the 40M-key file and its generator.

The counterpart of ``radix_sorting_tpu.utils.keyfile``, numpy only, kept as
the port's own copy (the port imports nothing of the JAX package). The
reference's ``make genkeys`` writes ``40M_32bit_keys.dat``, 40,000,000 random
u32 (160 MB) from /dev/urandom (`Makefile:79-82`); here the keys come from a
seeded PCG64, so every machine makes the same file, byte for byte the JAX
package's for the same count and seed.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = [
    "DEFAULT_COUNT",
    "default_keyfile",
    "generate_keys",
    "write_keyfile",
    "read_keyfile",
    "load_or_create",
]

DEFAULT_COUNT = 40_000_000  # `Makefile:79-82`


def default_keyfile(root: str | os.PathLike | None = None) -> Path:
    """The key file's path: ``root`` or the repository's ``data/``."""
    root = Path(root) if root is not None else Path(__file__).resolve().parents[2] / "data"
    return root / "40M_32bit_keys.dat"


def generate_keys(count: int = DEFAULT_COUNT, seed: int = 0x5EED) -> np.ndarray:
    """Deterministic uniform-random u32 keys (PCG64); prefix-stable:
    ``generate_keys(2 * n)[:n] == generate_keys(n)``."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, 1 << 32, size=count, dtype=np.uint32)


def write_keyfile(path: str | os.PathLike, keys: np.ndarray) -> None:
    """Write ``keys`` as raw little-endian u32 words."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    keys.astype("<u4").tofile(path)


def read_keyfile(path: str | os.PathLike, count: int | None = None, dtype=np.uint32) -> np.ndarray:
    """Up to ``count`` keys of ``dtype`` from a raw little-endian key file,
    through a read-only ``np.memmap`` (the first ``count * itemsize`` bytes,
    as `radix_experiment.cpp:78-104` reads them)."""
    path = Path(path)
    dt = np.dtype(dtype).newbyteorder("<")
    n_avail = path.stat().st_size // dt.itemsize
    n = n_avail if count is None else min(count, n_avail)
    try:
        return np.asarray(np.memmap(path, dtype=dt, mode="r", shape=(n,)))
    except (OSError, ValueError):
        return np.fromfile(path, dtype=dt, count=n)


def load_or_create(count: int = DEFAULT_COUNT, path: str | os.PathLike | None = None,
                   seed: int = 0x5EED) -> np.ndarray:
    """The benchmark keys, the key file written first if it is missing or
    holds fewer than ``max(count, DEFAULT_COUNT)`` words. The generator is
    prefix-stable, so a grown file keeps its first words."""
    p = Path(path) if path is not None else default_keyfile()
    want = max(int(count), DEFAULT_COUNT)
    have = p.stat().st_size // 4 if p.exists() else 0
    if have < want:
        write_keyfile(p, generate_keys(want, seed))
    return read_keyfile(p, count)
