"""The system under test: the only module of the benchmark that imports
``radix_sorting_tpu_torch``."""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import torch


def entry(config: dict) -> Callable:
    """The program's entry point a configuration names (``entry``, an
    attribute of ``radix_sorting_tpu_torch.api``), with its keyword
    arguments (``kwargs``; a key ending in ``dtype`` names a torch dtype)."""
    from radix_sorting_tpu_torch import api
    kwargs = {k: getattr(torch, v) if k.endswith("dtype") else v
              for k, v in config.get("kwargs", {}).items()}
    return functools.partial(getattr(api, config["entry"]), **kwargs)


def build() -> Optional[float]:
    """Build the port's CUDA kernels where this checkout has no library of
    the current sources yet (the first run of a checkout): the seconds that
    took, or None where the library was there and is only loaded."""
    from radix_sorting_tpu_torch.ops import _build
    if _build.library_path().exists():
        return None
    t = time.perf_counter()
    _build.build()
    return time.perf_counter() - t
