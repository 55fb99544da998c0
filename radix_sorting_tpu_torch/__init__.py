"""radix_sorting_tpu_torch: the PyTorch / CUDA port of ``radix_sorting_tpu``.

A second package beside the JAX one, for one NVIDIA Hopper GPU (sm_90a). It
imports torch and numpy, never JAX; the JAX package is the reference it is
tested against. So far it holds ``sort`` (with the ``dynamic_probe`` and
``device_probe`` routes), ``argsort`` / ``rank_sort``, ``sort_pairs``,
``counting_sort`` and ``sort_u64_multipass`` of 1-D keys of 8 to 64 bits,
byte strings, float8 and int4/uint4, plus ``bitmap_unique_sort`` and
``bincount``, and the group-by slice: ``group_reduce``, ``value_counts``,
``unique_sorted``, ``histogram``, ``histogram_bin_edges`` and ``mode``. The
kernels (K1 digit histogram, K2/K3 PEXT histogram, K4/K7 dense
regeneration, K5/K6/K8/K9 PDEP regeneration, K10/K11 weighted histograms)
are written in CUDA under ``csrc/``. A numpy input goes to the CUDA device
unless ``device=`` names another.

Public API: the entry points above, ``SortConfig`` / ``Strategy``, the
kernel launch counters (``LAUNCHES``, ``launch_counts``,
``reset_launch_counts``) and the numpy codec (``as_tensor``, ``to_numpy``).
"""

from . import stats
from .api import (argsort, counting_sort, rank_sort, sort, sort_pairs,
                  sort_u64_multipass)
from .config import DEFAULT_CONFIG, SortConfig, Strategy
from .extras import bincount, group_reduce, unique_sorted, value_counts
from .ops import cuda_kernels as _ck
from .ops.bitmap import bitmap_unique_sort
from .ops.kdf import as_tensor, to_numpy
from .stats import histogram, histogram_bin_edges, mode

LAUNCHES = _ck.LAUNCHES
launch_counts = _ck.launch_counts
reset_launch_counts = _ck.reset_launch_counts

__all__ = ["sort", "argsort", "rank_sort", "sort_pairs", "counting_sort",
           "sort_u64_multipass", "bitmap_unique_sort", "bincount",
           "group_reduce", "value_counts", "unique_sorted", "histogram",
           "histogram_bin_edges", "mode", "stats",
           "SortConfig", "Strategy", "DEFAULT_CONFIG", "LAUNCHES",
           "launch_counts", "reset_launch_counts", "as_tensor", "to_numpy"]
