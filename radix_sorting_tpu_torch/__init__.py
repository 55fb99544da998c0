"""radix_sorting_tpu_torch: the PyTorch / CUDA port of ``radix_sorting_tpu``.

A second package beside the JAX one, for one NVIDIA Hopper GPU (sm_90a). It
imports torch and numpy, never JAX; the JAX package is the reference it is
tested against. It holds the JAX package's whole public API: the sorts
(``sort`` with the ``dynamic_probe`` and ``device_probe`` routes,
``argsort`` / ``rank_sort``, ``sort_pairs``, ``counting_sort``,
``sort_u64_multipass``, the batched sorts, ``Strategy.LSD``) of 1-D keys of
8 to 64 bits, byte strings, float8 and int4/uint4; ``bitmap_unique_sort``;
``extras`` (``bincount``, the group-by slice, ``lexsort``, the segmented
sorts, ``merge_sorted``, ``searchsorted``, ``nth_element``, ``top_k`` /
``top_k_batched``, ``stable_partition``, ``sort_complex``); ``stats``
(``rankdata``, the quantiles, ``digitize``, ``histogram``, ``mode``, the
partitions); ``sets`` (``unique`` with its flags and ``axis=``, the numpy-2
quartet, the set operations, ``isin`` / ``in1d``);
``ops.vmem_sort.sort_planes_vmem``, the configured sorters of ``models`` and
the distributed tier ``parallel`` (a mesh of ranks driven by one process,
as in the JAX package, whose ``__init__`` exports none of it either). The
kernels (K1 digit histogram, K2/K3 PEXT histogram, K4/K7 dense
regeneration, K5/K6/K8/K9 PDEP regeneration, K10/K11 weighted histograms,
K12 bitonic sort, K13 the distributed exchange, L1/L2 the LSD radix passes,
E1/E2 the speed-of-light kernels) are written in CUDA under ``csrc/``. A
numpy input goes to the CUDA device unless ``device=`` names another.

Public API: the entry points above, ``SortConfig`` / ``Strategy``, the
kernel launch counters (``LAUNCHES``, ``launch_counts``,
``reset_launch_counts``) and the numpy codec (``as_tensor``, ``to_numpy``).
"""

from . import models, stats
from .api import (argsort, argsort_batched, counting_sort, rank_sort, sort,
                  sort_batched, sort_pairs, sort_pairs_batched, sort_u64_multipass)
from .config import DEFAULT_CONFIG, SortConfig, Strategy
from .extras import (bincount, group_reduce, lexsort, merge_sorted, nth_element,
                     searchsorted, segmented_argsort, segmented_sort, sort_complex,
                     stable_partition, top_k, top_k_batched, unique_sorted, value_counts)
from .ops import cuda_kernels as _ck
from .ops.bitmap import bitmap_unique_sort
from .ops.kdf import as_tensor, to_numpy
from .sets import (UniqueResult, in1d, intersect1d, isin, setdiff1d, setxor1d, union1d,
                   unique, unique_all, unique_counts, unique_inverse, unique_values)
from .stats import (argpartition, digitize, histogram, histogram_bin_edges, median, mode,
                    partition, percentile, quantile, rankdata)

__version__ = "0.4.1"

LAUNCHES = _ck.LAUNCHES
launch_counts = _ck.launch_counts
reset_launch_counts = _ck.reset_launch_counts

__all__ = ["sort", "argsort", "rank_sort", "sort_pairs", "counting_sort",
           "sort_u64_multipass", "sort_batched", "argsort_batched",
           "sort_pairs_batched", "bitmap_unique_sort", "lexsort", "merge_sorted",
           "searchsorted", "bincount", "nth_element", "stable_partition",
           "value_counts", "group_reduce", "unique_sorted", "sort_complex",
           "unique", "unique_values", "unique_counts", "unique_inverse", "unique_all",
           "UniqueResult", "isin", "in1d", "union1d", "intersect1d", "setdiff1d",
           "setxor1d",
           "segmented_sort", "segmented_argsort", "top_k", "top_k_batched",
           "rankdata", "quantile", "percentile", "median", "mode", "digitize",
           "histogram", "histogram_bin_edges", "partition", "argpartition",
           "stats", "models", "SortConfig", "Strategy", "DEFAULT_CONFIG",
           "__version__", "LAUNCHES", "launch_counts", "reset_launch_counts",
           "as_tensor", "to_numpy"]
