"""Scale-out over a mesh of ranks: shuffle, balanced sorts, distributed reductions.

The counterpart of ``radix_sorting_tpu.parallel``, in its two forms
(:mod:`._mesh`): one process drives every rank of a :class:`SortMesh` (an
explicit list of torch devices, which may repeat one device), or, with
``group=`` a ``torch.distributed`` process group, each process drives its
own ranks and passes its own slice of the keys. ``make_sort_mesh()`` spans
the visible CUDA devices; ``make_sort_mesh(devices=["cpu"] * 8)`` gives the
eight-rank CPU mesh of the tests. ``exchange="rdma"`` moves the bulk data
through K13 (``csrc/exchange.cu``), across processes through CUDA IPC
handles (:class:`.rdma.IpcPeers`).
"""

from ._mesh import SortMesh  # noqa: F401
from .balanced import (  # noqa: F401
    distributed_argsort_balanced,
    distributed_argsort_balanced_u32,
    distributed_group_reduce,
    distributed_median,
    distributed_quantile,
    distributed_select,
    distributed_sort_balanced,
    distributed_sort_balanced_u32,
    distributed_sort_pairs_balanced,
    distributed_sort_pairs_balanced_u32,
    distributed_top_k,
    distributed_unique_sorted,
)
from .histogram import (  # noqa: F401
    distributed_bincount,
    global_digit_histogram,
    global_live_bit_mask,
)
from .rdma import rdma_all_to_all  # noqa: F401
from .shuffle import (  # noqa: F401
    distributed_argsort,
    distributed_argsort_u32,
    distributed_sort,
    distributed_sort_pairs,
    distributed_sort_pairs_u32,
    distributed_sort_u32,
    gather_sorted,
    make_sort_mesh,
)
