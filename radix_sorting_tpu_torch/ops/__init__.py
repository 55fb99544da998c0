"""Engine building blocks of the port: KDF, probes, kernels, sort engines."""

from . import (  # noqa: F401
    bitmap,
    counting_engine,
    cuda_kernels,
    histogram,
    hw_engine,
    kdf,
    lsd_engine,
    probes,
    scan,
    vmem_sort,
)
