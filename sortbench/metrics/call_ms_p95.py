"""call_ms_p95: the nearest-rank 95th percentile over every call of the
window of its time from start to synchronised output (CUDA events)."""

from sortbench.stats import percentile


def read(record):
    if not record["latencies_ms"]:
        return None
    return percentile(record["latencies_ms"], 95)
