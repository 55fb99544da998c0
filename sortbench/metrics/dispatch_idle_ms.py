"""dispatch_idle_ms: device idle milliseconds a call while the innermost
host operation was one of the program's spans: the idle the program's own
Python leaves, beyond what torch's ops and the CUDA runtime name."""

from sortbench import spanfold


def read(record):
    seconds = [s for name, s in record["idle_seconds"].items()
               if name.startswith(spanfold.PREFIX)]
    if not seconds or not record["calls"]:
        return None
    return 1e3 * sum(seconds) / record["calls"]
