"""dispatch_host_ms: host milliseconds a call in the program's outermost
spans (its public call) less what its read spans cover: the host's own
dispatch work, with its waits for the device taken out."""

from sortbench import spanfold


def read(record):
    seconds = spanfold.per_call(record, "dispatch_s")
    return None if seconds is None else 1e3 * seconds
