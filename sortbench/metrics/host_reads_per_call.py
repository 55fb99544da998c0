"""host_reads_per_call: the program's read spans a call, each a read of
device data on the host that waits for the device (a host sync)."""

from sortbench import spanfold


def read(record):
    return spanfold.per_call(record, "counts", spanfold.READ)
