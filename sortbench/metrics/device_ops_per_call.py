"""device_ops_per_call: kernels, copies and memsets the traced calls put on
the device, per call: what the host had to enqueue, whoever implements it."""


def read(record):
    if not record["calls"] or not record["device_ops"]:
        return None
    return record["device_ops"] / record["calls"]
