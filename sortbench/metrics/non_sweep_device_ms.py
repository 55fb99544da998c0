"""non_sweep_device_ms: the device's busy milliseconds a call less those of
the kernels named k0_sweep: the key transform's split and join, the
presorted guard and K1's live digits around K0's passes; nothing where no
call launched a k0_sweep."""


def read(record):
    sweep = sum(s for name, s in record["op_seconds"].items() if "k0_sweep" in name)
    if sweep <= 0 or not record["calls"]:
        return None
    return 1e3 * (record["busy_s"] - sweep) / record["calls"]
