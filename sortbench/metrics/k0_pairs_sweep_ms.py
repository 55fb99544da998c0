"""k0_pairs_sweep_ms: device milliseconds a call of the kernels named
k0_sweep (K0's pass, csrc/lsd.cu) where each pass moves the key and the
4-byte payload riding beside it; nothing where no call launched one."""


def read(record):
    seconds = sum(s for name, s in record["op_seconds"].items() if "k0_sweep" in name)
    if seconds <= 0 or not record["calls"]:
        return None
    return 1e3 * seconds / record["calls"]
