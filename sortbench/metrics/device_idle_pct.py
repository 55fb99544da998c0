"""device_idle_pct: the share of the traced window in which no kernel, copy
or memset ran on the device."""


def read(record):
    if record["window_s"] <= 0 or record["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
