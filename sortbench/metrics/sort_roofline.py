"""sort_roofline: the traced calls' least bytes (each input byte read once,
each output byte written once) over the card's published peak bandwidth,
as a share of the device's busy time in the window."""


def read(record):
    peak = record.get("peak_bytes_per_s")
    if not peak or record["busy_s"] <= 0 or not record.get("least_bytes"):
        return None
    return 100.0 * record["least_bytes"] / peak / record["busy_s"]
