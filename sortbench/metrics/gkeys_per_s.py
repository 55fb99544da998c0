"""gkeys_per_s: the keys of every call completed in the window over the
window's seconds on the host's clock (the window ends with a synchronize)."""


def read(record):
    if record["window_s"] <= 0 or not record["keys"]:
        return None
    return record["keys"] / record["window_s"] / 1e9
