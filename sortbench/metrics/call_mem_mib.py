"""call_mem_mib: the peak of the bytes the window's calls asked of the
caching allocator (``requested_bytes``, before it rounds them to its
blocks) above what was held when the window began (the pool, the sample's
slots): the device memory a call takes beyond its input."""


def read(record):
    if record["call_mem_bytes"] <= 0:
        return None
    return record["call_mem_bytes"] / 2**20
