"""setup_s: process start to the first timed call: imports, the CUDA
context, building or loading the kernels, the pool made from the seed, one
warm call of every array of the pool."""


def read(record):
    return record["setup_s"]
