"""How ``u32_sort_pairs`` is called, its plain reference and its control."""

import torch

from sortbench import reference


def call(fn, inputs):
    """The timed call: ``fn`` is the configuration's entry point; the payload
    goes in as a bare tensor, so the result is a tuple of two tensors."""
    return fn(inputs["keys"], inputs["payload"])


def expected(inputs):
    """The sorted keys, and the payload in the unique stable order."""
    keys = inputs["keys"]
    return (reference.sorted_keys(keys),
            reference.take(inputs["payload"], reference.stable_order(keys)))


def control(inputs):
    """The sorted keys, and the payload in the ascending order with equal
    keys in reverse order of position: it breaks the stability the
    configuration states, and nothing else."""
    keys = inputs["keys"]
    order = reference.ties_reversed_permutation(keys, torch.int64)
    return reference.sorted_keys(keys), reference.take(inputs["payload"], order)
