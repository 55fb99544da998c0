"""How ``u64_sort`` is called, its plain reference and its control."""

import torch

from sortbench import reference


def call(fn, inputs):
    """The timed call: ``fn`` is the configuration's entry point."""
    return fn(inputs["keys"])


def expected(inputs):
    """The sorted keys."""
    return reference.sorted_keys(inputs["keys"])


def control(inputs):
    """The keys stably ordered by their top 32 bits alone: the sort at the
    precision of one 32-bit word plane, which breaks the bit-exact 64-bit
    order the configuration states."""
    keys = inputs["keys"]
    top = (reference.signed_view(keys) >> 32) & 0xFFFFFFFF    # the high word, unsigned
    order = torch.sort(top, stable=True).indices
    return reference.take(keys, order)
