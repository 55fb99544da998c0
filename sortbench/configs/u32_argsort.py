"""How ``u32_argsort`` is called, its plain reference and its control."""

import torch

from sortbench import reference


def call(fn, inputs):
    """The timed call: ``fn`` is the configuration's entry point."""
    return fn(inputs["keys"])


def expected(inputs):
    """The unique stable ascending permutation, as uint32."""
    return reference.stable_permutation(inputs["keys"], torch.uint32)


def control(inputs):
    """An ascending permutation with equal keys in reverse order of
    position: it breaks the stability the configuration states."""
    return reference.ties_reversed_permutation(inputs["keys"], torch.uint32)
