"""How ``u32_sort`` is called, its plain reference and its control."""

from sortbench import reference


def call(fn, inputs):
    """The timed call: ``fn`` is the configuration's entry point."""
    return fn(inputs["keys"])


def expected(inputs):
    """The sorted keys."""
    return reference.sorted_keys(inputs["keys"])


def control(inputs):
    """The keys sorted at 16-bit precision: ordered by their top 16 bits
    alone, which breaks the bit-exact order the configuration states."""
    return reference.sorted_by_top_bits(inputs["keys"], 16)
