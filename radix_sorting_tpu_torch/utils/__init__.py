"""Dataset, verification and timing utilities of the port's measurement
entry points (:mod:`..cli`, :mod:`..scripts`), and the multi-process
harness (:mod:`.mpharness`)."""

from . import keyfile, mpharness, timing, verify  # noqa: F401
