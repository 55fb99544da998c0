"""Dataset, verification and timing utilities of the port's measurement
entry points (:mod:`..cli`, :mod:`..scripts`)."""

from . import keyfile, timing, verify  # noqa: F401
