"""sortbench: the end-to-end benchmark of ``radix_sorting_tpu_torch``.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 sortbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: what is called, its key dtype and what it
  guarantees, and ``configs/<config>.py``: how the entry point is called on
  an input, its plain reference and its control;
* ``traffic/<mix>.json``: the parameters that :mod:`sortbench.generator` reads;
* ``metrics/<metric>.py``: a reader of the traced run's record.

The yardstick (traffic, the reduction of a trace, the table of peaks and the
least bytes, the percentiles, the comparison that decides ``correct``) lives
here. Only :mod:`sortbench.program` imports the program.
"""
