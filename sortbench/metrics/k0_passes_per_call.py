"""k0_passes_per_call: the program's K0 pass spans a call, one a k0_sweep
enqueued: the live digits K0 sorted by."""

from sortbench import spanfold

K0_PASS = spanfold.PREFIX + "k0_pass"


def read(record):
    folded = spanfold.of(record)
    if folded is None or K0_PASS not in folded["counts"] or not folded["calls"]:
        return None
    return folded["counts"][K0_PASS] / folded["calls"]
