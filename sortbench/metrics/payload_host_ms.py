"""payload_host_ms: host milliseconds a call in the program's payload spans
(``api.sort_pairs`` flattening the payload tree before the sort and
rebuilding it after); nothing where no call opened one."""

from sortbench import spanfold

PAYLOAD = spanfold.PREFIX + "payload"


def read(record):
    folded = spanfold.of(record)
    if folded is None or PAYLOAD not in folded["counts"] or not folded["calls"]:
        return None
    return 1e3 * folded["seconds"][PAYLOAD] / folded["calls"]
