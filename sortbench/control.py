"""Read the numbers that decide ``correct`` for the program and for the
control, at a cell's own size, many seeds in one process.

    python3 sortbench/control.py --workload <cell> --seconds <s> \\
        --program-seeds <n,n,...> --control-seeds <n,n,...>

The control is the configuration's ``control`` from its reference module,
put in the program's place in the same loop: a sort that breaks one
guarantee the configuration states. Each run prints one JSON line with its
seed, what ran, ``correct`` and the compared numbers. The limits come from
these readings (the largest the program gives, the smallest the control
gives); the benchmark's own runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from sortbench import harness, manifest, program

    if not torch.cuda.is_available():
        print("sortbench control: no CUDA device", file=sys.stderr)
        return 3
    cell = manifest.resolve(manifest.load(ROOT), args.workload, ROOT)
    program.build()
    fn, ref = program.entry(cell["config"]), cell["reference"]
    runs = [("program", lambda inputs: ref.call(fn, inputs), args.program_seeds),
            ("control", ref.control, args.control_seeds)]
    for what, call, seeds in runs:
        for seed in (int(s) for s in seeds.split(",") if s):
            out = harness.run(cell["config"], cell["reference"], cell["mix"], seed,
                              args.seconds, False, torch.device("cuda", 0), call,
                              time.perf_counter())
            print(json.dumps({"workload": args.workload, "what": what, "seed": seed,
                              "correct": out["correct"], "attempted": out["attempted"],
                              "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
