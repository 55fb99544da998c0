"""Run one cell of BENCHMARK.json once and print its result.

    python3 sortbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell asks
for. Untraced, the window lasts ``--seconds``; traced, it is the mix's
``trace_calls`` calls under ``torch.profiler``. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit,
which also end standard error. Without the card(s), or with JAX or the JAX
package loaded once the window has closed, it exits non-zero and prints no
result. The first run in a checkout builds the port's kernels with nvcc
(inside ``setup_s``; a line of standard output says so and how long it took);
later runs load them.
"""

import time

T0 = time.perf_counter()    # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "sortbench" / "out" / "cache"    # fixed paths inside the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "radix_sorting_tpu")


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unknown ({exc.__class__.__name__})"
    return done.stdout.strip().replace("\n", "; ") or "unknown"


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch
    from sortbench import harness, manifest, program, stats, tracefold

    cell = manifest.resolve(manifest.load(ROOT), args.workload, ROOT)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"sortbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    built_s = program.build()
    fn, ref = program.entry(cell["config"]), cell["reference"]
    out = harness.run(cell["config"], ref, cell["mix"], args.seed, args.seconds,
                      bool(args.trace), device, lambda inputs: ref.call(fn, inputs), T0,
                      ROOT / "sortbench" / "out" / f"{args.workload}.trace.json")
    found = loaded_forbidden()
    if found:
        print(f"sortbench: loaded once the window closed: {', '.join(found)}",
              file=sys.stderr)
        return 4
    record = out["record"]
    readers = cell["per_layer"] if args.trace else cell["end_to_end"]
    metrics = {}
    for m, read in readers:
        value = read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": kind, "count": chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = record["busy_s"]
        dev["window_s"] = record["window_s"]
        line["breakdown"] = {"device_ops": tracefold.top(record["op_seconds"]),
                             "idle_gaps": tracefold.top(record["idle_seconds"])}
    line["checks"] = out["checks"]
    print(f"sortbench: {args.workload} seed {args.seed} trace {args.trace}: "
          f"{out['attempted']} calls in {record['window_s']} s; {kind}, power "
          f"{_power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          + ("the port's kernels were loaded, built by an earlier run" if built_s is None
             else f"this run built the port's kernels, {built_s} s of setup_s"))
    if not args.trace and record["latencies_ms"]:
        lat = record["latencies_ms"]
        print(f"sortbench: call ms p50 {stats.percentile(lat, 50)}, mean "
              f"{sum(lat) / len(lat)}, max {max(lat)}; host ms a call outside the "
              f"calls {(record['window_s'] * 1e3 - sum(lat)) / len(lat)}")
    print(json.dumps(line), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['pass_if']} {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
