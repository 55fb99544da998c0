"""Device profile of the headline sort: the counterpart of
``scripts/profile_headline.py``.

Traces (:func:`..utils.timing.trace`, ``torch.profiler``) five chained calls
of the headline u32 sort (KDF encode, :func:`..ops.hw_engine.sort_words`,
decode) and of the masked counting sort (mask ``0xF0F00000``), reduces each
trace to device time by kernel (:func:`..utils.timing.device_op_table`) and
writes a dated report, ``report/profile-<device>-<date>-<sha>.json`` under
the repository root that holds this package. Needs a CUDA device.

Usage: python -m radix_sorting_tpu_torch.scripts.profile_headline [n]
"""

from __future__ import annotations

import datetime
import json
import platform
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import counting_engine, hw_engine, kdf
from ..ops.kdf import i32
from ..utils.timing import device_op_table, trace

REPO = Path(__file__).resolve().parents[2]
_MULTIPLIER = i32(2654435761)
MASK = 0xF0F00000


def headline(c: torch.Tensor) -> torch.Tensor:
    """One sort of the u32 keys in the int32 plane ``c``, chained into the
    next input."""
    words = kdf.encode(c.view(torch.uint32))
    sw, _ = hw_engine.sort_words(words, stable=False)
    r = kdf.decode(sw, torch.uint32).view(torch.int32)
    return c * _MULTIPLIER + (r[-1:] & 1)


def masked(c: torch.Tensor) -> torch.Tensor:
    """One counting sort of ``c & 0xF0F00000``, chained into the next input."""
    (s,) = counting_engine.sort_words_counting((c & i32(MASK),), (MASK,))
    return c * _MULTIPLIER + (s[-1:] & 1)


def _sha() -> str:
    git = shutil.which("git")
    if git is None or not (REPO / ".git").exists():
        return "nogit"
    out = subprocess.run([git, "rev-parse", "--short", "HEAD"], capture_output=True,
                         text=True, cwd=REPO)
    return out.stdout.strip() or "nogit"


def main(argv=None) -> Path:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 40_000_000
    reps = 5
    if not torch.cuda.is_available():
        raise SystemExit("profile_headline: needs a CUDA device")
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(device)
    gen = torch.Generator(device=device).manual_seed(0x5EED)
    x = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, device=device,
                      generator=gen)
    print(json.dumps({"device": name, "n": n, "reps": reps}), flush=True)

    sections = {}
    for section, fn in (("headline_u32_sort", headline), ("counting_masked_8bit", masked)):
        c = x
        for _ in range(reps):          # build and warm outside the trace
            c = fn(c)
        torch.cuda.synchronize(device)
        with tempfile.TemporaryDirectory() as logdir:
            with trace(logdir):
                c = x
                for _ in range(reps):
                    c = fn(c)
            rows = device_op_table(logdir)
        for r in rows:
            r["us_per_sort"] = r["total_us"] / reps
        sections[section] = rows[:20]
        print(json.dumps({"section": section,
                          "top_ops": [(r["op"], r["us_per_sort"]) for r in rows[:6]]}),
              flush=True)

    smi = shutil.which("nvidia-smi")
    card = (subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip().splitlines()[0]
            if smi else name)
    sha = _sha()
    path = (REPO / "report" /
            f"profile-{name.replace(' ', '-')}-{datetime.date.today().isoformat()}-{sha}.json")
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({
        "uname": platform.uname()._asdict(), "sha": sha, "device": name, "card": card,
        "torch": torch.__version__, "cuda": torch.version.cuda, "n": n,
        "reps_per_trace": reps,
        "note": ("device-side events (kernels, copies, memsets) of a torch.profiler "
                 f"trace; us_per_sort divides their totals by the {reps} calls traced"),
        "sections": sections}, indent=2))
    print(f"# wrote {path.relative_to(REPO)}", flush=True)
    return path


if __name__ == "__main__":
    main()
