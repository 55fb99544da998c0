"""The benchmark on the card: the check at sizes that take the cells' own
routes (K0 from 2^24 keys; the guard and ``torch.sort`` below), and whole
runs of ``sortbench/run.py``.

    python -m pytest sortbench/tests -q -m cuda
"""

import json
import subprocess
import sys

import pytest

from sortbench import manifest
from test_sortbench_faults import CAUGHT_BY, CELLS, FAULTS, plant, run_cell

pytestmark = pytest.mark.cuda



def sizes(cell):
    """A mix at 2^24 + 1000 keys where it sends more (K0's route, as the 40M
    mixes take), else at its own size."""
    n = manifest.resolve(manifest.load(), cell)["mix"]["sizes"]["fixed"]
    return {"fixed": min(n, (1 << 24) + 1000)}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_on_the_card_are_correct(cell, cuda):
    out = run_cell(cell, 2**31 + 11, device=cuda, **sizes(cell))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_on_the_card_is_not_correct(cell, cuda):
    ref = manifest.resolve(manifest.load(), cell)["reference"]
    out = run_cell(cell, 2**31 + 12, call=ref.control, device=cuda, **sizes(cell))
    assert not out["correct"] and out["checks"]["wrong_elements"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_on_the_card_is_not_correct(cell, fault, cuda, monkeypatch):
    plant(monkeypatch, fault)
    out = run_cell(cell, 2**31 + 13, device=cuda, **sizes(cell))
    assert not out["correct"] and out["checks"][CAUGHT_BY[fault]]["value"] > 0


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_whole_run_prints_its_result_last(cell, trace, cuda):
    done = subprocess.run([sys.executable, "sortbench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 14), "--seconds", "1", "--trace", str(trace)],
                          cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    resolved = manifest.resolve(manifest.load(), cell)
    want = resolved["per_layer"] if trace else resolved["end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m, _ in want}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"] and len(line["breakdown"]["idle_gaps"]) <= 10
    assert done.stderr.strip().splitlines()[-1].startswith("check ")
