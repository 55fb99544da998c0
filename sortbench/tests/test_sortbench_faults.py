"""The check that decides ``correct``: sound runs pass; the control and each
fault a sort can have, planted under the timed path, fail.

These drive the rest of a run without the harness's look for a card, on
the CPU at small sizes (the program's CPU route: the presorted guard, then
``torch.sort``). ``test_sortbench_cuda.py`` repeats them on the card.
"""

import time

import pytest
import torch

from radix_sorting_tpu_torch.ops import hw_engine
from sortbench import harness, manifest, program

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
FAULTS = ("state_unchanged", "half_left_out", "answer_altered", "input_overwritten")


def small(mix, fixed=3000, and_of=None):
    """The mix at a size a test run holds: its key distribution kept, its
    size cut (and its keys' entropy, where ``and_of`` is given)."""
    keys = mix.get("keys", {}) if and_of is None else dict(mix.get("keys", {}), and_of=and_of)
    return dict(mix, sizes={"fixed": fixed, "count": 3}, keys=keys)


def run_cell(cell, seed, call=None, device="cpu", **sizes):
    c = manifest.resolve(BENCH, cell)
    fn, ref = program.entry(c["config"]), c["reference"]
    return harness.run(c["config"], ref, small(c["mix"], **sizes), seed, 0.2, False, device,
                       call or (lambda inputs: ref.call(fn, inputs)), time.perf_counter())


def plant(monkeypatch, fault):
    """Break the sorter that ``api.sort`` and ``api.argsort`` call."""
    sort_guarded, argsort = hw_engine.sort_words_presort_guard, hw_engine.argsort_words

    def sort_fault(words, payloads=(), stable=True):
        w = words[0]
        if fault == "state_unchanged":
            return tuple(words), tuple(payloads)
        if fault == "half_left_out":
            h = w.shape[0] // 2
            first = sort_guarded((w[:h],), stable=stable)[0][0]
            return (torch.cat([first, w[h:]]),), tuple(payloads)
        sw, p = sort_guarded(words, payloads, stable)
        if fault == "input_overwritten":          # an in-place sort: the caller's keys
            w.copy_(sw[0])
            return (w,), p
        out = sw[0].clone()
        out[out.shape[0] // 2] ^= 1
        return (out,), p

    def argsort_fault(words, index_dtype=torch.uint32, guard=False):
        n = words[0].shape[0]
        iota = torch.arange(n, dtype=torch.int32, device=words[0].device)
        if fault == "state_unchanged":
            return tuple(words), iota.view(index_dtype)
        if fault == "half_left_out":
            h = n // 2
            first = argsort((words[0][:h],), torch.int32, guard)[1]
            return tuple(words), torch.cat([first, iota[h:]]).view(index_dtype)
        sw, perm = argsort(words, torch.int32, guard)
        if fault == "input_overwritten":
            words[0].copy_(sw[0])
            return sw, perm.view(index_dtype)
        perm = perm.clone()
        perm[[0, 1]] = perm[[1, 0]]
        return sw, perm.view(index_dtype)

    monkeypatch.setattr(hw_engine, "sort_words_presort_guard", sort_fault)
    monkeypatch.setattr(hw_engine, "argsort_words", argsort_fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell):
    out = run_cell(cell, 2**31 + 101)
    assert out["correct"], out["checks"]
    assert out["checks"]["wrong_elements"]["value"] == 0
    assert out["checks"]["checked_calls"]["value"] == min(
        out["attempted"], manifest.resolve(BENCH, cell)["mix"]["sample_calls"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    ref = manifest.resolve(BENCH, cell)["reference"]
    # argsort's control breaks only stability, which shows only where keys
    # tie: at 40M uniform keys ~186,000 pairs do, at 3,000 none; so here
    # the keys are drawn with many ties (each the AND of 4 words)
    out = run_cell(cell, 2**31 + 202, call=ref.control, and_of=4)
    assert not out["correct"]
    assert out["checks"]["wrong_elements"]["value"] > 0


# the number each fault moves
CAUGHT_BY = {"state_unchanged": "wrong_elements", "half_left_out": "wrong_elements",
             "answer_altered": "wrong_elements", "input_overwritten": "changed_input_elements"}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    plant(monkeypatch, fault)
    out = run_cell(cell, 2**31 + 303)
    assert not out["correct"]
    assert out["checks"][CAUGHT_BY[fault]]["value"] > 0


def test_a_call_that_raises_counts_as_failed():
    calls = {"n": 0}
    fn = program.entry(manifest.resolve(BENCH, CELLS[0])["config"])

    def flaky(inputs):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("planted")
        return fn(inputs["keys"])
    out = run_cell(CELLS[0], 7, call=flaky)
    assert out["failed"] == 1 and not out["correct"]


def test_without_a_card_the_run_prints_no_result(monkeypatch, capsys):
    import sys
    sys.path.insert(0, str(manifest.HERE))
    try:
        import run
    finally:
        sys.path.remove(str(manifest.HERE))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
