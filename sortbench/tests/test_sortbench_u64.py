"""The check that decides ``correct`` in the two-plane cell,
``u64_sort.uniform_40m``: a sound run passes, the control fails, and each
fault a sort of two word planes can have, planted under the timed path,
fails. On the CPU at small sizes, as ``test_sortbench_faults.py``, whose
planted faults act on the first plane alone; here they act on both planes
(hi, lo) that ``api.sort`` hands the sorter for a 64-bit key. Those planes
are a copy of the input, so the in-place fault is planted in the timed call
itself.
"""

import time

import pytest
import torch

from radix_sorting_tpu_torch.ops import hw_engine
from sortbench import harness, manifest, program, roofline

BENCH = manifest.load()
CELL = "u64_sort.uniform_40m"
FAULTS = ("state_unchanged", "half_left_out", "low_word_left_out", "answer_altered")


def run_cell(seed, call=None, fixed=3000, and_of=None):
    c = manifest.resolve(BENCH, CELL)
    fn, ref = program.entry(c["config"]), c["reference"]
    keys = c["mix"]["keys"] if and_of is None else dict(c["mix"]["keys"], and_of=and_of)
    mix = dict(c["mix"], sizes={"fixed": fixed, "count": 3}, keys=keys)
    return harness.run(c["config"], ref, mix, seed, 0.2, False, "cpu",
                       call or (lambda inputs: ref.call(fn, inputs)), time.perf_counter())


def plant(monkeypatch, fault):
    """Break the guarded sorter that ``api.sort`` calls for two planes."""
    sort_guarded = hw_engine.sort_words_presort_guard

    def sort_fault(words, payloads=(), stable=True):
        assert len(words) == 2
        if fault == "state_unchanged":
            return tuple(words), tuple(payloads)
        if fault == "half_left_out":
            h = words[0].shape[0] // 2
            first = sort_guarded(tuple(w[:h] for w in words), stable=stable)[0]
            return tuple(torch.cat([f, w[h:]]) for f, w in zip(first, words)), tuple(payloads)
        if fault == "low_word_left_out":          # ordered by the high word alone
            hi, lo = words
            perm = torch.sort(hi ^ (-(1 << 31)), stable=True).indices
            return (hi[perm], lo), tuple(payloads)
        sw, p = sort_guarded(words, payloads, stable)
        lo = sw[1].clone()
        lo[lo.shape[0] // 2] ^= 1
        return (sw[0], lo), p

    monkeypatch.setattr(hw_engine, "sort_words_presort_guard", sort_fault)


def test_a_sound_run_is_correct():
    out = run_cell(2**31 + 111)
    assert out["correct"], out["checks"]
    assert out["checks"]["checked_calls"]["value"] >= 1


def test_the_control_is_not_correct():
    """The control orders by the high word alone, which shows only where
    high words tie: at 40M uniform keys ~186,000 pairs do, at 3,000 none;
    so here the keys are drawn with many ties (each the AND of 4 words)."""
    ref = manifest.resolve(BENCH, CELL)["reference"]
    out = run_cell(2**31 + 222, call=ref.control, and_of=4)
    assert not out["correct"]
    assert out["checks"]["wrong_elements"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_each_two_plane_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    plant(monkeypatch, fault)
    out = run_cell(2**31 + 333, and_of=4 if fault == "low_word_left_out" else None)
    assert not out["correct"]
    assert out["checks"]["wrong_elements"]["value"] > 0


def test_a_call_that_sorts_its_input_in_place_is_not_correct():
    fn = program.entry(manifest.resolve(BENCH, CELL)["config"])

    def in_place(inputs):
        keys = inputs["keys"]
        return keys.copy_(fn(keys))
    out = run_cell(2**31 + 444, call=in_place)
    assert not out["correct"]
    assert out["checks"]["changed_input_elements"]["value"] > 0


def test_least_bytes_of_a_40m_u64_call():
    config = manifest.resolve(BENCH, CELL)["config"]
    assert roofline.least_bytes(config, 40_000_000) == 640_000_000
    assert 640e6 / roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") * 1e3 == \
        pytest.approx(0.191, abs=1e-3)     # ms
