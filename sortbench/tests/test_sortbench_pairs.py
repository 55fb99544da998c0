"""The check that decides ``correct`` in the record cell,
``u32_sort_pairs.uniform_f32_40m``: a sound run passes, the control fails,
and each fault a sort of keys carrying values can have, planted under the
timed path, fails. On the CPU at small sizes, as ``test_sortbench_faults.py``,
whose planted faults break the keys; here they break the payload alone,
with the keys right. Also the cell's two per-layer metrics of a traced CPU
run, and the least bytes of a 40M call.
"""

import time

import pytest
import torch

from radix_sorting_tpu_torch.ops import hw_engine
from sortbench import generator, harness, manifest, program, roofline, spanfold

BENCH = manifest.load()
CELL = "u32_sort_pairs.uniform_f32_40m"
FAULTS = ("payload_in_input_order", "tied_values_swapped", "one_value_wrong")


def run_cell(seed, call=None, fixed=3000, and_of=None, trace=False, trace_path=None):
    c = manifest.resolve(BENCH, CELL)
    fn, ref = program.entry(c["config"]), c["reference"]
    keys = c["mix"]["keys"] if and_of is None else dict(c["mix"]["keys"], and_of=and_of)
    mix = dict(c["mix"], sizes={"fixed": fixed, "count": 3}, keys=keys, trace_calls=6)
    return harness.run(c["config"], ref, mix, seed, 0.2, trace, "cpu",
                       call or (lambda inputs: ref.call(fn, inputs)), time.perf_counter(),
                       trace_path)


def plant(monkeypatch, fault):
    """Break the payload that the guarded sorter ``api.sort_pairs`` calls
    returns, and leave its keys right."""
    sort_guarded = hw_engine.sort_words_presort_guard

    def sort_fault(words, payloads=(), stable=True):
        assert len(words) == 1 and len(payloads) == 1
        sw, sp = sort_guarded(words, payloads, stable)
        if fault == "payload_in_input_order":
            return sw, tuple(payloads)
        v = sp[0].clone()
        bits = v.view(torch.int32)
        if fault == "tied_values_swapped":        # the first pair of equal keys
            k = sw[0]
            i = int(torch.nonzero(k[1:] == k[:-1])[0, 0])
            bits[[i, i + 1]] = bits[[i + 1, i]]
        else:
            bits[bits.shape[0] // 2] ^= 1
        return sw, (v,)

    monkeypatch.setattr(hw_engine, "sort_words_presort_guard", sort_fault)


def test_a_sound_run_is_correct():
    out = run_cell(2**31 + 111)
    assert out["correct"], out["checks"]
    assert out["checks"]["checked_calls"]["value"] >= 1


def test_the_control_is_not_correct():
    """The control reverses the values of equal keys, which shows only where
    keys tie: at 40M uniform keys ~186,000 pairs do, at 3,000 none; so here
    the keys are drawn with many ties (each the AND of 4 words)."""
    ref = manifest.resolve(BENCH, CELL)["reference"]
    out = run_cell(2**31 + 222, call=ref.control, and_of=4)
    assert not out["correct"]
    assert out["checks"]["wrong_elements"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_each_payload_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    plant(monkeypatch, fault)
    out = run_cell(2**31 + 333, and_of=4 if fault == "tied_values_swapped" else None)
    assert not out["correct"]
    assert out["checks"]["wrong_elements"]["value"] > 0


def test_a_call_that_writes_into_its_payload_is_not_correct():
    fn = program.entry(manifest.resolve(BENCH, CELL)["config"])

    def into_payload(inputs):
        keys, values = fn(inputs["keys"], inputs["payload"])
        inputs["payload"].copy_(values)
        return keys, values
    out = run_cell(2**31 + 444, call=into_payload)
    assert not out["correct"]
    assert out["checks"]["changed_input_elements"]["value"] > 0


def test_a_traced_cpu_run_reads_the_payload_spans_and_no_sweep(tmp_path, monkeypatch):
    """On the CPU the sort takes torch.sort: ``payload_host_ms`` reads the
    payload spans, ``k0_pairs_sweep_ms`` finds no k0_sweep and reads None."""
    monkeypatch.setattr(spanfold, "TRACES", tmp_path)
    out = run_cell(2**31 + 555, trace=True, trace_path=tmp_path / f"{CELL}.trace.json")
    assert out["correct"], out["checks"]
    values = {m["name"]: read(out["record"])
              for m, read in manifest.resolve(BENCH, CELL)["per_layer"]}
    assert values["payload_host_ms"] > 0 and values["k0_pairs_sweep_ms"] is None


def test_the_pool_and_its_payload_repeat_from_the_seed():
    """The mix's pool is keys and a float32 payload in [0, 1), each input's
    two tensors of one length, the same from one seed and not from the next
    (``test_sortbench_yardstick.py``'s pool test holds keys alone)."""
    c = manifest.resolve(BENCH, CELL)
    mix = dict(c["mix"], sizes={"fixed": 20_000, "count": 2})
    seed = 2**31 + 17
    a, b, d = (generator.make_pool(mix, s, "cpu", c["config"]) for s in (seed, seed, seed + 1))
    for x, y in zip(a, b):
        assert set(x) == {"keys", "payload"}
        assert x["keys"].dtype == torch.uint32 and x["payload"].dtype == torch.float32
        assert x["keys"].shape == x["payload"].shape == (20_000,)
        assert x["keys"].is_contiguous() and x["payload"].is_contiguous()
        assert 0 <= float(x["payload"].min()) and float(x["payload"].max()) < 1
        for k in x:
            assert torch.equal(x[k].view(torch.int32), y[k].view(torch.int32))
    for k in ("keys", "payload"):
        assert not torch.equal(a[0][k].view(torch.int32), d[0][k].view(torch.int32))


def test_least_bytes_of_a_40m_pairs_call():
    config = manifest.resolve(BENCH, CELL)["config"]
    assert roofline.least_bytes(config, 40_000_000) == 640_000_000
    assert 640e6 / roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") * 1e3 == \
        pytest.approx(0.191, abs=1e-3)     # ms
