"""The program's spans in a trace: :mod:`sortbench.spanfold`, the readers of
``dispatch_host_ms``, ``host_reads_per_call`` and ``dispatch_idle_ms``, and
``tracefold`` unchanged by the spans."""

import json
import time

import pytest

from sortbench import harness, manifest, program, spanfold, tracefold

BENCH = manifest.load()
NEW = ("dispatch_host_ms", "host_reads_per_call", "dispatch_idle_ms")


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def _ann(name, ts, dur, tid=1):
    return _x(name, "user_annotation", ts, dur, tid)


def _calls():
    """Two calls and their device work, with no span of the program."""
    return [
        _ann(tracefold.SPAN, 100, 100),
        _ann(tracefold.SPAN, 210, 90),
        _x("cudaLaunchKernel", "cuda_runtime", 112, 3),
        _x("aten::item", "cpu_op", 150, 40),
        _x("cudaStreamSynchronize", "cuda_runtime", 160, 30),
        _x("k0_sweep_kernel", "kernel", 130, 40, tid=7),
        _x("Memcpy DtoH", "gpu_memcpy", 185, 5, tid=7),
        _x("k0_sweep_kernel", "kernel", 230, 50, tid=7),
    ]


def _spans():
    """The program's spans of the two calls, one on another thread and one
    after the window."""
    return [
        _ann("rst.sort", 102, 96),            # call 1: sort > encode, k0 > read, decode
        _ann("rst.encode", 104, 4),
        _ann("rst.k0", 110, 80),
        _ann("rst.read", 150, 40),
        _ann("rst.decode", 192, 4),
        _ann("rst.sort", 212, 80),            # call 2: sort > launch, read
        _ann("rst.launch", 214, 6),
        _ann("rst.read", 260, 20),
        _ann("rst.read", 120, 50, tid=2),     # another thread
        _ann("rst.sort", 400, 10),            # after the window
    ]


def test_spanfold_reads_durations_and_counts():
    got = spanfold.fold(_calls() + _spans())
    assert got["calls"] == 2 and got["window_s"] == pytest.approx(200e-6)
    assert got["counts"] == {"rst.sort": 2, "rst.encode": 1, "rst.k0": 1, "rst.read": 2,
                             "rst.decode": 1, "rst.launch": 1}
    assert got["seconds"]["rst.sort"] == pytest.approx(176e-6)
    assert got["seconds"]["rst.read"] == pytest.approx(60e-6)
    # the two calls' outermost spans, 96 + 80 us, less their reads, 40 + 20
    assert got["dispatch_s"] == pytest.approx(116e-6)


def test_a_read_outside_every_span_is_no_dispatch():
    got = spanfold.fold(_calls() + [_ann("rst.read", 150, 40), _ann("rst.k0", 212, 10)])
    assert got["counts"] == {"rst.read": 1, "rst.k0": 1}
    assert got["dispatch_s"] == pytest.approx(10e-6)


def test_spanfold_needs_the_calls():
    with pytest.raises(ValueError):
        spanfold.fold(_spans())


def test_tracefold_keeps_its_record_and_names_the_spans_in_the_idle():
    """The spans leave every number of tracefold's record as it was, and
    only take over idle time that no host op held."""
    before = tracefold.fold(_calls())
    after = tracefold.fold(_calls() + _spans())
    assert before == {
        "calls": 2, "window_s": pytest.approx(200e-6), "busy_s": pytest.approx(95e-6),
        "device_ops": 3,
        "op_seconds": {"k0_sweep_kernel": pytest.approx(90e-6),
                       "Memcpy DtoH": pytest.approx(5e-6)},
        "idle_seconds": {"cudaLaunchKernel": pytest.approx(3e-6),
                         "cudaStreamSynchronize": pytest.approx(15e-6),
                         tracefold.NO_HOST_OP: pytest.approx(87e-6)}}
    assert {k: after[k] for k in ("calls", "window_s", "busy_s", "device_ops",
                                  "op_seconds")} == \
        {k: before[k] for k in ("calls", "window_s", "busy_s", "device_ops", "op_seconds")}
    # the innermost host op of each idle stretch: a torch op or a runtime call
    # inside a span keeps its time; the rest of the spans' time was no host op's
    assert after["idle_seconds"] == {
        "cudaLaunchKernel": pytest.approx(3e-6), "cudaStreamSynchronize": pytest.approx(15e-6),
        "rst.sort": pytest.approx(32e-6), "rst.k0": pytest.approx(17e-6),
        "rst.encode": pytest.approx(4e-6), "rst.decode": pytest.approx(4e-6),
        "rst.launch": pytest.approx(6e-6), tracefold.NO_HOST_OP: pytest.approx(24e-6)}


def _readers():
    return {m["name"]: manifest.load_module(manifest.reader_path(manifest.ROOT, m["name"]),
                                            f"spans_reader_{m['name']}").read
            for m in BENCH["per_layer"] if m["name"] in NEW}


def test_the_readers_read_the_runs_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(spanfold, "TRACES", tmp_path)
    events = _calls() + _spans()
    (tmp_path / "cell.trace.json").write_text(json.dumps({"traceEvents": events}))
    (tmp_path / "other.trace.json").write_text(json.dumps({"traceEvents": _calls()[1:]}))
    r = _readers()
    rec = tracefold.fold(events)
    assert r["dispatch_host_ms"](rec) == pytest.approx(116e-3 / 2)
    assert r["host_reads_per_call"](rec) == 1.0
    assert r["dispatch_idle_ms"](rec) == pytest.approx(63e-3 / 2)


def test_the_readers_find_nothing_without_spans(tmp_path, monkeypatch):
    """A program without spans (the parent of the change that added them)
    and a trace that is not the run's read as None."""
    monkeypatch.setattr(spanfold, "TRACES", tmp_path)
    r = _readers()
    rec = tracefold.fold(_calls())
    assert all(read(rec) is None for read in r.values())            # no trace at all
    (tmp_path / "cell.trace.json").write_text(json.dumps({"traceEvents": _calls()}))
    assert all(read(rec) is None for read in r.values())            # a trace with no span
    (tmp_path / "cell.trace.json").write_text(json.dumps({"traceEvents": _calls() + _spans()}))
    later = dict(rec, window_s=rec["window_s"] * 2)                 # another run's record
    assert r["dispatch_host_ms"](later) is None and r["host_reads_per_call"](later) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_cpu_run_reports_the_spans(cell, tmp_path, monkeypatch):
    """The program on the CPU (the presorted guard, then torch.sort): one
    read a call, and every new metric reported."""
    monkeypatch.setattr(spanfold, "TRACES", tmp_path)
    c = manifest.resolve(BENCH, cell)
    mix = dict(c["mix"], sizes={"fixed": 3000, "count": 3}, trace_calls=6)
    fn, ref = program.entry(c["config"]), c["reference"]
    out = harness.run(c["config"], ref, mix, 2**31 + 21, 0.1, True, "cpu",
                      lambda inputs: ref.call(fn, inputs), time.perf_counter(),
                      tmp_path / f"{cell}.trace.json")
    assert out["correct"], out["checks"]
    rec = out["record"]
    folded = spanfold.of(rec)
    top = "rst." + c["config"]["entry"]
    assert folded["counts"][top] == 6 and folded["counts"][spanfold.READ] == 6
    assert folded["counts"]["rst.torch_sort"] == 6 and "rst.k0" not in folded["counts"]
    values = {name: read(rec) for name, read in _readers().items()}
    assert values["host_reads_per_call"] == 1.0
    assert 0 < values["dispatch_host_ms"] < 1e3 * folded["seconds"][top] / 6
