"""The port's spans (``utils.timing.span``) on the CPU.

Under ``utils.timing.trace`` the sort path marks its steps with spans named
in ``utils.timing.SPANS``: the public call, the key transform each way, the
sorter it took, the presorted guard, K0's live digits, ``sort_pairs``' work
on the payload tree each way, each read of device data on the host and each
kernel's enqueue. Here: the spans' nesting and order on the ``torch.sort``
route of CPU tensors and through K0's plain passes, one read a K0 call, and
that with no profiler a span is one shared null context (no
``record_function`` is built). The benchmark reads the spans by their
prefix (``sortbench.spanfold.PREFIX``); ``payload_host_ms`` reads the
payload spans of a folded trace.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import radix_sorting_tpu_torch as rt
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import hw_engine, lsd_engine
from radix_sorting_tpu_torch.utils import timing
from sortbench import manifest, spanfold, tracefold

N = 5000
PORT = Path(rt.__file__).resolve().parent


def u32(n=N, seed=1, ordered=False):
    x = np.random.Generator(np.random.PCG64(seed)).integers(0, 1 << 32, n, dtype=np.uint32)
    return np.sort(x) if ordered else x


def traced(tmp_path, fn):
    """(fn's result, the tree of the program's spans under trace): each node
    (name, [children]), in the order they began."""
    with timing.trace(tmp_path):
        out = fn()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith(spanfold.PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    root: list = []
    stack = [(float("inf"), root)]
    for s, e, name in spans:
        while s >= stack[-1][0]:
            stack.pop()
        node = (name, [])
        stack[-1][1].append(node)
        stack.append((e, node[1]))
    return out, root


def names(nodes):
    return [n for n, _ in nodes]


def flat(nodes):
    return [n for name, kids in nodes for n in [name] + flat(kids)]


@pytest.fixture
def k0(monkeypatch):
    """One-plane sorts through K0's plain passes on CPU tensors."""
    real = hw_engine.sorter_route
    monkeypatch.setattr(hw_engine, "sorter_route",
                        lambda device_type, planes, n: "k0" if planes == 1
                        else real(device_type, planes, n))


# entry point: (call, its outermost span, the spans between the encode and the
# sorter, the spans after the sorter)
ENTRIES = {
    "sort": (lambda x: rt.sort(x), timing.SORT, [], [timing.DECODE]),
    "argsort": (lambda x: rt.argsort(x), timing.ARGSORT, [], []),
    "sort_pairs": (lambda x: rt.sort_pairs(x, torch.arange(N))[0], timing.SORT_PAIRS,
                   [timing.PAYLOAD], [timing.DECODE, timing.PAYLOAD]),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_points_nest_their_spans_on_the_torch_sort_route(tmp_path, entry):
    fn, top, head, tail = ENTRIES[entry]
    keys = u32()
    out, tree = traced(tmp_path, lambda: fn(torch.from_numpy(keys.view(np.int32))
                                            .view(torch.uint32)))
    want = np.argsort(keys, kind="stable") if entry == "argsort" else np.sort(keys)
    assert np.array_equal(out.view(torch.int32).numpy().view(np.uint32), want)
    assert names(tree) == [top]
    assert names(tree[0][1]) == [timing.ENCODE] + head + [timing.GUARD, timing.READ,
                                                          timing.TORCH_SORT] + tail
    assert flat(tree).count(timing.READ) == 1 and timing.K0 not in flat(tree)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_points_through_k0_read_once_inside_it(tmp_path, k0, entry):
    fn, top, head, tail = ENTRIES[entry]
    keys = torch.from_numpy(u32(seed=2).view(np.int32)).view(torch.uint32)
    _, tree = traced(tmp_path, lambda: fn(keys))
    assert names(tree) == [top]
    assert names(tree[0][1]) == [timing.ENCODE] + head + [timing.K0] + tail
    (k0_span,) = [kids for name, kids in tree[0][1] if name == timing.K0]
    assert names(k0_span) == [timing.LIVE_DIGITS, timing.READ] + [timing.K0_PASS] * 4
    assert flat(tree).count(timing.READ) == 1 and timing.TORCH_SORT not in flat(tree)


@pytest.mark.parametrize("ordered,passes", [(False, 4), (True, 0)])
def test_k0_reads_once_after_the_guard_and_the_live_digits(tmp_path, monkeypatch,
                                                           ordered, passes):
    """K0's one read comes after the live digits' enqueue, which holds the
    guard (no span of its own), and a pass span a live digit after it; an
    ordered input under the guard emits its read and no pass."""
    sweeps = []
    real = ck.k0_sweep
    monkeypatch.setattr(ck, "k0_sweep", lambda *a, **k: sweeps.append(1) or real(*a, **k))
    w = torch.from_numpy(u32(seed=3, ordered=ordered).view(np.int32))
    (out,), _, _ = lsd_engine.sort_words_k0((w,), guard=True)
    _, tree = traced(tmp_path, lambda: lsd_engine.sort_words_k0((w,), guard=True))
    assert np.array_equal(out.numpy().view(np.uint32), np.sort(w.numpy().view(np.uint32)))
    assert tree == [(timing.K0, [(timing.LIVE_DIGITS, []), (timing.READ, [])]
                     + [(timing.K0_PASS, [])] * passes)]
    assert len(sweeps) == 2 * passes          # the untraced call and the traced one


@pytest.mark.parametrize("entry", sorted(ENTRIES) + ["k0"])
def test_with_no_profiler_a_span_builds_no_record_function(monkeypatch, entry):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert timing.span(timing.SORT) is timing.span(timing.READ)
    keys = torch.from_numpy(u32(seed=4).view(np.int32))
    if entry == "k0":
        (out,), _, _ = lsd_engine.sort_words_k0((keys,), guard=True)
        assert np.array_equal(out.numpy().view(np.uint32), np.sort(u32(seed=4)))
    else:
        ENTRIES[entry][0](keys.view(torch.uint32))


def test_span_records_while_a_profiler_runs(tmp_path):
    off = timing.span(timing.LAUNCH)
    with timing.trace(tmp_path):
        on = timing.span(timing.LAUNCH)
        with on:
            assert on is not off and isinstance(on, torch.profiler.record_function)
    assert timing.span(timing.LAUNCH) is off
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert [e["cat"] for e in events if e.get("name") == timing.LAUNCH] == ["user_annotation"]


@pytest.mark.parametrize("entry", ["sort_pairs", "argsort"])
def test_payload_host_ms_reads_the_payload_spans_of_a_folded_trace(tmp_path, monkeypatch,
                                                                    entry):
    """Two calls in the benchmark's call spans, folded as a traced run's
    record: ``sort_pairs`` gives ``payload_host_ms`` a positive reading,
    inside its public span's time; ``argsort`` opens no payload span and
    reads None, not 0."""
    monkeypatch.setattr(spanfold, "TRACES", tmp_path)
    read = manifest.load_module(manifest.reader_path(manifest.ROOT, "payload_host_ms"),
                                "payload_host_ms_reader").read
    keys = torch.from_numpy(u32(seed=5).view(np.int32)).view(torch.uint32)
    values = torch.rand(N)
    fn = {"sort_pairs": lambda: rt.sort_pairs(keys, values),
          "argsort": lambda: rt.argsort(keys)}[entry]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with torch.profiler.record_function(tracefold.SPAN):
                fn()
    path = tmp_path / "cell.trace.json"
    prof.export_chrome_trace(str(path))
    record = tracefold.fold(json.loads(path.read_text())["traceEvents"])
    folded = spanfold.of(record)
    assert folded["calls"] == 2
    if entry == "argsort":
        assert timing.PAYLOAD not in folded["counts"] and read(record) is None
    else:
        assert folded["counts"][timing.PAYLOAD] == 4           # each way, each call
        assert 0 < read(record) < 1e3 * folded["seconds"][timing.SORT_PAIRS] / 2


@pytest.mark.parametrize("name", timing.SPANS)
def test_span_names_carry_the_benchmarks_prefix(name):
    assert name.startswith(spanfold.PREFIX) and timing.SPANS.count(name) == 1
    assert spanfold.READ == timing.READ


def _span_calls(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id",
                                                  getattr(node.func, "attr", None)) == "span":
            yield node


SOURCES = sorted(p for p in PORT.rglob("*.py") if any(_span_calls(p)))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PORT)))
def test_every_span_of_the_port_is_named_by_a_constant(path):
    """A span's name is one of ``utils.timing``'s constants, never a string
    written where it is opened."""
    for call in _span_calls(path):
        arg = call.args[0]
        name = arg.attr if isinstance(arg, ast.Attribute) else getattr(arg, "id", None)
        assert getattr(timing, str(name), None) in timing.SPANS, (path, ast.dump(arg))


def test_the_sort_path_opens_every_span():
    used = {getattr(timing, getattr(a, "attr", getattr(a, "id", "")), None)
            for p in SOURCES for a in (c.args[0] for c in _span_calls(p))}
    assert used == set(timing.SPANS)
