"""The frozen arithmetic: traffic, the reference, least bytes and peaks,
percentiles, the reduction of a trace, and the metric readers."""

import math

import numpy as np
import pytest
import torch

from sortbench import generator, manifest, reference, roofline, stats, tracefold

BENCH = manifest.load()
MIXES = {w["traffic"]: manifest.resolve(BENCH, w["name"])["mix"] for w in BENCH["workloads"]}
U32 = {"key_dtype": "uint32"}


def _scaled(mix, n=20000):
    return dict(mix, sizes={"fixed": n, "count": 2})


def _pool(mix, seed, config=U32):
    return generator.make_pool(mix, seed, "cpu", config)


# ---------------------------------------------------------------- traffic

@pytest.mark.parametrize("mix", sorted(MIXES))
def test_pool_repeats_from_its_seed(mix):
    m = _scaled(MIXES[mix])
    seed = 2**31 + 17
    a, b, c = _pool(m, seed), _pool(m, seed), _pool(m, seed + 1)
    assert all(torch.equal(x["keys"].view(torch.int32), y["keys"].view(torch.int32))
               for x, y in zip(a, b))
    assert not torch.equal(a[0]["keys"].view(torch.int32), c[0]["keys"].view(torch.int32))
    assert all(set(x) == {"keys"} and x["keys"].dtype == torch.uint32
               and x["keys"].is_contiguous() for x in a)
    assert generator.order(m, seed) == generator.order(m, seed)
    assert sorted(generator.order(m, seed)) == list(range(len(a)))


def test_log_uniform_sizes_are_the_same_for_every_seed():
    mix = {"sizes": {"log_uniform": [2**16, 2**23], "count": 96}}
    ns = generator.sizes(mix)
    assert len(ns) == 96 and ns == sorted(ns) and min(ns) > 2**16 and max(ns) < 2**23
    # the mean of a log-uniform over [2^16, 2^23], (hi - lo) / ln(hi / lo)
    assert sum(ns) / len(ns) == pytest.approx((2**23 - 2**16) / math.log(2**7), rel=0.01)


@pytest.mark.parametrize("mix", ["uniform_40m", "entropy0544_40m"])
def test_headline_mixes_are_40m_keys(mix):
    assert generator.sizes(MIXES[mix]) == [40_000_000] * 8


@pytest.mark.parametrize("and_of", [1, 3])
def test_bit_probability(and_of):
    keys = _pool({"sizes": {"fixed": 200_000, "count": 1}, "keys": {"and_of": and_of}},
                 99)[0]["keys"]
    w = keys.view(torch.int32).numpy().view(np.uint32)
    ones = np.unpackbits(w.view(np.uint8)).mean()
    assert ones == pytest.approx(0.5 ** and_of, abs=0.002)
    if and_of == 3:       # 34% of keys share digit 0 in each 8-bit digit
        assert (w & 0xFF == 0).mean() == pytest.approx((7 / 8) ** 8, abs=0.005)


def test_pool_arrays_start_on_aligned_boundaries():
    pool = _pool({"sizes": {"log_uniform": [100, 1000], "count": 5}}, 3)
    base = pool[0]["keys"].data_ptr()
    assert all((x["keys"].data_ptr() - base) % generator.ALIGN == 0 for x in pool)


def _np(t):
    """A tensor's values in numpy, through its signed view."""
    return reference.signed_view(t).numpy().view(NP[t.dtype])


NP = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.uint32: np.uint32,
      torch.uint64: np.uint64, torch.int8: np.int8, torch.int16: np.int16,
      torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32}


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32", "uint64", "int16", "int64"])
def test_the_configurations_key_dtype_is_the_pools(dtype):
    pool = _pool({"sizes": {"fixed": 4000, "count": 2}}, 5, {"key_dtype": dtype})
    keys = pool[0]["keys"]
    assert keys.dtype == getattr(torch, dtype) and keys.shape == (4000,)
    bits = np.unpackbits(_np(keys).view(np.uint8))
    assert bits.mean() == pytest.approx(0.5, abs=0.02)


def test_a_float_key_dtype_is_refused():
    with pytest.raises(ValueError):
        _pool({"sizes": {"fixed": 10, "count": 1}}, 5, {"key_dtype": "float32"})


@pytest.mark.parametrize("dtype", ["uint32", "uint64", "int32"])
@pytest.mark.parametrize("how", ["sorted", "reversed", "nearly_sorted"])
def test_orders(dtype, how):
    spec = {"order": how, "swap_share": 0.01}
    mix = {"sizes": {"fixed": 10_000, "count": 2}, "keys": spec}
    keys = _np(_pool(mix, 8, {"key_dtype": dtype})[1]["keys"])
    plain = _np(_pool(dict(mix, keys={}), 8, {"key_dtype": dtype})[1]["keys"])
    assert sorted(keys.tolist()) == sorted(plain.tolist())       # the same keys
    want = np.sort(plain)
    if how == "sorted":
        assert np.array_equal(keys, want)
    elif how == "reversed":
        assert np.array_equal(keys, want[::-1])
    else:                                    # 1% of the positions moved, in pairs
        assert (keys != want).sum() == 100


def test_and_of_none_mask_rows_and_payload():
    mix = {"sizes": {"fixed": 3000, "count": 3}, "rows": 4,
           "keys": {"and_of": 0, "mask": "0xF0F00000"}, "payload": {"dtype": "float32"}}
    pool = _pool(mix, 6)
    assert all(x["keys"].shape == (4, 3000) and x["payload"].shape == (4, 3000)
               for x in pool)
    assert set(_np(pool[0]["keys"]).ravel().tolist()) == {0xF0F00000}
    p = torch.cat([x["payload"].reshape(-1) for x in pool])
    assert p.dtype == torch.float32 and 0 <= p.min() and p.max() < 1 and p.std() > 0.25
    masked = _pool(dict(mix, keys={"mask": "0xFF"}, payload={"dtype": "int16"}), 6)
    assert _np(masked[0]["keys"]).max() <= 0xFF and masked[0]["payload"].dtype == torch.int16
    assert _pool(mix, 6)[2]["payload"].equal(pool[2]["payload"])


# ---------------------------------------------------------------- reference

def _keys(n, seed, and_of=1, dtype="uint32", rows=None):
    mix = {"sizes": {"fixed": n, "count": 1}, "keys": {"and_of": and_of}}
    if rows:
        mix["rows"] = rows
    return _pool(mix, seed, {"key_dtype": dtype})[0]["keys"]


@pytest.mark.parametrize("n,and_of", [(1, 1), (2, 1), (1000, 1), (50_000, 4), (20_000, 16)])
def test_reference_sort_and_argsort_match_numpy(n, and_of):
    keys = _keys(n, n + and_of, and_of)
    a = _np(keys)
    assert np.array_equal(_np(reference.sorted_keys(keys)), np.sort(a))
    assert np.array_equal(_np(reference.stable_permutation(keys)),
                          np.argsort(a, kind="stable").astype(np.uint32))


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint64", "int16", "int32", "int64"])
@pytest.mark.parametrize("rows", [None, 3])
def test_reference_of_other_widths_and_rows(dtype, rows):
    keys = _keys(5000, 21, and_of=2, dtype=dtype, rows=rows)
    a = _np(keys)
    assert np.array_equal(_np(reference.sorted_keys(keys)), np.sort(a, axis=-1))
    perm = reference.stable_permutation(keys, torch.int64)
    assert np.array_equal(perm.numpy(), np.argsort(a, axis=-1, kind="stable"))


def test_reference_handles_the_extremes():
    a = np.array([0xFFFFFFFF, 0, 0x80000000, 0x7FFFFFFF, 0xFFFFFFFF, 0], dtype=np.uint32)
    keys = torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    assert np.array_equal(_np(reference.sorted_keys(keys)), np.sort(a))
    assert _np(reference.stable_permutation(keys)).tolist() == [1, 5, 3, 2, 0, 4]
    assert _np(reference.ties_reversed_permutation(keys)).tolist() == [5, 1, 3, 2, 4, 0]
    b = np.array([2**64 - 1, 0, 2**63, 2**63 - 1], dtype=np.uint64)
    k64 = torch.from_numpy(b.view(np.int64)).view(torch.uint64)
    assert np.array_equal(_np(reference.sorted_keys(k64)), np.sort(b))


def test_controls_break_the_stated_guarantee():
    keys = _keys(50_000, 7, and_of=3)                   # many equal keys
    a = _np(keys)
    low = _np(reference.sorted_by_top_bits(keys, 16))
    assert sorted(low.tolist()) == sorted(a.tolist()) and not np.array_equal(low, np.sort(a))
    perm = _np(reference.ties_reversed_permutation(keys))
    assert np.array_equal(a[perm], np.sort(a))
    assert not np.array_equal(perm, np.argsort(a, kind="stable"))


def test_mismatches_counts_elements_and_every_one_of_another_shape_or_dtype():
    a = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    assert reference.mismatches(a, a.clone()) == 0
    assert reference.mismatches(a, torch.tensor([1, 2, 4, 3], dtype=torch.int32)) == 2
    assert reference.mismatches(a[:2], a) == 4
    assert reference.mismatches(a.view(torch.uint32), a) == 4
    f = torch.tensor([float("nan"), 1.0])
    assert reference.mismatches(f, f.clone()) == 0              # bit for bit


# ---------------------------------------------------------------- roofline, percentile

def test_least_bytes_and_the_bound_of_a_40m_call():
    for w in BENCH["workloads"]:
        config = manifest.resolve(BENCH, w["name"])["config"]
        assert roofline.least_bytes(config, 40_000_000) == 320_000_000
    peak = roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3")
    assert peak == 3.35e12
    assert 320e6 / peak * 1e3 == pytest.approx(0.0955, abs=1e-4)   # ms, PERF.md's bound
    assert roofline.peak_bytes_per_s("a card not in the table") is None


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 95) == 5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


# ---------------------------------------------------------------- the trace

def _x(name, cat, ts, dur, tid=1, pid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": pid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    return [
        _x(tracefold.SPAN, "user_annotation", 100, 100),
        _x(tracefold.SPAN, "user_annotation", 210, 90),
        _x("aten::sort", "cpu_op", 100, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 110, 5),
        _x("aten::item", "cpu_op", 150, 40),
        _x("cudaStreamSynchronize", "cuda_runtime", 160, 30),
        _x("k0_sweep_kernel", "kernel", 130, 40, tid=7, pid=0),
        _x("Memcpy DtoH", "gpu_memcpy", 185, 5, tid=7, pid=0),
        _x("k0_sweep_kernel", "kernel", 230, 50, tid=7, pid=0),
        _x("early", "kernel", 50, 60, tid=7, pid=0),          # clipped to the window
        _x("after", "kernel", 400, 10, tid=7, pid=0),         # outside it
        _x("gpu span", "gpu_user_annotation", 100, 200, tid=7, pid=0),
        _x("other thread", "cpu_op", 100, 200, tid=2),
    ]


def test_fold_reduces_a_trace():
    rec = tracefold.fold(_trace())
    assert rec["calls"] == 2
    assert rec["window_s"] == pytest.approx(200e-6)
    # busy: [100,110) + [130,170) + [185,190) + [230,280) = 105 us
    assert rec["busy_s"] == pytest.approx(105e-6)
    assert rec["device_ops"] == 3                         # those that start in the window
    assert rec["op_seconds"]["k0_sweep_kernel"] == pytest.approx(90e-6)
    assert rec["op_seconds"]["early"] == pytest.approx(10e-6)
    idle = rec["idle_seconds"]
    # gaps [110,130) [170,185) [190,230) [280,300): 95 us
    assert sum(idle.values()) == pytest.approx(95e-6)
    assert idle["cudaLaunchKernel"] == pytest.approx(5e-6)       # 110..115, innermost
    assert idle["aten::sort"] == pytest.approx(15e-6)            # 115..130
    assert idle["cudaStreamSynchronize"] == pytest.approx(15e-6)  # 170..185 inside item
    assert "aten::item" not in idle                               # 190 is its end
    assert idle[tracefold.NO_HOST_OP] == pytest.approx(60e-6)     # 190..230, 280..300


def test_fold_counts_only_what_the_calls_launched():
    """A copy the harness launches between calls (correlation 9) is not the
    calls' work; with correlation ids, the rest is matched to its launch."""
    events = _trace()
    runtime = [_x("cudaLaunchKernel", "cuda_runtime", 112, 2, corr=1),
               _x("cudaMemcpyAsync", "cuda_runtime", 181, 2, corr=2),
               _x("cudaLaunchKernel", "cuda_runtime", 215, 2, corr=3),
               _x("cudaMemcpyAsync", "cuda_runtime", 202, 2, corr=9)]
    corr = {(130, "k0_sweep_kernel"): 1, (185, "Memcpy DtoH"): 2,
            (230, "k0_sweep_kernel"): 3}
    for e in events:
        if e["cat"] in tracefold.DEVICE_CATEGORIES:
            e["args"] = {"correlation": corr.get((e["ts"], e["name"]), 8)}
    copy = _x("Memcpy DtoD", "gpu_memcpy", 203, 5, tid=7, pid=0, corr=9)
    rec = tracefold.fold(events + runtime + [copy])
    assert rec["device_ops"] == 3 and "Memcpy DtoD" not in rec["op_seconds"]
    assert "early" not in rec["op_seconds"]              # launched before the window
    assert rec["busy_s"] == pytest.approx(95e-6)         # 40 + 5 + 50


def test_fold_needs_spans():
    with pytest.raises(ValueError):
        tracefold.fold([_x("k", "kernel", 0, 1)])


def test_top_keeps_the_largest_and_cuts_names():
    t = tracefold.top({"a" * 300: 3.0, "b": 1.0, "c": 2.0}, k=2, width=10)
    assert t == [["a" * 10, 3.0], ["c", 2.0]]


def _readers(group):
    return {m["name"]: manifest.load_module(manifest.reader_path(manifest.ROOT, m["name"]),
                                            f"reader_{m['name']}").read
            for m in BENCH[group]}


def test_per_layer_readers():
    r = _readers("per_layer")
    rec = dict(tracefold.fold(_trace()), least_bytes=335_000, peak_bytes_per_s=3.35e12)
    assert r["device_idle_pct"](rec) == pytest.approx(100 * 95 / 200)
    assert r["device_ops_per_call"](rec) == 1.5
    assert r["k0_sweep_ms"](rec) == pytest.approx(90e-6 * 1e3 / 2)
    assert r["sort_roofline"](rec) == pytest.approx(100 * 1e-7 / 105e-6)
    empty = dict(rec, busy_s=0.0, device_ops=0, op_seconds={}, peak_bytes_per_s=None)
    assert all(read(empty) is None for read in r.values())


def test_end_to_end_readers():
    r = _readers("end_to_end")
    rec = {"calls": 20, "keys": 8_000_000_000, "window_s": 10.0, "setup_s": 7.5,
           "latencies_ms": [1.0] * 18 + [2.0, 3.0], "call_mem_bytes": 300 * 2**20}
    assert r["gkeys_per_s"](rec) == 0.8
    assert r["call_ms_p95"](rec) == 2.0
    assert r["call_mem_mib"](rec) == 300
    assert r["setup_s"](rec) == 7.5
    assert r["call_mem_mib"](dict(rec, call_mem_bytes=0)) is None
    assert r["gkeys_per_s"](dict(rec, keys=0)) is None
