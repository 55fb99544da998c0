"""The port's measurement utilities against the JAX package's.

``radix_sorting_tpu_torch.utils`` (keyfile, verify, timing) on the CPU: the
key file byte for byte, the oracles' answers on the same inputs as
``radix_sorting_tpu.utils.verify``, the rate counters, and the timers'
contracts. A time measured here is the CPU's; the tests check only that it
is a positive number and what the stream counts.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from radix_sorting_tpu.utils import keyfile as jkeyfile
from radix_sorting_tpu.utils import timing as jtiming
from radix_sorting_tpu.utils import verify as jverify
from radix_sorting_tpu_torch.utils import keyfile, timing, verify


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


# ---------------------------------------------------------------------------
# keyfile


@pytest.mark.parametrize("count", [1, 4097, 1_000_003])
def test_generate_keys_bytes_equal_jax(count):
    got = keyfile.generate_keys(count)
    assert got.dtype == np.uint32
    assert got.tobytes() == jkeyfile.generate_keys(count).tobytes()


def test_default_keyfile_is_the_repos_data_file():
    assert keyfile.default_keyfile() == jkeyfile.default_keyfile()
    assert keyfile.default_keyfile("elsewhere").as_posix() == "elsewhere/40M_32bit_keys.dat"


def test_write_read_round_trip(tmp_path):
    keys = keyfile.generate_keys(10_000, seed=7)
    path = tmp_path / "sub" / "keys.dat"
    keyfile.write_keyfile(path, keys)
    assert path.read_bytes() == keys.astype("<u4").tobytes()
    assert np.array_equal(keyfile.read_keyfile(path), keys)
    assert np.array_equal(keyfile.read_keyfile(path, 123), keys[:123])
    assert np.array_equal(keyfile.read_keyfile(path, 1 << 30), keys)    # past the end
    as_u64 = keyfile.read_keyfile(path, 100, dtype=np.uint64)
    assert np.array_equal(as_u64, keys[:200].view(np.uint64))
    assert np.array_equal(jkeyfile.read_keyfile(path, 123), keyfile.read_keyfile(path, 123))


def test_load_or_create_grows_and_keeps_the_prefix(tmp_path, monkeypatch):
    monkeypatch.setattr(keyfile, "DEFAULT_COUNT", 1000)
    path = tmp_path / "keys.dat"
    first = keyfile.load_or_create(500, path)
    assert path.stat().st_size == 4 * 1000 and first.size == 500
    grown = keyfile.load_or_create(3000, path)
    assert path.stat().st_size == 4 * 3000
    assert np.array_equal(grown[:500], first)
    assert np.array_equal(grown, keyfile.generate_keys(3000))
    # a smaller request reads, and leaves the file as it is
    assert np.array_equal(keyfile.load_or_create(10, path), first[:10])
    assert path.stat().st_size == 4 * 3000
    monkeypatch.setattr(jkeyfile, "DEFAULT_COUNT", 1000)
    jpath = tmp_path / "jax.dat"
    jkeyfile.load_or_create(3000, jpath)
    assert jpath.read_bytes() == path.read_bytes()


# ---------------------------------------------------------------------------
# verify, against the JAX package on the same inputs


def _f32_with_specials():
    x = rng_of(1).standard_normal(2000).astype(np.float32)
    x[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan]
    x[6:9] = np.array([0x7FC00001, 0xFFC00002, 0x7F800005], np.uint32).view(np.float32)
    return x


def _desc(a):
    """``a`` in the descending KDF order."""
    from radix_sorting_tpu_torch import SortConfig, sort
    return sort(a, config=SortConfig(descending=True), device="cpu")


def _asc(a):
    from radix_sorting_tpu_torch import sort
    return sort(a, device="cpu")


def _sorted_cases():
    f = _f32_with_specials()
    u = rng_of(2).integers(0, 1 << 64, size=3000, dtype=np.uint64)
    u[:4] = [0, 1, 2**64 - 1, 2**63]
    i8 = rng_of(3).integers(-128, 128, size=500).astype(np.int8)
    return {"f32": f, "u64": u, "i8": i8}


@pytest.mark.parametrize("name", ["f32", "u64", "i8"])
@pytest.mark.parametrize("order", ["ascending", "descending", "raw", "flipped"])
def test_is_sorted_matches_jax(name, order):
    x = _sorted_cases()[name]
    a = {"ascending": lambda: _asc(x), "descending": lambda: _desc(x),
         "raw": lambda: x, "flipped": lambda: _asc(x)[::-1].copy()}[order]()
    for descending in (False, True):
        want = jverify.is_sorted(a, descending)
        assert verify.is_sorted(a, descending, device="cpu") == want
        assert verify.is_sorted(torch.from_numpy(a.view(f"i{a.itemsize}"))
                                .view(getattr(torch, a.dtype.name)), descending) == want
    assert verify.is_sorted(a, order == "descending", device="cpu") == (
        order in ("ascending", "descending"))


def test_is_sorted_float_specials_order():
    # -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN
    a = np.array([-np.nan, -np.inf, -1.0, -0.0, 0.0, 1.0, np.inf, np.nan], np.float32)
    a[0] = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    assert jverify.is_sorted(a) and verify.is_sorted(a, device="cpu")
    b = a.copy()
    b[3], b[4] = b[4], b[3]                            # +0 before -0
    assert not jverify.is_sorted(b) and not verify.is_sorted(b, device="cpu")


def _perm_cases():
    p = rng_of(4).permutation(1000).astype(np.int32)
    dup = p.copy()
    dup[5] = dup[6]
    out = p.copy()
    out[7] = 1000
    neg = p.copy()
    neg[0] = -1
    return {"permutation": (p, None), "one index twice": (dup, None),
            "index past n": (out, None), "negative index": (neg, None),
            "short": (p[:999], 1000), "identity as uint32": (np.arange(64, dtype=np.uint32), None),
            "empty": (np.zeros(0, np.int32), None)}


@pytest.mark.parametrize("case", list(_perm_cases()))
def test_is_permutation_matches_jax(case):
    p, n = _perm_cases()[case]
    want = jverify.is_permutation(p, n)
    assert want == (case in ("permutation", "identity as uint32", "empty"))
    assert verify.is_permutation(p, n, device="cpu") == want
    assert verify.is_permutation(torch.from_numpy(p.view(np.int32)), n) == want


def test_same_multiset_matches_jax():
    f = _f32_with_specials()
    shuffled = f[rng_of(5).permutation(f.size)]
    other = f.copy()
    other[4] = np.array([0x7FC00003], np.uint32).view(np.float32)[0]  # another NaN payload
    u = _sorted_cases()["u64"]
    for a, b, want in ((f, shuffled, True), (f, other, False), (f, f[:-1], False),
                       (u, u[::-1], True), (u, u + np.uint64(1), False)):
        assert jverify.same_multiset(a, b) == want
        assert verify.same_multiset(a, b) == want
    assert verify.same_multiset(torch.from_numpy(f), shuffled)


@pytest.mark.parametrize("name", ["f32", "u64"])
def test_rank_is_stable_sort_matches_jax(name):
    x = _sorted_cases()[name].copy()
    x[100:200] = x[0]                                  # a run of equal keys
    for descending in (False, True):
        rk = _rank_keys(x, descending)
        stable = np.argsort(rk, kind="stable").astype(np.int32)
        first = np.flatnonzero(rk[stable] == rk[0])[:2]
        unstable = stable.copy()
        unstable[first] = unstable[first[::-1]]        # two equal keys out of order
        for perm, want in ((stable, True), (unstable, False), (stable[::-1].copy(), False)):
            assert jverify.rank_is_stable_sort(x, perm, descending) == want
            assert verify.rank_is_stable_sort(x, perm, descending, device="cpu") == want
            t = torch.from_numpy(x.view(f"i{x.itemsize}")).view(getattr(torch, x.dtype.name))
            assert verify.rank_is_stable_sort(t, torch.from_numpy(perm), descending) == want


def _rank_keys(x, descending):
    """Sort keys whose order is the KDF order of ``x`` (descending: reversed)."""
    from radix_sorting_tpu_torch.ops import kdf
    words = kdf.encode(kdf.as_tensor(x, "cpu"), descending, x.dtype)
    u = [w.numpy().view(np.uint32).astype(np.uint64) for w in words]
    return u[0] if len(u) == 1 else (u[0] << np.uint64(32)) | u[1]


def test_rank_is_stable_sort_refuses_a_broken_permutation():
    x = rng_of(6).integers(0, 10, size=300).astype(np.uint32)
    p = np.argsort(x, kind="stable").astype(np.int32)
    p[3] = p[4]
    assert jverify.rank_is_stable_sort(x, p) is False
    assert verify.rank_is_stable_sort(x, p, device="cpu") is False


# ---------------------------------------------------------------------------
# timing


@pytest.mark.parametrize("n,ms,itemsize", [(40_000_000, 74.5, 4), (10, 0.001, 8), (1, 3.0, 1)])
def test_counters_equal_jax(n, ms, itemsize):
    assert timing.counters(n, ms, itemsize) == jtiming.counters(n, ms, itemsize)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32, torch.uint8,
                                   torch.int64])
def test_steady_timers_are_positive_on_the_cpu(dtype):
    x = torch.arange(4096, dtype=torch.int64).to(dtype)
    seen = []

    def fn(c):
        seen.append(c.clone())
        return torch.sort(c).values
    assert timing.steady_chain_ms(fn, x, reps=3, repeats=2) > 0
    assert timing.steady_state_ms(lambda c: torch.sort(c).values, x, reps=2) > 0
    assert all(s.dtype == dtype for s in seen)
    # the chain feeds every call fresh data
    assert not torch.equal(seen[0], seen[1])
    assert timing.steady_chain_ms(lambda c, a: torch.sort(c).values[a], x, reps=2,
                                  aux=torch.arange(8)) > 0


def test_stream_gbps_is_positive_on_the_cpu():
    assert timing.stream_gbps(1 << 16, reps=3, device="cpu") > 0
    x = torch.arange(1 << 12, dtype=torch.int32)
    assert timing.stream_gbps(x=x, reps=2) > 0
    assert torch.equal(x, torch.arange(1 << 12, dtype=torch.int32))   # x is not written


class _Passes(TorchDispatchMode):
    """Every aten call, with the bytes its tensors hold."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tensors = [a for a in args if torch.is_tensor(a) and a.dim() > 0]   # not scalars
        self.calls.append((func, sum(t.numel() * t.element_size() for t in tensors)
                           + out.numel() * out.element_size()))
        return out


def test_stream_counts_the_bytes_of_the_passes_it_launches():
    n = 1000
    c = torch.arange(n, dtype=torch.int32)
    with _Passes() as mode:
        timing.stream_step(c)
    # in-place elementwise passes: each reads and writes the n words once
    assert len(mode.calls) == timing.STREAM_PASSES
    assert sum(b for _, b in mode.calls) == timing.stream_bytes_per_iter(n) == 16 * n
    want = (torch.arange(n, dtype=torch.int64) * 2654435761 + 1) & 0xFFFFFFFF
    assert torch.equal(c.long() & 0xFFFFFFFF, want)


def test_loop_ms_runs_the_body_reps_times_per_run():
    calls = []
    ms = timing.loop_ms(lambda: calls.append(1), reps=5, repeats=3, device="cpu")
    assert ms >= 0 and len(calls) == 5 * 4            # one warm run, three timed


def test_trace_and_device_op_table(tmp_path):
    x = torch.arange(1 << 12, dtype=torch.int32)
    with timing.trace(tmp_path / "t"):
        torch.sort(x)
    assert timing.device_op_table(tmp_path / "t") == []   # no device on the CPU
    events = [{"ph": "X", "cat": "kernel", "name": "k1", "dur": 2.5},
              {"ph": "X", "cat": "kernel", "name": "k1", "dur": 1.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "dur": 4.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "dur": 50.0},
              {"ph": "i", "cat": "kernel", "name": "marker"}]
    (tmp_path / "s").mkdir()
    (tmp_path / "s" / "trace.json").write_text(__import__("json").dumps({"traceEvents": events}))
    assert timing.device_op_table(tmp_path / "s") == [
        {"op": "Memcpy DtoD", "total_us": 4.0, "calls": 1},
        {"op": "k1", "total_us": 3.5, "calls": 2}]
    with pytest.raises(FileNotFoundError):
        timing.device_op_table(tmp_path / "none")
