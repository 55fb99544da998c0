"""``sort`` with ``device_probe`` / ``dynamic_probe`` against the JAX package.

The same keys (numpy, from a seed) and configuration go to both packages,
once on the JAX package's CPU routes (where it skips the range probe and
sorts) and once under ``RST_FORCE_TPU_ROUTES=1``, where both run their
probes. The JAX probe decides inside ``lax.cond`` and traces both branches,
so the route the port takes is held against the branch the data selects.
Tolerance: exact equality (sorted bit patterns).
"""

import dataclasses

import numpy as np
import pytest
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu_torch.ops import counting_engine as tce
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import hw_engine

from test_torch_kdf import raw
from test_torch_sort import forced_tpu_routes, jax_in  # noqa: F401


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


def both(x, value_mask=None, **cfg):
    """(port output, JAX output) of ``sort`` under the same config."""
    jcfg = rst.SortConfig(**cfg)
    tcfg = rt.SortConfig.from_dict(dataclasses.asdict(jcfg))
    want = np.asarray(rst.sort(jax_in(x), config=jcfg, value_mask=value_mask))
    got = rt.sort(x, config=tcfg, device="cpu", value_mask=value_mask)
    assert isinstance(got, np.ndarray) and got.dtype == x.dtype
    return got, want


def u64(base, n, span, seed):
    return np.uint64(base) + rng_of(seed).integers(0, span, size=n).astype(np.uint64)


# name -> (keys, the port's route under the probe)
PROBE_CASES = {
    "u32 narrow (K1+K4)": (lambda: (np.uint64(0x9E3779B9) + rng_of(1).integers(
        0, 1000, size=200_000).astype(np.uint64)).astype(np.uint32),
        ["hist", "regen"]),
    "u32 2^11 range (K1+K7)": (lambda: rng_of(2).integers(
        5_000_000, 5_000_000 + 2048, size=300_000).astype(np.uint32),
        ["hist", "regen_win"]),
    "u32 full entropy": (lambda: rng_of(3).integers(
        0, 1 << 32, size=100_003, dtype=np.uint32), ["sort"]),
    "u32 presorted": (lambda: np.sort(rng_of(4).integers(
        0, 1 << 32, size=100_003, dtype=np.uint32)), []),
    "i32 in [-500, 500]": (lambda: rng_of(5).integers(
        -500, 501, size=100_003).astype(np.int32), ["hist", "regen"]),
    "u32 across 0x80000000": (lambda: (np.uint64(0x7FFFFE00) + rng_of(6).integers(
        0, 1000, size=100_003).astype(np.uint64)).astype(np.uint32), ["hist", "regen"]),
    "f32 narrow band": (lambda: np.float32(1.0) + rng_of(7).integers(
        0, 900, size=100_003).astype(np.float32) * np.float32(2 ** -23),
        ["hist", "regen"]),
    "u64 constant hi, narrow lo": (lambda: u64(0x1234567890000000, 100_003, 1000, 8),
                                   ["hist", "regen"]),
    "u64 constant hi, lo in 2^11": (lambda: u64(0x12345678FFFFFA00, 300_000, 1500, 14),
                                    ["hist", "regen_win"]),
    "u64 constant hi, wide lo": (lambda: u64(7 << 32, 100_003, 1 << 32, 9), ["sort"]),
    "u64 varying hi": (lambda: rng_of(10).integers(
        0, 1 << 63, size=100_003, dtype=np.uint64), ["sort"]),
    "i64 constant hi, narrow lo": (lambda: (u64(0, 100_003, 1000, 11).astype(np.int64)
                                            - np.int64(1 << 40)), ["hist", "regen"]),
    "i64 varying hi": (lambda: rng_of(12).integers(
        -(1 << 62), 1 << 62, size=100_003, dtype=np.int64), ["sort"]),
    "u32 n=2": (lambda: np.array([7, 3], np.uint32), ["hist", "regen"]),
}


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_device_probe_matches_jax(case, descending):
    x = PROBE_CASES[case][0]()
    got, want = both(x, device_probe=True, descending=descending)
    assert np.array_equal(raw(got), raw(want))
    order = np.sort(x)
    assert np.array_equal(raw(got), raw(order[::-1] if descending else order))


@pytest.fixture
def probe_route(monkeypatch):
    """What the port's probe ran: the dense kernels, or the sorter."""
    seen = []

    def spy(module, attr, label):
        real = getattr(module, attr)

        def wrapped(*a, **k):
            seen.append(label(*a, **k) if callable(label) else label)
            return real(*a, **k)
        monkeypatch.setattr(module, attr, wrapped)

    spy(ck, "hist", "hist")
    spy(ck, "regen", lambda cum, *a, **k: "regen" if cum.shape[0] <= 1 << 10
        else "regen_win")
    spy(hw_engine, "sort_words", "sort")
    return seen


@pytest.mark.usefixtures("forced_tpu_routes")
class TestForcedProbeRoutes:

    @pytest.mark.parametrize("case", list(PROBE_CASES))
    def test_device_probe(self, probe_route, case):
        x, route = PROBE_CASES[case][0](), PROBE_CASES[case][1]
        got, want = both(x, device_probe=True)
        assert np.array_equal(raw(got), raw(want))
        assert probe_route == route

    def test_device_probe_without_guard(self, probe_route):
        x = np.sort(rng_of(13).integers(0, 1 << 32, size=50_001, dtype=np.uint32))
        got, want = both(x, device_probe=True, detect_presorted=False)
        assert np.array_equal(got, want)
        assert probe_route == ["sort"]

    @pytest.mark.parametrize("name,mask,route", [
        ("uint32", 0xF0F00000, ["hist_pext", "regen_pdep"]),
        ("uint64", 0x0000000F00F00000, ["hist_pext2", "regen_pdep2"]),
    ])
    def test_dynamic_probe(self, monkeypatch, name, mask, route):
        x = rng_of(mask & 0xFFFF).integers(0, 1 << 63, size=70_003).astype(name)
        x &= np.array(mask, dtype=name)
        seen = []
        for attr in route:
            real = getattr(ck, attr)
            monkeypatch.setattr(ck, attr, lambda *a, _r=real, _n=attr, **k:
                                seen.append(_n) or _r(*a, **k))
        got, want = both(x, dynamic_probe=True)
        assert np.array_equal(got, want) and np.array_equal(got, np.sort(x))
        assert seen == route


@pytest.mark.parametrize("x", [
    rng_of(20).integers(0, 1 << 32, size=70_003, dtype=np.uint32) & np.uint32(0xF0F00000),
    rng_of(21).integers(0, 1 << 63, size=70_003, dtype=np.uint64)
    & np.uint64(0xF000000000000F00),
    np.full(5000, 0xDEADBEEF, np.uint32),                  # popcount 0
    rng_of(22).integers(0, 1 << 32, size=70_003, dtype=np.uint32),
], ids=["masked u32", "masked u64", "all equal", "full entropy"])
def test_dynamic_probe_matches_jax(x):
    got, want = both(x, dynamic_probe=True)
    assert np.array_equal(got, want) and np.array_equal(got, np.sort(x))


def test_dynamic_probe_takes_counting_only_for_few_live_bits(monkeypatch):
    calls = []
    real = tce.sort_words_counting
    monkeypatch.setattr(tce, "sort_words_counting",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    cfg = rt.SortConfig(dynamic_probe=True)
    x = rng_of(23).integers(0, 1 << 32, size=4096, dtype=np.uint32)
    rt.sort(x & np.uint32(0xF0F00000), config=cfg, device="cpu")
    rt.sort(np.full(4096, 3, np.uint32), config=cfg, device="cpu")
    rt.sort(x, config=cfg, device="cpu")
    assert calls == [(0xF0F00000,)]


def test_device_probe_defers_to_static_compaction(monkeypatch):
    # a 64-bit value_mask with 18-32 live bits promises the one-operand
    # compacted sorter; the range probe must not pre-empt it
    def boom(*a, **k):
        raise AssertionError("the range probe pre-empted static compaction")
    monkeypatch.setattr(tce, "sort_word_range_probe", boom)
    monkeypatch.setattr(tce, "sort_words2_range_probe", boom)
    mask = (0xFFF << 32) | 0xFFF00000
    x = rng_of(24).integers(0, 1 << 63, size=20_011, dtype=np.uint64) & np.uint64(mask)
    got, want = both(x, device_probe=True, value_mask=mask)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("flag", ["device_probe", "dynamic_probe"])
def test_argsort_and_sort_pairs_ignore_the_probes(flag):
    x = rng_of(25).integers(0, 300, size=20_011).astype(np.uint32)
    pay = rng_of(26).standard_normal(20_011).astype(np.float32)
    cfg = rt.SortConfig(**{flag: True})
    assert np.array_equal(rt.argsort(x, config=cfg, device="cpu"),
                          rt.argsort(x, device="cpu"))
    k1, v1 = rt.sort_pairs(x, pay, config=cfg, device="cpu")
    k0, v0 = rt.sort_pairs(x, pay, device="cpu")
    assert np.array_equal(k1, k0) and np.array_equal(v1, v0)
    t = torch.from_numpy(x.view(np.int32))
    assert torch.equal(rt.rank_sort(t, config=cfg, index_dtype=torch.int64),
                       rt.rank_sort(t, index_dtype=torch.int64))
    jcfg = rst.SortConfig(**{flag: True})
    assert np.array_equal(np.asarray(rst.argsort(jax_in(x), config=jcfg)),
                          rt.argsort(x, config=cfg, device="cpu"))


def test_only_lsd_is_refused():
    # nothing is refused any more: Strategy.LSD ignores the probe flags, as
    # the JAX package's does, and sorts
    x = np.arange(8, dtype=np.uint32)
    assert np.array_equal(rt.sort(x[::-1].copy(), config=rt.SortConfig(
        strategy="lsd", device_probe=True), device="cpu"), x)
    for flag in ("device_probe", "dynamic_probe"):
        assert np.array_equal(rt.sort(x[::-1].copy(), config=rt.SortConfig(**{flag: True}),
                                      device="cpu"), x)
