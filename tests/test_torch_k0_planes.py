"""K0 over two word planes, on the CPU.

64-bit keys (``uint64``, ``int64``, ``float64``) encode to two int32 planes
(hi, lo), which ``hw_engine`` routes to K0 on the card from
``K0_TWO_PLANE_MIN_KEYS`` keys: one ``hist_multi`` a plane, one read, and up
to eight ``k0_sweep`` passes on one status buffer (epochs 1 to 8), the
digits of lo first, each pass moving both planes. On CPU tensors the route
is ``torch.sort``; here it is monkeypatched to K0 for one and two planes, so
the entry points run K0's pass structure with the plain versions of K1 and
the sweep. Each result is held bit for bit against the JAX package on its
CPU route, against the benchmark's plain-torch reference
(``sortbench.reference``) and against numpy's stable sort of the keys' order
(the KDF's total order: -0.0 below +0.0, NaNs above +inf by payload). One
length, N = 20,000 (three tiles, the last short), so the JAX package
compiles once a dtype and configuration.
"""

import dataclasses

import numpy as np
import pytest
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import hw_engine, kdf, lsd_engine
from sortbench import reference

from test_torch_api import assert_trees_equal, keys
from test_torch_kdf import raw
from test_torch_sort import jax_in

N = 20_000
_TOP = np.uint64(1 << 63)


def cfgs(**kw):
    jcfg = rst.SortConfig(**kw)
    return jcfg, rt.SortConfig.from_dict(dataclasses.asdict(jcfg))


@pytest.fixture
def k0(monkeypatch):
    """Route every one- and two-plane sort to K0 on any device; the K0 calls
    made, as (planes, payloads, keyword arguments)."""
    calls = []
    real_route, real_k0 = hw_engine.sorter_route, lsd_engine.sort_words_k0

    def route(device_type, planes, n):
        return "k0" if planes <= 2 else real_route(device_type, planes, n)

    def sort(words, payloads=(), **kw):
        calls.append((len(words), len(payloads), kw))
        return real_k0(words, payloads, **kw)
    monkeypatch.setattr(hw_engine, "sorter_route", route)
    monkeypatch.setattr(lsd_engine, "sort_words_k0", sort)
    return calls


@pytest.fixture
def passes(monkeypatch):
    """Every ``k0_sweep``: (shift, planes, epoch, status, position,
    index_dtype, the digit plane's index among the planes, whether planes 0
    and 1 come in as a pair, whether they go out as one)."""
    seen = []
    real = ck.k0_sweep

    def spy(w, planes, shift, radix_bits, tile, starts, status, epoch, position=False,
            index_dtype=torch.int32, pair_out=False):
        digit = next(i for i, p in enumerate(planes) if p is w)
        pair_in = kdf.pair_of(planes[0], planes[1]) is not None
        seen.append((shift, len(planes), epoch, status, position, index_dtype, digit,
                     pair_in, pair_out))
        return real(w, planes, shift, radix_bits, tile, starts, status, epoch,
                    position=position, index_dtype=index_dtype, pair_out=pair_out)
    monkeypatch.setattr(ck, "k0_sweep", spy)
    return seen


def order_bits(x: np.ndarray, descending: bool = False) -> np.ndarray:
    """uint64 numbers that order as the KDF orders 64-bit keys (floats:
    negatives reversed below positives, the sign bit set on positives;
    signed: the sign bit flipped), complemented for a descending sort."""
    b = raw(x)
    if x.dtype.kind == "f":
        b = np.where(b >> np.uint64(63) != 0, ~b, b | _TOP)
    elif x.dtype.kind == "i":
        b = b ^ _TOP
    return ~b if descending else b


def want_order(x: np.ndarray, descending: bool = False) -> np.ndarray:
    """The stable order of ``x``'s keys by numpy and by the plain-torch
    reference, which must agree; as int64 positions."""
    bits = order_bits(x, descending)
    by_numpy = np.argsort(bits, kind="stable")
    by_reference = reference.stable_order(
        torch.from_numpy(bits.view(np.int64)).view(torch.uint64)).numpy()
    assert np.array_equal(by_numpy, by_reference)
    return by_numpy


def tied_u64(seed: int, values: int = 500) -> np.ndarray:
    """N u64 keys drawn from ``values`` uniform words: every digit live,
    many ties, so stability shows."""
    rng = np.random.Generator(np.random.PCG64(seed))
    pool = rng.integers(0, 1 << 64, size=values, dtype=np.uint64)
    return pool[rng.integers(0, values, size=N)]


def eight_passes(seen, payload_planes: int = 0, index: bool = False):
    """What the spy sees for keys whose eight digits all live: lo's digits
    first, then hi's, epochs 1 to 8 on one status buffer."""
    assert [(s[0], s[2]) for s in seen] == [(8 * (p % 4), p + 1) for p in range(8)]
    assert all(s[3] is seen[0][3] for s in seen)
    assert [s[6] for s in seen] == [1] * 4 + [0] * 4          # lo is plane 1, hi plane 0
    assert [s[1] for s in seen] == [2 + payload_planes] + [2 + payload_planes + index] * 7


# ---------------------------------------------------------------------------
# the entry points


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["uint64", "int64", "float64"])
def test_sort_of_64_bit_keys_through_k0(k0, passes, name, descending):
    x = keys(name, N, 21 + descending)          # float64: +-0, +-inf, NaN payloads
    jcfg, tcfg = cfgs(descending=descending)
    want = np.asarray(rst.sort(jax_in(x), config=jcfg))
    got = rt.sort(x, config=tcfg, device="cpu")
    assert got.dtype == x.dtype and np.array_equal(raw(got), raw(want))
    assert np.array_equal(raw(got), raw(x)[want_order(x, descending)])
    assert k0 == [(2, 0, dict(index_dtype=None, guard=True))]     # AUTO: the guarded sorter
    eight_passes(passes)
    pair = name == "uint64" and not descending      # the identity KDF: the input's halves
    assert [s[7:] for s in passes] == [(pair, False)] + [(False, False)] * 6 + [(False, pair)]


@pytest.mark.parametrize("index_dtype", [np.uint32, np.int64])
def test_argsort_of_u64_through_k0(k0, passes, index_dtype):
    x = tied_u64(23)
    want = np.asarray(rst.argsort(jax_in(x), index_dtype=index_dtype))
    got = rt.argsort(x, index_dtype=index_dtype, device="cpu")
    assert got.dtype == np.dtype(index_dtype)
    assert np.array_equal(got, want) and np.array_equal(got, want_order(x))
    born = torch.int64 if np.dtype(index_dtype).itemsize == 8 else torch.int32
    assert k0 == [(2, 0, dict(guard=True, index_dtype=born))]     # the sweep writes it
    eight_passes(passes, index=True)
    assert [(s[4], s[5]) for s in passes] == [(True, torch.int32)] + \
        [(False, torch.int32)] * 6 + [(False, born)]
    assert [s[7:] for s in passes] == [(True, False)] + [(False, False)] * 6 + [(False, True)]


def test_sort_pairs_of_u64_keys_and_f32_payload_through_k0(k0, passes):
    x = tied_u64(25)
    v = np.random.Generator(np.random.PCG64(26)).standard_normal(N).astype(np.float32)
    wk, wv = rst.sort_pairs(jax_in(x), jax_in(v))
    gk, gv = rt.sort_pairs(x, v, device="cpu")
    order = want_order(x)
    assert np.array_equal(gk, np.asarray(wk)) and np.array_equal(gk, x[order])
    assert_trees_equal(gv, wv)
    assert np.array_equal(raw(gv), raw(v[order]))
    assert k0 == [(2, 1, dict(index_dtype=None, guard=True))]
    eight_passes(passes, payload_planes=1)        # hi, lo and the payload: 3 planes a launch
    assert all(s[7:] == (False, False) for s in passes)    # a payload sort: dense planes


# ---------------------------------------------------------------------------
# dead digits, no pass, and the guard


def _dead_case(case):
    if case == "constant hi word":
        lo = keys("uint32", N, 27).astype(np.uint64)
        return np.uint64(0x0000018F00000000) | lo      # ms timestamps in one 2^32 span
    if case == "all keys equal":
        return np.full(N, 0xFEEDFACE_DEADBEEF, np.uint64)
    return np.sort(keys("uint64", N, 28))              # presorted


@pytest.mark.parametrize("case,live", [("constant hi word", 4), ("all keys equal", 0),
                                       ("presorted", 0)])
def test_dead_digits_and_ordered_inputs_through_k0(k0, passes, case, live):
    x = _dead_case(case)
    want = np.asarray(rst.sort(jax_in(x)))
    got = rt.sort(x, device="cpu")
    assert np.array_equal(got, want) and np.array_equal(got, x[want_order(x)])
    perm = rt.argsort(x, device="cpu")
    assert np.array_equal(perm, np.asarray(rst.argsort(jax_in(x))))
    assert np.array_equal(perm, want_order(x))
    assert [c[:2] for c in k0] == [(2, 0), (2, 0)]
    keys_only = passes[:live]                          # the sort's, then the argsort's
    assert [(s[0], s[2], s[6]) for s in keys_only] == [(8 * p, p + 1, 1) for p in range(live)]
    assert len(passes) == 2 * live


def test_presorted_two_planes_exit_before_any_pass_under_the_guard(k0, passes):
    """Off the public entry points: the guard's flag comes in the live
    digits' read, and an ordered input comes back as given."""
    x = np.sort(keys("uint64", N, 29)).view(np.int64)
    hi = torch.from_numpy(np.ascontiguousarray((x >> 32).astype(np.int32)))
    lo = torch.from_numpy(np.ascontiguousarray(x.astype(np.int32)))
    p = torch.arange(N, dtype=torch.float32)
    (sh, sl), (q,) = hw_engine.sort_words_presort_guard((hi, lo), (p,))
    assert sh.data_ptr() == hi.data_ptr() and sl.data_ptr() == lo.data_ptr() and q is p
    assert passes == [] and len(k0) == 1


# ---------------------------------------------------------------------------
# the pass structure


def test_uniform_u64_takes_eight_passes_on_one_status_buffer(passes, monkeypatch):
    """Every digit of uniform u64 keys lives: eight sweeps, epochs 1 to 8,
    one zeroed status buffer for the call, each pass moving both planes;
    the starts of pass p are the scan of the p-th digit's histogram, least
    significant first across the planes."""
    starts = []
    real = ck.k0_sweep
    monkeypatch.setattr(ck, "k0_sweep",
                        lambda *a, **k: starts.append(a[5].clone()) or real(*a, **k))
    x = keys("uint64", N, 31)
    hi, lo = (x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32)
    (sh, sl), (), perm = lsd_engine.sort_words_k0(
        tuple(torch.from_numpy(w.view(np.int32)) for w in (hi, lo)))
    order = np.argsort(x, kind="stable")
    assert perm is None
    assert np.array_equal(sh.numpy().view(np.uint32), hi[order])
    assert np.array_equal(sl.numpy().view(np.uint32), lo[order])
    eight_passes(passes)
    for p, got in enumerate(starts):
        digit = ((lo if p < 4 else hi) >> np.uint32(8 * (p % 4))) & np.uint32(0xFF)
        h = np.bincount(digit, minlength=256)
        assert np.array_equal(got.numpy(), np.cumsum(h) - h)
    status = passes[0][3]
    assert status.dtype == torch.int64 and status.numel() == -(-N // ck.K0_SWEEP_TILE) * 256 + 1


# ---------------------------------------------------------------------------
# the routes of a u64 key that take no pair


@pytest.mark.parametrize("route", ["COUNTING with a value_mask", "Strategy.LSD sort",
                                   "Strategy.LSD argsort", "torch.sort", "torch.sort argsort",
                                   "torch.sort presorted under the guard"])
def test_u64_routes_off_k0_take_dense_planes_and_match_jax(monkeypatch, route):
    """An ascending u64 key encodes to a pair for K0 alone: the counting
    tier, ``Strategy.LSD`` and ``torch.sort`` (a CPU tensor's route) take
    dense planes, match the JAX package, leave the input as it was and
    return fresh tensors; no pass sees a pair."""
    seen = []
    real = ck.k0_sweep
    monkeypatch.setattr(ck, "k0_sweep", lambda w, planes, *a, **k: seen.append(
        kdf.pair_of(planes[0], planes[1]) is not None) or real(w, planes, *a, **k))
    x = tied_u64(33)
    mask = None
    if route.startswith("COUNTING"):
        mask = 0x000F00000000F0F0                 # 12 live bits: the counting tier
        x = x & np.uint64(mask)
    elif route.endswith("guard"):
        x = np.sort(x)
    t = torch.from_numpy(x.view(np.int64).copy()).view(torch.uint64)
    kept = t.clone()
    lsd = route.startswith("Strategy.LSD")
    jcfg, tcfg = cfgs(strategy=rst.Strategy.LSD) if lsd else cfgs()
    if route.endswith("argsort"):
        got = rt.argsort(t, config=tcfg)
        want = np.asarray(rst.argsort(jax_in(x), config=jcfg))
        assert np.array_equal(got.numpy(), want) and np.array_equal(got.numpy(), want_order(x))
    else:
        got = rt.sort(t, config=tcfg, value_mask=mask)
        want = np.asarray(rst.sort(jax_in(x), config=jcfg, value_mask=mask))
        assert np.array_equal(got.view(torch.int64).numpy().view(np.uint64), want)
        assert np.array_equal(want, x[want_order(x)])
    assert got.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    assert torch.equal(t.view(torch.int64), kept.view(torch.int64))
    assert not any(seen)


PAIR_ROUTES = {   # case: (entry, config, value_mask, whether the encode makes a pair)
    "AUTO sort": ("sort", {}, None, True),
    "HW_SORT sort": ("sort", {"strategy": rt.Strategy.HW_SORT}, None, True),
    "AUTO argsort": ("argsort", {}, None, True),
    "sort with a wide value_mask": ("sort", {}, 0xFFFFFFFFFFFF0FFF, False),
    "argsort with a wide value_mask": ("argsort", {}, 0xFFFFFFFFFFFF0FFF, False),
    "sort with dynamic_probe": ("sort", {"dynamic_probe": True}, None, False),
    "sort with device_probe": ("sort", {"device_probe": True}, None, False),
    "Strategy.LSD sort": ("sort", {"strategy": rt.Strategy.LSD}, None, False),
    "Strategy.LSD argsort": ("argsort", {"strategy": rt.Strategy.LSD}, None, False),
}


@pytest.mark.parametrize("case", list(PAIR_ROUTES))
def test_api_makes_a_pair_only_where_the_sorter_takes_k0(k0, monkeypatch, case):
    """With K0 the sorter of two planes, ``sort`` and ``argsort`` encode an
    ascending u64 key as a pair only where the strategy hands it straight
    to that sorter: a ``value_mask``, a probe or ``Strategy.LSD`` takes
    dense planes. Each result is numpy's stable order of the keys."""
    entry, kw, mask, pair = PAIR_ROUTES[case]
    made = []
    real = kdf.encode
    monkeypatch.setattr(kdf, "encode", lambda *a, **k: made.append(
        real(*a, **k)) or made[-1])
    x = tied_u64(35)
    if mask is not None:
        x = x & np.uint64(mask)
    t = torch.from_numpy(x.view(np.int64).copy()).view(torch.uint64)
    cfg = rt.SortConfig(**kw)
    if entry == "argsort":
        got = rt.argsort(t, config=cfg, value_mask=mask)
        assert np.array_equal(got.numpy(), want_order(x))
    else:
        got = rt.sort(t, config=cfg, value_mask=mask)
        assert np.array_equal(got.view(torch.int64).numpy().view(np.uint64), x[want_order(x)])
    assert [kdf.pair_of(*w) is not None for w in made] == [pair]
