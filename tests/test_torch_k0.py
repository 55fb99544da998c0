"""K0, the port's sorter of one word plane, on the CPU.

K0 is the LSD radix sort (``lsd_engine.sort_words_k0``: 8-bit digits,
tiles of 8,192 keys, one ``k0_sweep`` a live digit) that ``hw_engine``
routes one plane on the card to. On CPU tensors the route is ``torch.sort``,
K0's plain version; here it is monkeypatched to K0, so the AUTO / HW_SORT
entry points run K0's pass structure with the plain versions of K1
``hist_multi`` and the sweep, and are held bit for bit against the JAX
package on its CPU route (its ``lax.sort``).
Every case shares one length, N = 20,000 (three tiles, the last short), so
the JAX package compiles once a dtype and configuration; a spy shows each
call went through K0. Also: the route itself (a pure function of device
type, planes and n), the live digits from one ``hist_multi`` read against
the live-bit folds, the sweep's plain version against L1 + scan + L2's
(``scan.scatter_bases(lsd_hist_plain)`` and ``lsd_scatter_plain``), and
the live-digit read with the presorted guard's flag (``live_digits_plain``
against ``hist_multi_plain`` of each plane and ``probes.is_sorted_words``;
no guarded K0 call runs the guard's torch passes); and the pair, an
ascending u64 key's two halves read and written where they lie
(``kdf.halves``), against the dense planes of the same keys. The
``u32_sort_pairs`` benchmark cell's call (a float32 payload riding K0's
passes) against that configuration's plain reference
(``sortbench/configs/u32_sort_pairs.py``) and its control.
"""

import dataclasses

import numpy as np
import pytest
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import hw_engine, kdf, lsd_engine, probes, scan

from sortbench import manifest
from test_torch_api import assert_trees_equal, dup_keys, keys
from test_torch_cuda import ORDER_CASES, RANK_PATTERNS, order_keys, rank_keys
from test_torch_kdf import raw
from test_torch_sort import jax_in

N = 20_000


def cfgs(**kw):
    jcfg = rst.SortConfig(**kw)
    return jcfg, rt.SortConfig.from_dict(dataclasses.asdict(jcfg))


# ---------------------------------------------------------------------------
# (a) the route


@pytest.mark.parametrize("n_at", ["below", "gate", "index limit"])
@pytest.mark.parametrize("planes", [1, 2, 3])
@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_sorter_route(device_type, planes, n_at):
    """One gate for the sort and the argsort of one plane, 2^24, and one for
    two planes: from there both beat torch.sort in every sweep of
    scripts/k0_gate.py (PERF.md). Three planes keep torch.sort."""
    assert hw_engine.LSD_MIN_KEYS == 1 << 24
    assert hw_engine.K0_TWO_PLANE_MIN_KEYS == 1 << 23
    gate = hw_engine.K0_TWO_PLANE_MIN_KEYS if planes == 2 else hw_engine.LSD_MIN_KEYS
    n = {"below": gate - 1, "gate": gate, "index limit": 1 << 31}[n_at]
    k0 = device_type == "cuda" and planes <= 2 and n_at == "gate"
    assert hw_engine.sorter_route(device_type, planes, n) == ("k0" if k0 else "torch.sort")


def test_cpu_tensors_keep_torch_sort(monkeypatch):
    """Without the patch a CPU plane above the gate takes torch.sort."""
    def boom(*a, **k):
        raise AssertionError("K0 ran on a CPU tensor")
    monkeypatch.setattr(lsd_engine, "sort_words_k0", boom)
    monkeypatch.setattr(hw_engine, "LSD_MIN_KEYS", N // 2)
    w = torch.from_numpy(keys("uint32", N, 1).view(np.int32))
    (s,), _ = hw_engine.sort_words((w,), stable=False)
    assert np.array_equal(s.numpy().view(np.uint32), np.sort(w.numpy().view(np.uint32)))
    _, perm = hw_engine.argsort_words((w,), torch.int64)
    assert np.array_equal(perm.numpy(), np.argsort(w.numpy().view(np.uint32), kind="stable"))


# ---------------------------------------------------------------------------
# (b) the entry points through K0's plain passes, against the JAX package


@pytest.fixture
def k0(monkeypatch):
    """Route every one-plane sort to K0 on any device; the K0 calls made."""
    calls = []
    real_route, real_k0 = hw_engine.sorter_route, lsd_engine.sort_words_k0

    def route(device_type, planes, n, *a, **k):
        return "k0" if planes == 1 else real_route(device_type, planes, n, *a, **k)

    def sweep(words, payloads=(), **kw):
        calls.append((len(words), len(payloads), kw))
        return real_k0(words, payloads, **kw)
    monkeypatch.setattr(hw_engine, "sorter_route", route)
    monkeypatch.setattr(lsd_engine, "sort_words_k0", sweep)
    return calls


K0_ARGS = {"index_dtype": None}


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["uint32", "int32", "float32"])
def test_sort_through_k0_matches_jax(k0, name, descending):
    x = keys(name, N, 3 + descending)            # float32: +-0, +-inf, NaN payloads
    jcfg, tcfg = cfgs(descending=descending)
    want = np.asarray(rst.sort(jax_in(x), config=jcfg))
    got = rt.sort(x, config=tcfg, device="cpu")
    assert got.dtype == x.dtype and np.array_equal(raw(got), raw(want))
    assert k0 == [(1, 0, dict(K0_ARGS, guard=True))]     # AUTO: the guarded sorter


@pytest.mark.parametrize("index_dtype", [np.uint16, np.int32, np.int64, np.uint32])
def test_argsort_through_k0_matches_jax(k0, index_dtype):
    x = dup_keys("uint32", N, 5)
    want = np.asarray(rst.argsort(jax_in(x), index_dtype=index_dtype))
    got = rt.argsort(x, index_dtype=index_dtype, device="cpu")
    assert got.dtype == np.dtype(index_dtype)
    assert np.array_equal(got, want) and np.array_equal(got, np.argsort(x, kind="stable"))
    born = torch.int64 if np.dtype(index_dtype).itemsize == 8 else torch.int32
    assert k0 == [(1, 0, dict(guard=True, index_dtype=born))]     # the sweep writes it


def _leaves(which, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    f32 = rng.standard_normal(N).astype(np.float32)
    i64 = rng.integers(-2**62, 2**62, size=N, dtype=np.int64)
    return {"4-byte": {"f32": f32}, "8-byte": {"i64": i64},
            "both": {"f32": f32, "i64": i64}}[which]


@pytest.mark.parametrize("which", ["4-byte", "8-byte", "both"])
def test_sort_pairs_through_k0_matches_jax(k0, which):
    x = dup_keys("uint32", N, 7)
    vals = _leaves(which, 8)
    wk, wv = rst.sort_pairs(jax_in(x), {k: jax_in(v) for k, v in vals.items()})
    gk, gv = rt.sort_pairs(x, vals, device="cpu")
    assert np.array_equal(gk, np.asarray(wk))
    assert_trees_equal(gv, wv)
    assert k0 == [(1, len(vals), dict(K0_ARGS, guard=True))]


PAIRS_REF = manifest.load_module(manifest.HERE / "configs" / "u32_sort_pairs.py",
                                 "u32_sort_pairs_reference")


def _pairs_inputs(kind, seed):
    """The ``u32_sort_pairs`` cell's input at N keys: u32 keys with ties
    (one live digit, or uniform words with every seventh key one value: four
    live digits) and float32 values drawn from the seed."""
    x = dup_keys("uint32", N, seed) if kind == "one live digit" else keys("uint32", N, seed)
    if kind == "four live digits":
        x[::7] = x[3]
    v = np.random.Generator(np.random.PCG64(seed + 1)).random(N, dtype=np.float32)
    return x, {"keys": torch.from_numpy(x.view(np.int32)).view(torch.uint32),
               "payload": torch.from_numpy(v)}


@pytest.mark.parametrize("kind", ["one live digit", "four live digits"])
def test_sort_pairs_cell_through_k0_matches_its_reference(k0, monkeypatch, kind):
    """The benchmark cell's call (a bare float32 payload) through K0's plain
    passes: two tensors, both bit for bit the configuration's ``expected``
    and numpy's stable argsort applied to the payload, the inputs left as
    they were; the control differs, so the check can fail."""
    passes = []
    real = ck.k0_sweep
    monkeypatch.setattr(ck, "k0_sweep", lambda *a, **k: passes.append(a[2]) or real(*a, **k))
    x, inputs = _pairs_inputs(kind, 17)
    kept = {k: v.clone() for k, v in inputs.items()}
    got = PAIRS_REF.call(rt.sort_pairs, inputs)
    assert isinstance(got, tuple) and len(got) == 2
    assert all(torch.is_tensor(t) for t in got)
    assert got[0].dtype == torch.uint32 and got[1].dtype == torch.float32
    want = PAIRS_REF.expected(inputs)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    order = np.argsort(x, kind="stable")
    assert np.array_equal(got[0].view(torch.int32).numpy().view(np.uint32), x[order])
    assert np.array_equal(got[1].numpy().view(np.int32),
                          inputs["payload"].numpy().view(np.int32)[order])
    for k in inputs:
        assert torch.equal(inputs[k].view(torch.int32), kept[k].view(torch.int32))
    control = PAIRS_REF.control(inputs)
    assert torch.equal(control[0].view(torch.int32), want[0].view(torch.int32))
    assert not torch.equal(control[1].view(torch.int32), want[1].view(torch.int32))
    assert k0 == [(1, 1, dict(K0_ARGS, guard=True))]
    assert len(passes) == (1 if kind == "one live digit" else 4)


def test_unique_with_counts_through_k0_matches_jax(k0):
    x = dup_keys("uint32", N, 9)
    got = rt.unique(x, return_counts=True, device="cpu")
    want = rst.unique(jax_in(x), return_counts=True)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert (g is None and w is None) or np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert k0 and all(c[0] == 1 for c in k0)


@pytest.mark.parametrize("name,mask", [("uint64", 0x0FFF00000000FFF0),   # 24 live bits:
                                       ("uint32", 0x0001FFFF)])          # one operand; 2^17 bins
def test_compacted_and_counting_fallbacks_through_k0_match_jax(k0, name, mask):
    """u64 with 24 live bits sorts one compacted operand; u32 with 17 live
    bits takes COUNTING, whose 2^17 bins at N keys fall back to the sorter."""
    x = keys(name, N, 11)
    x = (raw(x) & raw(x).dtype.type(mask)).view(x.dtype)
    want = np.asarray(rst.sort(jax_in(x), value_mask=mask))
    got = rt.sort(x, value_mask=mask, device="cpu")
    assert np.array_equal(raw(got), raw(want)) and np.array_equal(got, np.sort(x))
    assert len(k0) == 1 and k0[0][:2] == (1, 0)


@pytest.mark.parametrize("detect_presorted", [True, False])
def test_all_equal_keys_through_k0_launch_no_pass(k0, monkeypatch, detect_presorted):
    passes = []
    real = ck.k0_sweep
    monkeypatch.setattr(ck, "k0_sweep", lambda *a, **k: passes.append(a[2]) or real(*a, **k))
    x = np.full(N, 0xDEADBEEF, np.uint32)
    jcfg, tcfg = cfgs(detect_presorted=detect_presorted)
    want = np.asarray(rst.sort(jax_in(x), config=jcfg))
    assert np.array_equal(rt.sort(x, config=tcfg, device="cpu"), want)
    perm = rt.argsort(x, config=tcfg, device="cpu")
    assert np.array_equal(perm, np.asarray(rst.argsort(jax_in(x), config=jcfg)))
    assert passes == [] and k0


def test_two_keys_through_k0_match_jax(k0):
    x = np.array([0x80000001, 0x7FFFFFFF], np.uint32)
    assert np.array_equal(rt.sort(x, device="cpu"), np.asarray(rst.sort(jax_in(x))))
    assert np.array_equal(rt.argsort(x, device="cpu"), np.asarray(rst.argsort(jax_in(x))))
    v = np.array([1.5, -2.5], np.float32)
    gk, gv = rt.sort_pairs(x, v, device="cpu")
    wk, wv = rst.sort_pairs(jax_in(x), jax_in(v))
    assert np.array_equal(gk, np.asarray(wk)) and np.array_equal(gv, np.asarray(wv))
    assert len(k0) == 3


def test_strided_planes_through_k0(k0):
    """A caller of hw_engine may pass views with a stride; K0's kernels read
    dense planes."""
    base = keys("uint32", 2 * N, 15)
    w = torch.from_numpy(base.view(np.int32))[::2]
    v = torch.arange(2 * N, dtype=torch.float32)[1::2]
    (sk,), (sv,) = hw_engine.sort_words((w,), (v,))
    order = np.argsort(base[::2], kind="stable")
    assert np.array_equal(sk.numpy().view(np.uint32), base[::2][order])
    assert np.array_equal(sv.numpy(), np.arange(1, 2 * N, 2, dtype=np.float32)[order])
    assert k0 == [(1, 1, dict(K0_ARGS, guard=False))]


def test_presorted_input_exits_before_any_pass(k0, monkeypatch):
    """The guard's flag comes in the live digits' read; an ordered input
    launches no pass and comes back as given."""
    monkeypatch.setattr(ck, "k0_sweep", lambda *a, **k: pytest.fail("a pass ran"))
    w = torch.from_numpy(np.sort(keys("uint32", N, 13)).view(np.int32))
    p = torch.arange(N, dtype=torch.int64)
    (s,), (q,) = hw_engine.sort_words_presort_guard((w,), (p,))
    assert s.data_ptr() == w.data_ptr() and q is p


# ---------------------------------------------------------------------------
# (c) the live digits from one hist_multi read, against the folds


def _crafted(case, seed):
    """(hi, lo) planes of 1,000 keys."""
    rng = np.random.Generator(np.random.PCG64(seed))
    hi, lo = (rng.integers(0, 1 << 32, size=1000, dtype=np.uint32) for _ in range(2))
    if case == "one constant digit":
        lo = (lo & np.uint32(0xFFFF00FF)) | np.uint32(0x0000A500)
    elif case == "one differing key":
        hi[:], lo[:] = 0x12345678, 0x9ABCDEF0
        lo[417] ^= np.uint32(1 << 13)
    elif case == "all equal":
        hi[:], lo[:] = 0xFFFFFFFF, 0x00000000
    elif case == "dead top digit":                 # at r = 11: bits 22-31 of both words
        hi &= np.uint32((1 << 22) - 1)
        lo &= np.uint32((1 << 22) - 1)
    return tuple(torch.from_numpy(a.view(np.int32)) for a in (hi, lo))


@pytest.mark.parametrize("case", ["one constant digit", "one differing key", "all equal",
                                  "dead top digit"])
@pytest.mark.parametrize("radix_bits", range(1, 17))
def test_live_digits_from_hist_multi_match_the_folds(radix_bits, case):
    words = _crafted(case, radix_bits)
    total = -(-32 // radix_bits) << radix_bits        # the card's launch takes the width too
    assert ck.hist_shape_ok(ck.hist_shape(total), total)
    got = lsd_engine.live_digit_flags(words, radix_bits)
    want = probes.live_digit_mask(probes.live_bit_mask(words), radix_bits)
    assert got.dtype == torch.bool and tuple(got.tolist()) == want
    if case == "all equal":
        assert not any(want)
    if case == "dead top digit" and radix_bits == 11:
        assert want == (True, True, False, True, True, False)


# ---------------------------------------------------------------------------
# (d) the sweep: its plain version against L1 + scan + L2's, the index it
# bears and writes, and what its wrapper refuses


def _sweep_keys(case, seed):
    if case in RANK_PATTERNS:
        return torch.from_numpy(rank_keys(case, N, seed).view(np.int32))
    x = np.random.Generator(np.random.PCG64(seed)).integers(0, 1 << 32, size=N,
                                                           dtype=np.uint32)
    if case == "90% one digit":
        x[: N * 9 // 10] = 0x5A5A5A5A
    elif case == "one differing key":
        x[:] = 0x12345678
        x[417] ^= np.uint32(0xFF << 8)
    elif case == "all equal":
        x[:] = 0xDEADBEEF
    return torch.from_numpy(x.view(np.int32))


def _starts(w, shift, radix_bits):
    """The exclusive scan of the digit's global histogram."""
    bins = 1 << radix_bits
    h = torch.bincount((probes.shift_right(w, shift) & (bins - 1)).long(), minlength=bins)
    return (torch.cumsum(h, 0) - h).to(torch.int32)


@pytest.mark.parametrize("shift", [0, 8, 13])
@pytest.mark.parametrize("tile", [8192, 7000, 1 << 15], ids=["short last tile",
                                                             "tiles of 7,000", "one tile"])
@pytest.mark.parametrize("case", ["random", "90% one digit", "one differing key",
                                  "all equal", *RANK_PATTERNS[1:]])
def test_sweep_plain_matches_l1_scan_l2(case, tile, shift):
    w = _sweep_keys(case, tile + shift)
    pay = torch.from_numpy(np.arange(N, dtype=np.int32) * 7)
    iota = torch.arange(N, dtype=torch.int32)
    bases = scan.scatter_bases(ck.lsd_hist_plain(w, shift, 8, tile))
    want = ck.lsd_scatter_plain(w, (w, pay, iota), shift, 8, tile, bases)
    starts = _starts(w, shift, 8)
    got = ck.k0_sweep_plain(w, (w, pay), shift, 8, tile, starts, position=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    wide = ck.k0_sweep_plain(w, (w, iota), shift, 8, tile, starts, index_dtype=torch.int64)
    assert wide[1].dtype == torch.int64 and torch.equal(wide[1], want[2].long())
    if tile == ck.K0_SWEEP_TILE:           # the wrapper on CPU tensors: the plain version
        status = ck.k0_sweep_status(N, w.device)
        again = ck.k0_sweep(w, (w, pay), shift, 8, tile, starts, status, 1, position=True)
        assert all(torch.equal(a, b) for a, b in zip(again, want))


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=str)
@pytest.mark.parametrize("live", ["four digits", "one digit", "no digit"])
def test_sweep_bears_the_index_first_and_writes_its_dtype_last(monkeypatch, live,
                                                               index_dtype):
    """The first live pass takes the index as the position, the last writes
    it in the asked dtype (one live digit: both at once; none: arange)."""
    calls = []
    real = ck.k0_sweep

    def spy(w, planes, *a, position=False, index_dtype=torch.int32, pair_out=False):
        calls.append((len(planes), position, index_dtype, pair_out))
        return real(w, planes, *a, position=position, index_dtype=index_dtype,
                    pair_out=pair_out)
    monkeypatch.setattr(ck, "k0_sweep", spy)
    x = _sweep_keys("random", 31).numpy().view(np.uint32)
    x = {"four digits": x, "one digit": x & np.uint32(0x0000FF00),
         "no digit": np.full(N, 0xC0FFEE, np.uint32)}[live]
    w = torch.from_numpy(x.view(np.int32))
    (sw,), (), perm = lsd_engine.sort_words_k0((w,), index_dtype=index_dtype)
    order = np.argsort(x, kind="stable")
    assert perm.dtype == index_dtype and np.array_equal(perm.numpy(), order)
    assert np.array_equal(sw.numpy().view(np.uint32), x[order])
    passes = {"four digits": 4, "one digit": 1, "no digit": 0}[live]
    want = [(1 if e == 0 else 2, e == 0, index_dtype if e == passes - 1 else torch.int32,
             False) for e in range(passes)]
    assert calls == want


def test_sweep_gathers_every_payload_past_its_plane_limit(monkeypatch):
    """All planes of a pass go in one launch: past the limit the payloads
    ride one index plane and are gathered once."""
    seen = []
    real = ck.k0_sweep
    monkeypatch.setattr(ck, "k0_sweep",
                        lambda w, planes, *a, **k: seen.append(len(planes)) or
                        real(w, planes, *a, **k))
    w = _sweep_keys("random", 41)
    pays = tuple(torch.full((N,), float(i), dtype=torch.float32) + torch.arange(N)
                 for i in range(ck.K0_SWEEP_MAX_PLANES))     # with the keys, one too many
    (sw,), out, perm = lsd_engine.sort_words_k0((w,), pays)
    order = np.argsort(w.numpy().view(np.uint32), kind="stable")
    assert perm is None and seen == [1, 2, 2, 2]
    assert all(np.array_equal(o.numpy(), p.numpy()[order]) for o, p in zip(out, pays))
    (sw2,), out2, _ = lsd_engine.sort_words_k0((w,), pays[:2])     # under it: they ride
    assert seen[4:] == [3, 3, 3, 3] and torch.equal(sw, sw2)
    assert all(torch.equal(a, b) for a, b in zip(out[:2], out2))


@pytest.mark.parametrize("bad", ["11-bit digits", "tiles of 4,096", "status short",
                                 "epoch 0", "int64 digit plane", "int16 index",
                                 "starts int64", "33 planes"])
def test_sweep_wrapper_refuses_what_the_entry_was_not_built_for(bad):
    w = _sweep_keys("random", 51)
    args = dict(w=w, planes=(w,), shift=0, radix_bits=8, tile=ck.K0_SWEEP_TILE,
                starts=_starts(w, 0, 8), status=ck.k0_sweep_status(N, w.device), epoch=1)
    kw = {}
    if bad == "11-bit digits":
        args.update(radix_bits=11, starts=_starts(w, 0, 11))
    elif bad == "tiles of 4,096":
        args["tile"] = 4096
    elif bad == "status short":
        args["status"] = args["status"][1:]
    elif bad == "epoch 0":
        args["epoch"] = 0
    elif bad == "int64 digit plane":
        kw["index_dtype"] = torch.int64
    elif bad == "int16 index":
        kw.update(position=True, index_dtype=torch.int16)
    elif bad == "starts int64":
        args["starts"] = args["starts"].long()
    elif bad == "33 planes":
        args["planes"] = (w,) * ck.K0_SWEEP_MAX_PLANES
        kw["position"] = True
    with pytest.raises(ValueError):
        ck.k0_sweep(*args.values(), **kw)


# ---------------------------------------------------------------------------
# (e) the live-digit read with the guard's flag


@pytest.mark.parametrize("case", ORDER_CASES)
@pytest.mark.parametrize("n", [2, 3, 5, 4097, 8193])
@pytest.mark.parametrize("planes", [1, 2])
def test_live_digits_plain_is_hist_multi_and_the_guard(planes, n, case):
    """Every plane's digit histograms, least significant plane first, and
    the descent flag: 1 exactly where ``probes.is_sorted_words`` is False."""
    hi, lo = order_keys(case, n, n + planes)
    words = tuple(torch.from_numpy(a.view(np.int32)) for a in ((hi, lo) if planes == 2 else (lo,)))
    hists, descent = ck.live_digits_plain(words, 8)
    want = torch.cat([ck.hist_multi_plain(w, 8) for w in reversed(words)])
    assert hists.dtype == torch.int32 and torch.equal(hists, want)
    assert descent.dtype == torch.int32 and descent.shape == ()
    assert int(descent) == int(not bool(probes.is_sorted_words(words)))
    ordered = ["sorted", "all equal", ("descent in lo, hi rising" if planes == 2
                                        else "descent in hi, lo rising")]
    if case in ordered:
        assert int(descent) == 0
    elif case != "random":
        assert int(descent) == 1
    got, none = ck.live_digits(words, 8, order=False)          # the wrapper, on the CPU
    assert none is None and torch.equal(got, want)


@pytest.mark.parametrize("ordered", [False, True], ids=["random", "ordered"])
@pytest.mark.parametrize("name", ["uint32", "uint64"])
def test_guarded_k0_calls_never_run_the_torch_guard(monkeypatch, name, ordered):
    """Through K0's plain route, a guarded call (``sort``, ``argsort``,
    ``sort_pairs``) finds its order in the live-digit read:
    ``probes.is_sorted_words`` never runs, and an ordered input of one plane
    or two launches no pass."""
    def refused(*a, **k):
        raise AssertionError("probes.is_sorted_words ran on a guarded K0 call")
    real = hw_engine.sorter_route
    monkeypatch.setattr(hw_engine, "sorter_route",
                        lambda device_type, planes, n: "k0" if planes <= 2
                        else real(device_type, planes, n))
    monkeypatch.setattr(probes, "is_sorted_words", refused)
    passes = []
    sweep = ck.k0_sweep
    monkeypatch.setattr(ck, "k0_sweep", lambda *a, **k: passes.append(a[2]) or sweep(*a, **k))
    x = keys(name, N, 61)
    if ordered:
        x = np.sort(x)
    order = np.argsort(x, kind="stable")
    assert np.array_equal(rt.sort(x, device="cpu"), x[order])
    assert np.array_equal(rt.argsort(x, device="cpu"), order)
    sk, sv = rt.sort_pairs(x, np.arange(N, dtype=np.float32), device="cpu")
    assert np.array_equal(sk, x[order]) and np.array_equal(sv, order.astype(np.float32))
    assert (passes == []) == ordered


@pytest.mark.parametrize("planes,radix_bits", [(3, 8), (2, 18)])
def test_live_digits_past_one_launch_take_hist_multi_and_the_torch_guard(planes, radix_bits):
    """Three planes, or two past 2^19 counters, which one K1 launch does not
    take: one ``hist_multi`` a plane, with the same histograms and no flag.
    The descent flag comes only from one launch (K0's guard reads one or
    two planes at r = 8), so asking for it there raises as ``live_digits``
    does."""
    assert not ck.live_digits_fit(planes, radix_bits)
    words = tuple(torch.from_numpy(keys("uint32", 1000, 70 + p).view(np.int32))
                  for p in range(planes))
    with pytest.raises(ValueError):
        ck.live_digits(words, radix_bits)
    for ordered in (False, True):
        ws = tuple(torch.sort(w).values for w in words) if ordered else words
        hists, descent = lsd_engine._digit_hists(ws, radix_bits)
        want = torch.cat([ck.hist_multi_plain(w, radix_bits) for w in reversed(ws)])
        assert torch.equal(hists, want) and descent is None
        with pytest.raises(ValueError):
            lsd_engine._digit_hists(ws, radix_bits, order=True)


def test_live_digits_fit_one_launch_at_every_config_width():
    """``SortConfig`` takes r = 1 to 16: one and two planes always fit one
    K1 launch; the wrapper refuses what its C entry refuses."""
    assert all(ck.live_digits_fit(p, r) for p in (1, 2) for r in range(1, 17))
    assert ck.live_digits_fit(1, 18) and ck.live_digits_fit(2, 17)
    assert not ck.live_digits_fit(2, 18) and not ck.live_digits_fit(3, 8)
    w = torch.zeros(16, dtype=torch.int32)
    for bad in ((w[::2],), (w, w[:8]), (w.long(),)):
        with pytest.raises((TypeError, ValueError)):
            ck.live_digits(bad, 8)


# ---------------------------------------------------------------------------
# (f) the pair: the halves of one 64-bit buffer, read by the live-digit read
# and the first live pass where they lie, written as one by the last


def _pair_keys(case, seed):
    """N u64 keys (three tiles, the last short) for a pair case."""
    x = np.random.Generator(np.random.PCG64(seed)).integers(0, 1 << 64, size=N,
                                                           dtype=np.uint64)
    x[::7] = x[3]                                      # ties: stability shows
    if case == "one live digit":
        x = np.uint64(0x0123456789AB00EF) | (x & np.uint64(0xFF00))
    elif case == "no live digit":
        x[:] = 0xFEEDFACE_DEADBEEF
    elif case == "presorted under the guard":
        x = np.sort(x)
    return x


@pytest.fixture
def pair_passes(monkeypatch):
    """Every ``k0_sweep``: (planes 0 and 1 in as a pair, out as one)."""
    seen = []
    real = ck.k0_sweep

    def spy(w, planes, *a, pair_out=False, **k):
        seen.append((kdf.pair_of(planes[0], planes[1]) is not None, pair_out))
        return real(w, planes, *a, pair_out=pair_out, **k)
    monkeypatch.setattr(ck, "k0_sweep", spy)
    return seen


@pytest.mark.parametrize("case", ["short last tile", "one live digit", "no live digit",
                                  "presorted under the guard", "argsort int32",
                                  "argsort int64", "a slice at an odd offset"])
def test_pair_through_k0_matches_the_dense_planes(pair_passes, case):
    """K0 over the halves of a u64 tensor: the first live pass reads them,
    the last writes the sorted keys as the halves of one fresh buffer (one
    live digit: one pass does both; none, or an ordered input under the
    guard: one copy of the input). Equal to K0 over the dense planes and to
    numpy's stable sort; the input left bit for bit, no storage shared. A
    slice one key in reads its halves off the 16-byte grid."""
    x = _pair_keys(case, 80 + len(case))
    t = torch.from_numpy(x.view(np.int64).copy())
    if case == "a slice at an odd offset":
        t = torch.cat([t[:1], t])[1:]
        assert t.data_ptr() % 16 == 8
    kept = t.clone()
    pair = kdf.halves(t)
    assert kdf.pair_of(*pair) is not None
    index = {"argsort int32": torch.int32, "argsort int64": torch.int64}.get(case)
    guard = case == "presorted under the guard"
    sw, _, perm = lsd_engine.sort_words_k0(pair, guard=guard, index_dtype=index)
    seen = list(pair_passes)
    dw, _, dperm = lsd_engine.sort_words_k0(kdf.split64(t), guard=guard, index_dtype=index)
    order = np.argsort(x, kind="stable")
    out = kdf.pair_of(*sw)
    assert out is not None and kdf.join64(*sw, torch.uint64).data_ptr() == out.data_ptr()
    assert np.array_equal(out.numpy().view(np.uint64), x[order])
    assert all(torch.equal(a, b) for a, b in zip(sw, dw))
    if index is not None:
        assert perm.dtype == index and np.array_equal(perm.numpy(), order)
        assert torch.equal(perm, dperm)
    assert torch.equal(t, kept)
    assert out.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    live = {"one live digit": 1, "no live digit": 0, "presorted under the guard": 0}.get(case, 8)
    assert seen == [(e == 0, e == live - 1) for e in range(live)]
    assert pair_passes[live:] == [(False, False)] * live       # the dense planes'


def _not_a_pair(bad):
    """(planes 0 and 1, the key plane) that look like a pair and are not."""
    t = torch.from_numpy(_pair_keys("short last tile", 90).view(np.int64).copy())
    words = t.view(torch.int32)
    if bad == "a stride of 3":
        third = torch.cat([words, words[:N]])
        return third[1::3], third[0::3]
    if bad == "swapped halves":
        hi, lo = kdf.halves(t)
        return lo, hi
    off = words[1:-1]                        # one word off the 8-byte grid
    return off[1::2], off[0::2][:N - 1]


@pytest.mark.parametrize("bad", ["a stride of 3", "swapped halves", "offset halves"])
def test_pair_wrappers_refuse_what_is_not_a_pair(bad):
    """Exactly the two halves of one dense 64-bit buffer, hi after lo, are
    a pair: a stride of 3, swapped halves and halves one word off the
    8-byte grid are refused by every wrapper as planes that are not dense,
    and ``join64`` copies them."""
    hi, lo = _not_a_pair(bad)
    assert hi.shape == lo.shape and kdf.pair_of(hi, lo) is None
    n = hi.shape[0]
    starts = _starts(lo.contiguous(), 0, 8)
    status = ck.k0_sweep_status(n, lo.device)
    for call in (lambda: ck.k0_sweep(lo, (hi, lo), 0, 8, ck.K0_SWEEP_TILE, starts, status, 1),
                 lambda: ck.k0_sweep_plain(lo, (hi, lo), 0, 8, ck.K0_SWEEP_TILE, starts),
                 lambda: ck.live_digits((hi, lo), 8),
                 lambda: ck.live_digits_plain((hi, lo), 8)):
        with pytest.raises((TypeError, ValueError)):
            call()
    joined = kdf.join64(hi, lo, torch.int64)
    assert joined.untyped_storage().data_ptr() != hi.untyped_storage().data_ptr()
    assert torch.equal(kdf.split64(joined)[0], hi) and torch.equal(kdf.split64(joined)[1], lo)


def test_pair_sweep_refuses_a_digit_or_an_index_off_the_pair():
    """A pass that reads or writes a pair takes its digit from plane 0 or 1,
    and a pair out is never the index written as int64."""
    t = torch.from_numpy(_pair_keys("short last tile", 91).view(np.int64).copy())
    hi, lo = kdf.halves(t)
    other = lo.contiguous()
    starts = _starts(other, 0, 8)
    with pytest.raises(ValueError):
        ck.k0_sweep_plain(other, (hi, lo, other), 0, 8, ck.K0_SWEEP_TILE, starts)
    dhi, dlo = kdf.split64(t)
    with pytest.raises(ValueError):
        ck.k0_sweep_plain(dhi, (dhi, dlo), 0, 8, ck.K0_SWEEP_TILE, starts,
                          index_dtype=torch.int64, pair_out=True)
    with pytest.raises(ValueError):
        ck.live_digits((hi, lo), 11)            # a pair at K0's 8-bit digits only
