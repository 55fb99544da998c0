"""``Strategy.LSD`` of the port against the JAX package's LSD engine.

The same keys and payloads (numpy, from a seed) and the same configuration
go to ``sort``, ``argsort`` and ``sort_pairs`` of both packages with
``strategy=LSD``; outputs must be equal bit for bit. The port runs its LSD
pass structure with the plain versions of L1 (``lsd_hist``) and L2
(``lsd_scatter``) on CPU tensors; the JAX package its jitted one-hot engine.
Every case shares one length, N, so that the JAX engine compiles once per
(planes, payload planes, radix_bits, chunk, skip_trivial). The building
blocks (``live_digit_mask``, ``chunked_digit_histogram``, ``scan``) are held
against the JAX package's too, and the plain L2 against a numpy oracle of a
stable pass.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu.ops import histogram as jhist
from radix_sorting_tpu.ops import probes as jprobes
from radix_sorting_tpu.ops import scan as jscan
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import histogram as thist
from radix_sorting_tpu_torch.ops import lsd_engine
from radix_sorting_tpu_torch.ops import probes as tprobes
from radix_sorting_tpu_torch.ops import scan as tscan

from test_torch_api import assert_trees_equal, dup_keys, keys, payload
from test_torch_kdf import raw
from test_torch_sort import jax_in

N = 1500


def cfgs(**kw):
    jcfg = rst.SortConfig(strategy=rst.Strategy.LSD, **kw)
    return jcfg, rt.SortConfig.from_dict(dataclasses.asdict(jcfg))


def plane(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# sort


SORT_KEYS = ["uint8", "int8", "uint16", "int16", "bfloat16", "float16", "uint32",
             "int32", "float32", "uint64", "int64", "float64"]


@pytest.mark.parametrize("radix_bits", [8, 11, 16])
@pytest.mark.parametrize("name", SORT_KEYS)
def test_lsd_sort_matches_jax(name, radix_bits):
    x = keys(name, N, SORT_KEYS.index(name) * 3 + radix_bits)
    jcfg, tcfg = cfgs(radix_bits=radix_bits, lsd_chunk=256)
    want = np.asarray(rst.sort(jax_in(x), config=jcfg))
    got = rt.sort(x, config=tcfg, device="cpu")
    assert got.dtype == x.dtype and np.array_equal(raw(got), raw(want))


@pytest.fixture
def passes(monkeypatch):
    """The digit passes that reached L2, as (shift, radix_bits) pairs."""
    seen = []
    real = ck.lsd_scatter

    def counted(w, planes, shift, radix_bits, tile, bases):
        seen.append((shift, radix_bits))
        return real(w, planes, shift, radix_bits, tile, bases)
    monkeypatch.setattr(ck, "lsd_scatter", counted)
    return seen


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("skip_trivial", [False, True])
@pytest.mark.parametrize("chunk", [256, 1000])
def test_lsd_tiles_and_column_skipping_match_jax(chunk, skip_trivial, descending, passes):
    # 0xF0F00000 leaves digits 2 and 3 live at radix_bits=8; duplicates, and
    # a short last tile at either chunk
    x = (raw(keys("uint32", N, chunk)) & np.uint32(0xF0F00000)).view(np.uint32)
    jcfg, tcfg = cfgs(lsd_chunk=chunk, skip_trivial_digits=skip_trivial,
                      descending=descending)
    want = np.asarray(rst.sort(jnp.asarray(x), config=jcfg))
    got = rt.sort(x, config=tcfg, device="cpu")
    assert np.array_equal(got, want)
    assert [s for s, _ in passes] == ([16, 24] if skip_trivial else [0, 8, 16, 24])


def test_lsd_tile_takes_at_least_one_key_per_bin():
    assert lsd_engine.lsd_tile(8192, 8) == 8192
    assert lsd_engine.lsd_tile(256, 11) == 2048
    assert lsd_engine.lsd_tile(8192, 16) == 65536


@pytest.mark.parametrize("mask", [0x00FF000000FFFF00, 0x0FFF0000FFFFFFF0])
def test_lsd_value_mask_compaction_matches_jax(mask, passes):
    # 24 live bits compact into one operand (4 digits); 44 do not (8)
    x = (raw(keys("uint64", N, 13)) & np.uint64(mask)).view(np.uint64)
    jcfg, tcfg = cfgs(skip_trivial_digits=False)
    want = np.asarray(rst.sort(x, config=jcfg, value_mask=mask))
    got = rt.sort(x, config=tcfg, value_mask=mask, device="cpu")
    assert np.array_equal(got, want) and np.array_equal(got, np.sort(x))
    assert len(passes) == (4 if bin(mask).count("1") <= 32 else 8)
    vals = {"i": np.arange(N, dtype=np.int64)}
    wk, wv = rst.sort_pairs(x, vals, config=jcfg, value_mask=mask)
    gk, gv = rt.sort_pairs(x, vals, config=tcfg, value_mask=mask, device="cpu")
    assert np.array_equal(gk, np.asarray(wk))
    assert_trees_equal(gv, wv)


# ---------------------------------------------------------------------------
# argsort and sort_pairs: the index and the payloads ride the passes


ARGSORT_KEYS = ["uint32", "int64", "float32", "bool", "S5"]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ARGSORT_KEYS)
def test_lsd_argsort_matches_jax(name, descending):
    x = dup_keys(name, N, len(name) + 40)
    jcfg, tcfg = cfgs(descending=descending)
    want = np.asarray(rst.argsort(jax_in(x), config=jcfg))
    got = rt.argsort(x, config=tcfg, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if not descending and name != "float32":     # numpy puts every NaN last
        assert np.array_equal(got, np.argsort(x, kind="stable"))


@pytest.mark.parametrize("index_dtype", [np.uint16, np.int32, np.uint32])
def test_lsd_argsort_index_dtypes_match_jax(index_dtype):
    x = dup_keys("uint32", N, 5)
    jcfg, tcfg = cfgs(radix_bits=11)
    want = np.asarray(rst.argsort(jnp.asarray(x), config=jcfg,
                                  index_dtype=jnp.dtype(index_dtype)))
    got = rt.argsort(x, config=tcfg, index_dtype=index_dtype, device="cpu")
    assert got.dtype == want.dtype == np.dtype(index_dtype)
    assert np.array_equal(got, want) and np.array_equal(got, np.argsort(x, kind="stable"))


PAIR_KEYS = ["uint32", "uint64", "S6"]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", PAIR_KEYS)
def test_lsd_sort_pairs_matches_jax(name, descending):
    # every leaf kind: 64-bit, 16- and 8-bit, byte fields and rows ride as
    # the index plane; the uint32 leaf rides the scatter itself
    x = dup_keys(name, N, 11 + len(name))
    vals = payload(N, 3)
    jcfg, tcfg = cfgs(descending=descending, lsd_chunk=1000)
    wk, wv = rst.sort_pairs(jax_in(x), vals, config=jcfg)
    gk, gv = rt.sort_pairs(x, vals, config=tcfg, device="cpu")
    assert np.array_equal(raw(gk), raw(np.asarray(wk)))
    assert_trees_equal(gv, wv)


def test_lsd_tensor_payloads_stay_tensors():
    x = dup_keys("int32", N, 21)
    t = torch.from_numpy(x)
    f = torch.from_numpy(np.random.Generator(np.random.PCG64(2)).standard_normal(N)
                         .astype(np.float32))
    h = torch.arange(N, dtype=torch.int16)
    _, tcfg = cfgs()
    sk, (sf, sh) = rt.sort_pairs(t, (f, h), config=tcfg)
    order = np.argsort(x, kind="stable")
    assert sf.dtype == torch.float32 and sh.dtype == torch.int16
    assert np.array_equal(sk.numpy(), x[order])
    assert np.array_equal(sf.numpy(), f.numpy()[order])
    assert np.array_equal(sh.numpy(), h.numpy()[order])


def test_lsd_tiny_inputs_match_jax():
    jcfg, tcfg = cfgs()
    for x in (np.zeros(0, np.uint32), np.array([7], np.int64), np.full(5, 3, np.uint16)):
        assert np.array_equal(rt.sort(x, config=tcfg, device="cpu"),
                              np.asarray(rst.sort(jax_in(x), config=jcfg)))
        assert np.array_equal(rt.argsort(x, config=tcfg, device="cpu"),
                              np.asarray(rst.argsort(jax_in(x), config=jcfg)))


# ---------------------------------------------------------------------------
# the building blocks


@pytest.mark.parametrize("radix_bits", [1, 5, 8, 11, 16])
def test_live_digit_mask_matches_jax(radix_bits):
    x = (raw(keys("uint64", N, radix_bits)) & np.uint64(0x00F0000F0FF00001)).view(np.uint64)
    hi, lo = (x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32)
    want = np.asarray(jprobes.live_digit_mask(
        jprobes.live_bit_mask((jnp.asarray(hi), jnp.asarray(lo))), radix_bits))
    got = tprobes.live_digit_mask(tprobes.live_bit_mask((plane(hi), plane(lo))), radix_bits)
    assert isinstance(got, tuple) and list(got) == want.tolist()
    masks = [int(m) for m in jprobes.live_bit_mask((jnp.asarray(hi), jnp.asarray(lo)))]
    assert tprobes.live_digit_mask(masks, radix_bits) == got       # ints too


@pytest.mark.parametrize("radix_bits,shift", [(8, 0), (8, 24), (11, 22), (16, 16)])
def test_chunked_digit_histogram_matches_jax(radix_bits, shift):
    x = keys("uint32", N, radix_bits + shift)
    tiles = 6                                 # the JAX form needs tiles | n
    digits = (x >> np.uint32(shift)) & np.uint32((1 << radix_bits) - 1)
    want = np.asarray(jhist.chunked_digit_histogram(jnp.asarray(digits), 1 << radix_bits,
                                                    tiles))
    got = thist.chunked_digit_histogram(plane(x), shift, radix_bits, N // tiles)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    short = thist.chunked_digit_histogram(plane(x), shift, radix_bits, 1000)
    assert short.shape == (2, 1 << radix_bits)
    assert np.array_equal(short.numpy().sum(0), want.sum(0))


def test_scan_matches_jax():
    h = np.random.Generator(np.random.PCG64(4)).integers(0, 50, size=(7, 33)).astype(np.int32)
    for axis in (0, 1, -1):
        assert np.array_equal(tscan.exclusive_scan(torch.from_numpy(h), axis=axis).numpy(),
                              np.asarray(jscan.exclusive_scan(jnp.asarray(h), axis=axis)))
    got = tscan.scatter_bases(torch.from_numpy(h))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jscan.scatter_bases(jnp.asarray(h))))


@pytest.mark.parametrize("radix_bits,tile", [(3, 100), (8, 256), (13, 999)])
def test_lsd_scatter_plain_is_one_stable_pass(radix_bits, tile):
    x = keys("uint32", N, tile)
    x[::7] = x[3]                                           # ties
    shift = 5
    w = plane(x)
    hist = ck.lsd_hist_plain(w, shift, radix_bits, tile)
    pay = torch.arange(N, dtype=torch.int32)
    sw, sp = ck.lsd_scatter_plain(w, (w, pay), shift, radix_bits, tile,
                                  tscan.scatter_bases(hist))
    order = np.argsort((x >> np.uint32(shift)) & np.uint32((1 << radix_bits) - 1),
                       kind="stable")
    assert np.array_equal(sp.numpy(), order)
    assert np.array_equal(sw.numpy().view(np.uint32), x[order])


def test_lsd_plain_versions_count_no_launches():
    before = ck.launch_counts()
    w = plane(keys("uint32", N, 1))
    h = ck.lsd_hist(w, 0, 8, 256)
    ck.lsd_scatter(w, (w,), 0, 8, 256, tscan.scatter_bases(h))
    rt.sort(w.view(torch.uint32), config=rt.SortConfig(strategy="lsd"))
    assert ck.launch_counts() == before


def test_lsd_wrappers_check_their_inputs():
    w = plane(keys("uint32", 64, 1))
    bases = tscan.scatter_bases(ck.lsd_hist(w, 0, 8, 16))
    for bad in (lambda: ck.lsd_hist(w, 0, 17, 16), lambda: ck.lsd_hist(w, 32, 8, 16),
                lambda: ck.lsd_hist(w, 0, 8, 0),
                lambda: ck.lsd_scatter(w, (w[:10],), 0, 8, 16, bases),
                lambda: ck.lsd_scatter(w, (w,), 0, 8, 32, bases)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        ck.lsd_hist(w.long(), 0, 8, 16)


# ---------------------------------------------------------------------------
# L2's launch shape, and what its staged form rests on

LSD_TILES = [1, 3, 1000, 2048, 4096, 8191, 8192, 16384, 65536, None]   # None: lsd_tile(8192, r)


@pytest.mark.parametrize("tile", LSD_TILES)
@pytest.mark.parametrize("radix_bits", range(1, 17))
def test_lsd_scatter_shape_serves_the_tile(radix_bits, tile):
    tile = tile or lsd_engine.lsd_tile(8192, radix_bits)
    shape = ck.lsd_scatter_shape(radix_bits, tile)
    if radix_bits > ck.LSD_STAGE_MAX_BITS:
        assert shape is None                     # the direct form takes it
        return
    assert (shape.threads, shape.keys) in ck.LSD_STAGE_SHAPES and shape.threads % 32 == 0
    assert shape.smem == ck.lsd_stage_smem(shape.threads, shape.keys, radix_bits) <= 232_448
    assert shape in ck.lsd_stage_shapes(radix_bits)
    assert shape.stage <= 1 << ck.LSD_SLOT_BITS  # slot indices fit their 16 bits
    stages = -(-tile // shape.stage)
    assert stages * shape.stage >= tile          # the stages cover the tile
    fits = [s.stage for s in ck.lsd_stage_shapes(radix_bits)]
    if tile <= max(fits):
        assert stages == 1                       # a tile that fits one stage takes one
        assert all(f >= shape.stage or f < tile for f in fits)   # the smallest such stage


def test_lsd_scatter_shape_refuses_what_it_cannot_serve():
    for bad in ((0, 8192), (17, 8192), (8, 0), (8, -5)):
        with pytest.raises(ValueError):
            ck.lsd_scatter_shape(*bad)


@pytest.mark.parametrize("radix_bits,tile", [(1, 3), (8, 256), (11, 1000), (16, 65536)])
def test_scatter_bases_of_consecutive_tiles_abut(radix_bits, tile):
    """The identity behind runs that continue from one tile into the next:
    digit d of tile t + 1 starts where tile t's keys of d end."""
    x = keys("uint32", N, radix_bits + tile)
    x[::4] = x[1]
    h = ck.lsd_hist_plain(plane(x), 3, radix_bits, tile).numpy()
    bases = np.asarray(jscan.scatter_bases(jnp.asarray(h)))
    assert np.array_equal(bases[1:], bases[:-1] + h[:-1])
    assert np.array_equal(tscan.scatter_bases(torch.from_numpy(h)).numpy(), bases)


def _staged_model(x, shift, radix_bits, tile, bases, threads, keys_per_thread):
    """csrc/lsd.cu's staged L2 step by step, in numpy: each key's
    destination. Warp w holds the stage positions [w * 32K, (w + 1) * 32K)
    and ranks them in input order (step k, lanes in order) against counters
    of its own; one scan over (digit, warp), digit-major, gives the slots;
    slot j of digit d goes to run[d] + j - first[d]."""
    n, bins = len(x), 1 << radix_bits
    stage, warps = threads * keys_per_thread, threads // 32
    digits = ((x >> np.uint32(shift)) & np.uint32(bins - 1)).astype(np.int64)
    dest = np.full(n, -1, np.int64)
    for t in range(-(-n // tile)):
        lo, hi = t * tile, min(n, (t + 1) * tile)
        run = bases[t].astype(np.int64)
        for s0 in range(lo, hi, stage):
            valid = min(stage, hi - s0)
            d = digits[s0:s0 + valid]
            warp = np.arange(valid) // (32 * keys_per_thread)
            counters = np.zeros((warps, bins), np.int64)
            rank = np.empty(valid, np.int64)
            for p in range(valid):               # a warp's steps: k, then lanes
                rank[p] = counters[warp[p], d[p]]
                counters[warp[p], d[p]] += 1
            count = counters.sum(0)
            first = np.cumsum(count) - count
            slot = first[d] + (np.cumsum(counters, 0) - counters)[warp, d] + rank
            assert sorted(slot) == list(range(valid)) and valid <= 1 << ck.LSD_SLOT_BITS
            at = np.empty(valid, np.int64)
            at[slot] = np.arange(valid)          # the stage in stable digit order
            dest[s0 + at] = (run - first)[d[at]] + np.arange(valid)
            run = run + count
    return dest


@pytest.mark.parametrize("threads,keys_per_thread", ck.LSD_STAGE_SHAPES)
@pytest.mark.parametrize("radix_bits,tile", [(4, 1000), (8, 3000), (11, 2048)])
def test_staged_scatter_model_is_one_stable_pass(radix_bits, tile, threads, keys_per_thread):
    n = 5003
    x = keys("uint32", n, radix_bits * tile)
    x[::5] = x[2]                                             # ties
    w = plane(x)
    bases = tscan.scatter_bases(ck.lsd_hist_plain(w, 2, radix_bits, tile))
    dest = _staged_model(x, 2, radix_bits, tile, bases.numpy(), threads, keys_per_thread)
    got = np.empty_like(x)
    got[dest] = x
    want = ck.lsd_scatter_plain(w, (w,), 2, radix_bits, tile, bases)[0]
    assert np.array_equal(got, want.numpy().view(np.uint32))
