"""K12, the bitonic small-n sort of the port, against the JAX package.

``radix_sorting_tpu_torch.ops.vmem_sort.sort_planes_vmem`` runs its plain
version (:func:`.cuda_kernels.bitonic_plain`) on CPU tensors; the JAX
package's ``sort_planes_vmem`` runs its Pallas kernel in interpret mode, as
tests/test_vmem_sort.py runs it. The cases mirror that file: keys-only
input and distinct key tuples, where the sorted output is unique and both
packages agree bit for bit, and the gate and its errors. Equal key tuples
with a payload are the R1 case of ROADMAP.md §3: the port's records are a
permutation of the input, the JAX package's duplicate payloads.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from radix_sorting_tpu.ops import vmem_sort as jvs
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import vmem_sort as tvs

SIZES = [1, 5, 777, 1024, 2048, 4096]


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


def both(planes, num_keys):
    """(JAX output, port output) of the same u32 planes, as numpy u32."""
    j = jvs.sort_planes_vmem(tuple(jnp.asarray(p) for p in planes), num_keys)
    t = tvs.sort_planes_vmem(tuple(torch.from_numpy(p.view(np.int32)) for p in planes),
                             num_keys)
    return ([np.asarray(x) for x in j], [x.numpy().view(np.uint32) for x in t])


@pytest.mark.parametrize("n", SIZES)
def test_keys_only_matches_jax(n):
    x = rng_of(n).integers(0, 1 << 32, size=n, dtype=np.uint32)
    (js,), (ts,) = both([x], 1)
    assert np.array_equal(ts, js) and np.array_equal(ts, np.sort(x))


@pytest.mark.parametrize("style", ["sorted", "reversed", "four values", "zeros",
                                   "all ones"])
def test_degenerate_styles_match_jax(style):
    base = rng_of(7).integers(0, 1 << 32, size=2000, dtype=np.uint32)
    x = {"sorted": np.sort(base), "reversed": np.sort(base)[::-1].copy(),
         "four values": (base % 4 * 0x40000001).astype(np.uint32),
         "zeros": np.zeros(2000, np.uint32),
         "all ones": np.full(2000, 0xFFFFFFFF, np.uint32)}[style]   # = the padding key
    (js,), (ts,) = both([x], 1)
    assert np.array_equal(ts, js) and np.array_equal(ts, np.sort(x))


@pytest.mark.parametrize("n", SIZES)
def test_two_key_planes_match_jax(n):
    rng = rng_of(n + 1)
    hi = rng.integers(0, 4, size=n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    j, t = both([hi, lo], 2)
    order = np.lexsort((lo, hi))
    for a, b, want in zip(j, t, (hi[order], lo[order])):
        assert np.array_equal(b, a) and np.array_equal(b, want)


@pytest.mark.parametrize("n", SIZES)
def test_stable_rank_composite_matches_jax(n):
    # (key, index) as two key planes: the unique stable permutation
    k = rng_of(n + 2).integers(0, 16, size=n, dtype=np.uint32)
    idx = np.arange(n, dtype=np.uint32)
    j, t = both([k, idx], 2)
    assert all(np.array_equal(a, b) for a, b in zip(j, t))
    assert np.array_equal(t[1], np.argsort(k, kind="stable").astype(np.uint32))


@pytest.mark.parametrize("n", SIZES)
def test_payload_plane_rides_like_jax(n):
    rng = rng_of(n + 3)
    k = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    idx = np.arange(n, dtype=np.uint32)
    pay = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    j, t = both([k, idx, pay], 2)
    o = np.argsort(k, kind="stable")
    assert all(np.array_equal(a, b) for a, b in zip(j, t))
    assert np.array_equal(t[0], k[o]) and np.array_equal(t[2], pay[o])


@pytest.mark.parametrize("n", [777, 4096])
def test_r1_equal_keys_keep_a_permutation_of_the_records(n):
    # 16 key values, one key plane, a payload of distinct values
    k = rng_of(n + 4).integers(0, 16, size=n, dtype=np.uint32)
    k[:3] = 0xFFFFFFFF                       # ties with the padding key, too
    pay = np.arange(n, dtype=np.uint32)
    (jk, jp), (tk, tp) = both([k, pay], 1)
    assert np.array_equal(tk, np.sort(k)) and np.array_equal(jk, tk)
    # the port: every record once, each payload beside its own key
    assert np.array_equal(np.sort(tp), pay) and np.array_equal(k[tp], tk)
    # the JAX package (R1): both partners of an equal pair take the lower
    # one's record, so payloads come out duplicated and others lost
    assert np.unique(jp).size < n


def test_plain_network_is_the_kernels_contract():
    # bitonic_plain pads to the network's size; its pads never move, so the
    # kernel's skipping of pairs past n gives the same output
    assert ck.bitonic_pad_len(1) == ck.bitonic_pad_len(1024) == 1024
    assert ck.bitonic_pad_len(1025) == 2048
    x = rng_of(9).integers(0, 4, size=3000, dtype=np.uint32)
    planes = (torch.from_numpy(x.view(np.int32)), torch.arange(3000, dtype=torch.int32))
    before = ck.launch_counts()
    k, p = ck.bitonic(planes, 1)
    assert ck.launch_counts() == before      # the plain version counts nothing
    assert torch.equal(k, planes[0][p.long()])


def test_gates_and_errors_match_jax():
    for args in [(0, 1), (1, 1), (tvs.VMEM_SORT_MIN_PAD, 1), ((1 << 17) + 1, 1),
                 (1 << 17, 12), (1 << 17, 13), (1 << 17, 16), (5000, 300)]:
        assert tvs.vmem_sort_ok(*args) == jvs.vmem_sort_ok(*args), args
    assert tvs.vmem_sort_ok(1 << 17, 1, max_elems=1 << 17)
    assert not tvs.vmem_sort_ok(1 << 17, 1, max_elems=1 << 16)
    assert tvs.VMEM_SORT_MIN_PAD == jvs.VMEM_SORT_MIN_PAD
    assert tvs.VMEM_SORT_MAX_ELEMS == jvs.VMEM_SORT_MAX_ELEMS
    x = torch.zeros(64, dtype=torch.int32)
    for bad in [lambda: tvs.sort_planes_vmem((x,), 0),
                lambda: tvs.sort_planes_vmem((x,), 2),
                lambda: tvs.sort_planes_vmem((x.long(),), 1),       # JAX: non-uint32
                lambda: tvs.sort_planes_vmem((x, torch.zeros(32, dtype=torch.int32)), 1)]:
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------------------
# K12's resident route on the card, modelled in numpy: the trips of
# cuda_kernels.bitonic_trips run as the kernel runs them (codes, swizzled
# words, cosets of 2^dims records a thread, blocks of one cluster), held
# against bitonic_plain


def _resident_slices(planes, num_keys, blocks):
    """The (blocks, planes, slice) shared memory after the kernel's load:
    each block's slice at its swizzled words, padding keys all-ones."""
    x = np.stack([p.numpy().view(np.uint32) for p in planes]).astype(np.uint64)
    nplanes, n = x.shape
    size = ck.bitonic_pad_len(n)
    full = np.zeros((nplanes, size), np.uint64)
    full[:, :n] = x
    full[:num_keys, n:] = 0xFFFFFFFF
    S = size // blocks
    sw = np.array([ck.bitonic_swizzle(i) for i in range(S)])
    smem = np.zeros((blocks, nplanes, S), np.uint64)
    for r in range(blocks):
        smem[r][:, sw] = full[:, r * S:(r + 1) * S]
    return smem, sw, n


def _unload(smem, sw, n):
    return np.concatenate([s[:, sw] for s in smem], axis=1)[:, :n].astype(np.uint32)


def _exchange_np(v, e, f, num_keys):
    """Swap records e, f (axis 1 of (cosets, records, planes)) where key(e) > key(f)."""
    a, b = v[:, e, :].copy(), v[:, f, :].copy()
    gt, eq = np.zeros(len(a), bool), np.ones(len(a), bool)
    for p in range(num_keys):
        gt |= eq & (a[:, p] > b[:, p])
        eq &= a[:, p] == b[:, p]
    v[:, e, :] = np.where(gt[:, None], b, a)
    v[:, f, :] = np.where(gt[:, None], a, b)


def run_trips_np(planes, num_keys):
    """The resident route: for each trip, every coset's records gathered by
    code (block << 16 | swizzled word), the steps run in the coset's
    coordinates, the records put back."""
    nplanes, n = len(planes), planes[0].shape[0]
    blocks = ck.bitonic_route(n, nplanes)
    dims = ck.bitonic_trip_dims(n, nplanes)
    smem, sw, n = _resident_slices(planes, num_keys, blocks)
    size = ck.bitonic_pad_len(n)
    words = np.array(ck.bitonic_trips(size.bit_length() - 1, blocks, dims), np.int64)
    R = 1 << dims
    for t in (words & 0xFFFFFFFF).reshape(-1, ck.BITONIC_TRIP_WORDS):
        head, bits = int(t[0]), int(t[1])
        c = np.arange(size // R)
        code = np.zeros_like(c)
        for b in range(bits):
            code ^= np.where((c >> b) & 1, t[2 + dims + b], 0)
        rel = np.zeros(R, np.int64)
        for e in range(1, R):
            rel[e] = rel[e & (e - 1)] ^ t[2 + (e & -e).bit_length() - 1]
        at = code[:, None] ^ rel[None, :]
        blk, word = at >> 16, at & 0xFFFF
        assert np.unique(at).size == size          # every record once a trip
        if not head >> 31:                         # a local trip stays in its block
            assert (blk == (c * R // (size // blocks))[:, None]).all()
        v = smem[blk, :, word]
        for s in range(dims):
            field = head >> (5 * s) & 31
            if field & 1:
                b, mirror = field >> 2, field >> 1 & 1
                for e in range(R):
                    if not e >> b & 1:
                        _exchange_np(v, e, e ^ ((2 << b) - 1 if mirror else 1 << b), num_keys)
        smem[blk, :, word] = v
    return _unload(smem, sw, n)


@pytest.mark.parametrize("n,nplanes,num_keys", [
    (1, 1, 1), (1000, 2, 1), (1024, 1, 1), (1025, 2, 2), (4097, 3, 2), (8191, 1, 1),
    (8193, 4, 3), (20_000, 2, 1), (1 << 14, 3, 3), (1 << 17, 1, 1), (3000, 4, 4),
    ((1 << 16) - 5, 4, 1), ((1 << 17) - 3, 3, 2)])
def test_resident_trips_run_the_network(n, nplanes, num_keys):
    rng = rng_of(n + nplanes)
    planes = [torch.from_numpy(rng.integers(0, 4 if p < num_keys else 1 << 32, size=n)
                               .astype(np.uint32).view(np.int32)) for p in range(nplanes)]
    assert ck.bitonic_route(n, nplanes) in (1, 8)
    want = np.stack([p.numpy().view(np.uint32) for p in ck.bitonic_plain(planes, num_keys)])
    assert np.array_equal(run_trips_np(planes, num_keys), want)


def test_resident_route_is_chosen_by_shape():
    # one cluster of 8 from 8 x 1,024 keys, one block below, up to 4 planes
    # whose slices fit a block's 227 KB; past that, tiles (0)
    assert ck.bitonic_route(8191, 1) == ck.bitonic_route(1 << 17, 3) == 8
    assert ck.bitonic_route(1, 1) == ck.bitonic_route(4096, 4) == 1
    assert ck.bitonic_route(1 << 17, 4) == ck.bitonic_route(4096, 5) == 0
    assert ck.bitonic_route(1 << 16, 4) == 8 and ck.bitonic_route(1 << 16, 5) == 0
    assert ck.bitonic_route(1024, 35) == ck.bitonic_route(1024, 1536) == 0
    # past 2^17 padded keys the trips would not fit the kernel's table: tiles
    assert ck.bitonic_route((1 << 17) + 1, 1) == ck.bitonic_route(1 << 18, 1) == 0
    assert ck.bitonic_trip_dims(1 << 17, 1) == 5
    assert ck.bitonic_trip_dims(1 << 16, 1) == ck.bitonic_trip_dims(1 << 17, 2) == 4


@pytest.mark.parametrize("log_n", range(10, 18))
def test_trip_tables_fit_the_kernel(log_n):
    # at most 48 trips (the kernel's parameter block); a trip that crosses
    # blocks keeps bits 0-4 for the lanes (128 contiguous bytes a warp)
    blocks = 8 if log_n >= 13 else 1
    for dims in (4, 5):
        t = (np.array(ck.bitonic_trips(log_n, blocks, dims), np.int64)
             & 0xFFFFFFFF).reshape(-1, ck.BITONIC_TRIP_WORDS)
        assert len(t) <= 48 and (t[:, 1] == log_n - dims).all()
        for trip in t[t[:, 0] >> 31 == 1]:
            assert [int(c) for c in trip[2 + dims:7 + dims]] == [1, 2, 4, 8, 16]


@pytest.mark.parametrize("dims", [4, 5])
def test_trip_tables_past_the_kernel_are_refused(dims):
    # 2^18 records take 20 words a trip; the kernel reads 19
    with pytest.raises(ValueError, match="20 words"):
        ck.bitonic_trips(18, 8, dims)


def test_every_trip_shape_has_straight_line_code():
    # csrc/bitonic.cu runs each trip shape it lists (RST_TRIP_SHAPES) as
    # straight-line code and refuses a table with any other; every shape the
    # schedules of the resident route's sizes make is listed
    import re
    from pathlib import Path
    src = (Path(ck.__file__).resolve().parent.parent / "csrc" / "bitonic.cu").read_text()
    body = re.search(r"#define RST_TRIP_SHAPES\(X\)((?:.*\\\n)*.*)", src).group(1)
    listed = set()
    for fields in re.findall(r"X\(([\d, ]+)\)", body):
        listed.add(sum(int(f) << (5 * s) for s, f in enumerate(fields.split(","))))
    assert len(listed) == 15
    made = set()
    for log_n in range(10, 18):
        size = 1 << log_n
        for nplanes in (1, 2, 3, 4):
            blocks = ck.bitonic_route(size, nplanes)
            if blocks:
                dims = ck.bitonic_trip_dims(size, nplanes)
                made |= {w & 0x1FFFFFF for w in ck.bitonic_trips(log_n, blocks, dims)
                         [::ck.BITONIC_TRIP_WORDS]}
    assert made and made <= listed
