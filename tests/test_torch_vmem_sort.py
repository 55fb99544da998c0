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
