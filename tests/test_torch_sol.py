"""E1 and E2, the speed-of-light kernels, the MSD pipeline that runs E2, and
K12 past 32 planes, on the CPU.

E1 (``cuda_kernels.dma_copy``) and E2 (``cuda_kernels.msd_spread``) run
their plain versions on CPU tensors. The JAX package's E2 and the MSD
pipeline around it (``scripts/exp_sol_round2.py``) have no interpret mode,
so E2's plain version is held against a numpy restatement of that Pallas
kernel, and the port's pipeline against ``np.sort``. K12 with more than 32
planes is held against the JAX package's ``sort_planes_vmem`` in interpret
mode at 33 planes; at 40 planes and 34 keys that mode takes minutes on the
CPU, so there the port is held against the JAX package's sorter
(``hw_engine.sort_words``), which gives the same output for distinct key
tuples.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from radix_sorting_tpu.ops import hw_engine as jhw
from radix_sorting_tpu.ops import vmem_sort as jvs
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import vmem_sort as tvs
from radix_sorting_tpu_torch.scripts import exp_sol_probe, exp_sol_round2

SENT = np.uint32(0xFFFFFFFF)


def rng_of(seed):
    return np.random.Generator(np.random.PCG64(seed))


def plane(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# E1


@pytest.mark.parametrize("n", [0, 1, 8191, 8192, 100_003])
def test_dma_copy_plain_is_the_identity(n):
    x = plane(rng_of(n).integers(0, 1 << 32, size=n, dtype=np.uint32))
    before = ck.launch_counts()
    got = ck.dma_copy(x)
    assert ck.launch_counts() == before          # the plain version counts nothing
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr() or n == 0
    assert torch.equal(ck.dma_copy_plain(x), x)


def test_dma_copy_rejects_bad_planes():
    for bad, exc in ((torch.zeros(4, dtype=torch.int64), TypeError),
                     (torch.zeros((2, 2), dtype=torch.int32), TypeError),
                     (torch.zeros(8, dtype=torch.int32)[::2], ValueError)):
        with pytest.raises(exc):
            ck.dma_copy(bad)


# ---------------------------------------------------------------------------
# E2


def spread_np(s128, xp, m, d, capr):
    """``exp_sol_round2.py:128-138`` in numpy, one grid step (r, k) at a time."""
    R, K = s128.shape
    out = np.empty((K, R, capr, 128), np.uint32)
    rowi, coli = np.indices((capr, 128))
    for r in range(R):
        for k in range(K):
            s = int(s128[r, k])
            w = xp[r, s:s + capr, :]
            pos = (s + rowi) * 128 + coli
            bucket = (w >> np.uint32(32 - d)).astype(np.int32)
            out[k, r] = np.where((bucket == k) & (pos < m), w, SENT)
    return out


def msd_inputs(R, m, d, capr, seed):
    """Row-sorted rows padded to W * 128 with all-ones, and each bucket's
    first 128-key row."""
    K = 1 << d
    W = -(-m // 128) + capr
    rows = np.sort(rng_of(seed).integers(0, 1 << 32, size=(R, m), dtype=np.uint32), axis=1)
    xp = np.full((R, W * 128), SENT, np.uint32)
    xp[:, :m] = rows
    starts = np.stack([np.searchsorted(row >> np.uint32(32 - d), np.arange(K)) for row in rows])
    return (starts // 128).astype(np.int32), xp.reshape(R, W, 128)


@pytest.mark.parametrize("R,m,d,capr", [(3, 1000, 2, 4), (4, 777, 3, 3), (2, 200, 1, 2),
                                        (5, 5000, 4, 5)])
def test_msd_spread_plain_matches_the_tpu_kernel(R, m, d, capr):
    s128, xp = msd_inputs(R, m, d, capr, R * m)
    want = spread_np(s128, xp, m, d, capr)
    before = ck.launch_counts()
    got = ck.msd_spread(torch.from_numpy(s128), plane(xp), m, d, capr)
    assert ck.launch_counts() == before
    assert got.shape == (1 << d, R, capr, 128)
    assert np.array_equal(u32(got), want)
    assert np.array_equal(u32(ck.msd_spread_plain(torch.from_numpy(s128), plane(xp), m, d,
                                                   capr)), want)


def test_msd_spread_plain_at_any_window():
    # windows from any row inside [0, W - capr], and d = 32 (a bucket per key)
    R, m, capr = 3, 900, 3
    _, xp = msd_inputs(R, m, 2, capr, 11)
    W = xp.shape[1]
    s128 = rng_of(12).integers(0, W - capr + 1, size=(R, 4)).astype(np.int32)
    got = ck.msd_spread_plain(torch.from_numpy(s128), plane(xp), m, 2, capr)
    assert np.array_equal(u32(got), spread_np(s128, xp, m, 2, capr))
    xk = np.arange(128, dtype=np.uint32).reshape(1, 1, 128)
    got = u32(ck.msd_spread_plain(torch.zeros((1, 2), dtype=torch.int32), plane(xk), 128, 32, 1))
    want = np.full((2, 1, 1, 128), SENT)
    want[0, 0, 0, 0], want[1, 0, 0, 1] = 0, 1       # bucket k holds the key k alone
    assert np.array_equal(got, want)


def test_msd_spread_rows_outside_the_row_are_all_ones():
    # the port's contract where the TPU kernel reads out of bounds: rows
    # before 0 or past W give all-ones
    R, m, capr = 2, 300, 4
    _, xp = msd_inputs(R, m, 1, capr, 13)
    W = xp.shape[1]
    s128 = np.array([[-2, W - 1], [W - 2, -5]], np.int32)
    padded = np.full((R, W + 2 * capr + 8, 128), SENT, np.uint32)
    padded[:, capr + 4:capr + 4 + W] = xp
    want = spread_np(s128 + capr + 4, padded, m + (capr + 4) * 128, 1, capr)
    # positions are counted from the real row 0: shift the bound back
    rowi, coli = np.indices((capr, 128))
    for r in range(R):
        for k in range(2):
            pos = (int(s128[r, k]) + rowi) * 128 + coli
            want[k, r] = np.where((pos >= 0) & (pos < m), want[k, r], SENT)
    got = ck.msd_spread_plain(torch.from_numpy(s128), plane(xp), m, 1, capr)
    assert np.array_equal(u32(got), want)


def test_msd_spread_rejects_bad_inputs():
    s, x = torch.zeros((2, 4), dtype=torch.int32), torch.zeros((2, 3, 128), dtype=torch.int32)
    for bad, exc in ((lambda: ck.msd_spread(s.long(), x, 10, 2, 1), TypeError),
                     (lambda: ck.msd_spread(s, x[:1], 10, 2, 1), ValueError),
                     (lambda: ck.msd_spread(s, x[..., :64].contiguous(), 10, 2, 1), ValueError),
                     (lambda: ck.msd_spread(s, x, 3 * 128 + 1, 2, 1), ValueError),
                     (lambda: ck.msd_spread(s, x, 10, 0, 1), ValueError),
                     (lambda: ck.msd_spread(s, x, 10, 33, 1), ValueError),
                     (lambda: ck.msd_spread(s, x, 10, 2, 0), ValueError),
                     (lambda: ck.msd_spread(s.t(), x, 10, 2, 1), ValueError)):
        with pytest.raises(exc):
            bad()


@pytest.mark.parametrize("style", ["uniform", "skewed low", "all ones"])
def test_msd_pipeline_matches_np_sort(style):
    # n = 2^16 as 16 rows of 4,096 keys and 16 buckets; windows of 4 rows
    n, R, K, capr = 1 << 16, 16, 16, 4
    keys = rng_of(14).integers(0, 1 << 32, size=n, dtype=np.uint32)
    if style == "skewed low":
        keys &= np.uint32(0x0FFFFFFF)                # every key in bucket 0
    elif style == "all ones":
        keys[::97] = SENT                            # ties with the padding
    pipeline, shapes, _ = exp_sol_round2.build_msd(n, R, K, capr)
    assert shapes == {"m": 4096, "W": 36, "win": 512, "d": 4}
    out, maxc = pipeline(plane(keys))
    fits = int(maxc) <= capr * 128 - 127
    assert fits == (style != "skewed low")
    if fits:
        assert np.array_equal(u32(out), np.sort(keys))
        assert exp_sol_round2.check_msd(keys, "cpu", R, K, capr)["bit_exact"]
    else:
        with pytest.raises(RuntimeError, match="msd pipeline"):
            exp_sol_round2.check_msd(keys, "cpu", R, K, capr)


def test_msd_pipeline_rejects_bad_shapes():
    with pytest.raises(ValueError):
        exp_sol_round2.build_msd(1000, 3, 16, 4)
    with pytest.raises(ValueError):
        exp_sol_round2.build_msd(1024, 4, 12, 4)


def test_sol_probes_run_on_the_cpu():
    cpu = torch.device("cpu")
    for probe in (exp_sol_probe.probe_stream, exp_sol_probe.probe_copy,
                  exp_sol_probe.probe_sorter, exp_sol_probe.probe_gather,
                  exp_sol_probe.probe_dma, exp_sol_probe.probe_canary):
        assert probe(cpu, n=1 << 14) > 0


def test_scripts_need_a_card(monkeypatch):
    from radix_sorting_tpu_torch.scripts import profile_headline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (exp_sol_probe.main, exp_sol_round2.main, profile_headline.main):
        with pytest.raises(SystemExit, match="CUDA"):
            main([])


def test_profile_headline_steps_chain_and_sort():
    from radix_sorting_tpu_torch.scripts import profile_headline as ph
    c = plane(rng_of(15).integers(0, 1 << 32, size=5000, dtype=np.uint32))
    assert not torch.equal(ph.headline(c), c) and not torch.equal(ph.masked(c), c)
    assert ph.REPO.joinpath("radix_sorting_tpu_torch").is_dir()


# ---------------------------------------------------------------------------
# K12 past 32 planes (the gate admits up to 1,536 at 1,024 keys)


@pytest.mark.parametrize("n,planes,keys", [(100, 33, 1), (1024, 40, 34)])
def test_sort_planes_vmem_past_32_planes_matches_jax(n, planes, keys):
    assert tvs.vmem_sort_ok(n, planes) and jvs.vmem_sort_ok(n, planes)
    rng = rng_of(n + planes)
    words = rng.integers(0, 1 << 32, size=(planes, n), dtype=np.uint32)
    words[0] = rng.permutation(n)          # distinct key tuples: one sorted output
    ws = tuple(jnp.asarray(w) for w in words)
    if planes * keys < 100:                # the Pallas kernel, interpreted
        j = jvs.sort_planes_vmem(ws, keys)
    else:                                  # the JAX package's sorter
        jk, jp = jhw.sort_words(ws[:keys], ws[keys:])
        j = jk + jp
    t = tvs.sort_planes_vmem(tuple(plane(w) for w in words), keys)
    order = np.argsort(words[0], kind="stable")
    for a, b, w in zip(j, t, words):
        assert np.array_equal(u32(b), np.asarray(a))
        assert np.array_equal(u32(b), w[order])


def test_sort_planes_vmem_at_the_gate_keeps_a_permutation():
    # the top plane count at 1,024 keys, 16 key values (R1): every record once
    n = 1024
    top = max(p for p in range(1, 4096) if tvs.vmem_sort_ok(n, p))
    assert top == 1536 and not tvs.vmem_sort_ok(n, top + 1)
    words = rng_of(16).integers(0, 1 << 32, size=(top, n), dtype=np.uint32)
    words[0] &= np.uint32(15)
    words[2] = np.arange(n)
    got = tvs.sort_planes_vmem(tuple(plane(w) for w in words), 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ck.bitonic_plain(
        tuple(plane(w) for w in words), 2)))
    perm = u32(got[2]).astype(np.int64)
    assert np.array_equal(np.sort(perm), np.arange(n))
    assert all(np.array_equal(u32(g), w[perm]) for g, w in zip(got, words))
    k = words[0][perm].astype(np.uint64) << np.uint64(32) | words[1][perm]
    assert (np.diff(k.astype(np.float64)) >= 0).all() and np.all(k[1:] >= k[:-1])
