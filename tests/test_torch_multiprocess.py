"""The port's distributed tier across real processes: the group mesh.

The counterpart of tests/test_multiprocess.py (which runs the JAX package
with ``jax.distributed`` and is opt-in), in the tier-1 run: it spawns the
port's worker (``python -m radix_sorting_tpu_torch.scripts.mp_worker``)
with gloo on the CPU at (processes, ranks a process) = (2, 4) and (4, 2),
D = 8, at n = 2^16 and at n = 2^12 + 24 (equal slices, but not a multiple
of D^2: each process appends its share of the pad rows, where the
single-controller form appends them all at the global tail), the four
launches at once. Each worker checks its own shards
against numpy and prints ``MP_OK <pid>``; here its outputs, concatenated in
global rank order, are held bit for bit (padded shards, counts,
permutations, selections; the group-by sums are i32 mod 2^32) against
numpy, against the port's single-controller run on ``SortMesh(("cpu",) *
8)`` (which tests/test_torch_balanced.py holds against the JAX package)
and, for ``distributed_sort_balanced_u32`` and ``distributed_sort_u32``,
against the JAX package on its eight virtual CPU devices.

A launch has a 120 s timeout and kills every worker when one fails or the
time is up (``utils.mpharness.run_workers``); each worker's collectives
time out after 60 s, so a dead peer fails the run instead of hanging it.
In this process a gloo group of one process checks the group collectives
against the single-controller ones, K13's plain version in its group form,
and the harness itself.
"""

import concurrent.futures
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from radix_sorting_tpu import parallel as jpar
from radix_sorting_tpu_torch import parallel as tpar
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.parallel import _mesh, rdma
from radix_sorting_tpu_torch.scripts import mp_worker
from radix_sorting_tpu_torch.utils import mpharness

from test_torch_parallel import _jit, bits, jmesh, same_all

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 16
NP = (1 << 12) + 24  # pad rows: 40 to a multiple of D^2 = 64, 20 or 10 a process
CONFIGS = [(2, 4, N), (4, 2, N), (2, 4, NP), (4, 2, NP)]
IDS = [f"{p}x{l}" + ("" if n == N else f"_n{n}") for p, l, n in CONFIGS]
SHARDED = {   # output name -> its parts; the shards' valid rows are counts' prefixes
    "balanced overlap=False": ("keys", "counts", "overflow"),
    "balanced overlap=True": ("keys", "counts", "overflow"),
    "shuffle uniform": ("keys", "counts", "overflow"),
    "shuffle skewed exact": ("keys", "counts", "overflow"),
    "balanced argsort": ("keys", "perm", "counts"),
    "unique_sorted": ("values", "counts"),
    "group_reduce groups=None": ("keys", "sums", "counts"),
    "group_reduce groups=97": ("keys", "sums", "counts"),
}
REPLICATED = ("select", "quantile", "bincount", "top_k.values", "top_k.indices")
NAMES = [f"{k}.{p}" for k, parts in SHARDED.items() for p in parts] + list(REPLICATED)
GROUP_CASES = ("mesh.size is the global D", "exchange='rdma' equals 'xla'",
               "unequal slices refused on every process", "gather_sorted without mesh= refused")


def _launch(nproc, local, n, tmp):
    port = mpharness.free_port()
    env = mpharness.worker_env(local, {
        "PYTHONPATH": _REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "OMP_NUM_THREADS": "1"})
    cmds = [[sys.executable, "-m", "radix_sorting_tpu_torch.scripts.mp_worker", str(pid),
             str(nproc), str(port), "--backend", "gloo", "--device", "cpu", "--n", str(n),
             "--out", os.path.join(tmp, f"{nproc}x{local}_{n}_{pid}.npz")]
            for pid in range(nproc)]
    return mpharness.run_workers(cmds, env=env, cwd=_REPO, timeout_s=120)


def _single_controller(n):
    """The single-controller port at n keys on eight CPU ranks: the nine
    surfaces' outputs and the rest of the surface's."""
    mesh = tpar.make_sort_mesh(devices=["cpu"] * 8)
    outs, failures = mp_worker.surfaces(mesh, n, "xla", log=lambda line: None)
    assert not failures
    return outs, mp_worker.rest_of_surface(mesh, n, "xla")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Every launch at once, and the single-controller runs while they go:
    ({config: (worker results, per-process outputs)}, {n: single-controller})."""
    tmp = str(tmp_path_factory.mktemp("mp"))
    # the workers take the cores: one thread here, like each of them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(CONFIGS)) as pool:
            futs = {c: pool.submit(_launch, *c, tmp) for c in CONFIGS}
            single = {n: _single_controller(n) for n in (N, NP)}
            results = {c: f.result() for c, f in futs.items()}
    finally:
        torch.set_num_threads(threads)
    out = {}
    for (nproc, local, n), res in results.items():
        files = [os.path.join(tmp, f"{nproc}x{local}_{n}_{pid}.npz") for pid in range(nproc)]
        out[(nproc, local, n)] = (res, [dict(np.load(f)) if os.path.exists(f) else None
                                        for f in files])
    return out, single


@pytest.fixture(scope="module")
def runs(both):
    return both[0]


@pytest.fixture(scope="module")
def singles(both):
    return both[1]


@pytest.fixture(scope="module")
def single(singles):
    return singles[N]


def _workers_of(runs, config):
    res, outs = runs[config]
    for pid, (rc, text) in enumerate(res):
        assert rc == 0 and f"MP_OK {pid}" in text, f"worker {pid} failed:\n{text[-4000:]}"
    return outs


def _concat(outs, name):
    return np.concatenate([o[name] for o in outs])


REST = ("sort f32 descending", "sort f32 shuffle", "argsort i32", "argsort i32 shuffle",
        "argsort_u32 shuffle", "sort_pairs f32 tree", "sort_pairs_u32 shuffle",
        "sort_pairs_balanced_u32", "median f32", "global_digit_histogram",
        "global_live_bit_mask", "rdma_all_to_all", "group_reduce min", "group_reduce max",
        "group_reduce mean", "group_reduce count", "group_reduce count groups=97")


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_workers_ok(runs, singles, config):
    outs, single = _workers_of(runs, config), singles[config[2]]
    assert all(set(o) - {"stats"} == set(NAMES) | set(single[1]) for o in outs)
    assert {k.split(".")[0] for k in single[1]} == set(REST)
    stats = json.loads(str(outs[0]["stats"]))
    assert stats["launches"]["rdma_exchange"] == 0      # the CPU: the plain version


@pytest.mark.parametrize("case", GROUP_CASES)
@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_group_cases_in_every_worker(runs, config, case):
    res, _ = runs[config]
    for pid, (_, text) in enumerate(res):
        assert any(line.startswith(f"[{pid}] {case}") and ": ok (gloo" in line
                   for line in text.splitlines()), text[-2000:]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_against_single_controller(runs, singles, config, name):
    outs, want = _workers_of(runs, config), singles[config[2]][0][name]
    if name in REPLICATED:
        for o in outs:
            assert np.array_equal(o[name], want)
    else:
        got = _concat(outs, name)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", REST)
@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_rest_of_the_surface_against_single_controller(runs, singles, config, name):
    # every other public function of parallel/ runs on a group mesh, with the
    # single-controller form's output: a replicated one on every process
    outs, single = _workers_of(runs, config), singles[config[2]]
    keys = [k for k in single[1] if k.split(".")[0] == name]
    assert keys
    for k in keys:
        want = single[1][k]
        if outs[0][k].shape == want.shape:
            assert all(np.array_equal(bits(o[k]), bits(want)) for o in outs), k
        else:
            got = _concat(outs, k)
            assert got.dtype == want.dtype and np.array_equal(bits(got), bits(want)), k


def _valid(outs, name, part):
    """The valid rows of a sharded output: each shard's counts prefix."""
    counts = _concat(outs, f"{name}.counts")
    rows = _concat(outs, f"{name}.{part}").reshape(len(counts), -1)
    return np.concatenate([r[:c] for r, c in zip(rows, counts)])


@functools.lru_cache(maxsize=None)
def _numpy_oracle(n):
    inp = mp_worker.inputs(n)
    x, small, gk, gv = inp["x"], inp["small"], inp["gk"], inp["gv"]
    uq, inv = np.unique(gk, return_inverse=True)
    sums = np.zeros(len(uq), np.int64)
    np.add.at(sums, inv, gv.astype(np.int64))
    order = np.argsort(-x.astype(np.int64), kind="stable")[:32]
    want = {"balanced overlap=False.keys": np.sort(x), "balanced overlap=True.keys": np.sort(x),
            "shuffle uniform.keys": np.sort(x), "shuffle skewed exact.keys": np.sort(inp["skew"]),
            "balanced argsort.keys": np.sort(x),
            "balanced argsort.perm": np.argsort(x, kind="stable").astype(np.uint32),
            "unique_sorted.values": np.unique(small),
            "select": np.sort(x)[[0, 1, n // 2, n - 1]],
            "quantile": np.quantile(x, [0.25, 0.75], method="lower").astype(np.uint32),
            "bincount": np.bincount(small, minlength=5000),
            "top_k.values": x[order], "top_k.indices": order.astype(np.uint32)}
    for g in ("None", "97"):
        want[f"group_reduce groups={g}.keys"] = uq
        want[f"group_reduce groups={g}.sums"] = sums.astype(np.int32)
    return want


NUMPY_NAMES = sorted(_numpy_oracle(N))


@pytest.mark.parametrize("name", NUMPY_NAMES)
@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_against_numpy(runs, config, name):
    outs = _workers_of(runs, config)
    want = _numpy_oracle(config[2])[name]
    if name in REPLICATED:
        got = outs[0][name]
    else:
        base, part = name.rsplit(".", 1)
        got = _valid(outs, base, part)
        if f"{base}.overflow" in outs[0]:
            assert not _concat(outs, f"{base}.overflow").any()
    assert np.array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_sort(n, name, fn, kw):
    """The JAX package's sort of the worker's input at n keys, on its eight
    virtual CPU devices (once for both launches at n)."""
    inp = mp_worker.inputs(n)
    return _jit(fn, inp["skew"] if "skewed" in name else inp["x"], mesh=jmesh(), **dict(kw))


@pytest.mark.parametrize("name,fn,kw", [
    ("balanced overlap=False", jpar.distributed_sort_balanced_u32, {"overlap": False}),
    ("balanced overlap=True", jpar.distributed_sort_balanced_u32, {"overlap": True}),
    ("shuffle uniform", jpar.distributed_sort_u32, {}),
    ("shuffle skewed exact", jpar.distributed_sort_u32, {"exact": True})])
@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_sorts_against_jax(runs, config, name, fn, kw):
    outs = _workers_of(runs, config)
    want = _jax_sort(config[2], name, fn, tuple(kw.items()))
    same_all([_concat(outs, f"{name}.{p}") for p in ("keys", "counts", "overflow")], want)


# ---------------------------------------------------------------------------
# in this process: a gloo group of one process


@pytest.fixture(scope="module")
def group():
    mpharness.init_worker(0, 1, f"127.0.0.1:{mpharness.free_port()}", backend="gloo",
                          timeout_s=60)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_group_of_one_matches_single_controller(group, single):
    # every collective takes its group form (all_reduce, all_gather_into_tensor,
    # all_to_all_single; ppermute stays local at world size 1)
    mesh = tpar.make_sort_mesh(devices=["cpu"] * 8, group=group)
    assert mesh.size == 8 and mesh.num_processes == 1 and list(mesh.ranks) == list(range(8))
    for exchange in ("xla", "rdma"):
        outs, failures = mp_worker.surfaces(mesh, N, exchange, log=lambda line: None)
        assert not failures
        want = dict(single[0])
        if exchange == "xla":
            outs.update(mp_worker.rest_of_surface(mesh, N, exchange))
            want.update(single[1])
        assert set(outs) == set(want)
        for name, v in outs.items():
            assert v.dtype == want[name].dtype and np.array_equal(bits(v), bits(want[name]))


def test_group_collectives(group):
    one = tpar.make_sort_mesh(devices=["cpu"] * 4)
    grp = tpar.make_sort_mesh(devices=["cpu"] * 4, group=group)
    r = np.random.default_rng(5)
    xs = [torch.from_numpy(r.integers(-2**31, 2**31, (4, 8))).to(torch.int32)
          for _ in range(4)]
    us = [x.view(torch.uint32) for x in xs]
    for a, b in ((_mesh.psum(xs, one), _mesh.psum(xs, grp)),
                 (_mesh.psum(us, one), _mesh.psum(us, grp)),       # gloo refuses uint32
                 (_mesh.pmax(xs, one), _mesh.pmax(xs, grp)),
                 (_mesh.all_gather(xs, one), _mesh.all_gather(xs, grp)),
                 (_mesh.all_gather(us, one, tiled=True), _mesh.all_gather(us, grp, tiled=True)),
                 (_mesh.all_to_all(xs, one), _mesh.all_to_all(xs, grp)),
                 (_mesh.all_to_all(xs, one, axis=1), _mesh.all_to_all(xs, grp, axis=1)),
                 (_mesh.ppermute(xs, one, 3), _mesh.ppermute(xs, grp, 3))):
        assert all(u.dtype == v.dtype and torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(TypeError, match="widen"):
        _mesh.pmax(us, grp)


@pytest.mark.parametrize("m,dtype", [(1, torch.int32), (37, torch.int16), (5, torch.int64)])
def test_rdma_plain_group_form(group, m, dtype):
    # the plain version of K13 on a group mesh: the group's all_to_all_single
    mesh = tpar.make_sort_mesh(devices=["cpu"] * 4, group=group)
    peers = rdma.peers(mesh)
    sends = [torch.from_numpy(np.random.default_rng(m + s).integers(-2**15, 2**15, (4, m)))
             .to(dtype) for s in range(4)]
    before = ck.launch_counts()["rdma_exchange"]
    for got in (ck.rdma_exchange_plain(sends, peers), ck.rdma_exchange(sends, peers)):
        for a, b in zip(got, ck.rdma_exchange_plain(sends)):
            assert a.dtype == dtype and torch.equal(a, b)
    assert ck.launch_counts()["rdma_exchange"] == before
    with pytest.raises(ValueError, match="sends for this process's 4 ranks"):
        ck.rdma_exchange_plain(sends[:3], peers)


def test_mesh_close_drops_its_peers(group):
    # K13's peers are kept by the mesh's value, in parallel/rdma.py: an equal
    # mesh shares them, another mesh over the group has its own, and after
    # close_peers a second mesh over the group opens fresh ones
    mesh = tpar.make_sort_mesh(devices=["cpu"] * 2, group=group)
    first = rdma.peers(mesh)
    assert rdma.peers(tpar.make_sort_mesh(devices=["cpu"] * 2, group=group)) is first
    other = tpar.make_sort_mesh(devices=["cpu"] * 2, axis_name="other", group=group)
    assert rdma.peers(other) is not first
    rdma.close_peers(other)
    rdma.close_peers(mesh)
    second = tpar.make_sort_mesh(devices=["cpu"] * 2, group=group)
    assert rdma.peers(second) is not first
    rdma.close_peers(second)
    rdma.close_peers(second)            # closing twice is a no-op
    assert mesh not in rdma._PEERS
    with pytest.raises(ValueError, match="no peers"):
        rdma.peers(tpar.make_sort_mesh(devices=["cpu"]))


def test_group_mesh_is_a_value(group):
    # the world size and the process index are read from the group; the mesh
    # holds nothing else
    a = tpar.make_sort_mesh(devices=["cpu"] * 2, group=group)
    b = tpar.make_sort_mesh(devices=["cpu"] * 2, group=group)
    assert a == b and hash(a) == hash(b)
    assert (a.num_processes, a.process_index, a.size) == (1, 0, 2)
    assert tpar.SortMesh(("cpu",) * 2, group=group) == a
    assert set(vars(a)) == {"devices", "axis_name", "group"}


def test_gloo_never_carries_the_bulk_exchange_of_cuda_tensors(group):
    class OnCard:
        is_cuda = True
    mesh = tpar.make_sort_mesh(devices=["cpu"] * 2, group=group)
    with pytest.raises(ValueError, match="exchange='rdma'"):
        _mesh._check_bulk(mesh, [OnCard()], "exchange='xla'")
    _mesh._check_bulk(tpar.make_sort_mesh(devices=["cpu"] * 2), [OnCard()], "one process")
    assert "gloo, 1 processes x 2 ranks" == mp_worker.wire_note(mesh)


def test_gather_sorted_over_the_group(group):
    mesh = tpar.make_sort_mesh(devices=["cpu"] * 4, group=group)
    x = np.random.default_rng(3).integers(0, 1 << 32, size=4096, dtype=np.uint32)
    out = tpar.distributed_sort_u32(x, mesh)
    assert np.array_equal(tpar.gather_sorted(*out, mesh=mesh), np.sort(x))
    assert np.array_equal(tpar.gather_sorted(*out), np.sort(x))


# ---------------------------------------------------------------------------
# the harness


def test_worker_env_scrubs_the_ambient_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.setenv(k, "7")
    env = mpharness.worker_env(3, {"EXTRA": "1"})
    assert not {"RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"} & set(env)
    assert env["RST_MP_LOCAL_DEVICES"] == "3" and env["EXTRA"] == "1"
    with pytest.raises(ValueError, match="backend"):
        mpharness.init_worker(0, 1, "127.0.0.1:1", backend="mpi")


def test_run_workers_kills_every_worker_when_one_fails():
    t0 = time.monotonic()
    res = mpharness.run_workers([[sys.executable, "-c", "import sys; sys.exit(3)"],
                                 [sys.executable, "-c", "import time; time.sleep(60)"]],
                                timeout_s=50)
    assert time.monotonic() - t0 < 30
    assert res[0][0] == 3 and res[1][0] < 0
    with pytest.raises(TimeoutError, match="all killed"):
        mpharness.run_workers([[sys.executable, "-c", "import time; time.sleep(60)"]],
                              timeout_s=1)


def test_worker_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs a machine without one")
    proc = subprocess.run([sys.executable, "-m", "radix_sorting_tpu_torch.scripts.mp_worker",
                           "0", "1", str(mpharness.free_port()), "--device", "cuda"],
                          cwd=_REPO, env=mpharness.worker_env(1), capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
