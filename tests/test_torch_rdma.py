"""K13 (``csrc/exchange.cu``) of the port: its plain version and its wrapper.

On the CPU the wrapper ``cuda_kernels.rdma_exchange`` runs its plain version
(``rdma_exchange_plain``), and ``parallel.rdma_all_to_all`` reaches it from
per-rank tensors of an eight-rank CPU mesh (``devices=["cpu"] * 8``). Both
are held, bit for bit, against the JAX package's ``lax.all_to_all`` on its
eight virtual CPU devices (the ``"xla"`` exchange, which the JAX package's
own tests/test_rdma.py holds its Pallas kernel against), and in one small
case against the JAX Pallas kernel itself in interpret mode. The kernel on
the card is tests/test_torch_cuda.py's.

Divergence pinned here (ROADMAP.md §3): ``detect_races=True`` raises, since
the Pallas interpret-mode race detector has no counterpart in the port.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from radix_sorting_tpu.parallel import rdma_all_to_all as jax_rdma_all_to_all
from radix_sorting_tpu_torch import parallel as tp
from radix_sorting_tpu_torch.parallel import _mesh
from radix_sorting_tpu_torch.ops import cuda_kernels as ck

D = 8


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < D:
        pytest.skip("needs the 8-device virtual mesh")
    return Mesh(np.array(jax.devices()[:D]), ("x",))


@pytest.fixture(scope="module")
def tmesh():
    return tp.make_sort_mesh(devices=["cpu"] * D)


def _spec(axis):
    return P(*(("x",) if axis == 0 else (None,) * axis + ("x",)))


def _xla_ref(x, mesh, axis):
    f = lambda s: lax.all_to_all(s, "x", split_axis=axis, concat_axis=axis, tiled=True)
    return np.asarray(jax.jit(jax.shard_map(f, mesh=mesh, in_specs=_spec(axis),
                                            out_specs=_spec(axis)))(x))


def _port(x, mesh, axis):
    """The global numpy x split along ``axis`` into per-rank tensors,
    exchanged, and concatenated back."""
    sends = [torch.from_numpy(np.ascontiguousarray(s))
             for s in np.split(x, mesh.size, axis=axis)]
    out = tp.rdma_all_to_all(sends, mesh, axis=axis)
    assert len(out) == mesh.size and all(o.shape == s.shape for o, s in zip(out, sends))
    return torch.cat(out, dim=axis).numpy()


@pytest.mark.parametrize("c,dtype", [(128, np.uint32), (37, np.uint32),
                                     (5, np.int32), (1, np.uint32)])
def test_rdma_matches_xla_all_to_all(jmesh, tmesh, c, dtype):
    r = np.random.default_rng(c)
    x = r.integers(0, 1 << 31, (3, 64, c)).astype(dtype)
    before = ck.launch_counts()["rdma_exchange"]
    assert np.array_equal(_port(x, tmesh, 1), _xla_ref(jnp.asarray(x), jmesh, 1))
    assert ck.launch_counts()["rdma_exchange"] == before     # CPU: the plain version


def test_rdma_leading_axis_and_2d(jmesh, tmesh):
    r = np.random.default_rng(9)
    x = r.integers(0, 1 << 31, (64, 33), dtype=np.uint32)
    assert np.array_equal(_port(x, tmesh, 0), _xla_ref(jnp.asarray(x), jmesh, 0))


def test_rdma_matches_the_pallas_kernel(jmesh, tmesh):
    # one small case against the JAX package's own kernel (interpret mode)
    x = np.random.default_rng(11).integers(0, 1 << 32, (64, 3), dtype=np.uint32)
    f = lambda s: jax_rdma_all_to_all(s, "x", D, axis=0)
    want = np.asarray(jax.jit(jax.shard_map(f, mesh=jmesh, in_specs=P("x"),
                                            out_specs=P("x"), check_vma=False))(
        jnp.asarray(x)))
    assert np.array_equal(_port(x, tmesh, 0), want)


@pytest.mark.parametrize("ranks", [2, 4, 8])
@pytest.mark.parametrize("m,dtype", [(1, torch.int32), (37, torch.int32),
                                     (1000, torch.int32), (37, torch.int16),
                                     (5, torch.int64), (0, torch.int32)])
def test_plain_is_the_mesh_all_to_all(rng, ranks, m, dtype):
    mesh = tp.make_sort_mesh(devices=["cpu"] * ranks)
    sends = [torch.from_numpy(rng.integers(-2**15, 2**15, (ranks, m))).to(dtype)
             for _ in range(ranks)]
    plain = ck.rdma_exchange_plain(sends)
    for d in range(ranks):
        for s in range(ranks):
            assert torch.equal(plain[d][s], sends[s][d])
    for a, b in zip(plain, _mesh.all_to_all(sends, mesh)):
        assert torch.equal(a, b)
    for a, b in zip(ck.rdma_exchange(sends), plain):
        assert a.dtype == dtype and torch.equal(a, b)


def test_single_device_identity():
    mesh = tp.make_sort_mesh(devices=["cpu"])
    x = torch.arange(12, dtype=torch.int32).reshape(1, 12)
    (out,) = tp.rdma_all_to_all([x], mesh, axis=0)
    assert torch.equal(out, x)


def test_wrong_axis_length_raises(tmesh):
    sends = [torch.zeros((4, 7), dtype=torch.int32)] * D
    with pytest.raises(ValueError, match="expected the mesh size"):
        tp.rdma_all_to_all(sends, tmesh, axis=0)
    with pytest.raises(ValueError, match="sends for"):
        tp.rdma_all_to_all(sends[:3], tmesh, axis=0)


def test_detect_races_raises(tmesh):
    # the divergence: the interpret-mode race detector has no counterpart
    sends = [torch.zeros((D, 7), dtype=torch.int32)] * D
    with pytest.raises(ValueError, match="race detector"):
        tp.rdma_all_to_all(sends, tmesh, axis=0, detect_races=True)


def test_wrapper_checks():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="share shape and dtype"):
        ck.rdma_exchange([a, a.to(torch.int64)])
    with pytest.raises(ValueError, match=r"\(2, m\) tensor"):
        ck.rdma_exchange([a, torch.zeros((3, 3), dtype=torch.int32)])
    with pytest.raises(ValueError, match="contiguous"):
        ck.rdma_exchange([a, torch.zeros((3, 2), dtype=torch.int32).t()])
    with pytest.raises(ValueError, match="ranks"):
        ck.rdma_exchange([])
