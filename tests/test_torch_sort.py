"""``radix_sorting_tpu_torch.sort`` against ``radix_sorting_tpu.sort``.

The same keys (numpy, from a seed) and the same configuration
(``SortConfig.from_dict(dataclasses.asdict(jax_cfg))``) go to both packages;
the outputs must be equal bit for bit (exact equality: sorts of integers and
of float bit patterns). Twice over:

* on the JAX package's CPU routes (its sorter stands in for the counting
  kernels there; the port runs its dispatch graph with the plain versions);
* under ``RST_FORCE_TPU_ROUTES=1`` (the fixture pattern of
  ``tests/test_forced_routes.py``), where both packages take the counting
  kernels' routes, and the routes themselves are compared.
"""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import radix_sorting_tpu as rst
import radix_sorting_tpu_torch as rt
from radix_sorting_tpu.ops import counting_engine as jce
from radix_sorting_tpu.ops import pallas_kernels as pk
from radix_sorting_tpu_torch.ops import counting_engine as tce
from radix_sorting_tpu_torch.ops import cuda_kernels as ck
from radix_sorting_tpu_torch.ops import kdf as tkdf

from test_torch_kdf import BYTE_DTYPES, DTYPES, WIDE_DTYPES, make_keys, raw


def jax_in(x):
    """The JAX package's input for numpy keys: 64-bit and byte-string keys
    stay numpy (its host codec; x64 is off), the rest become jax arrays."""
    return x if x.dtype.kind == "S" or x.dtype.itemsize == 8 else jnp.asarray(x)


def both(x, descending=False, **kw):
    """(port output, JAX output) as numpy arrays for the same keys."""
    jcfg = rst.SortConfig(descending=descending)
    tcfg = rt.SortConfig.from_dict(dataclasses.asdict(jcfg))
    want = np.asarray(rst.sort(jax_in(x), config=jcfg, **kw))
    got = rt.sort(x, config=tcfg, device="cpu", **kw)
    assert isinstance(got, np.ndarray) and got.dtype == x.dtype
    return got, want


def keys(name, n, seed):
    return make_keys(name, n, np.random.Generator(np.random.PCG64(seed)))


# value_mask promises: (dtype, mask); float masks leave the sign bit dead
MASKS = [("uint32", 0xF0F00000), ("uint32", 0x0003FF80), ("int32", 0x00FF0F00),
         ("uint16", 0x0FF0), ("uint8", 0x3C), ("float32", 0x7F800000),
         ("bfloat16", 0x00FF)]
WIDE_MASKS = [("uint64", 0xF000000000000F00), ("uint64", 0x00FF00000000FF00),
              ("uint64", 0x0FFF00000000FFF0), ("uint64", 0x0000000000FF0000),
              ("int64", 0x8000000F00000003), ("float64", 0x7FF0000000000000),
              ("float64", 0x800000000000000F), ("float8_e4m3fn", 0x7F),
              ("float8_e5m2", 0x0C), ("int4", 0x3), ("uint4", 0xA)]


def masked(name, mask, n, seed):
    x = keys(name, n, seed)
    return (raw(x) & mask).astype(raw(x).dtype).view(x.dtype)


# ---------------------------------------------------------------------------
# the JAX package's CPU routes


@pytest.mark.parametrize("n", [0, 1, 2, 70_003])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", DTYPES)
def test_sort_matches_jax(name, descending, n):
    x = keys(name, n, DTYPES.index(name) + n)
    got, want = both(x, descending)
    assert np.array_equal(raw(got), raw(want))


@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("name,mask", MASKS)
def test_value_mask_matches_jax(name, mask, validate):
    x = masked(name, mask, 70_003, mask & 0xFFFF)
    got, want = both(x, value_mask=mask, validate_mask=validate)
    assert np.array_equal(raw(got), raw(want))


@pytest.mark.parametrize("name", DTYPES)
def test_tensor_in_tensor_out(name):
    x = keys(name, 4099, 5)
    t = tkdf.as_tensor(x, "cpu")
    out = rt.sort(t, config=rt.SortConfig(descending=True))
    assert torch.is_tensor(out) and out.dtype == t.dtype and out.device == t.device
    want = np.asarray(rst.sort(jnp.asarray(x), config=rst.SortConfig(descending=True)))
    assert np.array_equal(raw(tkdf.to_numpy(out)), raw(want))


@pytest.mark.parametrize("name,mask", [("uint32", 0xF0F00000), ("uint32", None),
                                       ("uint16", None)])
def test_strided_tensor_input(name, mask):
    x = masked(name, mask, 20_002, 8) if mask else keys(name, 20_002, 8)
    t = tkdf.as_tensor(x, "cpu")[::2]
    out = rt.sort(t, value_mask=mask)
    assert np.array_equal(raw(tkdf.to_numpy(out)), np.sort(raw(x[::2])))


def test_violated_mask_raises_like_jax():
    x = keys("uint32", 1000, 3)
    for sort, arg in ((rst.sort, jnp.asarray(x)), (rt.sort, x)):
        kw = {"device": "cpu"} if sort is rt.sort else {}
        with pytest.raises(ValueError, match="value_mask violated"):
            sort(arg, value_mask=0xFF, validate_mask=True, **kw)


@pytest.mark.parametrize("call,exc", [
    (lambda: rt.sort(np.zeros((4, 4), np.uint32), device="cpu"), ValueError),
    (lambda: rt.sort(np.arange(8, dtype=np.uint32), device="cpu",
                     config=rt.SortConfig(strategy=rt.Strategy.COUNTING)), ValueError),
    (lambda: rt.sort(np.array([b"b", b"a"]), device="cpu", value_mask=0xFF), ValueError),
    (lambda: rt.sort(np.zeros(4, dtype="S300"), device="cpu"), ValueError),
    (lambda: rt.sort(np.zeros((2, 2), dtype="S3"), device="cpu"), ValueError),
    # Strategy.LSD sorts now; these three cases (their ids kept) hold its
    # entry points to the typed errors of the others
    pytest.param(lambda: rt.sort(np.zeros((4, 4), np.uint32), device="cpu",
                                 config=rt.SortConfig(strategy=rt.Strategy.LSD)),
                 ValueError, id="<lambda>-NotImplementedError0"),
    pytest.param(lambda: rt.argsort(np.arange(300, dtype=np.uint32), device="cpu",
                                    index_dtype=np.uint8,
                                    config=rt.SortConfig(strategy=rt.Strategy.LSD,
                                                         dynamic_probe=True)),
                 ValueError, id="<lambda>-NotImplementedError1"),
    pytest.param(lambda: rt.sort_pairs(np.arange(8, dtype=np.uint32), np.arange(7),
                                       device="cpu",
                                       config=rt.SortConfig(strategy=rt.Strategy.LSD,
                                                            device_probe=True)),
                 ValueError, id="<lambda>-NotImplementedError2"),
    # numpy input with no device= goes to the card, and raises without one
    # (the case keeps its name; tests/test_torch_api.py::test_port_only_errors
    # covers a machine with a card)
    pytest.param(lambda: rt.sort(np.arange(8, dtype=np.uint32)), RuntimeError,
                 id="<lambda>-TypeError"),
    (lambda: rt.sort(torch.arange(8), device="meta"), ValueError),
])
def test_typed_errors(call, exc):
    with pytest.raises(exc):
        call()


def test_jax_raises_the_same_for_shared_errors():
    with pytest.raises(ValueError):
        rst.sort(jnp.zeros((4, 4), jnp.uint32))
    with pytest.raises(ValueError):
        rst.sort(np.array([b"b", b"a"]), value_mask=0xFF)
    with pytest.raises(ValueError):
        rst.sort(np.zeros(4, dtype="S300"))
    with pytest.raises(ValueError):
        rst.sort(np.zeros((2, 2), dtype="S3"))
    with pytest.raises(ValueError):
        rst.sort(jnp.arange(8, dtype=jnp.uint32),
                 config=rst.SortConfig(strategy=rst.Strategy.COUNTING))


def test_config_carries_across():
    jcfg = rst.SortConfig(strategy=rst.Strategy.HW_SORT, descending=True,
                          counting_max_bits=9, detect_presorted=False)
    tcfg = rt.SortConfig.from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError):
        rt.SortConfig.from_dict({"no_such_knob": 1})


@pytest.mark.parametrize("cfg", [dict(strategy="hw_sort"),
                                 dict(strategy="counting"),
                                 dict(detect_presorted=False),
                                 dict(counting_max_bits=8)])
def test_strategies_match_jax(cfg):
    x = keys("uint16", 30_011, 9)
    x[: 5000] = np.sort(x[: 5000])
    jcfg = rst.SortConfig(**cfg)
    want = np.asarray(rst.sort(jnp.asarray(x), config=jcfg))
    got = rt.sort(x, config=rt.SortConfig.from_dict(dataclasses.asdict(jcfg)),
                  device="cpu")
    assert np.array_equal(got, want)


def test_presorted_input_skips_the_sorter(monkeypatch):
    x = np.sort(keys("uint32", 10_007, 4))
    calls = []
    from radix_sorting_tpu_torch.ops import hw_engine
    real = hw_engine.sort_words
    monkeypatch.setattr(hw_engine, "sort_words",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert np.array_equal(rt.sort(x, device="cpu"), x)
    assert calls == []
    rt.sort(x[::-1].copy(), device="cpu")
    assert calls == [1]


@pytest.mark.parametrize("n", [1, 2, 30_011])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", WIDE_DTYPES + BYTE_DTYPES[:6])
def test_new_dtypes_sort_matches_jax(name, descending, n):
    x = keys(name, n, len(name) + n)
    got, want = both(x, descending)
    assert np.array_equal(raw(got), raw(want))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name,mask", WIDE_MASKS)
def test_new_dtypes_value_mask_matches_jax(name, mask, descending):
    x = masked(name, mask, 40_009, mask & 0xFFFF)
    got, want = both(x, descending, value_mask=mask, validate_mask=True)
    assert np.array_equal(raw(got), raw(want))


@pytest.mark.parametrize("name", ["uint64", "int64", "float64",
                                  "float8_e4m3fn", "float8_e5m2"])
def test_new_dtypes_tensor_in_tensor_out(name):
    x = keys(name, 4099, 6)
    t = tkdf.as_tensor(x, "cpu")
    assert t.dtype == getattr(torch, name)
    out = rt.sort(t, config=rt.SortConfig(descending=True))
    assert torch.is_tensor(out) and out.dtype == t.dtype
    want = rst.sort(jax_in(x), config=rst.SortConfig(descending=True))
    assert np.array_equal(raw(tkdf.to_numpy(out)), raw(np.asarray(want)))


def test_violated_wide_mask_raises_like_jax():
    x = keys("uint64", 1000, 3)
    t = tkdf.as_tensor(x, "cpu")
    for call in (lambda: rst.sort(x, value_mask=0xFF, validate_mask=True),
                 lambda: rt.sort(x, value_mask=0xFF, validate_mask=True, device="cpu"),
                 lambda: rt.sort(t, value_mask=0xFF, validate_mask=True)):
        with pytest.raises(ValueError, match="value_mask violated"):
            call()


# ---------------------------------------------------------------------------
# forced TPU routes: both packages take the counting kernels' routes


@pytest.fixture(scope="class")
def forced_tpu_routes():
    # the JAX gates read the env var at trace time; clear caches around the
    # class so forced and unforced traces stay apart
    os.environ["RST_FORCE_TPU_ROUTES"] = "1"
    jax.clear_caches()
    yield
    os.environ.pop("RST_FORCE_TPU_ROUTES", None)
    jax.clear_caches()


@pytest.fixture
def routes(monkeypatch):
    """Record the route each package takes: counting or not, then which
    kernel contracts (hist / regen / regen_win) it reached."""
    seen = {"jax": [], "port": []}

    def spy(module, attr, who, label):
        real = getattr(module, attr)

        def wrapped(*a, **k):
            lab = label(*a) if callable(label) else label
            seen[who].append(lab)
            return real(*a, **k)
        monkeypatch.setattr(module, attr, wrapped)

    spy(jce, "sort_words_counting", "jax", "counting")
    spy(pk, "histogram_pext_tpu", "jax", "hist")
    spy(pk, "regenerate_pdep_tpu", "jax", "regen")
    spy(pk, "regenerate_pdep_windowed_tpu", "jax", "regen_win")
    spy(pk, "histogram_pext2_tpu", "jax", "hist2")
    spy(pk, "regenerate_pdep2_tpu", "jax", "regen2")
    spy(pk, "regenerate_pdep2_windowed_tpu", "jax", "regen2_win")
    spy(tce, "sort_words_counting", "port", "counting")
    spy(ck, "hist_pext", "port", "hist")
    spy(ck, "regen_pdep", "port",
        lambda cum, *a: "regen" if cum.shape[0] <= 1 << 10 else "regen_win")
    spy(ck, "hist_pext2", "port", "hist2")
    spy(ck, "regen_pdep2", "port",
        lambda cum, *a: "regen2" if cum.shape[0] <= 1 << 10 else "regen2_win")
    return seen


@pytest.mark.usefixtures("forced_tpu_routes")
class TestForcedTpuRoutes:

    @pytest.mark.parametrize("descending", [False, True])
    @pytest.mark.parametrize("name", ["bool", "uint8", "int8", "uint16",
                                      "int16", "float16", "bfloat16"])
    def test_narrow_dtypes(self, routes, name, descending):
        x = keys(name, 70_003, 100 + DTYPES.index(name))
        got, want = both(x, descending)
        assert np.array_equal(raw(got), raw(want))
        assert routes["port"] == routes["jax"]
        if name in ("uint8", "int8"):
            assert routes["port"] == ["counting", "hist", "regen"]

    @pytest.mark.parametrize("descending", [False, True])
    @pytest.mark.parametrize("mask,n,route", [
        (0xF0F00000, 150_007, ["counting", "hist", "regen"]),
        (0x0003FF80, 300_000, ["counting", "hist", "regen_win"]),
        (0x0FFFF000, 70_003, ["counting"]),   # 2^16 bins at small n: sorter
    ])
    def test_masked_u32(self, routes, mask, n, route, descending):
        x = masked("uint32", mask, n, mask & 0xFFFF)
        got, want = both(x, descending, value_mask=mask)
        assert np.array_equal(raw(got), raw(want))
        assert routes["port"] == routes["jax"] == route

    @pytest.mark.parametrize("descending", [False, True])
    @pytest.mark.parametrize("name,route", [
        ("float8_e4m3fn", ["counting", "hist", "regen"]),
        ("float8_e5m2", ["counting", "hist", "regen"]),
        ("int4", ["counting", "hist", "regen"]),
        ("uint4", ["counting", "hist", "regen"]),
        ("uint64", []), ("int64", []), ("float64", []), ("S5", []),
    ])
    def test_new_dtypes(self, routes, name, route, descending):
        x = keys(name, 70_003, 200 + len(name))
        got, want = both(x, descending)
        assert np.array_equal(raw(got), raw(want))
        assert routes["port"] == routes["jax"] == route

    @pytest.mark.parametrize("descending", [False, True])
    @pytest.mark.parametrize("mask,n,route", [
        (0xF000000000000F00, 150_007, ["counting", "hist2", "regen2"]),
        (0x00000000000FF000, 100_003, ["counting", "hist2", "regen2"]),
        (0x0000000700FF0000, 300_000, ["counting", "hist2", "regen2_win"]),
        (0x00FF00000000FF00, 70_003, ["counting"]),   # 2^16 bins: sorter
        (0x0FFF00000000FFF0, 70_003, []),  # 24 bits: one compacted operand
    ])
    def test_masked_u64(self, routes, mask, n, route, descending):
        x = masked("uint64", mask, n, mask & 0xFFFF)
        got, want = both(x, descending, value_mask=mask)
        assert np.array_equal(raw(got), raw(want))
        assert routes["port"] == routes["jax"] == route
