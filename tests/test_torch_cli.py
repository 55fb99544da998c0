"""The port's experiment CLI against the JAX package's, on the CPU.

``radix_sorting_tpu_torch.cli.main(args, device="cpu")`` and
``radix_sorting_tpu.cli.main(args)`` read the same key file, which a
module-scoped fixture writes under a temporary directory: both packages'
``keyfile.default_keyfile`` point at it for these tests only, so they never
touch the repository's ``data/``. Each record must verify, and its n, type,
mask and printed head and tail must be the JAX CLI's.
"""

import json

import pytest

from radix_sorting_tpu import cli as jcli
from radix_sorting_tpu.utils import keyfile as jkeyfile
from radix_sorting_tpu_torch import cli
from radix_sorting_tpu_torch.utils import keyfile

ARGS = [
    ("20000", "u32"),
    ("20000", "u32", "0xFF000000"),
    ("20000", "0", "0", "i32"),
    ("10000", "f32"),
    ("10000", "u64"),
    ("10000", "u64", "0x0000F0F000000000"),
    ("10000", "i64", "0x800000000000FF00"),
    ("10000", "bf16"),
    ("10000", "f8e4m3"),
]


@pytest.fixture(scope="module")
def key_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("keys") / "40M_32bit_keys.dat"
    keyfile.write_keyfile(path, keyfile.generate_keys(keyfile.DEFAULT_COUNT))
    return path


@pytest.fixture
def shared_keys(key_path, monkeypatch):
    for module in (keyfile, jkeyfile):
        monkeypatch.setattr(module, "default_keyfile", lambda root=None: key_path)
    return key_path


def _run(main, args, capsys, **kw):
    rc = main(list(args), **kw)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, [ln for ln in lines if ln.startswith("# ")], json.loads(lines[-1])


@pytest.mark.parametrize("args", ARGS, ids=" ".join)
def test_cli_matches_jax(args, shared_keys, capsys):
    rc, notes, rec = _run(cli.main, args, capsys, device="cpu")
    assert rc == 0 and rec["verified"] is True
    jrc, jnotes, jrec = _run(jcli.main, args, capsys)
    assert jrc == 0
    assert notes == jnotes and [ln[:7] for ln in notes] == ["# head:", "# tail:"]
    for key in ("n", "type", "mask", "verified"):
        assert rec[key] == jrec[key], key
    assert set(rec) == set(jrec)
    assert rec["ms"] > 0 and rec["first_call_ms"] > 0


def test_cli_bad_type(shared_keys):
    with pytest.raises(SystemExit, match="unknown type"):
        cli.main(["100", "q7"], device="cpu")


def test_cli_use_mmap_reads_the_memmap(shared_keys, capsys):
    rc, notes, rec = _run(cli.main, ("5000", "1", "0", "u32"), capsys, device="cpu")
    assert rc == 0 and rec["verified"] is True and rec["n"] == 5000
    assert notes[0] == "# allocation: numpy memmap read"
    _, same, _ = _run(cli.main, ("5000", "u32"), capsys, device="cpu")
    assert notes[1:] == same


def test_cli_without_a_card_raises(shared_keys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["100", "u32"])
