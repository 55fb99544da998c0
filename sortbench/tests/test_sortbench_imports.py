"""What the benchmark imports: never JAX or the JAX package (compared by
whole top-level names, since ``radix_sorting_tpu_torch`` begins with
``radix_sorting_tpu``), and the program only through ``program.py``."""

import ast
import subprocess
import sys

import pytest

from sortbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "radix_sorting_tpu"}
PROGRAM = "radix_sorting_tpu_torch"
SOURCES = sorted(p for p in manifest.HERE.rglob("*.py") if "out" not in p.parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(manifest.HERE)))
def test_no_jax_and_the_program_only_in_program_py(path):
    """Tests may plant faults in the program; the harness, the references
    and the readers reach it only through ``program.py``."""
    names = _top_level_imports(path)
    assert not names & FORBIDDEN
    if path.name != "program.py" and "tests" not in path.relative_to(manifest.HERE).parts:
        assert PROGRAM not in names


def test_the_walk_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import radix_sorting_tpu_torch.api\nfrom jax.numpy import sort\n"
                 "import radix_sorting_tpu as r\n")
    assert _top_level_imports(f) == {"radix_sorting_tpu_torch", "jax", "radix_sorting_tpu"}


def test_the_run_checks_loaded_modules_by_whole_names(monkeypatch):
    sys.path.insert(0, str(manifest.HERE))
    try:
        import run
    finally:
        sys.path.remove(str(manifest.HERE))
    modules = {"radix_sorting_tpu_torch": 1, "radix_sorting_tpu_torch.api": 1, "torch": 1}
    monkeypatch.setattr(sys, "modules", modules)
    assert run.loaded_forbidden() == []
    modules["jax.numpy"] = 1
    modules["radix_sorting_tpu.ops"] = 1
    assert run.loaded_forbidden() == ["jax", "radix_sorting_tpu"]


def test_the_benchmark_does_not_carry_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and sortbench/, the
    program cannot be imported, so a run there fails."""
    import shutil
    shutil.copytree(manifest.HERE, tmp_path / "sortbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from sortbench import program; "
            "program.entry({'entry': 'sort'})")
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, env={"PATH": "/usr/bin:/bin"})
    assert done.returncode != 0 and "radix_sorting_tpu_torch" in done.stderr
