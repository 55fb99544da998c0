"""BENCHMARK.json against the benchmark's contract, and the harness's way of
finding each cell's files by name."""

import copy
import json
import shutil
import time

import pytest

from sortbench import harness, manifest, program

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_benchmark_json_meets_the_contract():
    assert manifest.problems(BENCH) == []


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert manifest.NAME.fullmatch(name)


@pytest.mark.parametrize("unit", sorted({m["unit"] for m in
                                         BENCH["end_to_end"] + BENCH["per_layer"]}))
def test_units_use_allowed_characters(unit):
    assert manifest.UNIT.fullmatch(unit)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = manifest.resolve(BENCH, cell)
    assert callable(c["reference"].expected) and callable(c["reference"].control)
    assert c["mix"]["sample_calls"] >= 1 and c["mix"]["trace_calls"] >= 1
    assert {m["name"] for m, _ in c["end_to_end"]} >= {"setup_s", "gkeys_per_s"}
    assert c["per_layer"] and all(callable(r) for _, r in c["per_layer"])
    assert callable(program.entry(c["config"]))


@pytest.mark.parametrize("cell", CELLS)
def test_per_layer_workloads_report_what_they_move(cell):
    reported = {m["name"] for m, _ in manifest.resolve(BENCH, cell)["end_to_end"]}
    for m, _ in manifest.resolve(BENCH, cell)["per_layer"]:
        assert m["moves"] in reported


def _broken(change):
    bench = copy.deepcopy(BENCH)
    change(bench)
    return manifest.problems(bench)


@pytest.mark.parametrize("change", [
    lambda b: b["workloads"][0].update(name="has space"),
    lambda b: b["end_to_end"][0].update(unit="tokens per second"),
    lambda b: b["end_to_end"][0].update(bound=0.3),
    lambda b: b["end_to_end"][0].update(bound=0.005),
    lambda b: b["end_to_end"][0].update(source="program_span"),
    lambda b: b["end_to_end"].pop(),                       # setup_s
    lambda b: b["per_layer"][0].update(moves="nothing"),
    lambda b: b["per_layer"][0].update(why="extra key"),
    lambda b: b["workloads"].append(dict(b["workloads"][0], name="twice")),
    lambda b: b["workloads"][0].update(traffic="no_such_mix"),
    lambda b: b["workloads"][0].update(chips=2),
    lambda b: b["configs"][0].update(file="elsewhere/u32_sort.json"),
    lambda b: b["paths"].append("../out"),
    lambda b: b.update(run_seconds=52),
], ids=["name", "unit", "loose", "tight", "source", "setup_s", "moves", "key", "pair",
        "mix", "chips", "file", "path", "run_seconds"])
def test_problems_finds_each_breach(change):
    assert _broken(change)


# Throwaway cells of other families: each a configuration (its JSON and its
# call, reference and control), a mix and a per-layer metric, added as new
# files and BENCHMARK.json entries alone.
FAMILIES = {
    "u64_nearly_sorted": (
        {"key_dtype": "uint64", "entry": "sort", "kwargs": {},
         "bytes_per_key": {"read": 8, "written": 8}},
        "def call(fn, inputs):\n    return fn(inputs['keys'])\n\n\n"
        "def expected(inputs):\n    return reference.sorted_keys(inputs['keys'])\n\n\n"
        "def control(inputs):\n    return inputs['keys']\n",
        {"sizes": {"log_uniform": [300, 3000], "count": 5},
         "keys": {"order": "nearly_sorted", "swap_share": 0.02}}),
    "u32_pairs": (
        {"key_dtype": "uint32", "entry": "sort_pairs", "kwargs": {},
         "bytes_per_key": {"read": 8, "written": 8}},
        "def call(fn, inputs):\n    return fn(inputs['keys'], inputs['payload'])\n\n\n"
        "def expected(inputs):\n    order = reference.stable_order(inputs['keys'])\n"
        "    return (reference.take(inputs['keys'], order),\n"
        "            reference.take(inputs['payload'], order))\n\n\n"
        "def control(inputs):\n    return inputs['keys'], inputs['payload']\n",
        {"sizes": {"fixed": 2000, "count": 3}, "keys": {"and_of": 3},
         "payload": {"dtype": "float32"}}),
    "u16_batched": (
        {"key_dtype": "uint16", "entry": "sort_batched", "kwargs": {},
         "bytes_per_key": {"read": 2, "written": 2}},
        "def call(fn, inputs):\n    return fn(inputs['keys'])\n\n\n"
        "def expected(inputs):\n    return reference.sorted_keys(inputs['keys'])\n\n\n"
        "def control(inputs):\n    return inputs['keys']\n",
        {"sizes": {"fixed": 700, "count": 4}, "rows": 6, "keys": {"mask": "0x0FFF"}}),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_cell_mix_config_and_metric_are_added_by_new_files_alone(family, tmp_path):
    """A throwaway cell on a new configuration (another key dtype, another
    entry point, a payload or rows) and a new mix, with a new per-layer
    metric, added as files and BENCHMARK.json entries, runs through the
    harness unchanged (on the CPU, at a small size), traced and untraced;
    its control is not correct; the cells that were there stay as they were."""
    shutil.copytree(manifest.HERE, tmp_path / "sortbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    conf, module, mix = FAMILIES[family]
    sb, bench = tmp_path / "sortbench", copy.deepcopy(BENCH)
    (sb / "traffic" / f"{family}_mix.json").write_text(json.dumps(
        dict(mix, sample_calls=4, trace_calls=5)))
    (sb / "configs" / f"{family}.json").write_text(json.dumps(conf))
    (sb / "configs" / f"{family}.py").write_text("from sortbench import reference\n\n\n"
                                                 + module)
    (sb / "metrics" / "calls_traced.py").write_text(
        "def read(record):\n    return float(record['calls'])\n")
    cell_name = f"{family}.{family}_mix"
    bench["configs"].append(dict(bench["configs"][0], name=family,
                                 file=f"sortbench/configs/{family}.json"))
    bench["workloads"].append({"name": cell_name, "config": family,
                               "traffic": f"{family}_mix", "chips": 1,
                               "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "gkeys_per_s", "workloads": [cell_name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    assert manifest.problems(bench, tmp_path) == []
    cell = manifest.resolve(bench, cell_name, tmp_path)
    assert "calls_traced" in [m["name"] for m, _ in cell["per_layer"]]
    fn, ref = program.entry(cell["config"]), cell["reference"]
    for trace in (False, True):
        out = harness.run(cell["config"], ref, cell["mix"], 2**31 + 5, 0.1, trace, "cpu",
                          lambda inputs: ref.call(fn, inputs), time.perf_counter(),
                          tmp_path / "out" / "trace.json")
        assert out["correct"], out["checks"]
        assert out["checks"]["checked_calls"]["value"] == 4
    values = {m["name"]: read(out["record"]) for m, read in cell["per_layer"]}
    assert values["calls_traced"] == 5.0
    out = harness.run(cell["config"], ref, cell["mix"], 2**31 + 6, 0.1, False, "cpu",
                      ref.control, time.perf_counter())
    assert not out["correct"] and out["checks"]["wrong_elements"]["value"] > 0
    for name in CELLS:                                                # the others stay
        assert manifest.resolve(bench, name, tmp_path)["mix"] == \
            manifest.resolve(BENCH, name)["mix"]
