"""Read ``BENCHMARK.json`` and find each cell's files by the names it gives.

A cell names a configuration and a traffic mix; the harness finds

* the configuration at the ``file`` its entry gives, and its plain reference
  beside it (the same path ending in ``.py``: ``call``, ``expected``,
  ``control``);
* the mix at ``sortbench/traffic/<traffic>.json``;
* each metric's reader at ``sortbench/metrics/<name>.py``: a function
  ``read(record)`` of the untraced window's record (end-to-end metrics) or
  the traced window's (per-layer metrics), which returns None where it
  finds nothing to read.

So a cell, a mix, a configuration or a metric is added by new files and new
entries alone. :func:`problems` holds the file to the benchmark's contract.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
END_TO_END_SOURCES = ("device_trace", "host_clock")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def mix_path(root: Path, traffic: str) -> Path:
    return Path(root) / "sortbench" / "traffic" / f"{traffic}.json"


def reader_path(root: Path, metric: str) -> Path:
    return Path(root) / "sortbench" / "metrics" / f"{metric}.py"


def resolve(bench: dict, cell: str, root: Path = ROOT) -> dict:
    """Everything one cell needs: its entry, its configuration (the file's
    contents, and its reference module), its mix, and its end-to-end and
    per-layer metrics, each as (entry, reader)."""
    root = Path(root)
    work = _by_name(bench["workloads"], cell, "workload")
    conf_entry = _by_name(bench["configs"], work["config"], "config")
    conf_file = root / conf_entry["file"]
    def readers(group):
        return [(m, load_module(reader_path(root, m["name"]),
                                f"sortbench_metric_{group}_{i}").read)
                for i, m in enumerate(bench[group]) if _applies(m, cell)]
    return {
        "workload": work,
        "config": json.loads(conf_file.read_text()),
        "reference": load_module(conf_file.with_suffix(".py"),
                                 f"sortbench_reference_{work['config']}"),
        "mix": json.loads(mix_path(root, work["traffic"]).read_text()),
        "end_to_end": readers("end_to_end"),
        "per_layer": readers("per_layer"),
    }


def _text(v, limit: int = 200) -> bool:
    return isinstance(v, str) and 1 <= len(v) <= limit and "\n" not in v and "\t" not in v


def problems(bench: dict, root: Path = ROOT) -> List[str]:
    """Where ``bench`` breaks the benchmark's contract (empty: nowhere)."""
    root = Path(root)
    out = []
    if len(json.dumps(bench, indent=2)) > 64 * 1024:
        out.append("larger than 64 KiB")
    if set(bench) != KEYS["top"]:
        out.append(f"top-level keys {sorted(bench)}")
        return out
    paths = bench["paths"]
    if not (1 <= len(paths) <= 16 and all(PATH.fullmatch(p) and ".." not in p.split("/")
                                          and not p.startswith("/") for p in paths)):
        out.append(f"paths {paths}")
    command = bench["command"]
    if not (1 <= len(command) <= 32 and all(_text(w) for w in command)):
        out.append("command")
    if not (isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51):
        out.append("run_seconds")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e.get("name") for e in bench[group]]
        if len(set(names)) != len(names):
            out.append(f"{group}: duplicate names")
        for e in bench[group]:
            extra = set(e) - KEYS[group] - ({"workloads"} if group in ("end_to_end", "per_layer")
                                           else set())
            if set(e) < KEYS[group] or extra:
                out.append(f"{group} {e.get('name')}: keys {sorted(e)}")
                continue
            if not NAME.fullmatch(e["name"]):
                out.append(f"{group} {e['name']}: name")
            if group in ("end_to_end", "per_layer"):
                if not UNIT.fullmatch(e["unit"]):
                    out.append(f"{e['name']}: unit {e['unit']!r}")
                if e["better"] not in ("lower", "higher"):
                    out.append(f"{e['name']}: better")
                allowed = END_TO_END_SOURCES if group == "end_to_end" else SOURCES
                if e["source"] not in allowed:
                    out.append(f"{e['name']}: source")
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for c in bench["configs"]:
        if not (_text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
                and all(NAME.fullmatch(k) for k in c["reduced"])):
            out.append(f"config {c['name']}: source, why or reduced")
        f = c["file"]
        if not (any(f.startswith(p.rstrip("/") + "/") for p in paths) and (root / f).is_file()
                and (root / f).with_suffix(".py").is_file()):
            out.append(f"config {c['name']}: file {f} or its reference")
        if not any(w["config"] == c["name"] for w in bench["workloads"]):
            out.append(f"config {c['name']}: no cell uses it")
    if len({c["file"] for c in bench["configs"]}) != len(configs):
        out.append("configs share a file")
    for w in bench["workloads"]:
        if w["config"] not in configs or not NAME.fullmatch(w["traffic"]):
            out.append(f"cell {w['name']}: config or traffic")
        if not mix_path(root, w["traffic"]).is_file():
            out.append(f"cell {w['name']}: no mix file")
        if w["chips"] not in (1, 4) or not _text(w["why"]):
            out.append(f"cell {w['name']}: chips or why")
        reported = [m for m in bench["end_to_end"] if _applies(m, w["name"])]
        if "setup_s" not in [m["name"] for m in reported] or len(reported) < 2:
            out.append(f"cell {w['name']}: needs setup_s and another end-to-end metric")
        if not any(_applies(m, w["name"]) for m in bench["per_layer"]):
            out.append(f"cell {w['name']}: no per-layer metric")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    if len(set(pairs)) != len(pairs):
        out.append("a (config, traffic) pair appears twice")
    if len([w for w in bench["workloads"] if w["chips"] == 4]) > max(1, len(cells) // 4):
        out.append("too many four-chip cells")
    for m in bench["end_to_end"]:
        if not (isinstance(m["bound"], (int, float)) and 0.01 <= m["bound"] <= 0.25):
            out.append(f"{m['name']}: bound")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not set(m.get("workloads", [])) <= cells:
            out.append(f"{m['name']}: unknown workloads")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not reader_path(root, m["name"]).is_file():
            out.append(f"{m['name']}: no reader")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e or not _text(m["layer"]):
            out.append(f"{m['name']}: moves or layer")
        elif "workloads" in e2e[m["moves"]] and not set(
                m.get("workloads", cells)) <= set(e2e[m["moves"]]["workloads"]):
            out.append(f"{m['name']}: a cell that does not report {m['moves']}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    return out
