"""BENCHMARK.json against the benchmark's contract, and every file of a
cell found by name."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import lib

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = lib.manifest()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in MAN["configs"]] \
        + [w["name"] for w in MAN["workloads"]] \
        + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] in (1, 4)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in MAN["workloads"]}
    for cell in cells:
        have = [m for m in e2e.values() if cell in m.get("workloads", cells)]
        assert len(have) >= 2, cell


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert _line(metric["layer"])
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])
    reader = lib.load_module("metrics", f"{metric['name']}.py")
    assert callable(reader.read)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("work", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(work):
    man, w, config, traffic = lib.cell(work["name"])
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    assert conf["file"].startswith("perfbench/configs/")
    for key in conf["reduced"]:
        assert key in config and key in config["reduced"]
    assert (lib.ROOT / "reference" / f"{w['config']}.py").is_file()
    assert (lib.ROOT / "runners" / f"{traffic['kind']}.py").is_file()
    assert (lib.ROOT / "traffic" / f"{traffic['kind']}.py").is_file()
    assert traffic["limits"] and all(v > 0 for v in traffic["limits"].values())
    cells_per_layer = [m for m in man["per_layer"]
                       if w["name"] in m["workloads"]]
    assert cells_per_layer


def test_every_configuration_is_used_and_four_chip_share():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
