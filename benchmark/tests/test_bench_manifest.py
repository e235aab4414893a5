"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re

import pytest

from benchmark import harness

B = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves",
               "workloads"}


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert B["paths"] == ["benchmark"]
    assert all("/" not in w or w.startswith("benchmark")
               for w in B["command"][1:])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [x["name"] for x in B[kind]]
    assert len(names) == len(set(names))
    for x in B[kind]:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]), x["unit"]
            assert x["better"] in ("lower", "higher")
            assert set(x) <= METRIC_KEYS
        for k in ("why", "layer", "source"):
            if k in x:
                assert 1 <= len(x[k]) <= 200 and "\n" not in x[k] \
                    and "\t" not in x[k]


def test_bounds():
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = harness.cell(w["name"])
    assert w["chips"] in (1, 4)
    assert (harness.HERE / "drivers" / f"{cell['work']['driver']}.py").exists()
    for m in cell["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    cfg = cell["config"]
    assert cfg["reduced"] == []
    assert set(cell["work"]["limits"]) and all(
        v > 0 for v in cell["work"]["limits"].values())


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_each_of_its_cells_reports(m):
    e2e = {x["name"]: x for x in B["end_to_end"]}
    assert m["moves"] in e2e
    cells = m.get("workloads", [w["name"] for w in B["workloads"]])
    for c in cells:
        assert c in e2e[m["moves"]].get("workloads", [c])
    # a roofline names a function whose count is a file of its own
    if m["name"].startswith("roofline_pct."):
        fn = m["name"].split(".")[1]
        assert (harness.HERE / "counts" / f"{fn}.py").exists()


def test_configs_name_their_files():
    files = [c["file"] for c in B["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert c["file"].startswith("benchmark/") and c["name"] in used
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
