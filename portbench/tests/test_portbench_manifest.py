"""The benchmark's manifest against its contract, and every file a cell
names found by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_their_keys_and_names(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        allowed = KEYS[section] | ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert KEYS[section] <= set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if "source" in e and section in ("end_to_end", "per_layer"):
            allowed_sources = {"host_clock", "device_trace"} if section == "end_to_end" else {
                "host_clock", "device_trace", "program_span", "program_counter"}
            assert e["source"] in allowed_sources


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(cell):
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
    assert (BENCH / "models" / f"{cfg['family']}.py").is_file()
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    assert limits and all(isinstance(v, float) and v > 0 for v in limits.values())
    for m in MANIFEST["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_configs_point_at_their_files():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert c["source"] == data["source"]
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in MANIFEST["per_layer"])


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert cell in target.get("workloads", [cell]), (m["name"], cell)


def test_layers_named_alike():
    layers = {}
    for m in MANIFEST["per_layer"]:
        stem = m["name"].split(".")[0]
        layers.setdefault(m["layer"], []).append(stem)
    assert all(1 <= len(layer) <= 200 for layer in layers)


def test_reader_files_say_what_they_read():
    for m in MANIFEST["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        text = path.read_text()
        assert text.startswith('"""') and callable(run.load_file(path, "metric_" + m["name"]).read)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and "KERNELS" in text
