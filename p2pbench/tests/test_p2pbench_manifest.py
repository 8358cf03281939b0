"""BENCHMARK.json and the files it names are well formed, and every
configuration, cell and metric is found by its name."""
import json
import re
from pathlib import Path

import pytest

from p2pbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["p2pbench"]
    assert MANIFEST["command"][0] == "python3" and (ROOT / MANIFEST["command"][1]).is_file()
    assert MANIFEST["command"][1].startswith("p2pbench/")
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MANIFEST["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in MANIFEST["workloads"]] + [c["why"] for c in MANIFEST["configs"]]
                 + [m["layer"] for m in MANIFEST["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_exactly_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_configuration_has_a_cell_and_a_file():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        config = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("p2pbench/configs/") and config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        assert harness.family(config).UNIT in ("images", "tokens")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_matches_the_manifest(cell):
    _, data, config = harness.load_cell(cell, ROOT)
    assert data["limits"] and set(data["limits"]) <= {"loss_gap", "grad_norm_gap", "change_norm_gap"}
    e2e = {m["name"] for m in harness.cell_metrics(MANIFEST, cell, "end_to_end")}
    per_layer = harness.cell_metrics(MANIFEST, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:  # each per-layer metric moves an end-to-end metric its cells report
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_its_reader(metric):
    assert callable(harness.metric_reader(metric))
    for m in METRICS:
        for cell in m.get("workloads", []):
            assert cell in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_are_found_by_name_on_both_sides(cell):
    """The exchange, optimizer and schedule a cell names each have the
    program's side and the reference's, with what the harness calls."""
    from p2pbench.reference import p2p

    _, data, _ = harness.load_cell(cell, ROOT)
    kinds = {"exchanges": ("exchange", ("topology", "bound_s", "KERNELS"), ("combine",)),
             "optimizers": ("optimizer", ("program", "first_gradient"), ("zero_state", "update")),
             "schedules": ("schedule", ("program",), ("rate",))}
    for kind, (key, program, reference) in kinds.items():
        name = data[key]["name"]
        assert all(hasattr(harness.part(kind, name), a) for a in program), (kind, name)
        assert all(hasattr(p2p.part(kind, name), a) for a in reference), (kind, name)
