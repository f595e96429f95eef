"""BENCHMARK.json against its format's rules, and the harness finding
every file by name: a cell added as files alone runs with no edit."""

import json
import re
import shutil

import pytest

from portbench import run

ROOT = run.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert all(_line(w) for w in MANIFEST["command"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_allowed_keys_and_names(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer":
                assert _line(e[key])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_metrics_and_cells_agree():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert _line(m["layer"])
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in cells and w in moved.get("workloads", cells), (m["name"], w)
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
        reported = [m for m in e2e.values() if w["name"] in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", cells) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files(workload):
    spec = run.load_cell(workload)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["name"] == spec["cell"]["traffic"]
    for _, path in spec["end_to_end"] + spec["per_layer"]:
        assert path.exists(), path
        assert callable(run._load(path).read)


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files_are_the_port_config(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["source"] == config["source"] and cfg["reduced"] == config["reduced"]
    port = run.port_config(cfg)
    assert port.array.elements * (cfg["channels"] // 64) == cfg["channels"]


def test_a_cell_added_as_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    base = tmp_path / "portbench"
    cfg = json.loads((base / "configs" / "lk256-rt.json").read_text())
    (base / "configs" / "lk128-rt.json").write_text(json.dumps(dict(
        cfg, name="lk128-rt", channels=128)))
    traffic = json.loads((base / "traffic" / "wire.json").read_text())
    (base / "traffic" / "wire2x.json").write_text(json.dumps(dict(
        traffic, name="wire2x", rate_hz=2 * traffic["rate_hz"])))
    (base / "metrics" / "blocks_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['blocks'])\n")
    manifest["configs"].append(dict(manifest["configs"][0], name="lk128-rt",
                                    file="portbench/configs/lk128-rt.json"))
    manifest["workloads"].append(dict(name="lk128-rt-wire2x", config="lk128-rt",
                                      traffic="wire2x", chips=1, why="test"))
    for m in manifest["end_to_end"]:
        if "lk256-rt-live" in m.get("workloads", []):
            m["workloads"].append("lk128-rt-wire2x")
    manifest["per_layer"].append(dict(name="blocks_seen", unit="blocks", better="higher",
                                      source="host_clock", layer="test",
                                      moves="latency_p99_ms",
                                      workloads=["lk128-rt-wire2x"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    spec = run.load_cell("lk128-rt-wire2x", root=tmp_path)
    assert spec["config"]["channels"] == 128
    assert spec["estimator"] is None
    assert "setup_s" in [m["name"] for m, _ in spec["end_to_end"]]
    assert spec["traffic"]["rate_hz"] == 2 * traffic["rate_hz"]
    names = [m["name"] for m, _ in spec["per_layer"]]
    assert "blocks_seen" in names
    reader = dict((m["name"], p) for m, p in spec["per_layer"])["blocks_seen"]
    assert run._load(reader).read({"window": {"blocks": 7}}) == 7.0
