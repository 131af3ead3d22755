"""BENCHMARK.json against the benchmark's format rules, and the files it names:
names, units and keys; every configuration, traffic mix, metric and kernel
family is a file found by its name; the configurations are the program's
published presets."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_text(kind):
    entries = BENCH[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]


def test_configs_files_and_use():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert all(isinstance(k, str) and NAME.match(k) for k in c["reduced"])
        assert cfg["source"] == c["source"]
        assert c["file"].startswith("benchmark/configs/")


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        if traffic["loop"] == "open":
            assert traffic["rate_per_s"] > 0 and traffic["max_outstanding"] >= 1
            assert isinstance(traffic["arrivals_seed"], int)
        else:
            assert traffic["loop"] == "closed" and traffic["clients"] >= 1
        pair = (w["config"], w["traffic"])
        assert pair not in pairs
        pairs.add(pair)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in {"lower", "higher"}
    reported = {c: {n for n, m in e2e.items() if c in m.get("workloads", cells)}
                for c in cells}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["better"] in {"lower", "higher"}
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in reported[c], (m["name"], c)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2
        assert any(c in m.get("workloads", cells) for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:  # one layer name, letter for letter
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_configs_are_the_programs_presets():
    """The full-size files map to the port's own published presets, field
    for field, through the families' mapping."""
    import sys

    sys.path.insert(0, str(ROOT))
    from benchmark.families import controlnet_sd, sdxl
    from stablediffusioneo_tpu_torch.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.models.sdxl import SDXLConfig

    load = lambda n: json.loads((ROOT / "benchmark" / "configs" / f"{n}.json").read_text())  # noqa: E731
    assert controlnet_sd.program_config(load("sd15-controlnet-canny")) == sd15_pipeline()
    assert sdxl.program_config(load("sdxl-base")) == SDXLConfig()
