"""A later PR adds a configuration, a traffic mix, a per-layer metric and a
kernel of a family as files of their own, plus entries in BENCHMARK.json,
and edits no file of `benchmark/`: a copy of the benchmark with one of each
dropped in runs the new cell (on the CPU, at a tiny size) and reads the new
metric and the new kernel's name."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).parent))

from tiny import tiny_sd15  # noqa: E402

SCRIPT = """
import json, sys, time
sys.path[:0] = [{copy!r}, {root!r}]
import torch
from benchmark import harness, kernels
from benchmark.trace import Trace
bench, wl, cfg, traffic = harness.load_cell(harness.Path({copy!r}), "dummy-cell")
assert harness.__file__.startswith({copy!r})
res = harness.run_cell(bench, wl, cfg, traffic, 12345, 1.0, False, torch.device("cpu"),
                       time.perf_counter())
run = harness.Run(cfg=cfg, traffic=traffic, setup_s=1.0, window_s=1.0, records=[None] * 3,
                  failed=0, engines={{}}, counters={{}}, peak_reserved=0,
                  trace=Trace(1.0, 0.5, {{"dummy_attn_kernel": 0.25}}), trace_images=1)
layer = harness.per_layer(run, harness.cell_metrics(bench, "dummy-cell", "per_layer"))
roofline = harness.load_metric("kernels.attention_roofline").read(run)
print(json.dumps({{"result": res, "layer": layer, "marks": kernels.marks("attention"),
                  "roofline": roofline}}))
"""


def digest(tree: Path):
    return {p.relative_to(tree).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_metric_and_kernel_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(bench_dir)
    cfg = dict(tiny_sd15(), name="dummy-config")
    (bench_dir / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "single.json").read_text())
    traffic.update(pool=3, warm=1)
    (bench_dir / "traffic" / "dummy-traffic.json").write_text(json.dumps(traffic))
    (bench_dir / "metrics" / "dummy.requests.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    (bench_dir / "kernels" / "attention" / "dummy.json").write_text(
        json.dumps({"marks": ["dummy_attn"], "why": "a later kernel"}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-config", "source": cfg["source"],
                             "file": "benchmark/configs/dummy-config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy-traffic", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.requests", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "pipeline", "moves": "images_per_s",
                               "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", SCRIPT.format(copy=str(tmp_path),
                                                              root=str(ROOT))],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["result"]["correct"] and got["result"]["attempted"] > 0
    assert set(got["result"]["metrics"]) == {"images_per_s", "latency_p50_s", "setup_s"}
    assert got["layer"]["dummy.requests"] == {"value": 3.0, "unit": "requests"}
    assert set(got["layer"]) == {"dummy.requests"}
    assert got["roofline"] is not None and got["roofline"] > 0  # the new kernel's time counts
    assert {"attention_", "dummy_attn"} <= set(got["marks"])
    after = digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
