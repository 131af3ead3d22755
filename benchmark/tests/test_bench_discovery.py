"""A later PR adds a configuration, a traffic mix, a per-layer metric, a
kernel of a family and a model family as files of their own, plus entries in
BENCHMARK.json, and edits no file of `benchmark/`: a copy of the benchmark
with one of each dropped in runs the new cells (on the CPU, at a tiny size)
and reads the new metric, the new kernel's name and the new family's work
counts and reference."""

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


FAMILY = '''"""A family a later PR brings: one 1x1 convolution over the request's
image, its own work counts and its own reference."""
import torch
import torch.nn as nn

from benchmark.families import Output
from benchmark.weights import draw_state_dict


def reference_module(cfg):
    m = nn.Module()
    m.net = nn.Conv2d(3, cfg["channels"], 1)
    return m


def flops_per_image(cfg):
    return 2 * 3 * cfg["channels"] * cfg["sampling"]["resolution"] ** 2


def attention_calls(cfg, batch):
    return [(batch, 1, cfg["sampling"]["resolution"], 77, cfg["channels"])]


def build(cfg, seed, device):
    net = reference_module(cfg)
    net.load_state_dict(draw_state_dict(net, seed, device, torch.float32))
    return net.eval().requires_grad_(False), None


def image(net, req):
    x = torch.as_tensor(req.image, dtype=torch.float32).permute(2, 0, 1)[None] / 255
    with torch.no_grad():
        y = net.net(x)[0, :3].clamp(0, 1) * 255
    return y.to(torch.uint8).permute(1, 2, 0).numpy()


class Entry:
    clients_max = None

    def __init__(self, model, pcfg, cfg, traffic, device):
        self.model = model

    def warm(self, reqs):
        for r in reqs:
            self.run(r)

    def run(self, req):
        return Output(image(self.model, req), None, {})

    def engines(self):
        return {}

    def counters(self):
        return {}

    def reset(self):
        pass

    def close(self):
        pass


ENTRIES = {"server": Entry}


def reference_request(net, cfg, req):
    return None, image(net, req)
'''

FAMILY_SCRIPT = """
import json, sys, time
sys.path[:0] = [{copy!r}, {root!r}]
import torch
from benchmark import harness, work
bench, wl, cfg, traffic = harness.load_cell(harness.Path({copy!r}), "dummy-open-cell")
assert harness.__file__.startswith({copy!r})
res = harness.run_cell(bench, wl, cfg, traffic, 2 ** 31 + 5, 1.0, False, torch.device("cpu"),
                       time.perf_counter())
net = harness.reference_net(cfg, 3, torch.device("cpu"))
print(json.dumps({{"result": res, "flops": work.model_flops_per_image(cfg),
                  "calls": work.attention_calls(cfg, 2),
                  "bound_s": work.attention_bound_s(cfg, 2),
                  "keys": list(net.state_dict())}}))
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


def test_new_family_and_open_traffic_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(bench_dir)
    (bench_dir / "families" / "dummy_family.py").write_text(FAMILY)
    cfg = {"name": "dummy-family-config", "family": "dummy_family", "conditioning": "canny",
           "source": "https://example.org/dummy-family", "reduced": ["num_layers"],
           "num_layers": 1, "channels": 8, "sampling": {"resolution": 16},
           "dtype": "float32", "check_requests": 2, "limits": {"pixel_mad": 0.5}}
    (bench_dir / "configs" / "dummy-family-config.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "served-open.json").read_text())
    traffic.update(rate_per_s=12.0, max_outstanding=4, pool=5, warm=1)
    (bench_dir / "traffic" / "dummy-open.json").write_text(json.dumps(traffic))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-family-config", "source": cfg["source"],
                             "file": "benchmark/configs/dummy-family-config.json",
                             "reduced": ["num_layers"], "why": "a test"})
    bench["workloads"].append({"name": "dummy-open-cell", "config": "dummy-family-config",
                               "traffic": "dummy-open", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", FAMILY_SCRIPT.format(copy=str(tmp_path),
                                                                     root=str(ROOT))],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    res = got["result"]
    assert res["correct"] and res["failed"] == 0, res
    assert res["attempted"] == 12  # floor(12 a second x 1 s) arrivals
    assert set(res["metrics"]) == {"images_per_s", "latency_p50_s", "setup_s"}
    assert set(res["checks"]) == {"pixel_mad", "requests_failed"}
    assert got["flops"] == 2 * 3 * 8 * 16 * 16
    assert got["calls"] == [[2, 1, 16, 77, 8]] and got["bound_s"] > 0
    assert got["keys"] == ["net.weight", "net.bias"]
    after = digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
