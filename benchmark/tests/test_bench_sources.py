"""The benchmark's sources: no module imports the JAX stack or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference imports nothing of the program either;
the traffic generator is deterministic per seed; the command refuses to run
without a card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "stablediffusioneo_tpu"}
PORT = "stablediffusioneo_tpu_torch"

sys.path.insert(0, str(ROOT))


def top_level_imports(path: Path):
    """Top-level names of every import in a file, as whole strings."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) in
              ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    assert not top_level_imports(path) & JAX


def test_whole_name_comparison():
    """The port's name shares a prefix with the JAX package's; only a whole
    name counts."""
    assert PORT not in JAX and PORT.startswith("stablediffusioneo_tpu")
    src = BENCH_DIR / "families" / "controlnet_sd.py"
    assert PORT in top_level_imports(src)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    names = top_level_imports(path)
    assert not names & (JAX | {PORT})
    text = path.read_text()
    for other in ("benchmark.families", "benchmark.harness", "benchmark.work"):
        assert other not in text


def test_traffic_deterministic_per_seed_and_differs_across_seeds():
    from benchmark import traffic

    cfg = json.loads((BENCH_DIR / "configs" / "sd15-controlnet-canny.json").read_text())
    t = dict(traffic.load("single"), pool=5)
    a, b = traffic.requests(t, cfg, 2 ** 33 + 7), traffic.requests(t, cfg, 2 ** 33 + 7)
    c = traffic.requests(t, cfg, 2 ** 33 + 8)
    assert [(r.seed, r.prompt) for r in a] == [(r.seed, r.prompt) for r in b]
    assert all(np.array_equal(x.image, y.image) for x, y in zip(a, b))
    assert [(r.seed, r.prompt) for r in a] != [(r.seed, r.prompt) for r in c]
    assert not np.array_equal(a[0].image, c[0].image)
    for r in a:  # the same sizes for every seed: one 77-token window, res x res
        assert r.image.shape == (512, 512, 3) and r.image.dtype == np.uint8
        lo, hi = t["prompt_words"]
        assert lo <= len(r.prompt.split()) <= hi
        ids = traffic.stand_in_tokenizer([r.prompt + ", best quality, extremely detailed"])
        assert ids.shape == (1, 77) and (ids[0] == 49407).sum() > 1


def test_canny_images_have_edges():
    import cv2

    from benchmark import traffic

    cfg = json.loads((BENCH_DIR / "configs" / "sd15-controlnet-canny.json").read_text())
    for r in traffic.requests(dict(traffic.load("served"), pool=4), cfg, 11):
        edges = cv2.Canny(r.image, 100, 200)
        assert 0.005 < (edges > 0).mean() < 0.3


def test_command_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "sd15-canny.single", "--seed", str(2 ** 31 + 3), "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
