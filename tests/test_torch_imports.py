"""The PyTorch port stands on its own: it imports neither the JAX package
nor JAX, and keeps its own copies of the configuration dataclasses and the
host-side annotators, held here to the JAX package's field by field and
byte by byte.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from stablediffusioneo_tpu import config as jax_config
from stablediffusioneo_tpu.annotators import canny as jax_canny
from stablediffusioneo_tpu.annotators import util as jax_util
from stablediffusioneo_tpu_torch import annotators as port_annotators
from stablediffusioneo_tpu_torch import config as port_config

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "stablediffusioneo_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
# the JAX package and JAX; and two packages the card machine does not have
# (the port's tokenizer and checkpoint reader do without them)
FORBIDDEN = ("stablediffusioneo_tpu", "jax", "regex", "safetensors")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_neither_the_jax_package_nor_jax(path):
    """Every `import` / `from` of the file, at any depth of nesting; the
    exact packages, so `stablediffusioneo_tpu_torch` is allowed; nor
    `regex` or `safetensors`."""
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_walk_covers_the_port():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for must in ("chip_smoke.py", "stablediffusioneo_tpu_torch/config.py",
                 "stablediffusioneo_tpu_torch/annotators/canny.py",
                 "stablediffusioneo_tpu_torch/pipeline/canny2image.py",
                 "stablediffusioneo_tpu_torch/ops/kernels/attention.py",
                 "stablediffusioneo_tpu_torch/models/tokenizer.py",
                 "stablediffusioneo_tpu_torch/checkpoint/torch_reader.py",
                 "stablediffusioneo_tpu_torch/pipeline/hackathon.py",
                 "stablediffusioneo_tpu_torch/pipeline/plms.py",
                 "stablediffusioneo_tpu_torch/pipeline/dpm_solver.py",
                 "stablediffusioneo_tpu_torch/pipeline/unipc.py",
                 "stablediffusioneo_tpu_torch/pipeline/k_diffusion.py",
                 "stablediffusioneo_tpu_torch/ops/tome.py",
                 "stablediffusioneo_tpu_torch/models/sdxl.py",
                 "stablediffusioneo_tpu_torch/pipeline/concat_cond.py",
                 "stablediffusioneo_tpu_torch/checkpoint/__init__.py",
                 "stablediffusioneo_tpu_torch/utils/native.py",
                 "stablediffusioneo_tpu_torch/serving/__init__.py",
                 "stablediffusioneo_tpu_torch/serving/scheduler.py",
                 "stablediffusioneo_tpu_torch/serving/server.py",
                 "stablediffusioneo_tpu_torch/serving/http_api.py",
                 "stablediffusioneo_tpu_torch/cli/serve.py",
                 "stablediffusioneo_tpu_torch/training/lora.py",
                 "stablediffusioneo_tpu_torch/checkpoint/textual_inversion.py",
                 "stablediffusioneo_tpu_torch/checkpoint/convert.py",
                 "stablediffusioneo_tpu_torch/runtime/engine.py",
                 "stablediffusioneo_tpu_torch/annotators/_dtype.py",
                 "stablediffusioneo_tpu_torch/annotators/hed.py",
                 "stablediffusioneo_tpu_torch/annotators/midas.py",
                 "stablediffusioneo_tpu_torch/annotators/midas_hybrid.py",
                 "stablediffusioneo_tpu_torch/annotators/openpose.py",
                 "stablediffusioneo_tpu_torch/training/trainer.py",
                 "stablediffusioneo_tpu_torch/training/ema.py",
                 "stablediffusioneo_tpu_torch/training/data.py",
                 "stablediffusioneo_tpu_torch/training/logger.py",
                 "stablediffusioneo_tpu_torch/training/loop.py",
                 "stablediffusioneo_tpu_torch/training/__init__.py",
                 "stablediffusioneo_tpu_torch/annotators/native.py",
                 "stablediffusioneo_tpu_torch/annotators/mlsd.py",
                 "stablediffusioneo_tpu_torch/annotators/mlsd_net.py",
                 "stablediffusioneo_tpu_torch/annotators/uniformer.py",
                 "stablediffusioneo_tpu_torch/scoring/__init__.py",
                 "stablediffusioneo_tpu_torch/scoring/score.py",
                 "stablediffusioneo_tpu_torch/scoring/inception.py",
                 "stablediffusioneo_tpu_torch/cli/score.py",
                 "stablediffusioneo_tpu_torch/yolo/__init__.py",
                 "stablediffusioneo_tpu_torch/yolo/model.py",
                 "stablediffusioneo_tpu_torch/yolo/pipeline.py",
                 "stablediffusioneo_tpu_torch/testing/fixtures.py",
                 "stablediffusioneo_tpu_torch/checkpoint/manifest.py",
                 "stablediffusioneo_tpu_torch/checkpoint/diffusers.py",
                 "stablediffusioneo_tpu_torch/checkpoint/store.py",
                 "stablediffusioneo_tpu_torch/testing/offline_drill.py",
                 "stablediffusioneo_tpu_torch/cli/readiness.py",
                 "stablediffusioneo_tpu_torch/cli/smoke.py",
                 "stablediffusioneo_tpu_torch/models/t5.py",
                 "stablediffusioneo_tpu_torch/utils/debug.py",
                 "stablediffusioneo_tpu_torch/utils/misc.py"):
        assert must in names
    assert len(names) >= 81


# numpy-only functions of the JAX package the port keeps its own copy of,
# under the same name: (port module, JAX module, name)
COPIES = [
    ("pipeline.dpm_solver", "pipeline.dpm_solver", "dpmpp_schedule"),
    ("pipeline.k_diffusion", "pipeline.k_diffusion", "kdiff_schedule"),
    ("ops.tome", "ops.tome", "_dst_src_partition"),
    ("ops.tome", "ops.tome", "merge_count"),
]


@pytest.mark.parametrize("port_mod,jax_mod,name", COPIES, ids=[c[2] for c in COPIES])
def test_numpy_copies_are_their_originals(port_mod, jax_mod, name):
    """The copy's source is the original's, line for line, and it gives the
    original's results (schedules on the SD-1.5 DDPM schedule for 1, 2, 7 and
    20 steps in both spacings; partitions and merge counts over grids)."""
    import importlib
    import inspect

    port = getattr(importlib.import_module(f"stablediffusioneo_tpu_torch.{port_mod}"), name)
    ref = getattr(importlib.import_module(f"stablediffusioneo_tpu.{jax_mod}"), name)
    assert inspect.getsource(port) == inspect.getsource(ref)
    if name.endswith("_schedule"):
        from stablediffusioneo_tpu.ops.schedule import DiffusionSchedule as JaxSchedule
        from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule

        for n in (1, 2, 7, 20):
            for spacing in ("uniform", "karras"):
                got, want = port(DiffusionSchedule(), n, spacing), ref(JaxSchedule(), n, spacing)
                assert got.keys() == want.keys()
                assert all(np.array_equal(got[k], want[k]) for k in want)
    else:
        args = (0.5,) if name == "merge_count" else (2, 2)
        for h, w in ((8, 8), (64, 64), (7, 9), (128, 96)):
            got, want = port(h, w, *args), ref(h, w, *args)
            if name == "merge_count":
                assert got == want
            else:
                assert all(np.array_equal(a, b) for a, b in zip(got, want))


# functions the port copies line for line from a module it cannot import:
# (port module, JAX module, qualified name)
SOURCE_COPIES = [
    ("serving.scheduler", "serving.scheduler", name)
    for name in ("_configure", "_dptr", "decide_cut", "pick_group", "next_deadline_ms")
] + [
    ("serving.server", "serving.server", "_resolve"),
    ("pipeline.canny2image", "pipeline.canny2image", "Canny2ImagePipeline._pack_hint"),
] + [
    ("training.data", "training.data", name)
    for name in ("_configure", "read_prompt_json", "_epoch_perm", "ImagePairLoader.next",
                 "ImagePairLoader._next_python", "ImagePairLoader._decode_py",
                 "ImagePairLoader.error_count", "ImagePairLoader.close",
                 "ImagePairLoader.__enter__", "ImagePairLoader.__exit__", "fill50k_loader")
] + [
    ("training.logger", "training.logger", name)
    for name in ("make_grid", "ImageLogger.__init__", "ImageLogger.on_step",
                 "MetricsLogger.__init__", "MetricsLogger.log")
] + [
    ("annotators.mlsd", "annotators.mlsd", name)
    for name in ("decode_center_and_displacement", "pred_lines")
] + [
    ("annotators.uniformer", "annotators.uniformer", "ade20k_palette"),
    ("testing.fixtures", "testing.fixtures", "make_scene"),
    ("testing.fixtures", "testing.fixtures", "main"),
] + [
    ("scoring.score", "scoring.score", name)
    for name in ("get_score", "PixelFeatureExtractor", "perceptual_distance", "ScoreHarness")
] + [
    ("yolo.pipeline", "yolo.pipeline", name)
    for name in ("PreProcessor", "iou_matrix", "nms", "PostProcessor", "draw_boxes")
] + [
    ("testing.offline_drill", "testing.offline_drill", "synth_state_dict"),
    ("models.t5", "models.t5", "_rel_pos_buckets"),
    ("utils.misc", "utils.misc", "log_txt_as_img"),
    ("checkpoint.diffusers", "checkpoint.diffusers", "_vae_pairs"),
    ("checkpoint.diffusers", "checkpoint.diffusers", "_expand"),
] + [
    ("checkpoint.manifest", "checkpoint.manifest", name)
    for name in ("default_manifest_path", "sha256_file", "key_universe_digest", "load_manifest",
                 "load_universe", "_shape_str", "_match_entry", "verify_file", "pin_file")
] + [
    ("annotators.openpose", "annotators.openpose", name)
    for name in ("_stage1_spec", "_stageN_spec", "_hand_stage1", "_hand_stageN",
                 "_cv2_cubic_weights", "_upsample_matrices", "_gaussian_matrix", "_VirtualMap",
                 "peaks_from_mask", "_gaussian_sigma3", "find_peaks", "score_limbs",
                 "assemble_people", "hand_detect", "decode_hand_peaks", "draw_bodypose",
                 "draw_handpose")
]


@pytest.mark.parametrize("port_mod,jax_mod,name", SOURCE_COPIES,
                         ids=[c[2] for c in SOURCE_COPIES])
def test_source_copies_are_their_originals(port_mod, jax_mod, name):
    """The batch-cut policy's mirror (and its ctypes signatures), the future
    resolver, the hint packer, the training data loader's and loggers'
    functions, OpenPose's spec tables and numpy decode, MLSD's decode,
    UniFormer's palette, the fixture scenes, the score harness and YOLOv5's
    pre- and post-processing are the JAX package's code, statement for
    statement (docstrings aside); their results are held in
    tests/test_torch_serving.py, tests/test_torch_train_data.py,
    tests/test_torch_annotators.py, tests/test_torch_mlsd_uniformer.py,
    tests/test_torch_scoring.py and tests/test_torch_yolo.py."""
    import importlib
    import inspect

    def get(pkg, mod):
        obj = importlib.import_module(f"{pkg}.{mod}")
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    def code(obj):  # the function's syntax tree without its docstring
        tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
        body = tree.body[0].body
        if isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
            del body[0]
        return ast.dump(tree)

    port = get("stablediffusioneo_tpu_torch", port_mod)
    ref = get("stablediffusioneo_tpu", jax_mod)
    assert code(port) == code(ref)


def test_serve_cli_runs_with_both_packages_blocked():
    """With `stablediffusioneo_tpu` and `jax` blocked, the serving CLI builds
    its --tiny --cpu pipeline, and a DiffusionServer behind the HTTP API
    answers /healthz and one /generate."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "stablediffusioneo_tpu", "regex", "safetensors"):
            sys.modules[name] = None
        import base64, json, threading, urllib.request
        import cv2, numpy as np, torch
        torch.set_num_threads(1)
        from stablediffusioneo_tpu_torch.cli import serve
        from stablediffusioneo_tpu_torch.serving import DiffusionServer
        from stablediffusioneo_tpu_torch.serving.http_api import make_http_server
        args = serve.parse_args(["--tiny", "--cpu", "--port", "0"])
        pipe = serve.build_pipeline(args)
        assert pipe.runtime.device.type == "cpu"
        server = DiffusionServer(pipe, max_wait_ms=10).start()
        httpd = make_http_server(server, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        img = (np.random.default_rng(0).random((64, 64, 3)) * 255).astype(np.uint8)
        png = base64.b64encode(cv2.imencode(".png", img)[1].tobytes()).decode()
        body = json.dumps({"image_b64": png, "prompt": "a bird", "image_resolution": 64,
                           "ddim_steps": 2, "seed": 1}).encode()
        with urllib.request.urlopen(urllib.request.Request(base + "/generate", data=body),
                                    timeout=120) as r:
            out = json.loads(r.read())
        assert set(out) == {"image_b64", "detected_b64", "ms"}
        httpd.shutdown()
        server.stop()
        loaded = [m for m in sys.modules if sys.modules[m] is not None
                  and m.split(".")[0] in ("jax", "stablediffusioneo_tpu", "regex",
                                          "safetensors")]
        assert not loaded, loaded
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_score_cli_runs_with_both_packages_blocked():
    """With `stablediffusioneo_tpu` and `jax` blocked, the new detectors,
    the Inception extractor and YOLOv5 import, and sdeo-score-torch --cpu
    scores two fixture scenes on seeded tiny weights against
    self-consistency goldens: the distance is exactly 0."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "stablediffusioneo_tpu", "regex", "safetensors"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        import stablediffusioneo_tpu_torch.annotators.mlsd
        import stablediffusioneo_tpu_torch.annotators.native
        import stablediffusioneo_tpu_torch.annotators.uniformer
        import stablediffusioneo_tpu_torch.scoring.inception
        import stablediffusioneo_tpu_torch.yolo
        from stablediffusioneo_tpu_torch.cli import score
        result = score.main(["--cpu", "--n", "2"])
        assert result["mean_pd"] == 0.0 and len(result["records"]) == 2
        assert all(r["score"] > 0 for r in result["records"])
        loaded = [m for m in sys.modules if sys.modules[m] is not None
                  and m.split(".")[0] in ("jax", "stablediffusioneo_tpu", "regex",
                                          "safetensors")]
        assert not loaded, loaded
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mean perceptual distance: 0.000" in res.stdout
    assert res.stdout.strip().endswith("OK")


def test_score_console_script_is_registered():
    text = (REPO / "pyproject.toml").read_text()
    assert 'sdeo-score-torch = "stablediffusioneo_tpu_torch.cli.score:main"' in text


@pytest.mark.parametrize("script", ["readiness", "smoke"])
def test_checkpoint_console_scripts_are_registered(script):
    text = (REPO / "pyproject.toml").read_text()
    assert f'sdeo-{script}-torch = "stablediffusioneo_tpu_torch.cli.{script}:main"' in text


def test_manifest_is_package_data():
    text = (REPO / "pyproject.toml").read_text()
    assert ('"stablediffusioneo_tpu_torch.checkpoint" = ["weights_manifest.json", '
            '"universes/*.txt.gz"]') in text


CHECKPOINT_DATA = ["weights_manifest.json"] + sorted(
    f"universes/{p.name}"
    for p in (REPO / "stablediffusioneo_tpu/checkpoint/universes").glob("*.txt.gz"))


@pytest.mark.parametrize("name", CHECKPOINT_DATA)
def test_manifest_data_is_the_jax_packages(name):
    """The port's packaged manifest and key universes are the JAX package's
    files byte for byte (nine universes)."""
    port = REPO / "stablediffusioneo_tpu_torch/checkpoint" / name
    ref = REPO / "stablediffusioneo_tpu/checkpoint" / name
    assert port.read_bytes() == ref.read_bytes()
    assert len(CHECKPOINT_DATA) == 10
    assert sorted(p.name for p in (REPO / "stablediffusioneo_tpu_torch/checkpoint/universes")
                  .iterdir()) == [n.split("/")[1] for n in CHECKPOINT_DATA[1:]]


@pytest.mark.parametrize("package", ["models", "checkpoint", "utils"])
def test_exports_cover_the_jax_packages(package):
    import importlib

    port = importlib.import_module(f"stablediffusioneo_tpu_torch.{package}")
    ref = importlib.import_module(f"stablediffusioneo_tpu.{package}")
    assert set(ref.__all__) <= set(port.__all__)
    assert all(hasattr(port, name) for name in port.__all__)


@pytest.mark.parametrize("mode", ["tiny", "fixtures"])
def test_score_cli_hands_process_the_jax_clis_images(tmp_path, monkeypatch, mode):
    """Both score CLIs with process() recorded (the networks stubbed out):
    the port's hands process() the JAX CLI's fixture images, in size and in
    bytes: without --ckpt the scenes drawn at --res (256), resized by
    process() to the tiny path's 64; with --fixtures the files read."""
    import cv2

    import stablediffusioneo_tpu.models as jax_models
    import stablediffusioneo_tpu.pipeline.canny2image as jax_c2i
    import stablediffusioneo_tpu_torch.pipeline.canny2image as port_c2i
    from stablediffusioneo_tpu.cli import score as jax_score
    from stablediffusioneo_tpu.testing.fixtures import make_scene
    from stablediffusioneo_tpu_torch.cli import score as port_score

    seen = {"jax": [], "port": []}

    def fake(key):
        class Pipe:
            def __init__(self, *a, **kw):
                pass

            def process(self, img, prompt=None, num_samples=1, image_resolution=256, **kw):
                seen[key].append((img.copy(), image_resolution))
                out = np.zeros((image_resolution, image_resolution, 3), np.uint8)
                return [out, out]

        return Pipe

    monkeypatch.setattr(jax_c2i, "Canny2ImagePipeline", fake("jax"))
    monkeypatch.setattr(port_c2i, "Canny2ImagePipeline", fake("port"))
    for name in ("init_unet", "init_controlnet", "init_vae", "init_clip_text"):
        monkeypatch.setattr(jax_models, name, lambda *a, **kw: {})
    argv = ["--n", "2"]
    if mode == "fixtures":
        for i in range(2):
            cv2.imwrite(str(tmp_path / f"bird_{i}.jpg"), make_scene(2000 + i, 200))
        argv += ["--fixtures", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", ["sdeo-score"] + argv)
    jax_score.main()
    port_score.main(argv + ["--cpu"])
    assert len(seen["port"]) == len(seen["jax"]) == 4  # goldens pass, then the scored pass
    side = 200 if mode == "fixtures" else 256
    for (a, res_a), (b, res_b) in zip(seen["port"], seen["jax"]):
        assert a.shape == b.shape == (side, side, 3) and res_a == res_b == 64
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("args", [["readiness", "--dry-run", "--cpu"],
                                  ["smoke", "--tiny", "--cpu"]], ids=["readiness", "smoke"])
def test_checkpoint_clis_run_with_both_packages_blocked(args):
    """With `stablediffusioneo_tpu`, `jax`, `regex` and `safetensors`
    blocked, sdeo-readiness-torch --dry-run --cpu passes and
    sdeo-smoke-torch --tiny --cpu brings the CLIP engine up; the manifest,
    diffusers, store, drill and T5 modules import."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "stablediffusioneo_tpu", "regex", "safetensors"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        import stablediffusioneo_tpu_torch.checkpoint.manifest
        import stablediffusioneo_tpu_torch.checkpoint.diffusers
        import stablediffusioneo_tpu_torch.checkpoint.store
        import stablediffusioneo_tpu_torch.testing.offline_drill
        import stablediffusioneo_tpu_torch.models.t5
        import stablediffusioneo_tpu_torch.utils
        from stablediffusioneo_tpu_torch.cli import {args[0]} as cli
        assert cli.main({args[1:]!r}) == 0
        loaded = [m for m in sys.modules if sys.modules[m] is not None
                  and m.split(".")[0] in ("jax", "stablediffusioneo_tpu", "regex",
                                          "safetensors")]
        assert not loaded, loaded
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")
    if args[0] == "readiness":
        assert "READINESS: PASS" in res.stdout
    else:
        assert "clip engine OK" in res.stdout


def test_tiny_process_runs_with_both_packages_blocked():
    """With `stablediffusioneo_tpu` and `jax` (and `regex`, `safetensors`)
    made unimportable, the port's pipeline imports and runs a tiny process()
    on the CPU, and its tokenizer, checkpoint reader and hackathon import."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "stablediffusioneo_tpu", "regex", "safetensors"):
            sys.modules[name] = None
        import stablediffusioneo_tpu_torch.models.tokenizer
        import stablediffusioneo_tpu_torch.checkpoint.torch_reader
        import stablediffusioneo_tpu_torch.pipeline.hackathon
        import stablediffusioneo_tpu_torch.models.sdxl
        import stablediffusioneo_tpu_torch.pipeline.concat_cond
        import stablediffusioneo_tpu_torch.training.lora
        import stablediffusioneo_tpu_torch.checkpoint.textual_inversion
        import numpy as np, torch
        from stablediffusioneo_tpu_torch.config import tiny_pipeline
        from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights
        from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline
        cfg = tiny_pipeline()
        model = ControlLDM(cfg)
        init_weights(model, torch.Generator().manual_seed(0))
        def tok(texts):
            rows = [[998] + [sum(map(ord, w)) % 990 for w in t.split()][:14]
                    for t in texts]
            return np.array([(r + [999] * 16)[:16] for r in rows])
        pipe = Canny2ImagePipeline(model, tok, cfg, device="cpu")
        img = (np.random.default_rng(0).random((64, 64, 3)) * 255).astype(np.uint8)
        out = pipe.process(img, "a bird", image_resolution=64, ddim_steps=2, seed=3)
        assert out[0].shape == (64, 64, 3) and out[0].any()  # the Canny map
        assert out[1].shape == (64, 64, 3) and out[1].dtype == np.uint8
        loaded = [m for m in sys.modules if sys.modules[m] is not None
                  and m.split(".")[0] in ("jax", "stablediffusioneo_tpu", "regex",
                                          "safetensors")]
        assert not loaded, loaded
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


@pytest.mark.parametrize("name", ["_BODY_TRUNK", "_HAND_TRUNK", "LIMB_PAIRS", "PAF_CHANNELS",
                                  "HAND_EDGES", "_BODY_COLORS"])
def test_openpose_tables_are_the_jax_packages(name):
    from stablediffusioneo_tpu.annotators import openpose as jax_openpose
    from stablediffusioneo_tpu_torch.annotators import openpose as port_openpose

    assert getattr(port_openpose, name) == getattr(jax_openpose, name)


# ----------------------------------------------------------- configuration

CONSTRUCTORS = ["sd15_pipeline", "tiny_pipeline", "sd15_unet", "sd15_controlnet",
                "sd15_vae", "clip_vit_l14", "sd21_unet", "openclip_vit_h_text",
                "sd21_pipeline", "sd15_inpaint_pipeline", "sd2_inpaint_pipeline",
                "sd2_depth_pipeline"]
CLASSES = ["UNetConfig", "ControlNetConfig", "VAEConfig", "CLIPTextConfig",
           "DiffusionConfig", "PipelineConfig"]


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_config_constructor_equals_the_jax_packages(name):
    port, ref = getattr(port_config, name)(), getattr(jax_config, name)()
    assert type(port).__module__ == "stablediffusioneo_tpu_torch.config"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", CLASSES)
def test_config_class_has_the_same_fields_and_defaults(name):
    port, ref = getattr(port_config, name), getattr(jax_config, name)
    assert [(f.name, f.type) for f in dataclasses.fields(port)] == \
        [(f.name, f.type) for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    assert port.__dataclass_params__.frozen and hash(port()) == hash(port())


@pytest.mark.parametrize("name", ["sd15_pipeline", "tiny_pipeline", "sd21_pipeline"])
def test_config_helper_methods_agree(name):
    port, ref = getattr(port_config, name)(), getattr(jax_config, name)()
    assert port.unet.time_embed_dim == ref.unet.time_embed_dim
    assert port.vae.downsample_factor == ref.vae.downsample_factor
    for channels in (32, 64, 320, 640, 1280):
        assert port.unet.heads_for(channels) == ref.unet.heads_for(channels)
    for level in range(len(ref.unet.channel_mult)):
        assert port.unet.depth_for(level) == ref.unet.depth_for(level)


def test_config_helpers_with_per_head_channels_and_per_level_depth():
    kw = dict(num_head_channels=64, transformer_depth=(1, 2, 10),
              channel_mult=(1, 2, 4))
    port, ref = port_config.UNetConfig(**kw), jax_config.UNetConfig(**kw)
    assert [port.heads_for(c) for c in (320, 640, 1280)] == \
        [ref.heads_for(c) for c in (320, 640, 1280)] == [5, 10, 20]
    assert [port.depth_for(i) for i in range(3)] == \
        [ref.depth_for(i) for i in range(3)] == [1, 2, 10]


@pytest.mark.parametrize("name", ["sd15_inpaint_pipeline", "sd2_inpaint_pipeline"])
def test_inpaint_configs_take_their_arguments(name):
    for kw in ({"dtype": "float32"}, {"use_pallas": False}):
        port, ref = getattr(port_config, name)(**kw), getattr(jax_config, name)(**kw)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", ["sdxl_refiner_unet", "SDXLRefinerConfig",
                                  "tiny_sdxl_refiner"])
def test_refiner_configs_equal_the_jax_packages(name):
    """The refiner's configurations live beside their model (models/sdxl.py)
    in both packages: the same fields, types and values."""
    from stablediffusioneo_tpu.models import sdxl as jax_sdxl
    from stablediffusioneo_tpu_torch.models import sdxl as port_sdxl

    port, ref = getattr(port_sdxl, name)(), getattr(jax_sdxl, name)()
    assert [(f.name, f.type) for f in dataclasses.fields(port)] == \
        [(f.name, f.type) for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if name == "SDXLRefinerConfig":
        assert port_sdxl.SDXLRefinerConfig.__dataclass_params__.frozen


def test_native_sources_name_the_loader():
    """The port builds the JAX package's three native libraries from the same
    sources: the batch-cut policy, the training data loader and the
    annotators' preprocessing library (no link flags, as native/Makefile)."""
    from stablediffusioneo_tpu_torch.utils import native

    assert native.SOURCES == {"sdeo_sched": "scheduler.cpp", "sdeo_loader": "loader.cpp",
                              "sdeo_preproc": "preproc.cpp"}
    assert "sdeo_preproc" not in native.LINK_FLAGS
    assert all((native.NATIVE / src).exists() for src in native.SOURCES.values())


def test_training_exports_are_the_jax_packages():
    from stablediffusioneo_tpu import training as jax_training
    from stablediffusioneo_tpu_torch import training as port_training

    assert port_training.__all__ == jax_training.__all__
    assert all(hasattr(port_training, name) for name in port_training.__all__)


def test_lora_default_targets_are_the_jax_packages():
    from stablediffusioneo_tpu.training import lora as jax_lora
    from stablediffusioneo_tpu_torch.training import lora as port_lora

    assert port_lora.DEFAULT_TARGETS == jax_lora.DEFAULT_TARGETS


def test_sd15_pipeline_takes_the_dtype():
    assert port_config.sd15_pipeline(dtype="float32") == \
        dataclasses.replace(port_config.sd15_pipeline(), dtype="float32")


# -------------------------------------------------------------- annotators


@pytest.fixture
def image():
    rng = np.random.default_rng(7)
    img = np.zeros((96, 128, 3), np.uint8)
    img[20:70, 30:100] = 180  # a box, so Canny finds edges
    return (img + rng.integers(0, 50, img.shape)).astype(np.uint8)


@pytest.mark.parametrize("low,high", [(100, 200), (50, 120)])
def test_canny_gives_the_same_bytes(image, low, high):
    out = port_annotators.CannyDetector()(image, low, high)
    ref = jax_canny.CannyDetector()(image, low, high)
    assert out.dtype == np.uint8 and out.any()
    assert out.tobytes() == ref.tobytes()


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_hwc3_gives_the_same_bytes(image, channels):
    rng = np.random.default_rng(8)
    x = {None: image[..., 0], 1: image[..., :1], 3: image,
         4: np.concatenate([image, rng.integers(0, 256, image.shape[:2] + (1,),
                                                dtype=np.uint8)], axis=2)}[channels]
    out, ref = port_annotators.HWC3(x), jax_util.HWC3(x)
    assert out.shape == image.shape and out.tobytes() == ref.tobytes()


@pytest.mark.parametrize("resolution", [64, 128, 200])
def test_resize_image_gives_the_same_bytes(image, resolution):
    out = port_annotators.resize_image(image, resolution)
    ref = jax_util.resize_image(image, resolution)
    assert out.shape == ref.shape and out.shape[0] % 64 == 0 and out.shape[1] % 64 == 0
    assert out.tobytes() == ref.tobytes()
