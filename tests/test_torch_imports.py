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
                 "stablediffusioneo_tpu_torch/cli/serve.py"):
        assert must in names
    assert len(names) >= 45


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
]


@pytest.mark.parametrize("port_mod,jax_mod,name", SOURCE_COPIES,
                         ids=[c[2] for c in SOURCE_COPIES])
def test_source_copies_are_their_originals(port_mod, jax_mod, name):
    """The batch-cut policy's mirror (and its ctypes signatures), the future
    resolver and the hint packer are the JAX package's code, statement for
    statement (docstrings aside); their results are held in
    tests/test_torch_serving.py."""
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


# ----------------------------------------------------------- configuration

CONSTRUCTORS = ["sd15_pipeline", "tiny_pipeline", "sd15_unet", "sd15_controlnet",
                "sd15_vae", "clip_vit_l14", "sd21_unet", "openclip_vit_h_text",
                "sd21_pipeline"]
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
