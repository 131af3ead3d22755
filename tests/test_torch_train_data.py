"""The port's training data path and loggers (training/data.py,
training/logger.py) against the JAX package's, and the user's path end to
end on the CPU: a fill50k-layout directory through the loader,
controlnet_batches over the runtime's CLIP and VAE-encoder engines, and two
steps of train().

The native loader is the repository's native/loader.cpp, built by the
port's utils/native.py with g++, libpng and libjpeg (the JAX tests build it
with `make -C native`). PNG batches are equal in bytes across both backends
and both packages; a JPEG decode and the 48 -> 64 resize within 2 and 1 of
255, as tests/test_data_loader.py holds the JAX loader.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stablediffusioneo_tpu.training import data as jdata
from stablediffusioneo_tpu.training import logger as jlogger
from stablediffusioneo_tpu_torch.training import data as pdata
from stablediffusioneo_tpu_torch.training import logger as plogger
from stablediffusioneo_tpu_torch.utils import native

from torch_port_util import PORT_CFG


def _make_dataset(root, n=8, size=64, fmt="PNG"):
    os.makedirs(os.path.join(root, "source"), exist_ok=True)
    os.makedirs(os.path.join(root, "target"), exist_ok=True)
    rng = np.random.default_rng(42)
    ext = "png" if fmt == "PNG" else "jpg"
    with open(os.path.join(root, "prompt.json"), "w") as f:
        for i in range(n):
            for sub in ("source", "target"):
                img = (rng.random((size, size, 3)) * 255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(root, sub, f"{i}.{ext}"), format=fmt)
            f.write(json.dumps({"source": f"source/{i}.{ext}", "target": f"target/{i}.{ext}",
                                "prompt": f"a colored circle {i}"}) + "\n")
    return root


def test_the_loader_builds_into_the_ports_directory():
    """utils/native.py builds loader.cpp with its own link flags, into
    csrc/build/ under a name that hashes the flags."""
    assert native.SOURCES["sdeo_loader"] == "loader.cpp"
    assert native.LINK_FLAGS["sdeo_loader"] == ("-lpng", "-ljpeg", "-lpthread")
    assert pdata.native_available()
    path = native.library_path("sdeo_loader")
    assert path.parent == native.BUILD_DIR and path.exists()


def test_native_matches_python_and_the_jax_loader(tmp_path):
    """shuffle=False: the port's two backends and the JAX package's Python
    loader deliver the same pixel batches in the same order, wrapping
    epochs; the prompt table is the JAX one."""
    root = _make_dataset(str(tmp_path), n=6, size=64)
    nat, prompts = pdata.fill50k_loader(root, batch=4, resolution=64, shuffle=False,
                                        backend="native")
    py, _ = pdata.fill50k_loader(root, batch=4, resolution=64, shuffle=False, backend="python")
    ref, j_prompts = jdata.fill50k_loader(root, batch=4, resolution=64, shuffle=False,
                                          backend="python")
    assert nat.backend == "native" and prompts == j_prompts
    with nat, py, ref:
        for _ in range(4):  # 16 samples > 2 epochs of 6
            a, b, c = nat.next(), py.next(), ref.next()
            for key in ("indices", "source", "target"):
                np.testing.assert_array_equal(a[key], c[key])
                np.testing.assert_array_equal(b[key], c[key])
        assert nat.error_count() == 0


@pytest.mark.parametrize("fmt,size,tol", [("PNG", 48, 1), ("JPEG", 64, 2)])
def test_native_resize_and_jpeg_decode(tmp_path, fmt, size, tol):
    root = _make_dataset(str(tmp_path), n=2, size=size, fmt=fmt)
    nat, _ = pdata.fill50k_loader(root, batch=2, resolution=64, shuffle=False,
                                  backend="native")
    py, _ = pdata.fill50k_loader(root, batch=2, resolution=64, shuffle=False, backend="python")
    with nat, py:
        a, b = nat.next(), py.next()
    for key in ("source", "target"):
        assert np.abs(a[key].astype(np.int16) - b[key].astype(np.int16)).max() <= tol


@pytest.mark.parametrize("backend", ["native", "python"])
def test_shuffle_covers_every_sample_per_epoch(tmp_path, backend):
    root = _make_dataset(str(tmp_path), n=8, size=64)
    loader, _ = pdata.fill50k_loader(root, batch=4, resolution=64, shuffle=True, seed=3,
                                     backend=backend)
    with loader:
        epochs = [np.concatenate([loader.next()["indices"], loader.next()["indices"]])
                  for _ in range(2)]
    assert all(sorted(e.tolist()) == list(range(8)) for e in epochs)
    assert epochs[0].tolist() != epochs[1].tolist()


@pytest.mark.parametrize("backend", ["native", "python"])
def test_missing_file_zero_fills_and_counts(tmp_path, backend):
    root = _make_dataset(str(tmp_path), n=2, size=64)
    good = os.path.join(root, "source", "0.png")
    loader = pdata.ImagePairLoader([good, os.path.join(root, "nope.png")], [good, good],
                                   batch=2, resolution=64, shuffle=False, backend=backend)
    with loader:
        out = loader.next()
        assert loader.error_count() >= 1
    assert out["source"][1].max() == 0 and out["source"][0].max() > 0


def test_native_backend_raises_where_the_library_does_not_build(tmp_path, monkeypatch):
    """backend="native" raises when the build fails; "auto" then takes the
    Python path."""
    root = _make_dataset(str(tmp_path), n=2, size=64)

    def fail():
        raise RuntimeError("building libsdeo_loader.so failed")

    monkeypatch.setattr(pdata, "_load_lib", fail)
    with pytest.raises(RuntimeError, match="failed"):
        pdata.fill50k_loader(root, batch=2, resolution=64, backend="native")
    loader, _ = pdata.fill50k_loader(root, batch=2, resolution=64, backend="auto")
    assert loader.backend == "python"


def test_controlnet_batch_adapter(tmp_path):
    root = _make_dataset(str(tmp_path), n=4, size=64)
    loader, prompts = pdata.fill50k_loader(root, batch=2, resolution=64, shuffle=False,
                                           backend="python")
    seen = []

    def tok(texts):
        seen.extend(texts)
        return np.zeros((len(texts), 77), np.int64)

    it = pdata.controlnet_batches(
        loader, prompts, tok, lambda ids: torch.zeros(ids.shape[0], 77, 768),
        lambda u8, step: torch.zeros(u8.shape[0], u8.shape[1] // 8, u8.shape[2] // 8, 4))
    batch = next(it)
    assert batch["x0"].shape == (2, 8, 8, 4) and batch["ctx"].shape == (2, 77, 768)
    assert batch["hint"].shape == (2, 64, 64, 3) and batch["hint"].dtype == np.uint8
    assert seen == ["a colored circle 0", "a colored circle 1"]
    loader.close()


def test_end_to_end_training_from_the_loader(tmp_path):
    """A seeded tiny ControlLDM on the CPU: native loader -> tokenizer ->
    the runtime's CLIP engine (encode_prompt) and VAE-encoder engine
    (encode_image, the posterior sampled from a per-step generator) -> two
    train() steps; the loss is finite and the ControlNet's tensors move."""
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights
    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime
    from stablediffusioneo_tpu_torch.training.loop import train

    model = ControlLDM(PORT_CFG)
    init_weights(model, torch.Generator().manual_seed(0))
    rt = CNSDRuntime(model, PORT_CFG, device="cpu")
    tok = toy_tokenizer(vocab_size=PORT_CFG.clip.vocab_size, max_length=PORT_CFG.clip.max_length)
    root = _make_dataset(str(tmp_path), n=4, size=64)
    loader, prompts = pdata.fill50k_loader(root, batch=2, resolution=64, shuffle=True,
                                           backend="native")

    def enc_image(u8, step):
        img = torch.from_numpy(u8).float() / 127.5 - 1.0
        return rt.encode_image(img, torch.Generator().manual_seed(step))

    data = pdata.controlnet_batches(loader, prompts, lambda t: tok(t), rt.encode_prompt,
                                    enc_image)
    metrics = tmp_path / "metrics.jsonl"
    with loader:
        state = train(PORT_CFG, model.unet, model.control_model, data, num_steps=2,
                      ema_decay=None, metrics_path=str(metrics), device="cpu")
    assert all(np.isfinite(json.loads(x)["loss"]) for x in metrics.read_text().splitlines())
    before = dict(model.control_model.named_parameters())
    assert any(not torch.equal(p, before[n]) for n, p in state.params.items())


def test_make_grid_is_the_jax_packages():
    images = (np.random.default_rng(1).random((5, 8, 6, 3)) * 255).astype(np.uint8)
    for cols in (1, 2, 4):
        np.testing.assert_array_equal(plogger.make_grid(images, cols),
                                      jlogger.make_grid(images, cols))


def test_image_and_metrics_loggers(tmp_path):
    images = (np.random.default_rng(2).random((2, 8, 8, 3)) * 255).astype(np.uint8)
    log = plogger.ImageLogger(str(tmp_path / "img"), every_n_steps=2, sample_fn=lambda: images)
    assert log.on_step(1) is None
    path = log.on_step(2)
    got = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got, plogger.make_grid(images))
    m = plogger.MetricsLogger(str(tmp_path / "m.jsonl"))
    m.log(3, loss=0.5)
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5
