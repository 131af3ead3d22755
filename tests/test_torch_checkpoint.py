"""Starting the port from files, on the CPU: the checkpoint readers
(.pth, a nested {"state_dict": ...}, .safetensors in F32, F16 and BF16), key
accounting against the full-width model and the control_sd15_canny key
universe, `load_controlnet_pipeline` up to an image, the port's copies of
SD_KNOWN_UNUSED and prepare_inpaint, and the `hackathon` surface against
the JAX package's.

Tolerances: read tensors and loaded weights are equal to what was written;
images from the file equal those of the in-memory route in bytes; hackathon
images within 1 uint8 LSB of the JAX package's, as
tests/test_torch_pipeline.py holds the default path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.checkpoint import accounting as jax_accounting
from stablediffusioneo_tpu.checkpoint.manifest import load_universe
from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu.pipeline import inpaint as jax_inpaint
from stablediffusioneo_tpu.pipeline.canny2image import (
    Canny2ImagePipeline as JaxPipeline,
)
from stablediffusioneo_tpu.pipeline.hackathon import hackathon as JaxHackathon
from stablediffusioneo_tpu_torch.checkpoint import accounting, load_controlnet_pipeline
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax
from stablediffusioneo_tpu_torch.checkpoint.torch_reader import load_torch_state_dict
from stablediffusioneo_tpu_torch.config import sd15_pipeline
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
from stablediffusioneo_tpu_torch.pipeline import inpaint as port_inpaint
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline
from stablediffusioneo_tpu_torch.pipeline.hackathon import hackathon

from torch_port_util import CFG, PORT_CFG, port_model, tiny_params


@pytest.fixture(scope="module")
def params():
    return tiny_params()


@pytest.fixture(scope="module")
def sd(params):
    return state_dict_from_jax(params, PORT_CFG)


def test_full_width_model_has_the_checkpoint_key_universe():
    """SD-1.5 + ControlNet canny at full width, built on the meta device (it
    allocates nothing): exactly the 1,470 keys and shapes of
    control_sd15_canny's universe, less those SD_KNOWN_UNUSED documents."""
    universe = load_universe("control_sd15_canny")
    want = {k: s for k, s in universe.items() if not accounting.known_unused(k)}
    with torch.device("meta"):
        model = ControlLDM(sd15_pipeline())
    have = {k: "x".join(map(str, v.shape)) for k, v in model.state_dict().items()}
    assert have == want
    assert len(have) == 1470
    assert sum(k.startswith("first_stage_model.encoder.")
               or k.startswith("first_stage_model.quant_conv.") for k in have) == 108


def test_known_unused_is_the_jax_packages():
    assert accounting.SD_KNOWN_UNUSED == jax_accounting.SD_KNOWN_UNUSED
    assert issubclass(accounting.ConversionAccountingError, RuntimeError)
    for key in ("betas", "model_ema.decay", "logvar",
                "cond_stage_model.transformer.text_model.embeddings.position_ids"):
        assert accounting.known_unused(key)
    assert not accounting.known_unused("first_stage_model.encoder.conv_in.weight")


def test_jax_state_dict_matches_the_model_one_to_one(sd):
    """state_dict_from_jax makes every parameter of the port's model, the VAE
    encoder and quant_conv included, and no other key."""
    model = ControlLDM(PORT_CFG)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    rep = accounting.account_checkpoint(model, sd)
    assert rep.complete and rep.consumed == set(sd)


# ----------------------------------------------------------------- readers


def _save(sd, path, form):
    if form == "pth":
        torch.save(sd, path)
    elif form == "nested":
        torch.save({"state_dict": sd, "global_step": 7, "epoch": 1}, path)
    else:
        safetensors_torch = pytest.importorskip("safetensors.torch")
        dtype = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[form]
        safetensors_torch.save_file({k: v.to(dtype).contiguous() for k, v in sd.items()},
                                    str(path), metadata={"format": "pt"})


@pytest.mark.parametrize("form", ["pth", "nested", "F32", "F16", "BF16"])
def test_reader_round_trip(sd, tmp_path, form):
    path = tmp_path / ("m.pth" if form in ("pth", "nested") else "m.safetensors")
    extra = {"betas": torch.linspace(0, 1, 10, dtype=torch.float64).float(),
             "cond_stage_model.transformer.text_model.embeddings.position_ids":
                 torch.arange(16)[None].float()}
    _save({**sd, **extra}, path, form)
    back = load_torch_state_dict(str(path))
    assert back.keys() == {**sd, **extra}.keys()
    dtype = {"F16": torch.float16, "BF16": torch.bfloat16}.get(form, torch.float32)
    for k, v in sd.items():
        assert back[k].dtype == dtype and torch.equal(back[k], v.to(dtype)), k
    # and into the model: fp32 holding the file's values
    model = load_controlnet_pipeline(str(path), PORT_CFG, device="cpu")
    assert model.load_report.ignored == set(extra) and not model.load_report.orphans
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k].to(dtype).float()), k
    assert not any(p.requires_grad for p in model.parameters())


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    """The reader takes the float dtypes and the integer ones of counters
    and index rows (I64 since the offline drill's files carry them); a dtype
    outside its table (fp8) raises naming it."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    path = tmp_path / "ids.safetensors"
    safetensors_torch.save_file({"ids": torch.arange(4)}, str(path))
    back = load_torch_state_dict(str(path))
    assert back["ids"].dtype == torch.int64 and torch.equal(back["ids"], torch.arange(4))
    path = tmp_path / "fp8.safetensors"
    safetensors_torch.save_file({"w": torch.zeros(4).to(torch.float8_e4m3fn)}, str(path))
    with pytest.raises(TypeError, match="F8_E4M3"):
        load_torch_state_dict(str(path))


# -------------------------------------------------------------- accounting


@pytest.mark.parametrize("change,match", [
    (lambda sd: sd.update({"control_model.extra.weight": torch.zeros(3)}),
     "control_model.extra.weight"),
    (lambda sd: sd.update({"first_stage_model.quant_conv.weight": torch.zeros(8, 8, 3, 3)}),
     r"first_stage_model.quant_conv.weight \(8, 8, 3, 3\) vs model \(8, 8, 1, 1\)"),
    (lambda sd: sd.pop("first_stage_model.encoder.conv_in.bias"),
     "first_stage_model.encoder.conv_in.bias"),
], ids=["orphan", "shape", "missing"])
def test_strict_load_names_the_key(sd, tmp_path, change, match):
    bad = dict(sd)
    change(bad)
    path = tmp_path / "bad.pth"
    torch.save(bad, path)
    with pytest.raises(accounting.ConversionAccountingError, match=match):
        load_controlnet_pipeline(str(path), PORT_CFG, device="cpu")
    with pytest.raises(accounting.ConversionAccountingError, match=match):
        ControlLDM(PORT_CFG).load_checkpoint(bad)


def test_non_strict_load_tolerates_orphans_only(sd, tmp_path):
    path = tmp_path / "orphan.pth"
    torch.save({**sd, "control_model.extra.weight": torch.zeros(3)}, path)
    model = load_controlnet_pipeline(str(path), PORT_CFG, device="cpu", strict=False)
    assert model.load_report.orphans == {"control_model.extra.weight"}
    torch.save({k: v for k, v in sd.items() if "encoder.conv_in" not in k}, path)
    with pytest.raises(accounting.ConversionAccountingError, match="missing"):
        load_controlnet_pipeline(str(path), PORT_CFG, device="cpu", strict=False)


# ------------------------------------------------------- from file to image


@pytest.fixture(scope="module")
def jax_pipe(params):
    return JaxPipeline(params, toy_tokenizer(max_length=CFG.clip.max_length), CFG,
                       persistent_cache=False)


def test_file_to_image_equals_the_in_memory_route(params, sd, tmp_path):
    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    path = tmp_path / "control_tiny.pth"
    torch.save(sd, path)
    rng = np.random.default_rng(2)
    image = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    kw = dict(image_resolution=64, ddim_steps=2, seed=5, num_samples=1)
    outs = [Canny2ImagePipeline(m, tok, PORT_CFG, device="cpu").process(
                image, "a bird", init_image=image, denoise_strength=0.5, **kw)
            for m in (load_controlnet_pipeline(str(path), PORT_CFG, device="cpu"),
                      port_model(params))]
    assert np.array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("mask_kind", ["u8", "u8_hw1", "float"])
def test_prepare_inpaint_is_the_jax_packages(rng, mask_kind):
    src = (rng.random((50, 70, 3)) * 255).astype(np.uint8)
    mask = rng.random((50, 70)) > 0.5
    mask = {"u8": mask.astype(np.uint8) * 255,
            "u8_hw1": (mask.astype(np.uint8) * 255)[..., None],
            "float": mask.astype(np.float32) * 0.7}[mask_kind]
    for a, b in zip(port_inpaint.prepare_inpaint(src, mask, 64, 64, 8),
                    jax_inpaint.prepare_inpaint(src, mask, 64, 64, 8)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_hackathon_matches_jax(params, jax_pipe, monkeypatch):
    """14 positional arguments, the map dropped. hackathon.process hands no
    x_T through, so the port's pipeline is given the JAX engine's draw,
    normal(split(PRNGKey(seed))[1]), by wrapping its process()."""
    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    ref_h = JaxHackathon(params, tok, CFG)
    ref_h.pipe = jax_pipe  # its initialize() would compile a 256x256 warm-up
    port_h = hackathon(port_model(params), tok, PORT_CFG, device="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        port_h.process(*[None] * 14)
    port_h.initialize()
    seed, n = 12, 2
    x_T = np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(seed))[1],
                                       (n, 8, 8, 4), jnp.float32))
    monkeypatch.setattr(port_h.pipe, "process",
                        functools.partial(port_h.pipe.process, x_T=x_T))
    image = (np.random.default_rng(3).random((64, 64, 3)) * 255).astype(np.uint8)
    args = (image, "a bird", "best quality", "lowres", n, 64, 2, False, 1.0, 9.0,
            seed, 0.0, 100, 200)
    ref, out = ref_h.process(*args), port_h.process(*args)
    assert len(out) == len(ref) == n
    for a, b in zip(out, ref):
        assert a.shape == (64, 64, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
