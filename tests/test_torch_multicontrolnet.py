"""Multi-ControlNet in the PyTorch port against the JAX package, fp32 on the
CPU at tiny size: N nets' scaled taps sum into the UNet. The controlled UNet
with two nets within the tolerance of tests/test_torch_modules.py (max |d| <=
1e-4 x max |reference|), the composition's properties (split strengths,
a zero-strength net, the manual sum), the loop, process(annotator=[...])
with x_T injected (images within 1 uint8 LSB, as tests/test_torch_pipeline.py),
and a served multi request against process()."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.models import (
    init_clip_text,
    init_controlnet,
    init_unet,
    init_vae,
)
from stablediffusioneo_tpu.models.controlnet import (
    controlled_unet_apply as jax_controlled_unet,
)
from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
from stablediffusioneo_tpu_torch.models.controlnet import (
    controlled_unet_apply,
    controlnet_apply,
    scale_control,
)
from stablediffusioneo_tpu_torch.models.unet import unet_forward
from stablediffusioneo_tpu_torch.ops.layers import nchw, nhwc

from torch_port_util import (
    CFG,
    PORT_CFG,
    assert_close_scaled,
    numpy_params,
    port_model,
)

N_TAPS = 5  # tiny_pipeline(): 4 input blocks + the middle block


@pytest.fixture(scope="module")
def params():
    """Tiny weights drawn with numpy (the JAX initialisers take most of a
    minute here), with two distinct ControlNets."""
    return {"unet": numpy_params(init_unet, CFG.unet, seed=1),
            "controlnet": tuple(numpy_params(init_controlnet, CFG.controlnet, seed=s)
                                for s in (2, 3)),
            "vae": numpy_params(init_vae, CFG.vae, seed=4),
            "clip": numpy_params(init_clip_text, CFG.clip, seed=5)}


def multi_model(params, nets=(0, 1)) -> ControlLDM:
    trees = tuple(params["controlnet"][i] for i in nets)
    model = ControlLDM(PORT_CFG, n_controlnets=len(trees))
    model.load_checkpoint(state_dict_from_jax({**params, "controlnet": trees}, PORT_CFG))
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def model(params):
    return multi_model(params)


@pytest.fixture(scope="module")
def single(params):
    return port_model({**params, "controlnet": params["controlnet"][0]})


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, 8, 8, 4), dtype=np.float32),
            "hints": tuple(rng.random((b, 64, 64, 3), dtype=np.float32) for _ in range(2)),
            "t": np.asarray([981.0, 500.0][:b], np.float32),
            "ctx": rng.standard_normal((b, CFG.clip.max_length, CFG.unet.context_dim),
                                       dtype=np.float32)}


def test_state_dict_holds_each_net_under_its_index(params, model, single):
    names = {k.split(".")[1] for k in model.state_dict() if k.startswith("control_model.")}
    assert names == {"0", "1"}
    assert not any(k.startswith("control_model.0") for k in single.state_dict())
    for name, p in single.control_model.state_dict().items():
        assert torch.equal(model.control_model[0].state_dict()[name], p)
    assert not torch.equal(model.control_model[0].input_hint_block[0].weight,
                           model.control_model[1].input_hint_block[0].weight)
    assert isinstance(model.control, tuple) and len(model.control) == 2
    assert single.control is single.control_model


# scales: one per-tap list a net, per-sample (B, taps) matrices, one list for both
SCALES = {
    "per_net": lambda: ([0.8] * N_TAPS, [0.5] * N_TAPS),
    "per_sample": lambda: (np.asarray([[1.0] * N_TAPS, [0.3] * N_TAPS], np.float32),
                           np.asarray([[0.6] * N_TAPS, [1.2] * N_TAPS], np.float32)),
    "shared": lambda: [0.7] * N_TAPS,
}


@pytest.mark.parametrize("case", sorted(SCALES))
def test_two_nets_match_jax(params, model, case):
    a = _inputs()
    scales = SCALES[case]()
    if isinstance(scales, tuple):
        jax_scales = tuple(jnp.asarray(s) for s in scales)
        port_scales = tuple(_t(s) if isinstance(s, np.ndarray) else s for s in scales)
    else:
        jax_scales, port_scales = scales, scales
    ref = jax_controlled_unet(
        params["unet"], params["controlnet"], CFG.controlnet, jnp.asarray(a["x"]),
        tuple(jnp.asarray(h) for h in a["hints"]), jnp.asarray(a["t"]),
        jnp.asarray(a["ctx"]), control_scales=jax_scales)
    out = controlled_unet_apply(model.unet, model.control, _t(a["x"]),
                                tuple(_t(h) for h in a["hints"]), _t(a["t"]), _t(a["ctx"]),
                                control_scales=port_scales)
    assert_close_scaled(out.numpy(), np.asarray(ref))


def _pair(params, model, nets, scales, hints):
    """(port, JAX) controlled UNet of the nets `nets` (indices into the two
    trees) at per-net `scales`."""
    a = _inputs()
    trees = tuple(params["controlnet"][i] for i in nets)
    control = tuple(model.control[i] for i in nets)
    ref = jax_controlled_unet(
        params["unet"], trees, CFG.controlnet, jnp.asarray(a["x"]),
        tuple(jnp.asarray(a["hints"][i]) for i in hints), jnp.asarray(a["t"]),
        jnp.asarray(a["ctx"]), control_scales=tuple(jnp.full((N_TAPS,), s) for s in scales))
    out = controlled_unet_apply(model.unet, control, _t(a["x"]),
                                tuple(_t(a["hints"][i]) for i in hints), _t(a["t"]),
                                _t(a["ctx"]), control_scales=tuple([s] * N_TAPS
                                                                   for s in scales))
    return out.numpy(), np.asarray(ref)


def _one(model, net, scale, hint):
    a = _inputs()
    return controlled_unet_apply(model.unet, model.control[net], _t(a["x"]),
                                 _t(a["hints"][hint]), _t(a["t"]), _t(a["ctx"]),
                                 control_scales=[scale] * N_TAPS).numpy()


def test_split_strength_linearity(params, model):
    """The same net at (0.6, 0.4) is that net at 1.0 (the taps are linear in
    the scale), in both packages."""
    out, ref = _pair(params, model, (0, 0), (0.6, 0.4), (0, 0))
    assert_close_scaled(out, ref)
    one = _one(model, 0, 1.0, 0)
    np.testing.assert_allclose(out, one, rtol=2e-5, atol=2e-5)


def test_zero_strength_net_is_a_no_op(params, model):
    out, ref = _pair(params, model, (0, 1), (1.0, 0.0), (0, 1))
    assert_close_scaled(out, ref)
    np.testing.assert_allclose(out, _one(model, 0, 1.0, 0), rtol=1e-6, atol=1e-6)


def test_distinct_nets_equal_the_manual_sum(params, model):
    out, ref = _pair(params, model, (0, 1), (0.8, 0.5), (0, 1))
    assert_close_scaled(out, ref)
    a = _inputs()
    x, t, ctx = _t(a["x"]), _t(a["t"]), _t(a["ctx"])
    taps = [scale_control(controlnet_apply(net, x, _t(a["hints"][i]), t, ctx), [s] * N_TAPS)
            for i, (net, s) in enumerate(zip(model.control, (0.8, 0.5)))]
    control = [nchw(u + v) for u, v in zip(*taps)]
    want = nhwc(unet_forward(model.unet, nchw(x), t, ctx, control))
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- the pipeline


def inverted(img):
    """A second annotator, not binary (the uint8 path): the negative."""
    return 255 - img[..., 0]


@pytest.fixture(scope="module")
def pipes(params, model):
    from stablediffusioneo_tpu.annotators.canny import CannyDetector as JaxCanny
    from stablediffusioneo_tpu.pipeline.canny2image import Canny2ImagePipeline as JaxPipe
    from stablediffusioneo_tpu_torch.annotators.canny import CannyDetector
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    jax_pipe = JaxPipe(params, tok, CFG, persistent_cache=False,
                       annotator=[JaxCanny(), inverted])
    port_pipe = Canny2ImagePipeline(model, tok, PORT_CFG, device="cpu",
                                    annotator=[CannyDetector(), inverted])
    return jax_pipe, port_pipe


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(0)
    img = np.zeros((70, 60, 3), np.uint8)
    img[15:55, 10:50] = 180
    return (img + rng.integers(0, 60, img.shape)).astype(np.uint8)


@pytest.mark.parametrize("strength,guess_mode", [((1.0, 0.5), False), (0.7, True)],
                         ids=["per_net", "shared_guess"])
def test_process_matches_jax(pipes, image, strength, guess_mode):
    jax_pipe, port_pipe = pipes
    x_T = np.random.default_rng(1).standard_normal((1, 8, 8, 4), dtype=np.float32)
    kw = dict(num_samples=1, image_resolution=64, ddim_steps=2, seed=3, x_T=x_T,
              strength=strength, guess_mode=guess_mode)
    ref = jax_pipe.process(image, "a bird", **kw)
    out = port_pipe.process(image, "a bird", **kw)
    assert len(port_pipe.last_detected_maps) == len(jax_pipe.last_detected_maps) == 2
    for a, b in zip(port_pipe.last_detected_maps, jax_pipe.last_detected_maps):
        assert np.array_equal(a, b)
    assert np.array_equal(out[0], ref[0])
    assert out[1].shape == ref[1].shape == (64, 64, 3)
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1


def test_per_net_strength_matters(pipes, image):
    port_pipe = pipes[1]
    kw = dict(image_resolution=64, ddim_steps=2, seed=3)
    a = port_pipe.process(image, "a bird", strength=(1.0, 0.5), **kw)[1]
    b = port_pipe.process(image, "a bird", strength=(1.0, 0.0), **kw)[1]
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_loop_at_split_strength_equals_one_net(params, single, image, sampler):
    """The same net twice at strengths (0.25, 0.75) gives the one-net image
    at 1.0 (the JAX scan test's property, through process())."""
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    twice = Canny2ImagePipeline(multi_model(params, (0, 0)), tok, PORT_CFG, device="cpu")
    one = Canny2ImagePipeline(single, tok, PORT_CFG, device="cpu")
    kw = dict(image_resolution=64, ddim_steps=2, seed=4, sampler=sampler)
    a = twice.process(image, "a bird", strength=(0.25, 0.75), **kw)
    b = one.process(image, "a bird", strength=1.0, **kw)
    assert np.array_equal(a[0], b[0])
    assert np.abs(a[1].astype(int) - b[1].astype(int)).max() <= 1
    assert (twice.last_latents - one.last_latents).abs().max() <= 1e-4


def test_refusals(pipes, image, single):
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    port_pipe = pipes[1]
    rt = port_pipe.runtime
    engines = dict(rt._engines)
    with pytest.raises(ValueError, match="hires_upscale \\+ multi-ControlNet"):
        port_pipe.process(image, "a bird", image_resolution=64, ddim_steps=2,
                          hires_upscale=2.0)
    with pytest.raises(ValueError, match="multi-ControlNet \\+ encoder caching"):
        port_pipe.process(image, "a bird", image_resolution=64, ddim_steps=2,
                          encoder_cache_interval=2)
    ctx = rt.encode_prompt(np.zeros((2, CFG.clip.max_length), np.int64))
    hint = np.zeros((1, 64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="multi-ControlNet"):
        rt.sample_decode(2, None, hint, ctx[:1], ctx[1:], seeds=[0])
    with pytest.raises(ValueError, match="3 hints for 2 ControlNets"):
        rt.sample_decode(2, None, (hint,) * 3, ctx[:1], ctx[1:], seeds=[0])
    assert {k for k in rt._engines if k[0] == "sample_decode"} == \
        {k for k in engines if k[0] == "sample_decode"}
    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    with pytest.raises(ValueError, match="annotator="):
        Canny2ImagePipeline(single, tok, PORT_CFG, device="cpu", annotator=[inverted])


def test_multi_runtime_takes_uint8_and_float_hints_alike(pipes):
    """A tuple of uint8 maps is normalised per net as the one-net uint8
    variant does (/255 in fp32): the same image as the float hints."""
    rt = pipes[1].runtime
    rng = np.random.default_rng(2)
    maps = [(rng.random((1, 64, 64, 3)) * 255).astype(np.uint8) for _ in range(2)]
    ctx = rt.encode_prompt(np.zeros((2, CFG.clip.max_length), np.int64) + 3)
    x_T = torch.from_numpy(rng.standard_normal((1, 8, 8, 4), dtype=np.float32))
    a = rt.sample_decode(2, x_T, tuple(maps), ctx[:1], ctx[1:], strength=(0.9, 0.4))
    b = rt.sample_decode(2, x_T, tuple(m.astype(np.float32) / 255.0 for m in maps),
                         ctx[:1], ctx[1:], strength=[0.9, 0.4])
    assert torch.equal(a, b)


def test_served_multi_requests_match_process(pipes, image):
    """Per-request, per-net strengths batch through DiffusionServer and
    match process() (the JAX test's contract)."""
    from stablediffusioneo_tpu_torch.serving import DiffusionServer, GenRequest

    port_pipe = pipes[1]
    server = DiffusionServer(port_pipe, batch_buckets=(1, 2), max_wait_ms=200.0).start()
    try:
        server.warmup(resolutions=(64,), steps=2)
        assert all(k[9] == "multi" for k in port_pipe.runtime._engines
                   if k[0] == "sample_decode" and k[3] in (1, 2) and k[2] == 2)
        reqs = [GenRequest(image=image, prompt="a bird", image_resolution=64,
                           ddim_steps=2, seed=11, strength=(1.0, 0.3)),
                GenRequest(image=image[::-1].copy(), prompt="a dog", image_resolution=64,
                           ddim_steps=2, seed=12, strength=0.7)]
        results = [f.result(timeout=120) for f in [server.submit(r) for r in reqs]]
        assert server.stats.batches == 1 and server.stats.batch_hist == {2: 1}
        with pytest.raises(ValueError, match="strengths"):
            server.submit(GenRequest(image=image, prompt="x", image_resolution=64,
                                     ddim_steps=2, strength=(1.0, 0.5, 0.2)))
    finally:
        server.stop(drain=False)
    for r, (det, im) in zip(reqs, results):
        outs = port_pipe.process(r.image, r.prompt, num_samples=1, image_resolution=64,
                                 ddim_steps=2, seed=r.seed, strength=r.strength)
        assert np.array_equal(det, outs[0])
        assert (np.abs(outs[1].astype(np.int16) - im.astype(np.int16)) > 1).mean() < 0.02
