"""The PyTorch port's int8 weight-only configuration against the JAX
package's, fp32 on the CPU: the int8 bytes and scales, the set of converted
linears (tiny config with min_dim 32, and SD-1.5 widths without weights),
the kernel's plain version against the Pallas kernel in interpret mode, the
int8_linear gate, and the tiny process() with quantize_linears=True with the
flag off and on in both packages.

Tolerances: int8 bytes and scales exactly equal; fp32 products 1e-5 (the
same fp32 formula, another summation order); bf16 products max |d| <= 2e-2,
mean <= 2e-3 (both round the same fp32 value once); images within 1 uint8
LSB, as test_torch_pipeline.py holds the default path.
"""

import collections
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.config import sd15_pipeline as jax_sd15_pipeline
from stablediffusioneo_tpu.models import init_controlnet, init_unet
from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu.ops import dispatch as jax_dispatch
from stablediffusioneo_tpu.ops.pallas import quant as jax_quant
from stablediffusioneo_tpu.pipeline.canny2image import (
    Canny2ImagePipeline as JaxPipeline,
)
from stablediffusioneo_tpu.scoring.score import perceptual_distance
from stablediffusioneo_tpu_torch.checkpoint.convert import (
    controlnet_state_dict,
    unet_state_dict,
)
from stablediffusioneo_tpu_torch.config import sd15_pipeline
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
from stablediffusioneo_tpu_torch.models.controlnet import controlled_unet_apply
from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops import quant as port_quant
from stablediffusioneo_tpu_torch.ops.kernels.quant import (
    pick_blocks,
    quantized_matmul,
    quantized_matmul_plain,
)
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

from torch_port_util import CFG, PORT_CFG, port_model, tiny_params

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the plan-derived int8 sites)

BF16_TOL = (2e-2, 2e-3)
MIN_DIM = 32  # converts every linear of the tiny config, as test_pipeline.py does


@pytest.fixture
def int8_kernels(monkeypatch):
    """set_kernels(int8_linear=True) in both packages, restored afterwards;
    the JAX package reaches its Pallas kernel on the CPU only in interpret
    mode."""
    monkeypatch.setenv("SDEO_PALLAS_INTERPRET", "1")
    jax_dispatch.set_kernels(int8_linear=True)
    dispatch.set_kernels(int8_linear=True)
    try:
        yield
    finally:
        jax_dispatch.set_kernels(int8_linear=False)
        dispatch.set_kernels(int8_linear=False)


@pytest.fixture
def tiny_min_dim(monkeypatch):
    """Both runtimes convert with min_dim 32 (the default 256 converts
    nothing at tiny widths)."""
    monkeypatch.setattr(jax_quant, "quantize_linear_tree", functools.partial(
        jax_quant.quantize_linear_tree, min_dim=MIN_DIM))
    monkeypatch.setattr(port_quant, "quantize_linear_modules", functools.partial(
        port_quant.quantize_linear_modules, min_dim=MIN_DIM))


# ------------------------------------------------------------ weights


@pytest.mark.parametrize("bf16", [False, True])
def test_quantize_weights_matches_jax(rng, bf16):
    w = rng.standard_normal((96, 160), dtype=np.float32) * 0.05
    w[3] = 0.0  # an all-zero channel: scale 1e-8, all q 0
    w[5, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]  # scale 1: ties round to even
    if bf16:  # quantised after the cast to the compute dtype, as the runtimes do
        w = np.asarray(torch.from_numpy(w).bfloat16().float())
    q, scale = port_quant.quantize_weights(torch.from_numpy(w))
    q_ref, scale_ref = jax_quant.quantize_weights(jnp.asarray(w.T))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_ref)[0])
    assert list(q[5, :5]) == [127, 0, 2, 2, 0]


def _converted_names(tree):
    """Port state-dict weight names of the leaves quantize_linear_tree
    converted: a marker tree (converted "w" = ones, all else zeros) through
    the port's checkpoint converter."""
    def mark(node):
        if isinstance(node, dict) and "w_q" in node:
            out = {"w": np.ones(node["w_q"].shape, np.float32)}
            if "b" in node:
                out["b"] = np.zeros(node["b"].shape, np.float32)
            return out
        if isinstance(node, dict):
            return {k: mark(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(mark(v) for v in node)
        return np.zeros(np.shape(node), np.float32)

    sd = {}
    unet_state_dict(sd, PORT_CFG.unet, mark(tree["unet"]))
    controlnet_state_dict(sd, PORT_CFG.controlnet, mark(tree["controlnet"]))
    return {k for k, v in sd.items() if k.endswith(".weight") and bool((v == 1).all())}


def _port_converted(model, min_dim):
    """Convert the port model's UNet and ControlNet; return the converted
    weights' state-dict names and, per network, the multiset of shapes."""
    names, shapes = set(), {}
    for prefix, net in (("model.diffusion_model.", model.unet),
                        ("control_model.", model.control_model)):
        n = port_quant.quantize_linear_modules(net, min_dim=min_dim)
        mods = [(name, m) for name, m in net.named_modules()
                if isinstance(m, port_quant.QuantizedLinear)]
        assert n == len(mods)
        names |= {f"{prefix}{name}.weight" for name, _ in mods}
        shapes[prefix] = collections.Counter(tuple(m.w_q.shape) for _, m in mods)
    return names, shapes


@pytest.fixture(scope="module")
def params():
    return tiny_params()


def test_converted_set_matches_jax_tiny(params):
    tree = {name: jax_quant.quantize_linear_tree(params[name], min_dim=MIN_DIM)[0]
            for name in ("unet", "controlnet")}
    want = _converted_names(tree)
    got, _ = _port_converted(ControlLDM(PORT_CFG), MIN_DIM)
    assert got == want
    assert any("time_embed.0" in n for n in got) and any("ff.net.2" in n for n in got)
    assert not any("to_q" in n or "to_out" in n for n in got)


def test_converted_set_matches_jax_sd15():
    """SD-1.5 widths, no weights: jax.eval_shape over quantize_linear_tree
    against the port's model on the meta device."""
    cfg, jax_cfg = sd15_pipeline(), jax_sd15_pipeline()
    key = jax.random.PRNGKey(0)

    def jax_shapes(init, sub_cfg):
        tree = jax.eval_shape(lambda: jax_quant.quantize_linear_tree(init(key, sub_cfg))[0])
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        return collections.Counter(
            tuple(reversed(leaf.shape)) for path, leaf in leaves
            if getattr(path[-1], "key", None) == "w_q")

    with torch.device("meta"):
        model = ControlLDM(cfg)
    _, shapes = _port_converted(model, 256)
    unet, ctrl = (jax_shapes(init_unet, jax_cfg.unet),
                  jax_shapes(init_controlnet, jax_cfg.controlnet))
    assert sum(unet.values()) == 56 and sum(ctrl.values()) == 26
    assert shapes["model.diffusion_model."] == unet
    assert shapes["control_model."] == ctrl


# ------------------------------------------------------------ the kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_plain_matches_pallas(rng, dtype):
    m, k, n = 64, 96, 256
    x = rng.standard_normal((m, k), dtype=np.float32)
    w_q = rng.integers(-127, 128, (n, k)).astype(np.int8)
    scale = (rng.random(n).astype(np.float32) + 0.5) * 1e-2
    ref = jax_quant.quantized_matmul(
        jnp.asarray(x, dtype), jnp.asarray(w_q.T), jnp.asarray(scale[None]),
        block_m=32, block_n=128, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    args = (torch.from_numpy(w_q), torch.from_numpy(scale))
    dispatch.reset_launches()
    for out in (quantized_matmul_plain(tx, *args), quantized_matmul(tx, *args)):
        assert out.dtype == tx.dtype and out.shape == (m, n)
        err = np.abs(out.float().numpy() - ref)
        if dtype == "float32":
            assert err.max() <= 1e-5
        else:
            assert err.max() <= BF16_TOL[0] and err.mean() <= BF16_TOL[1]
    assert dispatch.launches["quantized_matmul"] == 0  # CPU: the plain version


def test_gate_matches_jax_blocks(monkeypatch, int8_kernels):
    """Over a grid of (M, N), the port's gate sends to the kernel exactly
    the products the JAX package's quantized_linear sends to its Pallas
    kernel, with the same blocks."""
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_quant, "quantized_matmul", lambda x, w, s, block_m, block_n,
                        interpret: jax_calls.append((block_m, block_n))
                        or jnp.zeros((x.shape[0], w.shape[1]), x.dtype))
    monkeypatch.setattr(port_quant, "quantized_matmul", lambda x, w, s: port_calls.append(
        pick_blocks(x.shape[0], w.shape[0])) or torch.zeros(x.shape[0], w.shape[0]))
    k = 8
    for m in (1, 2, 6, 8, 12, 24, 40, 100, 128, 384, 1000, 1024, 8192):
        for n in (64, 128, 192, 256, 320, 640, 1280, 2560):
            jax_calls.clear(), port_calls.clear()
            p = {"w_q": jnp.zeros((k, n), jnp.int8), "scale": jnp.ones((1, n))}
            jax_quant.quantized_linear(jnp.zeros((m, k)), p)
            port_quant.quantized_linear(torch.zeros(m, k), torch.zeros((n, k), dtype=torch.int8),
                                        torch.ones(n))
            assert port_calls == jax_calls, (m, n)


@pytest.mark.parametrize("flag", [False, True])
def test_quantized_linear_matches_jax(rng, request, flag):
    if flag:
        request.getfixturevalue("int8_kernels")
    w = rng.standard_normal((256, 64), dtype=np.float32) * 0.1  # (out, in)
    b = rng.standard_normal(256, dtype=np.float32) * 0.1
    x = rng.standard_normal((2, 16, 64), dtype=np.float32)
    tree, n = jax_quant.quantize_linear_tree({"w": jnp.asarray(w.T), "b": jnp.asarray(b)},
                                             min_dim=MIN_DIM)
    ref = np.asarray(jax_quant.quantized_linear(jnp.asarray(x), tree))
    q, scale = port_quant.quantize_weights(torch.from_numpy(w))
    out = port_quant.quantized_linear(torch.from_numpy(x), q, scale, torch.from_numpy(b))
    assert n == 1 and out.shape == (2, 16, 256)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_quant_sites_are_the_modules_calls(params, rng, monkeypatch, int8_kernels):
    """quant_sites (the smoke run's int8 launch expectation) lists exactly
    the (M, K, N) of the int8 linears one tiny controlled-UNet step runs,
    and the gate sends exactly quant_gated of them to the kernel entry."""
    model = port_model(params)
    for net in (model.unet, model.control_model):
        port_quant.quantize_linear_modules(net, min_dim=MIN_DIM)
    calls, kernel = [], []
    linear, entry = port_quant.quantized_linear, port_quant.quantized_matmul
    monkeypatch.setattr(port_quant, "quantized_linear", lambda x, q, *a: (
        calls.append((x.numel() // x.shape[-1], q.shape[1], q.shape[0])),
        linear(x, q, *a))[1])
    monkeypatch.setattr(port_quant, "quantized_matmul", lambda x, q, s: (
        kernel.append((x.shape[0], q.shape[1], q.shape[0])), entry(x, q, s))[1])
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4), dtype=np.float32))
    hint = torch.from_numpy((rng.random((2, 64, 64, 3)) > 0.8).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 64), dtype=np.float32))
    with torch.no_grad():
        controlled_unet_apply(model.unet, model.control_model, x, hint,
                              torch.tensor([500.0, 500.0]), ctx, control_scales=[1.0] * 13)
    sites = chip_smoke.quant_sites(PORT_CFG, 64)
    assert sorted(calls) == sorted(sites)
    assert sorted(kernel) == sorted(chip_smoke.quant_gated(sites))
    assert kernel  # the tiny GEGLU products reach the kernel entry


# ------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def slice_setup(params):
    rng = np.random.default_rng(0)
    return {"params": params,
            "tok": toy_tokenizer(max_length=CFG.clip.max_length),
            "image": (rng.random((70, 60, 3)) * 255).astype(np.uint8),
            "x_T": rng.standard_normal((1, 8, 8, 4), dtype=np.float32)}


def _process(pipe, setup):
    return pipe.process(setup["image"], "a bird", a_prompt="best quality",
                        n_prompt="lowres", num_samples=1, image_resolution=64,
                        ddim_steps=2, seed=11, eta=0.0, x_T=setup["x_T"])


def _int8_bytes_jax(params):
    leaves = jax.tree_util.tree_leaves_with_path(params)
    w_q = {path[:-1]: np.asarray(leaf).T.tobytes() for path, leaf in leaves
           if getattr(path[-1], "key", None) == "w_q"}
    scale = {path[:-1]: np.asarray(leaf)[0].tobytes() for path, leaf in leaves
             if getattr(path[-1], "key", None) == "scale"}
    return collections.Counter((w_q[p], scale[p]) for p in w_q)


def _int8_bytes_port(model):
    return collections.Counter(
        (m.w_q.numpy().tobytes(), m.scale.numpy().tobytes())
        for net in (model.unet, model.control_model) for m in net.modules()
        if isinstance(m, port_quant.QuantizedLinear))


@pytest.mark.parametrize("flag", [False, True])
def test_int8_process_matches_jax(slice_setup, tiny_min_dim, request, flag):
    """quantize_linears=True in both packages, the int8_linear flag off
    (dequantise, then a plain matmul) and on (the kernel's math)."""
    if flag:
        request.getfixturevalue("int8_kernels")
    params, tok = slice_setup["params"], slice_setup["tok"]
    jax_pipe = JaxPipeline(params, tok, CFG, persistent_cache=False,
                           quantize_linears=True)
    model = port_model(params)
    port_pipe = Canny2ImagePipeline(model, tok, PORT_CFG, device="cpu",
                                    quantize_linears=True)
    jax_bytes = _int8_bytes_jax(jax_pipe.runtime.params)
    assert sum(jax_bytes.values()) > 0
    assert _int8_bytes_port(port_pipe.runtime.model) == jax_bytes
    # the caller's model keeps its nn.Linears
    assert not any(isinstance(m, port_quant.QuantizedLinear) for m in model.modules())
    ref, out = _process(jax_pipe, slice_setup), _process(port_pipe, slice_setup)
    assert np.array_equal(out[0], ref[0])
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1


def test_int8_quality_gate(slice_setup, tiny_min_dim):
    """The JAX package's quality gate (test_pipeline.py): int8 weight-only
    stays perceptually close to the unquantised output."""
    params, tok = slice_setup["params"], slice_setup["tok"]
    base = Canny2ImagePipeline(port_model(params), tok, PORT_CFG, device="cpu")
    quant = Canny2ImagePipeline(port_model(params), tok, PORT_CFG, device="cpu",
                                quantize_linears=True)
    a, b = _process(base, slice_setup)[1], _process(quant, slice_setup)[1]
    assert a.shape == b.shape and not np.array_equal(a, b)
    assert perceptual_distance(a, b) < 10.0
