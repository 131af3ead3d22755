"""LoRA adapters in the port (training/lora.py, CNSDRuntime.apply_lora)
against the JAX package's training/lora.py, fp32 on the CPU at tiny size:
the same sites in the same order, the JAX merge of a non-zero adapter equal
to the port's in-place merge parameter by parameter (UNet, ControlNet, HF
CLIP, and an OpenCLIP tower whose q / k / v land in the packed in_proj),
sdeo-lora-v1 files across the two packages, the strict accounting, and the
runtime's merge into live engines."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.config import sd21_pipeline as jax_sd21
from stablediffusioneo_tpu.models import init_clip_text
from stablediffusioneo_tpu.training import lora as jl
from stablediffusioneo_tpu_torch import config as port_config
from stablediffusioneo_tpu_torch.checkpoint.convert import openclip_state_dict, tree_state_dict
from stablediffusioneo_tpu_torch.checkpoint import accounting
from stablediffusioneo_tpu_torch.models.clip import OpenCLIPTextModel
from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline
from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime
from stablediffusioneo_tpu_torch.training import lora as pl

from torch_port_util import CFG, PORT_CFG, numpy_params, port_model, tiny_params

MERGE_TOL = 1e-6  # |port merged - JAX merged|, fp32 (one rank-r product, one add)
SCALE = 0.7


def _openclip_cfgs():
    """A two-layer OpenCLIP tower with a text projection, in both packages."""
    import dataclasses

    jax_cfg = dataclasses.replace(jax_sd21().clip, vocab_size=1000, hidden_size=32,
                                  intermediate_size=64, num_layers=2, num_heads=2,
                                  max_length=16, projection_dim=24)
    port_cfg = dataclasses.replace(port_config.sd21_pipeline().clip, vocab_size=1000,
                                   hidden_size=32, intermediate_size=64, num_layers=2,
                                   num_heads=2, max_length=16, projection_dim=24)
    return jax_cfg, port_cfg


@pytest.fixture(scope="module")
def trees():
    """{name: (JAX tree, port network)} of the same seeded weights."""
    params = tiny_params()
    model = port_model(params)
    jax_cfg, port_cfg = _openclip_cfgs()
    oc = numpy_params(init_clip_text, jax_cfg, 11)
    sd = {}
    openclip_state_dict(sd, oc, prefix="")
    tower = OpenCLIPTextModel(port_cfg)
    accounting.account_checkpoint(tower, sd).assert_complete("openclip")
    accounting.copy_checkpoint_(tower, sd)
    return {"unet": (params["unet"], model.unet),
            "controlnet": (params["controlnet"], model.control_model),
            "clip": (params["clip"], model.clip),
            "openclip": (oc, tower.eval().requires_grad_(False)),
            "params": params}


def _nonzero(lora, seed=5):
    """The adapter with every "b" drawn N(0, 0.1^2) (init_lora zeroes it)."""
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 4096))
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x if p[-1].key != "b" else
        jax.random.normal(next(keys), x.shape, x.dtype) * 0.1, lora)


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _port_tensors(kind, net, jax_tree):
    """{port name: tensor} of a JAX tree, by the converter's map."""
    sd = {}
    tree_state_dict(sd, kind, getattr(net.cfg, "unet", net.cfg), jax_tree)
    return sd


@pytest.mark.parametrize("name", ["unet", "controlnet", "clip", "openclip"])
def test_sites_match_jax(trees, name):
    jtree, net = trees[name]
    assert pl.DEFAULT_TARGETS == jl.DEFAULT_TARGETS
    assert pl.lora_sites(net) == jl.lora_sites(jtree)
    assert pl.lora_sites(net, ("ff1", "fc2")) == jl.lora_sites(jtree, ("ff1", "fc2"))
    if name == "openclip":  # a projected tower's text_projection is a site too
        assert ("text_projection",) in pl.lora_sites(net, ("text_projection",))


@pytest.mark.parametrize("name", ["unet", "controlnet", "clip", "openclip"])
def test_merge_matches_jax(trees, name):
    """A non-zero adapter merged by the JAX package and by the port: every
    tensor of the network within MERGE_TOL, the untargeted ones unchanged."""
    jtree, net = trees[name]
    lora = _nonzero(jl.init_lora(jax.random.PRNGKey(1), jtree, rank=4))
    want = _port_tensors(pl.net_kind(net), net, jl.merge_lora(jtree, lora, SCALE))
    port = copy.deepcopy(net)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    assert pl.merge_lora(port, _to_torch(lora), SCALE) == jl.n_sites(lora)
    got = port.state_dict()
    assert set(got) == set(want)
    moved = 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=MERGE_TOL,
                                   err_msg=k)
        moved += not torch.equal(got[k], before[k])
    assert moved > 0
    if name == "openclip":  # q, k and v rows all moved
        w0, w1 = before["transformer.resblocks.0.attn.in_proj_weight"], \
            got["transformer.resblocks.0.attn.in_proj_weight"]
        d = w0.shape[1]
        assert all(not torch.equal(w0[i * d:(i + 1) * d], w1[i * d:(i + 1) * d])
                   for i in range(3))


def test_merge_keeps_dtype_and_storage(trees):
    """bf16 weights stay bf16 and in their storage (the delta rounded once,
    the JAX order (w.f32 + delta).astype(w.dtype))."""
    jtree, net = trees["unet"]
    lora = _nonzero(jl.init_lora(jax.random.PRNGKey(1), jtree, rank=2))
    port = copy.deepcopy(net).to(torch.bfloat16)
    w = port.input_blocks[1][1].transformer_blocks[0].attn1.to_q.weight
    ptr, before = w.data_ptr(), w.detach().clone()
    pl.merge_lora(port, _to_torch(lora), SCALE)
    assert w.dtype == torch.bfloat16 and w.data_ptr() == ptr
    site = lora["input_blocks"][1]["attn"]["blocks"][0]["attn1"]["wq"]
    delta = (torch.from_numpy(np.array(site["a"])) @ torch.from_numpy(
        np.array(site["b"]))) * SCALE
    assert torch.equal(w, (before.float() + delta.T).to(torch.bfloat16))


def test_init_lora_identity(trees):
    _, net = trees["unet"]
    lora = pl.init_lora(torch.Generator().manual_seed(0), net, rank=4)
    assert pl.n_sites(lora) == len(pl.lora_sites(net))
    assert pl.count_params(lora) < sum(p.numel() for p in net.parameters()) / 10
    port = copy.deepcopy(net)
    pl.merge_lora(port, lora)
    for (k, a), b in zip(net.state_dict().items(), port.state_dict().values()):
        assert torch.equal(a, b), k


def test_files_across_packages(trees, tmp_path):
    jtree, net = trees["controlnet"]
    lora = _nonzero(jl.init_lora(jax.random.PRNGKey(2), jtree, rank=8))
    p_jax = str(tmp_path / "jax.npz")
    jl.save_lora(p_jax, lora, alpha=16.0, on="controlnet")
    tree, meta = pl.load_lora(p_jax)
    assert meta == {"format": "sdeo-lora-v1", "alpha": 16.0, "rank": 8, "on": "controlnet"}
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b.numpy()),
                 lora, tree)
    p_port = str(tmp_path / "port.npz")
    pl.save_lora(p_port, _to_torch(lora), alpha=4.0, on="unet")
    back, meta = jl.load_lora(p_port)
    assert meta["alpha"] == 4.0 and meta["rank"] == 8 and meta["on"] == "unet"
    jax.tree.map(np.testing.assert_array_equal, lora, back)
    # the JAX file merged into the port equals the JAX merge
    want = _port_tensors("controlnet", net, jl.merge_lora(jtree, lora, 0.5))
    port = copy.deepcopy(net)
    pl.merge_lora(port, tree, 0.5)
    for k, v in want.items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(), v.numpy(), rtol=0,
                                   atol=MERGE_TOL, err_msg=k)


def test_accounting_raises(trees, tmp_path):
    """A UNet adapter merged into the ControlNet (orphans: the decoder's
    sites), a misshapen site and a conv site fail before any weight
    changes; a foreign file and an incomplete file fail to load."""
    ju, net_u = trees["unet"]
    _, net_c = trees["controlnet"]
    lora = jl.init_lora(jax.random.PRNGKey(1), ju, rank=2)
    port = copy.deepcopy(net_c)
    with pytest.raises(ValueError, match="no matching path"):
        pl.merge_lora(port, _to_torch(lora))
    for k, v in net_c.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    with pytest.raises(ValueError, match="no matching path|does not match"):
        jl.merge_lora(trees["params"]["controlnet"], lora)
    bad = _to_torch(lora)
    site = bad["input_blocks"][1]["attn"]["blocks"][0]["attn1"]["wq"]
    site["a"] = torch.zeros((site["a"].shape[0] + 1, 2))
    with pytest.raises(ValueError, match="does not match"):
        pl.merge_lora(copy.deepcopy(net_u), bad)
    conv = {"input_blocks": {1: {"attn": {"proj_in": {"a": torch.zeros(32, 2),
                                                      "b": torch.zeros(2, 32)}}}}}
    with pytest.raises(ValueError, match="does not match"):
        pl.merge_lora(copy.deepcopy(net_u), conv)
    p = str(tmp_path / "foreign.npz")
    np.savez(p, some_weight=np.zeros(3))
    with pytest.raises(ValueError, match="__meta__"):
        pl.load_lora(p)
    inc = jl.init_lora(jax.random.PRNGKey(1), trees["params"]["controlnet"], rank=2)
    node = inc
    for k in jl.lora_sites(trees["params"]["controlnet"])[0]:
        node = node[k]
    del node["b"]
    p2 = str(tmp_path / "incomplete.npz")
    jl.save_lora(p2, inc, alpha=2.0)
    with pytest.raises(ValueError, match="incomplete"):
        pl.load_lora(p2)


def test_runtime_apply_lora(trees):
    """apply_lora on a CPU runtime: scale 0 leaves process() as it was, a
    non-zero merge changes it, the engine cache keeps its keys (no engine is
    rebuilt), the count is the adapter's sites; an unknown tree and a
    quantized runtime are refused in the JAX words."""
    params = trees["params"]
    tok = toy_tokenizer(vocab_size=PORT_CFG.clip.vocab_size,
                        max_length=PORT_CFG.clip.max_length)
    pipe = Canny2ImagePipeline(port_model(params), tok, PORT_CFG, device="cpu")
    rng = np.random.default_rng(0)
    img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    kw = dict(num_samples=1, image_resolution=64, ddim_steps=2, seed=1)
    base = pipe.process(img, "a bird", **kw)[1]
    keys = set(pipe.runtime._engines)
    rt = pipe.runtime
    for on in ("unet", "controlnet", "clip"):
        lora = _to_torch(_nonzero(jl.init_lora(jax.random.PRNGKey(4), params[on], rank=4)))
        assert rt.apply_lora(lora, scale=0.0, on=on) == pl.n_sites(lora)
    assert np.array_equal(pipe.process(img, "a bird", **kw)[1], base)
    for on in ("unet", "controlnet", "clip"):
        lora = _to_torch(_nonzero(jl.init_lora(jax.random.PRNGKey(4), params[on], rank=4)))
        assert rt.apply_lora(lora, scale=1.0, on=on) == pl.n_sites(lora)
    out = pipe.process(img, "a bird", **kw)[1]
    assert set(rt._engines) == keys
    assert np.any(out != base), "merged adapters had no effect"
    with pytest.raises(KeyError, match="no 'text' tree"):
        rt.apply_lora({}, on="text")
    with pytest.raises(ValueError, match="no matching path"):
        rt.apply_lora(_to_torch(jl.init_lora(jax.random.PRNGKey(1), params["unet"])),
                      on="controlnet")
    q = CNSDRuntime(port_model(params), PORT_CFG, device="cpu", quantize_linears=True)
    with pytest.raises(ValueError, match="quantized"):
        q.apply_lora(_to_torch(jl.init_lora(jax.random.PRNGKey(4), params["unet"])))


def test_multi_controlnet_merge(trees):
    """A tuple of ControlNets takes an adapter per net (a tuple of trees, or
    the position-keyed dict a file gives), each merged as alone."""
    jtree, net = trees["controlnet"]
    lora = _nonzero(jl.init_lora(jax.random.PRNGKey(3), jtree, rank=2))
    nets = (copy.deepcopy(net), copy.deepcopy(net))
    assert pl.lora_sites(nets) == tuple((i,) + s for i in (0, 1)
                                        for s in jl.lora_sites(jtree))
    one = copy.deepcopy(net)
    pl.merge_lora(one, _to_torch(lora), SCALE)
    assert pl.merge_lora(nets, {1: _to_torch(lora)}, SCALE) == jl.n_sites(lora)
    for k, v in one.state_dict().items():
        assert torch.equal(nets[1].state_dict()[k], v), k
        assert torch.equal(nets[0].state_dict()[k], net.state_dict()[k]), k
    pl.merge_lora(nets, (_to_torch(lora), {}), SCALE)
    for k, v in one.state_dict().items():
        assert torch.equal(nets[0].state_dict()[k], v), k
