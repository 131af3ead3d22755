"""The port's row-parallel (sp) axis and its mesh construction on gloo worlds
of CPU processes: the cases of tests/test_mesh_sp.py and
tests/test_attention_spmd.py against the JAX package's unsharded functions.

Under sp a rank holds its rows of each NHWC latent, hint and image; the
port supplies what GSPMD inserted (parallel/mesh.py): halo rows for every
conv (the stride-2 downsamplers and the VAE encoder's one-sided pad
included), GroupNorm moments all-reduced over sp, the token flatten
carrying the rows, and attention with a rank's queries against K/V
all-gathered over sp, its queries gathered too where the JAX partition
algebra degrades to replicated (ops/attention.py:packed_partition).

Worlds: 2 ranks (sp=2: one ControlNet + UNet evaluation, the VAE decode
and encode, three attention sites, the mesh runtime's request, its engine
selection at 48x48, cfg_rescale, ToMe and process()) and 4 ranks (the
meshes' axes and specs; the request at dp=2 x sp=2). The JAX references
run unsharded (its attention on the plain reference, as
test_torch_training.py does). Tolerances, max |d| over max |reference|:
one evaluation (with the fused-norm configuration too: the GroupNorm
stats and apply entries on a rank's rows, their partial sums all-reduced),
VAE and attention 1e-5 (fp32; the sp moments are one-pass sums, the JAX
GroupNorm's too); the sampler's latents and contexts 1e-5, images within
1; the whole-row fallback, cfg_rescale and ToMe against the JAX runtime's
sample(), and process() against the JAX pipeline's, x_T handed in: latents
1e-5, images within 1.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from stablediffusioneo_tpu.models import init_clip_text, init_vae
from stablediffusioneo_tpu.models.controlnet import controlled_unet_apply
from stablediffusioneo_tpu.models.vae import vae_decode, vae_encode
from stablediffusioneo_tpu.ops.attention import multi_head_attention as jax_mha
from stablediffusioneo_tpu.ops import dispatch as jax_dispatch
from stablediffusioneo_tpu.ops.pallas import attention as jax_pallas_attention
from stablediffusioneo_tpu.parallel import mesh as jax_mesh
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax
from stablediffusioneo_tpu_torch.ops.attention import packed_partition

import torch_parallel_ranks as ranks
from torch_port_util import (
    CFG,
    PORT_CFG,
    assert_close_scaled,
    jax_sampler_reference,
    numpy_params,
    tiny_control_nets,
)

TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    nets = tiny_control_nets(seed=0)
    trees = {"unet": nets["unet"][0], "controlnet": nets["controlnet"][0],
             "vae": numpy_params(init_vae, CFG.vae, 2),
             "clip": numpy_params(init_clip_text, CFG.clip, 3)}
    return trees, state_dict_from_jax(trees, PORT_CFG)


def _eval_inputs():
    rng = np.random.default_rng(3)
    return {"x": rng.standard_normal((1, 8, 8, 4), dtype=np.float32),
            "hint": rng.random((1, 64, 64, 3), dtype=np.float32),
            "t": np.array([500.0], np.float32),
            "ctx": rng.standard_normal((1, 16, 64), dtype=np.float32),
            "z": rng.standard_normal((1, 8, 8, 4), dtype=np.float32),
            "img": rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)}


def _attention_cases():
    """Three sites of 2 heads of 16: self-attention over 2048 tokens (a
    rank's 1024 queries stay its own), over 1152 (576 a rank, not a multiple
    of 128: the queries are gathered), cross-attention of 2048 tokens to 77."""
    rng = np.random.default_rng(5)

    def w(o, i):
        return (rng.standard_normal((o, i)) * i ** -0.5).astype(np.float32)

    def case(tq, ctx):
        return {"x": rng.standard_normal((1, tq, 32), dtype=np.float32),
                "ctx": None if ctx is None else rng.standard_normal((1, ctx, 64),
                                                                    dtype=np.float32),
                "wq": w(32, 32), "wk": w(32, 64 if ctx else 32),
                "wv": w(32, 64 if ctx else 32), "wo": w(32, 32),
                "bo": (rng.standard_normal(32) * 0.1).astype(np.float32),
                "heads": 2, "split": True}

    return {"self_2048": case(2048, None), "self_1152": case(1152, None),
            "cross_77": case(2048, 77)}


@pytest.fixture(scope="module")
def world2(weights, tmp_path_factory):
    x = ranks.request()
    x.update(x_T6=x["x_T"][:1, :6, :6], hint6=x["hint"][:1, :48, :48])
    return ranks.spawn(ranks.sp_job, 2, tmp_path_factory.mktemp("sp2"), sd=weights[1], x=x,
                       eval_x=_eval_inputs(), attn=_attention_cases(),
                       mesh_kw=dict(dp=1, sp=2))


@pytest.fixture(scope="module")
def world4(weights, tmp_path_factory):
    return ranks.spawn(ranks.mesh_job, 4, tmp_path_factory.mktemp("sp4"), sd=weights[1],
                       x=ranks.request())


@pytest.fixture(scope="module")
def jax_request(weights):
    return jax_sampler_reference(weights[0], ranks.request())


@pytest.fixture(scope="module")
def jax_plain():
    """The JAX package's attention on its plain reference (the Pallas
    kernels run only in interpret mode on the CPU)."""
    was = jax_dispatch.kernels_enabled("flash_attention")
    jax_dispatch.set_kernels(flash_attention=False)
    yield
    jax_dispatch.set_kernels(flash_attention=was)


@pytest.fixture(scope="module")
def jax_pipe(weights):
    """The JAX package's unsharded pipeline on the same weights, ToMe's
    site threshold lowered as in the sp job's runtime (32 tokens), with the
    port's toy tokenizer."""
    import dataclasses

    from stablediffusioneo_tpu.pipeline.canny2image import Canny2ImagePipeline as JaxPipeline
    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer

    unet = dataclasses.replace(CFG.unet, tome_min_tokens=32)
    cfg = dataclasses.replace(CFG, unet=unet,
                              controlnet=dataclasses.replace(CFG.controlnet, unet=unet))
    tok = toy_tokenizer(PORT_CFG.clip.vocab_size, PORT_CFG.clip.max_length)
    return JaxPipeline(weights[0], tok, cfg, persistent_cache=False)


def _jax_sample(pipe, x, **kw):
    """The JAX runtime's sample() of 2 DDIM steps at its defaults (guidance
    9, strength 1), as the sp job calls the port's."""
    return np.asarray(pipe.runtime.sample(
        2, *(jnp.asarray(x[k]) for k in ("x_T", "hint", "ctx_c", "ctx_u")),
        jax.random.PRNGKey(0), **kw))


# ------------------------------------------------------------ construction


def _jax_mesh(**kw):
    return jax_mesh.make_mesh(devices=jax.devices()[:4], **kw)


@pytest.mark.parametrize("name, kw", [
    ("dp2tp2", dict(dp=2, tp=2)), ("sp2", dict(dp=2, sp=2)), ("pp2", dict(pp=2, dp=2)),
    ("inferred", dict(tp=1, sp=2)), ("sp1", dict(dp=4, tp=1, sp=1))])
def test_mesh_axes_order_and_inferred_dp(world4, name, kw):
    """The JAX axis order (pp outermost, tp innermost, size-1 axes other than
    dp and tp dropped), dp inferred from the ranks left, on every rank."""
    ref = _jax_mesh(**kw)
    for out in world4:
        names, shape, _, _ = out[name]
        assert names == ref.axis_names
        assert shape == tuple(ref.shape[n] for n in ref.axis_names)


@pytest.mark.parametrize("name, kw", [("sp2", dict(dp=2, sp=2)), ("dp2tp2", dict(dp=2, tp=2))])
def test_latent_sharding_specs(world4, name, kw):
    ref = _jax_mesh(**kw)
    _, _, spec4, spec1 = world4[0][name]
    assert spec4 == tuple(jax_mesh.latent_sharding(ref, 4).spec)
    assert spec1 == tuple(jax_mesh.latent_sharding(ref, 1).spec)


# -------------------------------------------------------------- sp parity


def test_sp_forward_parity_and_halos(world2, weights):
    """One ControlNet + UNet evaluation of rows split over sp=2 (halos at
    every 3x3 conv, the stride-2 downsamplers and the hint block's, sharded
    GroupNorm moments, K/V gathered at the self-attentions) equals the JAX
    unsharded evaluation on every rank."""
    trees, _ = weights
    x = _eval_inputs()
    want = jax.jit(lambda u, c, *a: controlled_unet_apply(u, c, CFG.controlnet, *a))(
        trees["unet"], trees["controlnet"], *(jnp.asarray(x[k]) for k in
                                              ("x", "hint", "t", "ctx")))
    for out in world2:
        assert_close_scaled(out["eps"], np.asarray(want), TOL)


def test_sp_fused_norms_parity(world2, weights):
    """The same evaluation with the fused-norm configuration on: each
    GroupNorm whose whole image's slab the kernel gate admits goes through
    group_norm_stats on a rank's rows, an all-reduce of the fp32 partial
    sums over sp and group_norm_apply with the whole image's count, and
    LayerNorm takes a rank's tokens; equal to the JAX unsharded
    evaluation."""
    trees, _ = weights
    x = _eval_inputs()
    want = jax.jit(lambda u, c, *a: controlled_unet_apply(u, c, CFG.controlnet, *a))(
        trees["unet"], trees["controlnet"], *(jnp.asarray(x[k]) for k in
                                              ("x", "hint", "t", "ctx")))
    for out in world2:
        assert_close_scaled(out["eps_fused"], np.asarray(want), TOL)


def test_sp_vae_decode_and_encode(world2, weights):
    """The VAE over rows: the decoder's upsamplers and mid-block attention,
    the encoder's one-sided stride-2 pad (its bottom row from the next rank,
    zeros on the last)."""
    trees, _ = weights
    x = _eval_inputs()
    dec = jax.jit(lambda p, z: vae_decode(p, CFG.vae, z))(trees["vae"], jnp.asarray(x["z"]))
    enc = jax.jit(lambda p, i: vae_encode(p, CFG.vae, i).mode())(trees["vae"],
                                                                 jnp.asarray(x["img"]))
    for out in world2:
        assert_close_scaled(out["decode"], np.asarray(dec), TOL)
        assert_close_scaled(out["encode"], np.asarray(enc), TOL)


@pytest.mark.parametrize("site", ["self_2048", "self_1152", "cross_77"])
def test_sp_attention_sites(world2, jax_plain, site):
    """A rank's tokens through multi_head_attention under sp: its queries
    against the whole K/V (gathered for self-attention, the context's for
    cross-attention), the queries gathered too where a rank's 576 are not a
    multiple of 128; equal to the JAX unsharded block."""
    a = _attention_cases()[site]
    want = jax_mha(
        jnp.asarray(a["x"]), None if a["ctx"] is None else jnp.asarray(a["ctx"]),
        *(jnp.asarray(a[k].T) for k in ("wq", "wk", "wv", "wo")), jnp.asarray(a["bo"]),
        a["heads"])
    for out in world2:
        assert_close_scaled(out["attn_" + site], np.asarray(want), TOL)


@pytest.mark.parametrize("q, s, heads, spec", [
    ((2, 4096, 320), 4096, 8, ("dp", "sp", "tp")),     # the 512x512 level-0 site
    ((2, 4096, 320), 77, 8, ("dp", "sp", "tp")),       # its cross-attention
    ((2, 1152, 320), 1152, 8, ("dp", "sp", "tp")),     # 576 queries a rank
    ((2, 4096, 192), 4096, 3, ("dp", "sp", "tp")),     # heads indivisible by tp
    ((2, 2048, 320), 2048, 8, ("dp", "sp", None)),     # tp not on the channels
    ((1, 16384, 320), 16384, 8, (None, "sp", "tp")),   # hires: the streaming kernel
])
def test_partition_algebra_matches_jax(q, s, heads, spec):
    """packed_partition picks the candidate the JAX _packed_partition picks
    on a dp=2 x sp=2 x tp=2 mesh of the same shapes (bf16)."""
    mesh = jax_mesh.make_mesh(dp=2, tp=2, sp=2)
    arg = types.SimpleNamespace(shape=q, dtype=jnp.bfloat16,
                                sharding=NamedSharding(mesh, P(*spec)))
    kv = types.SimpleNamespace(shape=(q[0], s, q[2]), dtype=jnp.bfloat16,
                               sharding=NamedSharding(mesh, P()))
    got_mesh = jax_pallas_attention._packed_partition(heads, 0.125, False, mesh,
                                                      (arg, kv, kv), None)
    chosen = got_mesh[2].spec
    want = tuple(mesh.shape[n] if n else 1 for n in (list(chosen) + [None] * 3)[:3])
    n = tuple(mesh.shape[n] if n else 1 for n in spec)
    assert packed_partition(q[0], q[1], s, q[2], heads, 2, *n) == want


# ---------------------------------------------------------------- runtime


def _assert_request(out, ref):
    assert_close_scaled(out["z"], ref["z"], TOL)
    assert_close_scaled(out["ctx"], ref["ctx"], TOL)
    assert np.abs(out["img"].astype(int) - ref["img"].astype(int)).max() <= 1


def test_runtime_request_at_sp2_and_dp2_sp2(world2, world4, jax_request):
    """The mesh runtime's sampler, decode and CLIP calls at sp=2 and at dp=2
    x sp=2 equal the JAX package's unsharded ones on every rank; the loop
    and decode engines ran split by rows."""
    for out in world2 + [o["request"] for o in world4]:
        _assert_request(out, jax_request)
    for out in (world2[0], world4[0]):
        sp = {name: s for name, (_, s) in out["engines"].items()}
        assert sp["ddim_2x4x64x64"] and sp["decoder_b4_64x64"] and not sp["clip_b4"]


def test_io_sharding_selection(world2, jax_pipe):
    """48x48 (6 latent rows, not a multiple of sp=2 x 2 levels) runs with
    whole rows on every rank, and equals the JAX runtime's unsharded
    sample()."""
    x = ranks.request()
    small = {"x_T": x["x_T"][:1, :6, :6], "hint": x["hint"][:1, :48, :48],
             "ctx_c": x["ctx_c"][:1], "ctx_u": x["ctx_u"][:1]}
    want = _jax_sample(jax_pipe, small)
    assert world2[0]["engines"]["ddim_2x1x48x48"] == (True, False)
    for out in world2:
        assert_close_scaled(out["z6"], want, TOL)


@pytest.mark.parametrize("kw", [dict(cfg_rescale=0.7), dict(tome_ratio=0.5)],
                         ids=["cfg_rescale", "tome"])
def test_sp_loop_variants(world2, jax_pipe, kw):
    """cfg_rescale's per-sample standard deviations (moments all-reduced over
    sp) and ToMe's merge (over the whole token grid, gathered) under sp,
    against the JAX runtime's sample() with the same knob."""
    want = _jax_sample(jax_pipe, ranks.request(), **kw)
    key = "rescale" if "cfg_rescale" in kw else "tome"
    for out in world2:
        assert_close_scaled(out[key], want, TOL)


def test_process_sp_parity(world2, jax_pipe):
    """process() of Canny2ImagePipeline(mesh=) at sp=2 (clip, then the fused
    sample + decode engine split by rows) against the JAX pipeline's
    process(), x_T handed in: within 1 on every rank."""
    want = ranks.run_process(jax_pipe, ranks.request()).astype(int)
    for out in world2:
        assert np.abs(out["process"].astype(int) - want).max() <= 1
