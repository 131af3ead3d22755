"""The port's parallel layer (stablediffusioneo_tpu_torch/parallel/mesh.py) on
gloo worlds of CPU processes, against the JAX package's unsharded functions:
the cases of tests/test_parallel.py (dp x tp sampler parity and the applied
TP specs, the mesh runtime and its inpaint / img2img engines, FSDP against
the replicated step and composed with tp, SDXL under tp) plus the GEGLU
guard, train(dp=2, tp=2) and a served batch on a two-rank mesh runtime.

Ranks run the port only (tests/torch_parallel_ranks.py; one process a rank,
one thread each, a FileStore under tmp_path). Weights: the tiny
configuration's numpy-drawn JAX trees carried to the port by
checkpoint/convert.py. Tolerances, max |d| over max |reference| unless said:
  * the sampler's latents (2 DDIM steps, CFG 7.5) 1e-5, CLIP contexts 1e-5:
    fp32, the sharded port against the unsharded JAX package (summation
    order: the row-parallel all-reduce adds two partial products);
  * uint8 images within 1 of the JAX decode of the JAX latents;
  * a train step: the loss 1e-5, every gradient 1e-4 (as
    test_torch_training.py), the parameters after AdamW at lr 1e-3 within
    1e-6 where the JAX gradient is above 1e-3 of its tensor's max and within
    2 lr everywhere (a gradient within summation noise of 0 steps either way);
  * SDXL's 2-step loop 1e-4 (the test_torch_sdxl.py loop tolerance is 1e-3);
  * the inpaint and img2img engines (the JAX draws handed in) and the
    sampler after a LoRA merge: latents 1e-5, images within 1 of the JAX
    ddim_sample_scan, DDIMSampler.img2img and merge_lora's;
  * train(dp=2, tp=2) for two steps against the JAX train_step math on the
    same draws (the port's step_draws, handed to the JAX loss): AdamW's
    first moments 1e-4 of each tensor's max; the parameters' and the EMA's
    moves from their start, summed over all tensors, within 1e-4 of the JAX
    moves' sum (seen: 9.5e-6; a step left untaken is 100% off);
  * the served batch: each image within 1 of the JAX pipeline's process()
    of that request with the server's seed draw handed in as x_T.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from stablediffusioneo_tpu.models import init_clip_text, init_unet, init_vae
from stablediffusioneo_tpu.models.vae import vae_decode
from stablediffusioneo_tpu.parallel import mesh as jax_mesh
from stablediffusioneo_tpu.training import ema as jema
from stablediffusioneo_tpu.training import lora as jl
from stablediffusioneo_tpu.training import trainer as jt
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax, tree_state_dict
from stablediffusioneo_tpu_torch.parallel import mesh as pmesh
from stablediffusioneo_tpu_torch.training.trainer import step_draws

import torch_parallel_ranks as ranks
from torch_port_util import (
    CFG,
    PORT_CFG,
    SAMPLER_SCALE,
    SAMPLER_STRENGTH,
    assert_close_scaled,
    jax_sampler_reference,
    n_taps,
    numpy_params,
    port_names,
    schedules,
    tiny_control_nets,
)

LR = 1e-3
SAMPLE_TOL, CTX_TOL, GRAD_TOL, LOSS_TOL, SDXL_TOL = 1e-5, 1e-5, 1e-4, 1e-5, 1e-4
MOVE_TOL = 1e-4  # parameters' and EMA's moves, summed over tensors (see above)
DRAW_KEY = 11  # the JAX key of the inpaint and img2img draws


@pytest.fixture(scope="module")
def weights():
    nets = tiny_control_nets(seed=0)
    trees = {"unet": nets["unet"][0], "controlnet": nets["controlnet"][0],
             "vae": numpy_params(init_vae, CFG.vae, 2),
             "clip": numpy_params(init_clip_text, CFG.clip, 3)}
    return nets, trees, state_dict_from_jax(trees, PORT_CFG)


def _batch(b=4, seed=4):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((b, 8, 8, 4), dtype=np.float32),
            "hint": rng.random((b, 64, 64, 3), dtype=np.float32),
            "ctx": rng.standard_normal((b, CFG.clip.max_length, CFG.unet.context_dim),
                                       dtype=np.float32)}


def _draws(batch, key=7):
    kt, kn = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(key), 0))
    b = batch["x0"].shape[0]
    return (np.array(jax.random.randint(kt, (b,), 0, CFG.diffusion.timesteps)),
            np.array(jax.random.normal(kn, batch["x0"].shape, jnp.float32)))


def _sdxl_inputs():
    rng = np.random.default_rng(11)
    from stablediffusioneo_tpu.models.sdxl import tiny_sdxl

    cfg = tiny_sdxl()
    b, d = 4, cfg.unet.context_dim
    return {"x_T": rng.standard_normal((b, 8, 8, 4), dtype=np.float32),
            "ctx_c": rng.standard_normal((b, 5, d), dtype=np.float32),
            "ctx_u": rng.standard_normal((b, 5, d), dtype=np.float32),
            "y_c": rng.standard_normal((b, cfg.unet.adm_in_channels), dtype=np.float32),
            "y_u": rng.standard_normal((b, cfg.unet.adm_in_channels), dtype=np.float32),
            "steps": 2, "scale": 5.0}


@pytest.fixture(scope="module")
def sdxl_weights():
    from stablediffusioneo_tpu.models.sdxl import tiny_sdxl
    from stablediffusioneo_tpu_torch.models import sdxl as psdxl

    tree = numpy_params(init_unet, tiny_sdxl().unet, 5)
    sd = {}
    tree_state_dict(sd, "unet", psdxl.tiny_sdxl().unet, tree)
    return tree, sd


def _requests():
    from stablediffusioneo_tpu_torch.serving.server import GenRequest

    rng = np.random.default_rng(1)
    return [GenRequest(image=(rng.random((64, 64, 3)) * 255).astype(np.uint8),
                       prompt=f"a bird {i}", seed=10 + i, ddim_steps=2,
                       image_resolution=64) for i in range(2)]


@pytest.fixture(scope="module")
def world4(weights, sdxl_weights, tmp_path_factory):
    """dp=2 x tp=2: the runtime (and its inpaint / img2img engines), a train
    step with FSDP + tp, train(dp=2, tp=2), SDXL under tp."""
    nets, _, sd = weights
    d = tmp_path_factory.mktemp("world4")
    batch = _batch()
    t, noise = _draws(batch)
    frozen = {k: v[1] for k, v in nets.items()}
    jobs = {
        "runtime": ("runtime_job", dict(sd=sd, x=_runtime_request(), mesh_kw=dict(dp=2, tp=2),
                                        lora=_jax_lora(weights[1]))),
        "step": ("train_step_job", dict(nets=frozen, batch=batch, t=t, noise=noise,
                                        mesh_kw=dict(dp=2, tp=2), fsdp=True)),
        "loop": ("train_loop_job", dict(nets=frozen, batches=_loop_batches(),
                                        kw=dict(dp=2, tp=2), directory=str(d))),
        "sdxl": ("sdxl_job", dict(sd=sdxl_weights[1], x=_sdxl_inputs(),
                                  mesh_kw=dict(dp=2, tp=2))),
    }
    return ranks.spawn(ranks.multi_job, 4, d, jobs=jobs)


@pytest.fixture(scope="module")
def world2(weights, tmp_path_factory):
    """dp=2: a train step with FSDP alone, a served batch."""
    nets, _, sd = weights
    d = tmp_path_factory.mktemp("world2")
    batch = _batch()
    t, noise = _draws(batch)
    jobs = {
        "step": ("train_step_job", dict(nets={k: v[1] for k, v in nets.items()}, batch=batch,
                                        t=t, noise=noise, mesh_kw=dict(dp=2), fsdp=True)),
        "serve": ("serve_job", dict(sd=sd, requests=_requests(), mesh_kw=dict(dp=2))),
    }
    return ranks.spawn(ranks.multi_job, 2, d, jobs=jobs)


@pytest.fixture(scope="module")
def world3(weights, tmp_path_factory):
    """tp=3: no head count, GEGLU half or CLIP MLP of the tiny nets tiles 3."""
    _, _, sd = weights
    jobs = {"runtime": ("runtime_job", dict(sd=sd, x=ranks.request(), mesh_kw=dict(dp=1, tp=3)))}
    return ranks.spawn(ranks.multi_job, 3, tmp_path_factory.mktemp("world3"), jobs=jobs)


@pytest.fixture(scope="module")
def jax_request(weights):
    return jax_sampler_reference(weights[1], ranks.request())


def _loop_batches():
    return [_batch(seed=20), _batch(seed=21)]


def _runtime_request():
    """ranks.request() with the JAX draws of the inpaint and img2img calls:
    the blend's per-step noise (_step_noise of fold_in(key, 0x1B9A1), as
    ddim_sample_scan draws it) and img2img's re-noise (split(key)[1], as
    DDIMSampler.img2img draws it)."""
    from stablediffusioneo_tpu.pipeline.ddim import _step_noise

    x = ranks.request()
    key = jax.random.PRNGKey(DRAW_KEY)
    ikey = jax.random.fold_in(key, 0x1B9A1)
    shape = x["x_T"].shape
    x["inpaint_noise"] = [np.asarray(_step_noise(ikey, jnp.int32(i), shape)) for i in range(2)]
    x["renoise"] = np.asarray(jax.random.normal(jax.random.split(key)[1], shape, jnp.float32))
    return x


def _jax_lora(trees):
    """A rank-2 LoRA on the tiny UNet's sites by the JAX package's
    init_lora, its b factors drawn too (init_lora zeroes them), as numpy."""
    lora = jl.init_lora(jax.random.PRNGKey(3), trees["unet"], rank=2)
    keys = iter(jax.random.split(jax.random.PRNGKey(4), 4096))
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: x if p[-1].key != "b" else jax.random.normal(next(keys), x.shape) * 0.05,
        lora)
    return jax.tree.map(np.asarray, lora)


def _jax_image(vae, z):
    return np.asarray(jax.jit(lambda p, z: jnp.clip(
        vae_decode(p, CFG.vae, z).astype(jnp.float32) * 127.5 + 127.5, 0, 255))(
        vae, z)).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_extra(weights):
    """The JAX package's answers to extra_calls: the inpaint blend
    (ddim_sample_scan with inpaint_latent / inpaint_mask), img2img
    (DDIMSampler.img2img at denoise 0.5 of 2 steps: t_enc 1), their uint8
    decodes, and the sampler's latents after merge_lora at scale 0.8."""
    from stablediffusioneo_tpu.pipeline.ddim import DDIMSampler, ddim_sample_scan

    _, trees, _ = weights
    x = _runtime_request()
    key = jax.random.PRNGKey(DRAW_KEY)
    hint = jnp.asarray(x["hint_u8"], jnp.float32) / 255.0
    ctx_c, ctx_u = jnp.asarray(x["ctx_c"]), jnp.asarray(x["ctx_u"])
    sched = {k: jnp.asarray(v) for k, v in schedules()[1].ddim(2).items()}
    inpaint = jax.jit(lambda u, c: ddim_sample_scan(
        u, c, CFG.controlnet, sched, jnp.asarray(x["x_T"]), hint, ctx_c, ctx_u,
        jnp.float32(SAMPLER_SCALE), [SAMPLER_STRENGTH] * n_taps(), key,
        inpaint_latent=jnp.asarray(x["lat"]), inpaint_mask=jnp.asarray(x["mask"])))(
        trees["unet"], trees["controlnet"])
    img2img = DDIMSampler(CFG, trees["unet"], trees["controlnet"]).img2img(
        jnp.asarray(x["lat"]), 0.5, 2, hint, ctx_c, ctx_u, key,
        guidance_scale=SAMPLER_SCALE, strength=SAMPLER_STRENGTH)
    merged = jl.merge_lora(trees["unet"], _jax_lora(trees), 0.8)
    lora = jax_sampler_reference(dict(trees, unet=merged), x)["z"]
    return {"inpaint_z": np.asarray(inpaint), "inpaint": _jax_image(trees["vae"], inpaint),
            "img2img_z": np.asarray(img2img), "img2img": _jax_image(trees["vae"], img2img),
            "lora": lora}


@pytest.fixture(scope="module")
def jax_pipe(weights):
    """The JAX package's pipeline on the same weights, with the port's toy
    tokenizer."""
    from stablediffusioneo_tpu.pipeline.canny2image import Canny2ImagePipeline as JaxPipeline
    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer

    _, trees, _ = weights
    tok = toy_tokenizer(PORT_CFG.clip.vocab_size, PORT_CFG.clip.max_length)
    return JaxPipeline(trees, tok, CFG, persistent_cache=False)


# ---------------------------------------------------------------- inference


def _assert_request(out, ref):
    assert_close_scaled(out["z"], ref["z"], SAMPLE_TOL)
    assert_close_scaled(out["ctx"], ref["ctx"], CTX_TOL)
    assert out["img"].dtype == np.uint8 and out["img"].shape == ref["img"].shape
    assert np.abs(out["img"].astype(int) - ref["img"].astype(int)).max() <= 1


def test_dp_tp_sampler_matches_unsharded(world4, jax_request):
    """Every rank of dp=2 x tp=2 returns the whole batch's latents, images
    and contexts, equal to the JAX package's unsharded ones; the runtime's
    engines ran dp-split (a batch of 4 tiles dp=2)."""
    for out in world4:
        r = out["runtime"]
        assert r["axis_names"] == ("dp", "tp")
        _assert_request(r, jax_request)
        assert all(dp for dp, _ in r["engines"].values())


def test_tp_param_shardings_applied(world4, weights):
    """The applied specs are the JAX _tp_spec's on the same layers: an
    attention projection column-parallel (a rank holds half the heads), convs
    whole, and per kind as many sharded leaves as the JAX rules shard in the
    same trees (torch layout: JAX P(None, "tp") on (in, out) is ("tp", None)
    on (out, in)), plus CLIP's column biases."""
    _, trees, _ = weights
    r = world4[0]["runtime"]
    specs = r["specs"]
    name = "model.diffusion_model.input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"
    assert specs[name] == ("tp", None) and r["heads"] == CFG.unet.num_heads // 2
    assert r["wq"][0] == 32 // 2
    assert not any(k.endswith(("conv.weight", "op.weight")) or ".in_layers." in k
                   for k in specs)

    def jax_counts(tree, tp=2):
        specs = jax.tree.leaves(jax.tree_util.tree_map_with_path(
            lambda p, l: jax_mesh._tp_spec(p, l, tp), tree),
            is_leaf=lambda x: isinstance(x, P))
        return {"col": sum(s == P(None, "tp") for s in specs),
                "row": sum(s == P("tp", None) for s in specs),
                "bias": sum(s == P("tp") for s in specs)}

    want = {k: sum(jax_counts(trees[n])[k] for n in ("unet", "controlnet", "clip"))
            for k in ("col", "row", "bias")}
    # CLIP's q/k/v biases: the JAX rule leaves them whole and GSPMD slices
    # them at the add; the port stores the slice that matches the weight's
    want["bias"] += 3 * CFG.clip.num_layers
    got = {"col": sum(s == ("tp", None) for s in specs.values()),
           "row": sum(s == (None, "tp") for s in specs.values()),
           "bias": sum(s == ("tp",) for s in specs.values())}
    assert got == want


def test_geglu_guard_and_indivisible_heads_stay_whole(world3, jax_request, weights):
    """tp=3: the GEGLU guard (ff1 out 256 is not a multiple of 2 x 3), heads
    2 and CLIP's MLP do not tile 3, so nothing is sharded, as the JAX rule
    leaves ff1 whole; the result is the unsharded one on every rank."""
    _, trees, _ = weights
    ff1 = trees["unet"]["input_blocks"][1]["attn"]["blocks"][0]["ff1"]["w"]
    path = tuple(jax.tree_util.DictKey(k) for k in ("blocks", "ff1", "w"))
    assert ff1.shape[-1] % 6 and jax_mesh._tp_spec(path, ff1, 3) == P()
    assert jax_mesh._tp_spec(path, ff1, 2) == P(None, "tp")
    for out in world3:
        r = out["runtime"]
        assert r["specs"] == {} and r["heads"] == CFG.unet.num_heads
        _assert_request(r, jax_request)


def test_geglu_slices_are_value_and_gate_halves():
    """A rank's ff1 holds its slice of the value half and the same slice of
    the gate half (not a contiguous slice of [value; gate], which straddles
    the split); `tp_whole` inverts it."""
    t = torch.arange(16.0).reshape(8, 2)
    parts = [pmesh._rows(t, r, 2, 2) for r in range(2)]
    assert torch.equal(parts[0], torch.cat([t[0:2], t[4:6]]))
    assert torch.equal(parts[1], torch.cat([t[2:4], t[6:8]]))
    assert pmesh.tp_parts("x.net.0.proj.weight") == 2
    assert pmesh.tp_parts("attn.in_proj_weight") == 3


def test_runtime_inpaint_img2img_and_lora_on_mesh(world4, jax_extra):
    """The inpaint blend and img2img engines over dp=2 x tp=2, the JAX draws
    handed in: every rank returns the JAX package's latents and images (the
    kept region of the blend is the clean original); then apply_lora merges
    each rank's slice of the JAX-drawn adapter's update into its
    tensor-parallel weights (the JAX runtime re-shards the merged tree), and
    the sampler's latents are the JAX sampler's on the merged tree."""
    x = ranks.request()
    kept = np.broadcast_to(x["mask"] == 0, x["lat"].shape)
    for out in world4:
        r = out["runtime"]
        for k in ("inpaint", "img2img"):
            assert_close_scaled(r[k + "_z"], jax_extra[k + "_z"], SAMPLE_TOL)
            assert r[k].shape == (4, 64, 64, 3)
            assert np.abs(r[k].astype(int) - jax_extra[k].astype(int)).max() <= 1, k
        assert np.array_equal(r["inpaint_z"][kept], x["lat"][kept])
        assert_close_scaled(r["lora"], jax_extra["lora"], SAMPLE_TOL)
        assert np.abs(r["lora"] - r["z"]).max() > 1e-3


# ----------------------------------------------------------------- training


def _jax_step(nets, batch):
    jcfg = CFG
    key = jax.random.PRNGKey(7)
    state, tx = jt.create_train_state(nets["controlnet"][0], LR)
    sa, s1 = jt.make_schedule_buffers(jcfg)
    step = jax.jit(functools.partial(jt.train_step, tx=tx, cfg=jcfg))
    state, loss = step(state, unet_params=nets["unet"][0], sqrt_abar=sa,
                       sqrt_one_minus_abar=s1,
                       batch={k: jnp.asarray(v) for k, v in batch.items()}, key=key)
    # the step's gradients from AdamW's first moment after one step: (1 - b1) g
    grads = jax.tree.map(lambda m: m / 0.1, state.opt_state[0].mu)
    return float(loss), port_names("controlnet", grads), port_names("controlnet", state.params)


@pytest.fixture(scope="module")
def jax_step(weights):
    return _jax_step(weights[0], _batch())


def _assert_step(out, ref):
    j_loss, j_grads, j_params = ref
    assert abs(out["loss"] - j_loss) <= LOSS_TOL * abs(j_loss)
    assert set(out["grads"]) == set(j_grads)
    for name, want in j_grads.items():
        want = want.numpy()
        assert_close_scaled(out["grads"][name], want, GRAD_TOL)
        got, ref_p = out["params"][name], j_params[name].numpy()
        sure = np.abs(want) > 1e-3 * np.abs(want).max()
        assert np.abs(got - ref_p)[sure].max(initial=0) <= 1e-6, name
        assert np.abs(got - ref_p).max() <= 2 * LR, name


def test_fsdp_train_step_matches_replicated(world2, jax_step):
    """dp=2 FSDP: the step equals the JAX package's replicated step on every
    rank, and a rank holds half of the large leaves and of their moments."""
    for out in world2:
        step = out["step"]
        _assert_step(step, jax_step)
        assert step["share"][0] <= 0.5 + 1e-9 and step["share"][1] <= 0.5 + 1e-9


def test_fsdp_composes_with_tp(world4, jax_step, weights):
    """dp=2 x tp=2 with FSDP: the step equals the replicated JAX step; a
    TP-sharded attention weight picks up a dp shard on its other dim (the
    JAX fsdp_param_sharding_rules on the same leaf)."""
    for out in world4:
        _assert_step(out["step"], jax_step)
    step = world4[0]["step"]
    name = "input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"
    assert step["tp_specs"][name] == ("tp", None)
    local = {name: torch.zeros(32 // 2, 32)}
    rules = pmesh.fsdp_param_sharding_rules(_MeshShape(dp=2, tp=2), local, min_size=0,
                                            tp_specs=step["tp_specs"])
    assert rules[name] == ("tp", "dp")


class _MeshShape:
    """What the rules read of a mesh: its axis sizes."""

    def __init__(self, **shape):
        self.shape = shape

    def size(self, name):
        return self.shape.get(name, 1)


def test_fsdp_shards_the_leaves_the_jax_rules_shard(world2, weights):
    """The count of FSDP-sharded leaves of the ControlNet at dp=2 is the JAX
    rules' count on the same tree (min_size 2^14)."""
    _, trees, _ = weights
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("dp", "tp"))
    rules = jax_mesh.fsdp_param_sharding_rules(mesh, trees["controlnet"])
    want = sum("dp" in r.spec for r in jax.tree.leaves(
        rules, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
    got = world2[0]["step"]["fsdp_sharded"]
    assert want > 0 and len(got) == want


def _jax_train(nets, batches, seed=0, decay=0.9):
    """The JAX package's train_step for len(batches) steps (its loss and
    gradients, the optax AdamW update, then its EMA update), each step's t
    and noise the port's step_draws(seed, step) as train() draws them:
    {name: tensor} of the parameters, AdamW's first moments and the EMA."""
    state, tx = jt.create_train_state(nets["controlnet"][0], LR)
    sa, s1 = jt.make_schedule_buffers(CFG)
    ema = jema.ema_init(state.params)
    value_and_grad = jax.jit(jax.value_and_grad(jt.diffusion_loss), static_argnums=(2,))
    for step, batch in enumerate(batches):
        t, noise = step_draws(seed, step, torch.from_numpy(batch["x0"]), CFG.diffusion.timesteps)
        _, grads = value_and_grad(state.params, nets["unet"][0], CFG, sa, s1,
                                  *(jnp.asarray(batch[k]) for k in ("x0", "hint", "ctx")),
                                  jnp.asarray(t.numpy().astype(np.int32)),
                                  jnp.asarray(noise.numpy()))
        updates, opt = tx.update(grads, state.opt_state, state.params)
        state = jt.TrainState(optax.apply_updates(state.params, updates), opt, state.step + 1)
        ema = jema.ema_update(ema, state.params, decay)
    return {k: port_names("controlnet", tree)
            for k, tree in (("params", state.params), ("mu", state.opt_state[0].mu),
                            ("ema", ema[0]))}


def _moves_close(got, want, start):
    """sum |(got - start) - (want - start)| <= MOVE_TOL x sum |want - start|
    over every tensor of `want`."""
    off = sum(np.abs(got[n] - want[n].numpy()).sum() for n in want)
    moved = sum(np.abs(want[n].numpy() - start[n].numpy()).sum() for n in want)
    assert moved > 0 and off <= MOVE_TOL * moved, (off, moved)


def test_train_dp2_tp2_matches_one_device(world4, weights):
    """train(dp=2, tp=2) for two steps (EMA, a checkpoint at the end) writes
    the JAX train steps' parameters and first moments whole, and its EMA is
    theirs."""
    nets, _, _ = weights
    want = _jax_train(nets, _loop_batches())
    start = port_names("controlnet", nets["controlnet"][0])
    saved = world4[0]["loop"]
    assert saved["step"] == 2 and saved["mesh"] == ("dp", "tp")
    assert set(saved["params"]) == set(want["params"])
    _moves_close(saved["params"], want["params"], start)
    _moves_close(saved["ema"], want["ema"], start)
    for name, got in zip(saved["names"], saved["exp_avg"]):
        assert_close_scaled(got, want["mu"][name].numpy(), GRAD_TOL)


# --------------------------------------------------------------------- SDXL


def test_sdxl_txt2img_tp_matches_unsharded(world4, sdxl_weights):
    """The TP rules cover SDXL's ADM UNet unchanged: column and row specs
    applied, and the dp=2 x tp=2 loop equals the JAX unsharded
    sdxl_txt2img_scan on every rank."""
    from stablediffusioneo_tpu.models import sdxl as jsdxl
    from stablediffusioneo_tpu.ops.schedule import DiffusionSchedule

    x = _sdxl_inputs()
    cfg = jsdxl.tiny_sdxl()
    sched = {k: jnp.asarray(v) for k, v in DiffusionSchedule().ddim(x["steps"]).items()}
    ref = jax.jit(lambda u, s, *a: jsdxl.sdxl_txt2img_scan(
        u, cfg, s, *a, jnp.float32(x["scale"]), jax.random.PRNGKey(1)))(
        sdxl_weights[0], sched, *(jnp.asarray(x[k]) for k in ("x_T", "ctx_c", "ctx_u",
                                                                "y_c", "y_u")))
    for out in world4:
        s = out["sdxl"]
        assert ("tp", None) in s["specs"] and (None, "tp") in s["specs"]
        assert_close_scaled(s["z"], np.asarray(ref), SDXL_TOL)


# ------------------------------------------------------------------ serving


def test_served_batch_on_a_two_rank_mesh_runtime(world2, jax_pipe):
    """A DiffusionServer over a dp=2 mesh runtime: rank 0 cut both requests
    into one batch of 2 and broadcast it, rank 1 ran the same cut; each
    image is the JAX pipeline's process() of its request, the server's draw
    of the request's seed (a generator seeded with it, one row) handed in as
    x_T (within 1)."""
    lead, follower = world2[0]["serve"], world2[1]["serve"]
    assert lead["hist"] == {2: 1} and follower["cuts"] == 1
    for req, got in zip(_requests(), lead["images"]):
        x_T = torch.randn((8, 8, 4), generator=torch.Generator().manual_seed(req.seed))
        want = jax_pipe.process(req.image, req.prompt, req.a_prompt, req.n_prompt,
                                num_samples=1, image_resolution=req.image_resolution,
                                ddim_steps=req.ddim_steps, scale=req.scale, seed=req.seed,
                                x_T=x_T[None].numpy())[1]
        assert got.shape == want.shape and np.abs(got.astype(int) - want.astype(int)).max() <= 1
