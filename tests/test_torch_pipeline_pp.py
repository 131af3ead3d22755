"""The port's GPipe schedule (stablediffusioneo_tpu_torch/parallel/pipeline.py)
and its pp towers on gloo worlds of CPU processes: the cases of
tests/test_pipeline_pp.py. The references are unsharded JAX: the toy
stack applied layer by layer in JAX (and jax.grad of it), the JAX package's
clip_text_apply in every layer= mode and its t5_encode with and without a
padding mask, on the same numpy-drawn weights (the towers carried by
checkpoint/convert.py).

Worlds: 2 ranks (pp=2: microbatch counts 1, 2, 4, capture_last_input, a
stage's own parameters, grads with and without remat, the towers; dp=2 with
no pp axis: the single stage) and 4 ranks (pp=4, pp=2 x dp=2, the
per-stage batched_extra indexing, the layer-tiling error). Tolerances: fp32
forward 1e-6 of the output's max (the toy) and 1e-5 (the towers: the
port's attention and norms against the JAX package's); gradients 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stablediffusioneo_tpu.config import tiny_pipeline
from stablediffusioneo_tpu.models import t5 as jax_t5
from stablediffusioneo_tpu.models.clip import clip_text_apply, init_clip_text
from stablediffusioneo_tpu_torch.checkpoint.convert import clip_state_dict, t5_state_dict_from_jax
from stablediffusioneo_tpu_torch.parallel import stack_layer_params, unstack_layer_params

import torch_parallel_ranks as ranks
from torch_port_util import assert_close_scaled, numpy_params

CFG = tiny_pipeline()
SCALE = np.float32(0.7)
TOY_TOL, TOWER_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-5


def toy_layers(n_layers=8, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * 0.5 / np.sqrt(d)).astype(np.float32),
             "b": (rng.standard_normal(d) * 0.01).astype(np.float32)}
            for _ in range(n_layers)]


def jax_toy(p, x, scale):
    return jnp.tanh(x @ p["w"] + p["b"]) * scale + x


def jax_sequential(layers, x, scale=SCALE, fn=jax_toy):
    for p in layers:
        x = fn(p, x, scale)
    return x


def _x(seed=1, shape=(4, 6, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _extra_case():
    rng = np.random.default_rng(9)
    layers = [{"w": (rng.standard_normal((8, 8)) * 0.3).astype(np.float32)} for _ in range(4)]
    return layers, _x(10, (8, 3, 8)), _x(11, (8, 3, 8))


@pytest.fixture(scope="module")
def towers():
    clip_p = numpy_params(init_clip_text, CFG.clip, 7)
    t5_cfg = jax_t5.tiny_t5()
    t5_p = numpy_params(jax_t5.init_t5, t5_cfg, 3)
    rng = np.random.default_rng(7)
    clip_ids = rng.integers(0, CFG.clip.vocab_size, (4, CFG.clip.max_length)).astype(np.int32)
    t5_ids = rng.integers(0, t5_cfg.vocab_size, (4, t5_cfg.max_length)).astype(np.int32)
    mask = np.ones_like(t5_ids)
    mask[0, 5:], mask[2, 9:], mask[3, 2:] = 0, 0, 0
    clip_sd = {}
    clip_state_dict(clip_sd, clip_p, prefix="")
    return {"clip_p": clip_p, "t5_p": t5_p, "t5_cfg": t5_cfg, "clip_sd": clip_sd,
            "clip_ids": clip_ids, "t5_sd": t5_state_dict_from_jax(t5_p), "t5_ids": t5_ids,
            "t5_mask": mask}


def _inputs(towers):
    ex_layers, ex_x, ex_e = _extra_case()
    return dict(layers=toy_layers(), x=_x(), scale=float(SCALE), ex_layers=ex_layers,
                ex_x=ex_x, ex_e=ex_e, clip_sd=towers["clip_sd"], clip_ids=towers["clip_ids"],
                t5_sd=towers["t5_sd"], t5_ids=towers["t5_ids"], t5_mask=towers["t5_mask"])


@pytest.fixture(scope="module")
def world2(towers, tmp_path_factory):
    return ranks.spawn(ranks.pipeline_job, 2, tmp_path_factory.mktemp("pp2"),
                       **_inputs(towers))


@pytest.fixture(scope="module")
def world4(towers, tmp_path_factory):
    return ranks.spawn(ranks.pipeline_job, 4, tmp_path_factory.mktemp("pp4"),
                       **_inputs(towers))


@pytest.fixture(scope="module")
def toy_ref():
    layers = [{k: jnp.asarray(v) for k, v in p.items()} for p in toy_layers()]
    x = jnp.asarray(_x())
    y = jax_sequential(layers, x)
    grads = jax.grad(lambda ls: (jax_sequential(ls, x) ** 2).sum() / 2)(layers)
    stacked = {k: np.stack([np.asarray(g[k]) for g in grads]) for k in grads[0]}
    pen = jax_sequential(layers[:-1], x)
    return np.asarray(y), np.asarray(pen), stacked


# ---------------------------------------------------------------- primitive


def test_forward_parity_pp4_and_pp2_dp2(world4, toy_ref):
    """Every rank returns the whole batch; the mesh keeps the JAX axis order."""
    for out in world4:
        assert out["pp4_axes"] == ("pp", "dp", "tp")
        assert out["pp2dp2_axes"] == ("pp", "dp", "tp")
        assert_close_scaled(out["pp4"], toy_ref[0], TOY_TOL)
        assert_close_scaled(out["pp2dp2"], toy_ref[0], TOY_TOL)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_microbatch_counts(world2, toy_ref, microbatches):
    for out in world2:
        assert_close_scaled(out[f"mb{microbatches}"], toy_ref[0], TOY_TOL)


def test_single_stage_degenerate(world2, toy_ref):
    """A mesh without a pp axis runs the stack as one stage (batch over dp)."""
    for out in world2:
        assert out["single_axes"] == ("dp", "tp")
        assert_close_scaled(out["single"], toy_ref[0], TOY_TOL)


def test_capture_last_input(world2, toy_ref):
    """The input of the globally last layer, published by the last stage."""
    for out in world2:
        y, pen = out["capture"]
        assert_close_scaled(y, toy_ref[0], TOY_TOL)
        assert_close_scaled(pen, toy_ref[1], TOY_TOL)


def test_stage_params_run_the_same_pipeline(world2, toy_ref):
    """pp_shard_params leaves a rank its stage's layers (4 of 8), and the
    pipeline over them is the pipeline over the whole stack."""
    for r, out in enumerate(world2):
        assert out["stage"] == (8, r, (4, 16, 16))
        assert_close_scaled(out["prestaged"], toy_ref[0], TOY_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_grad_parity(world2, toy_ref, remat):
    """Autograd through the schedule (sends and receives carry gradients one
    hop back): each stage's rows of the stacked gradient land on its rank,
    and together they are jax.grad of the sequential stack."""
    for k, want in toy_ref[2].items():
        got = sum(out[f"grad_remat{int(remat)}"][k] for out in world2)
        assert_close_scaled(got, want, GRAD_TOL)
        for s, out in enumerate(world2):  # a stage's rows only
            rows = out[f"grad_remat{int(remat)}"][k]
            assert not np.any(rows[:4 * s]) and not np.any(rows[4 * (s + 1):])


def test_grad_parity_with_dp(world4, toy_ref):
    """pp=2 x dp=2: each dp replica's gradient is its batch slice's; summed
    over the replicas (as a data-parallel step does) they are the whole
    gradient. pp=4: each stage its quarter."""
    for case in ("pp2dp2", "pp4"):
        for k, want in toy_ref[2].items():
            got = sum(out[case + "_grad"][k] for out in world4)
            assert_close_scaled(got, want, GRAD_TOL)


def test_layer_count_must_tile_stages(world4):
    assert "6 layers do not tile 4 pipeline stages" in world4[0]["tile_layers"]


def test_local_batch_must_tile_microbatches(world2):
    assert "local batch 4 does not tile 3 microbatches" in world2[0]["tile_batch"]


def test_stack_roundtrip():
    layers = [{k: torch.from_numpy(v) for k, v in p.items()} for p in toy_layers(3)]
    stacked = stack_layer_params(layers)
    assert stacked["w"].shape == (3, 16, 16)
    back = unstack_layer_params(stacked)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(layers, back) for k in a)


def test_batched_extra_per_stage_indexing(world4):
    """A per-sample side input travels with its microbatch: at tick t stage
    s works on microbatch t - s; a layer that adds the extra catches any
    mis-slice (pp=4, 2 microbatches)."""
    layers, x, e = _extra_case()

    def fn(p, h, ex):
        return jnp.tanh(h @ p["w"]) + ex

    want = np.asarray(jax_sequential([{"w": jnp.asarray(p["w"])} for p in layers],
                                     jnp.asarray(x), jnp.asarray(e), fn))
    for out in world4:
        assert_close_scaled(out["batched_extra"], want, TOY_TOL)


# ------------------------------------------------------------------- towers


@pytest.mark.parametrize("layer", ["last", "penultimate", "penultimate_raw"])
def test_clip_pp_parity(world2, towers, layer):
    want = np.asarray(clip_text_apply(towers["clip_p"], CFG.clip,
                                      jnp.asarray(towers["clip_ids"]), layer=layer))
    for out in world2:
        assert_close_scaled(out[f"clip_{layer}"], want, TOWER_TOL)


def test_clip_pp_prestacked(world2, towers):
    """The blocks stacked once and cut to the rank's stage (pp_shard_params)."""
    want = np.asarray(clip_text_apply(towers["clip_p"], CFG.clip,
                                      jnp.asarray(towers["clip_ids"])))
    for out in world2:
        assert_close_scaled(out["clip_prestacked"], want, TOWER_TOL)


def test_t5_pp_parity_no_mask(world2, towers):
    want = np.asarray(jax_t5.t5_encode(towers["t5_p"], towers["t5_cfg"],
                                       jnp.asarray(towers["t5_ids"])))
    for out in world2:
        assert_close_scaled(out["t5"], want, TOWER_TOL)


def test_t5_pp_parity_padding_mask(world2, towers):
    """The per-sample bias rides batched_extra: wrong per-stage indexing
    would corrupt every padded row (2 microbatches)."""
    want = np.asarray(jax_t5.t5_encode(towers["t5_p"], towers["t5_cfg"],
                                       jnp.asarray(towers["t5_ids"]),
                                       mask=jnp.asarray(towers["t5_mask"])))
    for out in world2:
        assert_close_scaled(out["t5_mask"], want, TOWER_TOL)
