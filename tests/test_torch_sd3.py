"""SD 3.5 Medium on the port (models/{sd3,mmdit}.py, pipeline/flow_match.py,
runtime/engine.py:sd3_sample_decode_engine) against the plain fp32
reference (stablediffusioneo_tpu_torch/testing/torch_ref_sd3.py), on the CPU
at tiny_sd3()'s widths: 4 joint blocks, the first 2 with the image-only
second attention, the last one's context stream pre-only. One seeded draw
of the reference's state dict, under the checkpoint's names, is loaded into
both.

Tolerances, ||port - reference|| / ||reference||: 1e-5 for a network
evaluation and the conditioning (measured 6.4e-6 and 0: both sides are fp32
and compute the same products, in other orders, with timestep frequencies
that differ in the last bit, numpy's exp against torch's); 3e-5 for a
3-step request's x_0 latents (measured 1.5e-5: each step feeds the last
one's difference back through the network); the uint8 image within one
level (a pixel whose fp32 value sits at a rounding edge may truncate either
way).
"""

import collections
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from stablediffusioneo_tpu_torch.checkpoint.accounting import ConversionAccountingError
from stablediffusioneo_tpu_torch.models import sd3
from stablediffusioneo_tpu_torch.models.mmdit import sincos_pos_embed
from stablediffusioneo_tpu_torch.ops import norms
from stablediffusioneo_tpu_torch.ops.attention import packed_attention
from stablediffusioneo_tpu_torch.pipeline.flow_match import (
    flow_match_sigmas,
    flow_match_steps,
    shifted,
)
from stablediffusioneo_tpu_torch.runtime import engine
from stablediffusioneo_tpu_torch.runtime.engine import sd3_sample_decode_engine
from stablediffusioneo_tpu_torch.testing import torch_ref_sd3 as ref

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the card's SD3 launch plan; imports no JAX)

CFG = sd3.tiny_sd3()
RES, STEPS, SCALE, SEED = 64, 3, 4.5, 2 ** 33 + 17
TOL, LOOP_TOL = 1e-5, 3e-5


def ref_config(cfg: sd3.SD3Config, res=RES, steps=STEPS):
    """The reference's plain-dict configuration of a port configuration."""
    d = {k: dataclasses.asdict(getattr(cfg, k))
         for k in ("transformer", "clip_l", "clip_g", "t5", "vae")}
    d["sampling"] = {"resolution": res, "steps": steps, "scale": SCALE, "shift": cfg.shift}
    return d


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture(scope="module")
def nets():
    """(reference, port, state dict): weights drawn by name, norm gains and
    biases away from 1 and 0, so a norm that is dropped or swapped shows."""
    torch.manual_seed(0)
    net = ref.SD3(ref_config(CFG)).eval()
    g = torch.Generator().manual_seed(5)
    sd = {}
    for k, v in net.state_dict().items():
        if v.dim() >= 2 and "embed" not in k and "shared" not in k:
            bound = v[0].numel() ** -0.5
            sd[k] = (torch.rand(v.shape, generator=g) * 2 - 1) * bound
        elif "norm" in k or k.endswith(("ln_q.weight", "ln_k.weight")):
            sd[k] = 1 + 0.2 * torch.randn(v.shape, generator=g)
        else:
            sd[k] = 0.3 * torch.randn(v.shape, generator=g)
    net.load_state_dict(sd)
    port = sd3.SD3(CFG).eval()
    port.load_checkpoint(sd)
    return net, port, sd


def token_ids(seed):
    """(ids_l, ids_g, ids_t5), two rows each: CLIP ids with the EOT (the
    largest id) after 5 and 2 words, CLIP-L padded with EOT, bigG with
    zeros; T5 ids with EOS 1 and pad 0."""
    rng = np.random.default_rng(seed)
    cl, ct = CFG.clip_l, CFG.t5
    eot = cl.vocab_size - 1
    ids_l = np.full((2, cl.max_length), eot, np.int64)
    ids_g = np.zeros((2, cl.max_length), np.int64)
    ids_t5 = np.zeros((2, ct.max_length), np.int64)
    for row, n in enumerate((5, 2)):
        words = rng.integers(1, eot - 1, n)
        ids_l[row, 1:n + 1] = ids_g[row, 1:n + 1] = words
        ids_l[row, 0] = ids_g[row, 0] = eot - 1
        ids_g[row, n + 1] = eot
        ids_t5[row, :n] = rng.integers(3, ct.vocab_size, n)
        ids_t5[row, n] = 1
    return tuple(torch.from_numpy(a) for a in (ids_l, ids_g, ids_t5))


@pytest.mark.parametrize("hw", [(8, 8), (12, 8)], ids=["square", "tall"])
def test_mmdit_forward_matches_reference(nets, hw):
    net, port, _ = nets
    t = CFG.transformer
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, *hw, t.in_channels), generator=g)
    ctx = torch.randn((2, 40, t.joint_attention_dim), generator=g)
    pooled = torch.randn((2, t.pooled_projection_dim), generator=g)
    ts = torch.tensor([700.0, 31.5])
    with torch.no_grad():
        want = net.model.diffusion_model(x.permute(0, 3, 1, 2), ts, ctx, pooled)
        got = port.mmdit(x, ts, ctx, pooled)
    assert got.shape == x.shape[:3] + (t.out_channels,)
    assert rel(got.permute(0, 3, 1, 2), want) < TOL


def test_dual_and_pre_only_blocks():
    """The tiny configuration has what the published one has: image-only
    attention in the listed blocks, a pre-only last context stream."""
    port = sd3.SD3(CFG)
    blocks = port.mmdit.joint_blocks
    assert [hasattr(b.x_block, "attn2") for b in blocks] == [True, True, False, False]
    assert [b.context_block.pre_only for b in blocks] == [False, False, False, True]
    last = dict(blocks[-1].context_block.named_parameters())
    assert "attn.proj.weight" not in last and not any(k.startswith("mlp") for k in last)
    c = CFG.transformer.hidden_size
    assert blocks[0].x_block.adaLN_modulation[1].weight.shape == (9 * c, c)
    assert blocks[-1].context_block.adaLN_modulation[1].weight.shape == (2 * c, c)


def test_position_table_is_the_centre_crop():
    """The port's cropped table equals the reference's whole table cropped,
    and the published one's centre starts at patch (160, 160)."""
    c, grid, base = 32, 12, 4
    whole = ref.sincos_table(c, grid, base).reshape(grid, grid, c).numpy()
    got = sincos_pos_embed(c, grid, base, 6, 4).reshape(6, 4, c)
    np.testing.assert_allclose(got, whole[3:9, 4:8], rtol=0, atol=1e-12)
    full = sincos_pos_embed(1536, 384, 64, 64, 64)
    assert full.shape == (4096, 1536)
    # token (0, 0) sits at table position 160 / 6 along both axes
    assert np.allclose(full[0, :384], np.sin(160 / 6 / 10000 ** (np.arange(384) / 384)))


def test_conditioning_matches_reference(nets):
    net, port, _ = nets
    ids = token_ids(3)
    with torch.no_grad():
        ctx, pooled = sd3.sd3_conditioning(port, *ids)
        want_ctx, want_pooled = ref.conditioning(net, *ids)
    n_clip = CFG.clip_l.max_length
    clip_w = CFG.clip_l.hidden_size + CFG.clip_g.hidden_size
    assert ctx.shape == (2, n_clip + CFG.t5.max_length, CFG.t5.d_model)
    assert pooled.shape == (2, CFG.clip_l.projection_dim + CFG.clip_g.projection_dim)
    assert pooled.shape[1] == CFG.transformer.pooled_projection_dim
    assert torch.all(ctx[:, :n_clip, clip_w:] == 0)      # the zero pad
    assert torch.any(ctx[:, n_clip:, clip_w:] != 0)      # T5 fills its width
    assert rel(ctx, want_ctx) < TOL and rel(pooled, want_pooled) < TOL


def test_conditioning_spans_nest_t5_in_text_encode(nets):
    from stablediffusioneo_tpu_torch.runtime import profiling

    _, port, _ = nets
    profiling.clear()
    with torch.no_grad():
        sd3.sd3_conditioning(port, *token_ids(4))
    spans = {sp.name: sp for sp in profiling.spans()}
    assert spans["text.t5"].parent == spans["text.encode"].id


def test_flow_schedule_against_its_closed_form():
    n, shift = 40, 3.0
    sig = flow_match_sigmas(n, shift)
    assert sig.shape == (n + 1,) and sig[0] == 1.0 and sig[-1] == 0.0
    assert np.all(np.diff(sig) < 0)
    s_min = 3 * 0.001 / (1 + 2 * 0.001)                  # shift(1/1000)
    for k in (0, 1, 17, 39):
        s = 1 + (s_min - 1) * k / (n - 1)                # linspace(1, shift(1/1000))
        assert sig[k] == pytest.approx(3 * s / (1 + 2 * s), rel=1e-14)
    np.testing.assert_allclose(sig, ref.flow_sigmas(n, shift), rtol=0, atol=1e-15)
    assert shifted(0.5, 1.0) == 0.5
    steps = flow_match_steps(sig, "cpu")
    assert len(steps) == n
    assert float(steps[0][0]) == pytest.approx(1000.0)
    assert float(sum(dt for _, dt in steps)) == pytest.approx(-1.0, abs=1e-6)


@pytest.mark.parametrize("stage_steps,stages", [(20, 1), (2, 2), (1, 3)])
def test_request_through_the_engine_matches_reference(nets, stage_steps, stages, monkeypatch):
    """A whole request: conditioning, the engine run eagerly on the CPU
    (capture None) in one, two or three stages, against the reference's
    request on the same ids and seed."""
    net, port, _ = nets
    ids = token_ids(7)
    f = CFG.vae.downsample_factor
    with torch.no_grad():
        ctx, pooled = sd3.sd3_conditioning(port, *ids)
        monkeypatch.setattr(engine, "SD3_STAGE_STEPS", stage_steps)
        eng = sd3_sample_decode_engine(port, STEPS, 1, RES, RES)
        assert not eng.compiled and len(eng.stages) == stages and not eng.pace
        x = ref.draw_x_T(SEED, RES // f, RES // f, 16, "cpu").permute(0, 2, 3, 1)
        img, z = eng(x, ctx[:1], ctx[1:], pooled[:1], pooled[1:],
                     torch.full((1,), SCALE))
        z_ref, img_ref = ref.sd3_request(net, ref_config(CFG), *ids, SEED)
    assert img.dtype == torch.uint8 and img.shape == (1, RES, RES, 3)
    assert z.shape == z_ref.shape == (1, RES // f, RES // f, 16)
    assert rel(z, z_ref) < LOOP_TOL
    diff = (img.int() - img_ref.int()).abs()
    assert diff.max() <= 1 and diff.float().mean() < 0.01


def test_the_smoke_plan_counts_a_request_norms(nets):
    """chip_smoke.sd3_plan, which holds the card's SD3 requests to their
    launch counts, against the norm calls of a tiny request through the
    engine (on the CPU every call runs plain, so they are compared by norm,
    whatever the route)."""
    _, port, _ = nets
    ids = token_ids(7)
    f = CFG.vae.downsample_factor
    with torch.no_grad():
        ctx, pooled = sd3.sd3_conditioning(port, *ids)
        eng = sd3_sample_decode_engine(port, STEPS, 1, RES, RES)
        x = ref.draw_x_T(SEED, RES // f, RES // f, 16, "cpu").permute(0, 2, 3, 1)
        norms.route_counts.clear()
        eng(x, ctx[:1], ctx[1:], pooled[:1], pooled[1:], torch.full((1,), SCALE))
    got, want = collections.Counter(), collections.Counter()
    for (norm, _), n in norms.route_counts.items():
        got[norm] += n
    for (norm, _), n in chip_smoke.sd3_plan(CFG, STEPS, 1, res=RES)[2].items():
        want[norm] += n
    assert got == want and want["rms_norm"] == STEPS * 2 * (2 * 4 + 2)


def test_load_checkpoint_takes_the_documented_leftovers(nets):
    _, _, sd = nets
    extra = dict(sd)
    extra["model.diffusion_model.pos_embed"] = torch.zeros(1, 144, 32)
    extra["text_encoders.clip_g.transformer.text_model.embeddings.position_ids"] = \
        torch.arange(16)[None]
    extra["text_encoders.t5xxl.transformer.encoder.embed_tokens.weight"] = \
        sd["text_encoders.t5xxl.transformer.shared.weight"]
    sd3.SD3(CFG).load_checkpoint(extra)


@pytest.mark.parametrize("fault", ["missing", "orphan", "misshapen"])
def test_load_checkpoint_refuses(nets, fault):
    _, _, sd = nets
    bad = dict(sd)
    key = "model.diffusion_model.joint_blocks.1.x_block.attn2.ln_k.weight"
    if fault == "missing":
        del bad[key]
    elif fault == "orphan":
        bad["model.diffusion_model.joint_blocks.3.context_block.attn.proj.weight"] = \
            torch.zeros(32, 32)
    else:
        bad[key] = torch.ones(17)
    with pytest.raises(ConversionAccountingError):
        sd3.SD3(CFG).load_checkpoint(bad)


def test_sixteen_channel_vae_has_no_quant_convs():
    port = sd3.SD3(CFG)
    keys = [k for k in port.state_dict() if k.startswith("first_stage_model.")]
    assert not any("quant_conv" in k for k in keys)
    assert port.vae.decoder.conv_in.in_channels == 16
    assert port.vae.encoder.conv_out.out_channels == 32
    assert CFG.vae.shift_factor == 0.0609 and CFG.vae.scale_factor == 1.5305


def test_rms_norm_counts_its_route_and_matches_definition():
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn((3, 5, 64), generator=g), torch.randn(64, generator=g)
    before = norms.route_counts["rms_norm", "plain_cpu"]
    got = norms.rms_norm(x, w, 1e-6)
    want = x / torch.sqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * w
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert norms.route_counts["rms_norm", "plain_cpu"] == before + 1
    assert norms.rms_norm_route("cuda", False) == "plain_card"
    assert norms.rms_norm_route("cuda", True) == "plain_grad"


def test_layer_norm_without_affine():
    x = torch.randn((2, 7, 24), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(norms.layer_norm(x, None, None, 1e-6),
                               torch.nn.functional.layer_norm(x, (24,), eps=1e-6),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tq,s", [(40, 40), (1024 + 13, 77)], ids=["plain", "packed"])
def test_packed_attention_matches_written_out(tq, s):
    g = torch.Generator().manual_seed(4)
    q = torch.randn((2, tq, 32), generator=g)
    k, v = torch.randn((2, s, 32), generator=g), torch.randn((2, s, 32), generator=g)
    torch.testing.assert_close(packed_attention(q, k, v, 2), ref.attend(q, k, v, 2),
                               rtol=1e-5, atol=1e-5)
