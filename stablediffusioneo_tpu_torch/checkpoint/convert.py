"""JAX parameter trees -> one torch state dict under the checkpoint's names.

The inverse of stablediffusioneo_tpu/checkpoint/convert.py (`convert_unet`,
`convert_controlnet`, `convert_vae`, `convert_clip`, `convert_openclip_text`):
HWIO convs go back to OIHW, (in, out) linears to (out, in), g/b norms to
weight/bias, an OpenCLIP tower's q/k/v into its packed in_proj (3d, d), its
text_projection kept as stored (d, proj), under the prefixes
model.diffusion_model. / control_model. / first_stage_model. /
cond_stage_model.transformer. (HF CLIP) or cond_stage_model.model. (OpenCLIP,
SD-2.x), or SDXL's sgm layout (model.diffusion_model. /
conditioner.embedders.0.transformer. / conditioner.embedders.1.model. /
first_stage_model.). The parameters arrive as arrays (numpy, or anything
numpy can read), so this module needs no JAX. Every parameter of the port's
model (`ControlLDM`, `LatentDiffusion` or `SDXL`) gets one, and no other key
is made, so its `load_checkpoint` loads the result with nothing left over, by
the same names a real checkpoint uses.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from stablediffusioneo_tpu_torch.models.unet import decoder_plan, encoder_plan

StateDict = Dict[str, torch.Tensor]


def _put(sd: StateDict, name: str, a) -> None:
    sd[name] = torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _conv(sd, name, p):
    _put(sd, f"{name}.weight", np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    if "b" in p:
        _put(sd, f"{name}.bias", p["b"])


def _linear(sd, name, p):
    _put(sd, f"{name}.weight", np.transpose(np.asarray(p["w"])))
    if "b" in p:
        _put(sd, f"{name}.bias", p["b"])


def _norm(sd, name, p):
    _put(sd, f"{name}.weight", p["g"])
    _put(sd, f"{name}.bias", p["b"])


# ------------------------------------------------------------------- UNet


def _resblock(sd, base, p):
    _norm(sd, f"{base}.in_layers.0", p["norm1"])
    _conv(sd, f"{base}.in_layers.2", p["conv1"])
    _linear(sd, f"{base}.emb_layers.1", p["emb"])
    _norm(sd, f"{base}.out_layers.0", p["norm2"])
    _conv(sd, f"{base}.out_layers.3", p["conv2"])
    if "skip" in p:
        _conv(sd, f"{base}.skip_connection", p["skip"])


def _spatial_transformer(sd, base, p):
    _norm(sd, f"{base}.norm", p["norm"])
    _conv(sd, f"{base}.proj_in", p["proj_in"])
    _conv(sd, f"{base}.proj_out", p["proj_out"])
    for j, blk in enumerate(p["blocks"]):
        tb = f"{base}.transformer_blocks.{j}"
        for i in (1, 2, 3):
            _norm(sd, f"{tb}.norm{i}", blk[f"norm{i}"])
        for a in ("attn1", "attn2"):
            for src, dst in (("wq", "to_q"), ("wk", "to_k"), ("wv", "to_v"),
                             ("wo", "to_out.0")):
                _linear(sd, f"{tb}.{a}.{dst}", blk[a][src])
        _linear(sd, f"{tb}.ff.net.0.proj", blk["ff1"])
        _linear(sd, f"{tb}.ff.net.2", blk["ff2"])


def _encoder_part(sd, prefix, cfg, p):
    _linear(sd, f"{prefix}time_embed.0", p["time_embed"]["l1"])
    _linear(sd, f"{prefix}time_embed.2", p["time_embed"]["l2"])
    if "label_emb" in p:  # ADM conditioning (SDXL), sgm's names
        _linear(sd, f"{prefix}label_emb.0.0", p["label_emb"]["l1"])
        _linear(sd, f"{prefix}label_emb.0.2", p["label_emb"]["l2"])
    for i, (desc, blk) in enumerate(zip(encoder_plan(cfg), p["input_blocks"])):
        base = f"{prefix}input_blocks.{i}"
        if desc["kind"] == "conv":
            _conv(sd, f"{base}.0", blk["conv"])
        elif desc["kind"] == "down":
            _conv(sd, f"{base}.0.op", blk["down"])
        else:
            _resblock(sd, f"{base}.0", blk["res"])
            if "attn" in blk:
                _spatial_transformer(sd, f"{base}.1", blk["attn"])
    mid = p["middle_block"]
    _resblock(sd, f"{prefix}middle_block.0", mid["res1"])
    _spatial_transformer(sd, f"{prefix}middle_block.1", mid["attn"])
    _resblock(sd, f"{prefix}middle_block.2", mid["res2"])


def unet_state_dict(sd, cfg, p, prefix="model.diffusion_model."):
    _encoder_part(sd, prefix, cfg, p)
    for i, (desc, blk) in enumerate(zip(decoder_plan(cfg), p["output_blocks"])):
        base = f"{prefix}output_blocks.{i}"
        _resblock(sd, f"{base}.0", blk["res"])
        if "attn" in blk:
            _spatial_transformer(sd, f"{base}.1", blk["attn"])
        if "up" in blk:
            _conv(sd, f"{base}.{2 if 'attn' in blk else 1}.conv", blk["up"])
    _norm(sd, f"{prefix}out.0", p["out"]["norm"])
    _conv(sd, f"{prefix}out.2", p["out"]["conv"])


def controlnet_state_dict(sd, cfg, p, prefix="control_model."):
    _encoder_part(sd, prefix, cfg.unet, p)
    for i, conv in enumerate(p["input_hint_block"]):
        _conv(sd, f"{prefix}input_hint_block.{2 * i}", conv)
    for i, conv in enumerate(p["zero_convs"]):
        _conv(sd, f"{prefix}zero_convs.{i}.0", conv)
    _conv(sd, f"{prefix}middle_block_out.0", p["middle_block_out"])


# --------------------------------------------------------------------- VAE


def _vae_resnet(sd, base, p):
    for n in ("norm1", "norm2"):
        _norm(sd, f"{base}.{n}", p[n])
    for n in ("conv1", "conv2", "nin_shortcut"):
        if n in p:
            _conv(sd, f"{base}.{n}", p[n])


def _vae_mid(sd, base, p):
    _vae_resnet(sd, f"{base}.block_1", p["block_1"])
    _vae_resnet(sd, f"{base}.block_2", p["block_2"])
    a = p["attn_1"]
    _norm(sd, f"{base}.attn_1.norm", a["norm"])
    for n in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{base}.attn_1.{n}", a[n])


def vae_state_dict(sd, p, prefix="first_stage_model."):
    """Both towers with quant_conv and post_quant_conv, under the names of
    the port's AutoencoderKL (and of convert_vae's input)."""
    for tower, levels, sample in (("encoder", "down", "downsample"),
                                  ("decoder", "up", "upsample")):
        t = p[tower]
        base = f"{prefix}{tower}"
        _conv(sd, f"{base}.conv_in", t["conv_in"])
        _vae_mid(sd, f"{base}.mid", t["mid"])
        for i, level in enumerate(t[levels]):
            for j, blk in enumerate(level["block"]):
                _vae_resnet(sd, f"{base}.{levels}.{i}.block.{j}", blk)
            if sample in level:
                _conv(sd, f"{base}.{levels}.{i}.{sample}.conv", level[sample])
        _norm(sd, f"{base}.norm_out", t["norm_out"])
        _conv(sd, f"{base}.conv_out", t["conv_out"])
    _conv(sd, f"{prefix}quant_conv", p["quant_conv"])
    _conv(sd, f"{prefix}post_quant_conv", p["post_quant_conv"])


# -------------------------------------------------------------------- CLIP


def clip_state_dict(sd, p, prefix="cond_stage_model.transformer."):
    tm = f"{prefix}text_model."
    _put(sd, f"{tm}embeddings.token_embedding.weight", p["token_embedding"])
    _put(sd, f"{tm}embeddings.position_embedding.weight", p["position_embedding"])
    for i, layer in enumerate(p["layers"]):
        base = f"{tm}encoder.layers.{i}"
        _norm(sd, f"{base}.layer_norm1", layer["ln1"])
        _norm(sd, f"{base}.layer_norm2", layer["ln2"])
        for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "out_proj")):
            _linear(sd, f"{base}.self_attn.{dst}", layer[src])
        _linear(sd, f"{base}.mlp.fc1", layer["fc1"])
        _linear(sd, f"{base}.mlp.fc2", layer["fc2"])
    _norm(sd, f"{tm}final_layer_norm", p["final_ln"])


def openclip_state_dict(sd, p, prefix="cond_stage_model.model."):
    """The CLIP tree under OpenCLIP's names: q, k, v packed in that order
    into in_proj (3d, d), text_projection (d, proj) as OpenCLIP stores it."""
    _put(sd, f"{prefix}token_embedding.weight", p["token_embedding"])
    _put(sd, f"{prefix}positional_embedding", p["position_embedding"])
    for i, layer in enumerate(p["layers"]):
        base = f"{prefix}transformer.resblocks.{i}"
        _norm(sd, f"{base}.ln_1", layer["ln1"])
        _norm(sd, f"{base}.ln_2", layer["ln2"])
        _put(sd, f"{base}.attn.in_proj_weight", np.concatenate(
            [np.transpose(np.asarray(layer[n]["w"])) for n in ("q", "k", "v")]))
        _put(sd, f"{base}.attn.in_proj_bias", np.concatenate(
            [np.asarray(layer[n]["b"]) for n in ("q", "k", "v")]))
        _linear(sd, f"{base}.attn.out_proj", layer["out"])
        _linear(sd, f"{base}.mlp.c_fc", layer["fc1"])
        _linear(sd, f"{base}.mlp.c_proj", layer["fc2"])
    _norm(sd, f"{prefix}ln_final", p["final_ln"])
    if "text_projection" in p:
        _put(sd, f"{prefix}text_projection", p["text_projection"]["w"])


def state_dict_from_jax(params: dict, cfg) -> StateDict:
    """JAX trees -> one fp32 state dict. cfg a PipelineConfig: {"unet",
    "controlnet" (absent for a ControlNet-free model), "vae", "clip"}, the
    text tower under OpenCLIP's names where cfg.clip.layer is "penultimate"
    (SD-2.x). cfg an SDXL configuration (models/sdxl.py:SDXLConfig):
    {"unet", "clip_l", "clip_g", "vae"} in sgm's layout."""
    sd: StateDict = {}
    unet_state_dict(sd, cfg.unet, params["unet"])
    vae_state_dict(sd, params["vae"])
    if hasattr(cfg, "clip_g"):
        clip_state_dict(sd, params["clip_l"], "conditioner.embedders.0.transformer.")
        openclip_state_dict(sd, params["clip_g"], "conditioner.embedders.1.model.")
        return sd
    if "controlnet" in params:
        controlnet_state_dict(sd, cfg.controlnet, params["controlnet"])
    if cfg.clip.layer == "penultimate":
        openclip_state_dict(sd, params["clip"])
    else:
        clip_state_dict(sd, params["clip"])
    return sd
