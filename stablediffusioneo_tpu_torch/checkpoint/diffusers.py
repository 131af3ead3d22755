"""Diffusers-layout checkpoints (counterpart of
stablediffusioneo_tpu/checkpoint/diffusers.py).

The port's modules keep the sgm / ldm single-file names
(`model.diffusion_model.*`, openaimodel naming) and OpenCLIP's for the
second SDXL tower; diffusers naming (`down_blocks.{i}.resnets.{j}.*`,
AutoencoderKL, HF text encoders) is the dominant distribution format of
SDXL-era checkpoints. As in the JAX package, no second converter exists: a
key bijection between the two namings is generated from the same
`encoder_plan` / `decoder_plan` (and VAE topology) the modules are built
from, and laid over the diffusers-named state dict as a view. The
converters return the sgm-named state dict of one network (names relative
to its module), which the port's strict loaders take
(checkpoint/accounting.py:load_strict, or under a checkpoint prefix
`LatentDiffusion.load_checkpoint`). Accounting holds through the view:
every diffusers key is consumed exactly once, and a key the bijection does
not name raises ConversionAccountingError naming itself, before any
tensor is read.

Naming correspondence (public convention, e.g. diffusers'
``convert_from_ckpt`` tables, re-derived here from the topology plans):

  UNet   time_embed.{0,2}        <-> time_embedding.linear_{1,2}
         label_emb.0.{0,2}       <-> add_embedding.linear_{1,2}   (SDXL)
         input_blocks.0.0        <-> conv_in
         input_blocks.{i}.0      <-> down_blocks.{L}.resnets.{j}
         input_blocks.{i}.1      <-> down_blocks.{L}.attentions.{j}
         input_blocks.{i}.0.op   <-> down_blocks.{L}.downsamplers.0.conv
         middle_block.{0,1,2}    <-> mid_block.{resnets.0,attentions.0,resnets.1}
         output_blocks.{i}.*     <-> up_blocks.{u}.*   (same level order)
         out.{0,2}               <-> conv_norm_out / conv_out
         ResBlock: in_layers.0/2 -> norm1/conv1, emb_layers.1 ->
         time_emb_proj, out_layers.0/3 -> norm2/conv2,
         skip_connection -> conv_shortcut; transformer inner names match.

  VAE    down.{i}.block.{j}      <-> down_blocks.{i}.resnets.{j}
         up.{i}                  <-> up_blocks.{n-1-i}   (REVERSED index)
         mid.block_1/attn_1/block_2 <-> mid_block.resnets.0/attentions.0/
         resnets.1; norm_out -> conv_norm_out; nin_shortcut ->
         conv_shortcut; attention q/k/v/proj_out (1x1 convs, (C, C, 1, 1))
         -> to_q/to_k/to_v/to_out.0 (linears, (C, C); reshaped in the view).

  CLIP   diffusers text_encoder is HF ``text_model.*`` naming, the port's
         CLIPTextModel's own. SDXL text_encoder_2 (HF
         CLIPTextModelWithProjection) becomes the port's OpenCLIPTextModel:
         q, k, v packed into attn.in_proj_{weight,bias} in that order,
         layer_norm1/2 -> ln_1/2, mlp.fc1/fc2 -> mlp.c_fc/c_proj,
         self_attn.out_proj -> attn.out_proj, the embeddings ->
         token_embedding / positional_embedding, final_layer_norm ->
         ln_final; text_projection.weight, stored (proj, d) for x @ W.T,
         becomes text_projection (d, proj) for x @ W.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Optional

import torch

from stablediffusioneo_tpu_torch.checkpoint.accounting import (
    HF_CLIP_IGNORES,
    ConversionAccountingError,
)
from stablediffusioneo_tpu_torch.config import CLIPTextConfig, UNetConfig, VAEConfig

__all__ = [
    "convert_clip_diffusers",
    "convert_clip_g_diffusers",
    "convert_unet_diffusers",
    "convert_vae_diffusers",
    "rename_sgm_to_diffusers",
    "sgm_view",
]

# sgm inner module name -> diffusers inner module name
_RES_INNER = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}
_VAE_RES_INNER = {
    "norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
    "nin_shortcut": "conv_shortcut",
}
_VAE_ATTN_INNER = {
    "norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v",
    "proj_out": "to_out.0",
}


def _unet_pairs(cfg: UNetConfig):
    """(sgm_base, diffusers_base, inner_map|None) module pairs, generated
    from the same plans the model is built from (models/unet.py)."""
    from stablediffusioneo_tpu_torch.models.unet import decoder_plan, encoder_plan

    pairs = [
        ("time_embed.0", "time_embedding.linear_1", None),
        ("time_embed.2", "time_embedding.linear_2", None),
        ("out.0", "conv_norm_out", None),
        ("out.2", "conv_out", None),
    ]
    if cfg.adm_in_channels:
        pairs += [("label_emb.0.0", "add_embedding.linear_1", None),
                  ("label_emb.0.2", "add_embedding.linear_2", None)]
    level = j = 0
    for i, desc in enumerate(encoder_plan(cfg)):
        if desc["kind"] == "conv":
            pairs.append((f"input_blocks.{i}.0", "conv_in", None))
        elif desc["kind"] == "down":
            pairs.append((f"input_blocks.{i}.0.op",
                          f"down_blocks.{level}.downsamplers.0.conv", None))
            level, j = level + 1, 0
        else:
            pairs.append((f"input_blocks.{i}.0",
                          f"down_blocks.{level}.resnets.{j}", _RES_INNER))
            if desc["attn"]:
                pairs.append((f"input_blocks.{i}.1",
                              f"down_blocks.{level}.attentions.{j}", None))
            j += 1
    pairs += [
        ("middle_block.0", "mid_block.resnets.0", _RES_INNER),
        ("middle_block.1", "mid_block.attentions.0", None),
        ("middle_block.2", "mid_block.resnets.1", _RES_INNER),
    ]
    u = j = 0
    for i, desc in enumerate(decoder_plan(cfg)):
        pairs.append((f"output_blocks.{i}.0",
                      f"up_blocks.{u}.resnets.{j}", _RES_INNER))
        up_idx = 1
        if desc["attn"]:
            pairs.append((f"output_blocks.{i}.1",
                          f"up_blocks.{u}.attentions.{j}", None))
            up_idx = 2
        if desc["up"]:
            pairs.append((f"output_blocks.{i}.{up_idx}.conv",
                          f"up_blocks.{u}.upsamplers.0.conv", None))
        j += 1
        if j == cfg.num_res_blocks + 1:
            u, j = u + 1, 0
    return pairs


def _vae_pairs(cfg: VAEConfig):
    n = len(cfg.ch_mult)
    pairs = [
        ("quant_conv", "quant_conv", None),
        ("post_quant_conv", "post_quant_conv", None),
    ]
    for tower in ("encoder", "decoder"):
        pairs += [
            (f"{tower}.conv_in", f"{tower}.conv_in", None),
            (f"{tower}.norm_out", f"{tower}.conv_norm_out", None),
            (f"{tower}.conv_out", f"{tower}.conv_out", None),
            (f"{tower}.mid.block_1", f"{tower}.mid_block.resnets.0",
             _VAE_RES_INNER),
            (f"{tower}.mid.attn_1", f"{tower}.mid_block.attentions.0",
             _VAE_ATTN_INNER),
            (f"{tower}.mid.block_2", f"{tower}.mid_block.resnets.1",
             _VAE_RES_INNER),
        ]
    for i in range(n):
        for j in range(cfg.num_res_blocks):
            pairs.append((f"encoder.down.{i}.block.{j}",
                          f"encoder.down_blocks.{i}.resnets.{j}",
                          _VAE_RES_INNER))
        if i != n - 1:
            pairs.append((f"encoder.down.{i}.downsample.conv",
                          f"encoder.down_blocks.{i}.downsamplers.0.conv",
                          None))
    for i in range(n):  # ldm up.{i} <-> diffusers up_blocks.{n-1-i}
        for j in range(cfg.num_res_blocks + 1):
            pairs.append((f"decoder.up.{i}.block.{j}",
                          f"decoder.up_blocks.{n - 1 - i}.resnets.{j}",
                          _VAE_RES_INNER))
        if i != 0:
            pairs.append((f"decoder.up.{i}.upsample.conv",
                          f"decoder.up_blocks.{n - 1 - i}.upsamplers.0.conv",
                          None))
    return pairs


def _expand(keys, pairs, reverse: bool = False) -> Dict[str, str]:
    """Full key->key map for the given key set. Forward: diffusers keys in,
    {sgm_key: diffusers_key} out. reverse=True: sgm keys in,
    {sgm_key: diffusers_key} out (same orientation, matched from the sgm
    side) — used to synthesize diffusers dicts from sgm-named ones."""
    by_base = []
    for sgm_b, diff_b, inner in pairs:
        from_b = sgm_b if reverse else diff_b
        inner_map = None
        if inner is not None:
            inner_map = inner if reverse else {v: k for k, v in inner.items()}
        by_base.append((from_b, sgm_b, diff_b, inner_map))
    by_base.sort(key=lambda t: -len(t[0]))

    out: Dict[str, str] = {}
    for key in keys:
        for from_b, sgm_b, diff_b, inner_map in by_base:
            if not (key == from_b or key.startswith(from_b + ".")):
                continue
            rem = key[len(from_b):].lstrip(".")
            if inner_map is not None and rem:
                mod, _, leaf = rem.rpartition(".")
                to_mod = inner_map.get(mod)
                if to_mod is None:
                    continue  # not this base (e.g. ambiguous prefix)
                rem_sgm = f"{mod if reverse else to_mod}.{leaf}"
                rem_diff = f"{to_mod if reverse else mod}.{leaf}"
            else:
                rem_sgm = rem_diff = rem
            sgm_key = f"{sgm_b}.{rem_sgm}" if rem_sgm else sgm_b
            diff_key = f"{diff_b}.{rem_diff}" if rem_diff else diff_b
            out[sgm_key] = diff_key
            break
    return out


class _SgmView(Mapping):
    """sgm-named read view over a diffusers-named state dict. Reads pass
    through to the underlying mapping; per-key value transforms handle the
    one layout difference (VAE attention linears <-> 1x1 convs)."""

    def __init__(self, sd: Mapping, key_map: Dict[str, str], transforms=()):
        self._sd = sd
        self._map = key_map
        self._tr = set(transforms)

    def __getitem__(self, k):
        v = self._sd[self._map[k]]
        if k in self._tr and v.dim() == 2:
            # diffusers stores VAE mid-attention q/k/v/proj as nn.Linear
            # (C, C); the ldm modules are 1x1 convs (C, C, 1, 1)
            v = v.reshape(*v.shape, 1, 1)
        return v

    def __iter__(self):
        return iter(self._map)

    def __len__(self):
        return len(self._map)

    def __contains__(self, k):
        return k in self._map


def _vae_attn_transform_keys(key_map: Dict[str, str]):
    return {k for k in key_map
            if ".attn_1." in k and k.endswith(".weight")}


def _head(keys, n: int = 15) -> str:
    keys = sorted(keys)
    return ", ".join(keys[:n]) + (f" (+{len(keys) - n} more)" if len(keys) > n else "")


def _orphans(tag: str, orphans: Iterable[str]) -> None:
    orphans = set(orphans)
    if orphans:
        raise ConversionAccountingError(
            f"[{tag}] incomplete load:\n  {len(orphans)} checkpoint keys never "
            f"consumed: {_head(orphans)}")


def sgm_view(sd: Mapping, cfg, component: str) -> Mapping:
    """sgm-named view over a diffusers-named ``unet`` or ``vae`` dict. Keys
    of `sd` the bijection does not name are not in the view (the converters
    raise on them)."""
    if component == "unet":
        km = _expand(sd, _unet_pairs(cfg))
        return _SgmView(sd, km)
    if component == "vae":
        km = _expand(sd, _vae_pairs(cfg))
        return _SgmView(sd, km, _vae_attn_transform_keys(km))
    raise ValueError(f"unknown component {component!r}")


def rename_sgm_to_diffusers(sd: Mapping, cfg, component: str) -> Dict:
    """Eagerly rename an sgm-named dict to diffusers naming (tests /
    export). VAE attention convs are flattened to the linear layout."""
    pairs = _unet_pairs(cfg) if component == "unet" else _vae_pairs(cfg)
    km = _expand(sd, pairs, reverse=True)
    unmapped = set(sd) - set(km)
    if unmapped:
        raise KeyError(f"sgm keys with no diffusers name: "
                       f"{sorted(unmapped)[:6]}")
    tr = _vae_attn_transform_keys(km) if component == "vae" else set()
    out = {}
    for sgm_k, diff_k in km.items():
        v = sd[sgm_k]
        if sgm_k in tr and v.dim() == 4:
            v = v.reshape(v.shape[0], v.shape[1])
        out[diff_k] = v
    return out


# ------------------------------------------------------------- converters


def _strict_view(sd: Mapping, cfg, component: str, tag: str,
                 dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    view = sgm_view(sd, cfg, component)
    # every diffusers key consumed exactly once: the map is one-to-one onto
    # the file's keys, or a key is an orphan
    _orphans(tag, set(sd) - set(view._map.values()))
    return {k: (view[k] if dtype is None else view[k].to(dtype)) for k in view}


def convert_unet_diffusers(sd: Mapping, cfg: UNetConfig,
                           dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Diffusers-named UNet2DConditionModel state dict -> the sgm-named
    state dict of the port's UNetModel(cfg) (load_strict(unet, ...), or
    under model.diffusion_model. in a full checkpoint), in `dtype` if
    given."""
    return _strict_view(sd, cfg, "unet", "unet_diffusers", dtype)


def convert_vae_diffusers(sd: Mapping, cfg: VAEConfig,
                          dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Diffusers-named AutoencoderKL state dict -> the ldm-named state dict
    of the port's AutoencoderKL(cfg)."""
    return _strict_view(sd, cfg, "vae", "vae_diffusers", dtype)


def _cast(sd: Mapping, dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    return {k: (v if dtype is None else v.to(dtype)) for k, v in sd.items()}


def convert_clip_diffusers(sd: Mapping, cfg: CLIPTextConfig,
                           dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Diffusers ``text_encoder`` is HF CLIPTextModel naming, the port's
    CLIPTextModel's own: the state dict as it is (in `dtype` if given); its
    position_ids leftover is named by accounting.HF_CLIP_IGNORES."""
    return _cast(sd, dtype)


_HF_LAYER = re.compile(r"text_model\.encoder\.layers\.(\d+)\.(.+)")
_HF_TO_OPENCLIP = {
    "layer_norm1.weight": "ln_1.weight", "layer_norm1.bias": "ln_1.bias",
    "layer_norm2.weight": "ln_2.weight", "layer_norm2.bias": "ln_2.bias",
    "self_attn.out_proj.weight": "attn.out_proj.weight",
    "self_attn.out_proj.bias": "attn.out_proj.bias",
    "mlp.fc1.weight": "mlp.c_fc.weight", "mlp.fc1.bias": "mlp.c_fc.bias",
    "mlp.fc2.weight": "mlp.c_proj.weight", "mlp.fc2.bias": "mlp.c_proj.bias",
}
_HF_TOP = {
    "text_model.embeddings.token_embedding.weight": "token_embedding.weight",
    "text_model.embeddings.position_embedding.weight": "positional_embedding",
    "text_model.final_layer_norm.weight": "ln_final.weight",
    "text_model.final_layer_norm.bias": "ln_final.bias",
}
_QKV = ("q_proj", "k_proj", "v_proj")  # OpenCLIP's in_proj order


def convert_clip_g_diffusers(sd: Mapping, cfg: CLIPTextConfig,
                             dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """SDXL diffusers ``text_encoder_2`` (HF CLIPTextModelWithProjection:
    text_model.* + text_projection.weight) -> the state dict of the port's
    OpenCLIPTextModel(cfg) (SDXL's clip_g, under
    conditioner.embedders.1.model. in an sgm file). HF stores the
    projection (proj, d) applied as x @ W.T; OpenCLIP keeps (d, proj) for
    x @ W, so it is transposed. Every key is consumed once (q, k, v of a
    layer into one packed in_proj); the position_ids leftover
    (HF_CLIP_IGNORES) is dropped, any other key raises."""
    ignores = [re.compile(p) for p in HF_CLIP_IGNORES]
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for k, v in sd.items():
        m = _HF_LAYER.fullmatch(k)
        if k in _HF_TOP:
            out[_HF_TOP[k]] = v
        elif k == "text_projection.weight":
            out["text_projection"] = v.t().contiguous()
        elif m and m.group(2) in _HF_TO_OPENCLIP:
            out[f"transformer.resblocks.{m.group(1)}.{_HF_TO_OPENCLIP[m.group(2)]}"] = v
        elif not any(p.fullmatch(k) for p in ignores):
            continue  # a layer's q / k / v (packed below), or an orphan
        used.add(k)
    for i in range(cfg.num_layers):
        base = f"text_model.encoder.layers.{i}.self_attn"
        for leaf in ("weight", "bias"):
            names = [f"{base}.{p}.{leaf}" for p in _QKV]
            if all(n in sd for n in names):
                out[f"transformer.resblocks.{i}.attn.in_proj_{leaf}"] = torch.cat(
                    [sd[n] for n in names], dim=0)
                used.update(names)
    _orphans("clip_g_diffusers", set(sd) - used)
    return _cast(out, dtype)
