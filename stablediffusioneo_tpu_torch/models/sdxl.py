"""SDXL base and refiner (counterpart of stablediffusioneo_tpu/models/sdxl.py):
configs, conditioning, the checkpoints' module trees and the loops.

The SDXL base architecture (Podell et al., arXiv:2307.01952) is built from
the port's blocks: the openaimodel UNet with a per-level transformer-depth
ladder and ADM conditioning (models/unet.py), the HF CLIP-L and OpenCLIP
bigG text towers (models/clip.py), the AutoencoderKL VAE, and the DDIM loop
(pipeline/ddim.py). `SDXL` holds them under sgm's top-level names:
  model.diffusion_model.*                  -> UNetModel
  conditioner.embedders.0.transformer.*    -> CLIPTextModel (CLIP-L)
  conditioner.embedders.1.model.*          -> OpenCLIPTextModel (bigG)
  first_stage_model.*                      -> AutoencoderKL
`SDXLRefiner` holds the refiner's three: the UNet, bigG alone at
`conditioner.embedders.0.model.*` (the aesthetic / size embedders 1 and 2 are
parameter-free fourier encoders) and the VAE.

Conditioning contract (sgm GeneralConditioner):
  context = concat(CLIP-L penultimate (B,77,768),
                   OpenCLIP-bigG penultimate (B,77,1280)) -> (B,77,2048)
  y       = concat(bigG pooled (B,1280),
                   fourier(add_time_ids: orig_hw + crop_tl + target_hw,
                           256 each) (B,1536)) -> (B,2816)
Refiner (one CFG branch a call: aesthetic score 6.0 for cond, 2.5 uncond):
  context = OpenCLIP-bigG penultimate (B,77,1280)
  y       = concat(bigG pooled (B,1280),
                   fourier(orig_hw + crop_tl + aesthetic score) (B,1280))
            -> (B,2560)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.checkpoint.accounting import (
    HF_CLIP_IGNORES,
    OPENCLIP_IGNORES,
    account_checkpoint,
    copy_checkpoint_,
    tree_ignores,
)
from stablediffusioneo_tpu_torch.config import (
    CLIPTextConfig,
    DiffusionConfig,
    UNetConfig,
    VAEConfig,
)
from stablediffusioneo_tpu_torch.models.clip import (
    CLIPTextModel,
    OpenCLIPTextModel,
    clip_text_apply,
    clip_text_apply_with_pooled,
)
from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.models.vae import AutoencoderKL
from stablediffusioneo_tpu_torch.ops.schedule import timestep_embedding
from stablediffusioneo_tpu_torch.pipeline.ddim import ddim_sample, stochastic_tail_entry
from stablediffusioneo_tpu_torch.runtime import profiling


# ------------------------------------------------------------------ configs


def sdxl_unet() -> UNetConfig:
    """SDXL-base UNet: 3 levels, depth ladder (0, 2, 10), ctx 2048,
    64-ch heads, ADM 2816 (sgm configs/inference/sd_xl_base.yaml)."""
    return UNetConfig(
        model_channels=320,
        channel_mult=(1, 2, 4),
        num_res_blocks=2,
        attention_resolutions=(2, 4),
        transformer_depth=(0, 2, 10),
        context_dim=2048,
        num_head_channels=64,
        adm_in_channels=2816,
    )


def clip_l_sdxl() -> CLIPTextConfig:
    """Tower 1: OpenAI CLIP-L, penultimate hidden WITHOUT the final LN
    (sgm FrozenCLIPEmbedder layer='hidden', layer_idx=11)."""
    return CLIPTextConfig(layer="penultimate_raw")


def clip_bigg_sdxl() -> CLIPTextConfig:
    """Tower 2: OpenCLIP bigG/14 text tower (1280 wide, 32 layers,
    penultimate hidden raw; pooled output through text_projection)."""
    return CLIPTextConfig(
        hidden_size=1280, intermediate_size=5120, num_layers=32,
        num_heads=20, layer="penultimate_raw", act="gelu",
        projection_dim=1280,
    )


def sdxl_vae() -> VAEConfig:
    """Same AutoencoderKL topology as SD-1.x; SDXL scale factor 0.13025."""
    return VAEConfig(scale_factor=0.13025)


@dataclasses.dataclass(frozen=True)
class SDXLConfig:
    unet: UNetConfig = dataclasses.field(default_factory=sdxl_unet)
    clip_l: CLIPTextConfig = dataclasses.field(default_factory=clip_l_sdxl)
    clip_g: CLIPTextConfig = dataclasses.field(default_factory=clip_bigg_sdxl)
    vae: VAEConfig = dataclasses.field(default_factory=sdxl_vae)
    diffusion: DiffusionConfig = dataclasses.field(
        default_factory=DiffusionConfig)
    dtype: str = "bfloat16"


def tiny_sdxl() -> SDXLConfig:
    """Miniature SDXL topology for tests: same structure, tiny widths."""
    unet = UNetConfig(
        model_channels=32, channel_mult=(1, 2, 4), num_res_blocks=2,
        attention_resolutions=(2, 4), transformer_depth=(0, 1, 2),
        context_dim=48, num_head_channels=16, adm_in_channels=16 + 6 * 8,
        groups=8,
    )
    mk = lambda d, p: CLIPTextConfig(  # noqa: E731
        vocab_size=1000, hidden_size=d, intermediate_size=2 * d,
        num_layers=2, num_heads=2, max_length=16, layer="penultimate_raw",
        act="gelu", projection_dim=p)
    return SDXLConfig(
        unet=unet,
        clip_l=mk(32, None),
        clip_g=mk(16, 16),
        vae=VAEConfig(ch=16, ch_mult=(1, 1, 1, 1), num_res_blocks=1,
                      groups=8, scale_factor=0.13025),
        dtype="float32",
    )


# ------------------------------------------------------------------ modules

# (prefix, documented leftovers) of each tree of an sgm SDXL-base file, the
# JAX load_sdxl_pipeline's jobs
SDXL_TREES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("model.diffusion_model.", ()),
    ("conditioner.embedders.0.transformer.", HF_CLIP_IGNORES),
    ("conditioner.embedders.1.model.", OPENCLIP_IGNORES),
    ("first_stage_model.", ()),
)


class SDXL(nn.Module):
    """The four networks of an SDXL-base checkpoint under sgm's names."""

    def __init__(self, cfg: SDXLConfig):
        super().__init__()
        self.cfg = cfg
        self.model = nn.Module()
        self.model.diffusion_model = UNetModel(cfg.unet)
        self.conditioner = nn.Module()
        self.conditioner.embedders = nn.ModuleList([nn.Module(), nn.Module()])
        self.conditioner.embedders[0].transformer = CLIPTextModel(cfg.clip_l)
        self.conditioner.embedders[1].model = OpenCLIPTextModel(cfg.clip_g)
        self.first_stage_model = AutoencoderKL(cfg.vae)

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    @property
    def clip_l(self) -> CLIPTextModel:
        return self.conditioner.embedders[0].transformer

    @property
    def clip_g(self) -> OpenCLIPTextModel:
        return self.conditioner.embedders[1].model

    @property
    def vae(self) -> AutoencoderKL:
        return self.first_stage_model

    def load_checkpoint(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Strict load of an sgm-layout state dict (see ControlLDM's)."""
        account_checkpoint(self, state_dict, tree_ignores(SDXL_TREES)).assert_complete(
            "SDXL")
        copy_checkpoint_(self, state_dict)


# -------------------------------------------------------------- conditioning


def add_time_ids(
    original_size: Tuple[int, int],
    crop_coords: Tuple[int, int],
    target_size: Tuple[int, int],
    batch: int,
    fourier_dim: int = 256,
    device="cpu",
) -> torch.Tensor:
    """The SDXL micro-conditioning vector: fourier features of
    (orig_h, orig_w, crop_top, crop_left, target_h, target_w), fourier_dim
    each (sgm ConcatTimestepEmbedderND). Returns (B, 6 * fourier_dim) fp32."""
    ids = torch.tensor(list(original_size) + list(crop_coords) + list(target_size),
                       dtype=torch.float32, device=device)
    return timestep_embedding(ids, fourier_dim).reshape(1, -1).repeat(batch, 1)


def sdxl_tokenize(tokenizer, texts) -> Tuple[np.ndarray, np.ndarray]:
    """Per-tower token ids from ONE BPE tokenizer (CLIP-L and bigG share
    the 49408 vocab; only the padding convention differs):
      tower 1 (CLIP-L / HF): pad with EOT after the first EOT
      tower 2 (bigG / open_clip.tokenize): pad with ZEROS after EOT
    Returns (ids_l, ids_g), each (B, 77) int32."""
    ids_l = np.asarray(tokenizer(texts))
    ids_g = ids_l.copy()
    for row in ids_g:
        eots = np.nonzero(row == tokenizer.eot)[0]
        if len(eots) > 1:
            row[eots[0] + 1:] = 0
    return ids_l, ids_g


def sdxl_conditioning(
    model: SDXL,
    ids_l: torch.Tensor,
    ids_g: torch.Tensor,
    size_hw: Tuple[int, int],
    original_size: Optional[Tuple[int, int]] = None,
    crop_coords: Tuple[int, int] = (0, 0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context (B, 77, 2048) in the towers' dtype, y (B, 2816) fp32) from
    both towers' token ids (sdxl_tokenize). size_hw is the TARGET size;
    original_size defaults to it (the no-crop, native-size conditioning that
    sampling uses). One bigG forward gives both its halves. The `text.encode`
    span, device time on the current stream."""
    cfg = model.cfg
    with profiling.span("text.encode", device=ids_l.device):
        hl = clip_text_apply(model.clip_l, ids_l)
        hg, pooled = clip_text_apply_with_pooled(model.clip_g, ids_g)
        context = torch.cat([hl, hg], dim=-1)
        proj = cfg.clip_g.projection_dim or cfg.clip_g.hidden_size
        tids = add_time_ids(original_size or size_hw, crop_coords, size_hw, ids_l.shape[0],
                            fourier_dim=(cfg.unet.adm_in_channels - proj) // 6,
                            device=pooled.device)
        return context, torch.cat([pooled.float(), tids], dim=-1)


# ------------------------------------------------------------------ sampler


def sdxl_txt2img(
    unet: UNetModel,
    schedule: Dict[str, np.ndarray],
    x_T: torch.Tensor,
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    y_cond: torch.Tensor,
    y_uncond: torch.Tensor,
    scale,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None,
    parameterization: str = "eps",
    cfg_rescale: float = 0.0,
    inpaint_latent: Optional[torch.Tensor] = None,
    inpaint_mask: Optional[torch.Tensor] = None,
    inpaint_noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """The DDIM txt2img loop of the ControlNet-free SDXL base (the JAX
    sdxl_txt2img_scan): CFG as one batch-2 UNet evaluation a step with the
    ADM y beside the context, the context K/V hoisted, the fp32 update, x
    carried in the nets' dtype, eps or v, cfg_rescale; inpaint_latent /
    inpaint_mask (B, h, w, 1; 1 = generate) the blended-latent inpaint with
    `inpaint_noise[i]` (else draws from `generator`). Returns fp32 NHWC
    x_0 latents (pipeline/ddim.py:ddim_sample)."""
    return ddim_sample(unet, None, schedule, x_T, None, ctx_cond, ctx_uncond, scale,
                       None, generator=generator, noise=noise, dtype=dtype,
                       parameterization=parameterization, inpaint_latent=inpaint_latent,
                       inpaint_mask=inpaint_mask, inpaint_noise=inpaint_noise,
                       cfg_rescale=cfg_rescale, y_cond=y_cond, y_uncond=y_uncond)


def sdxl_img2img_latents(
    unet: UNetModel,
    schedule: Dict[str, np.ndarray],
    z0: torch.Tensor,
    t_enc: int,
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    y_cond: torch.Tensor,
    y_uncond: torch.Tensor,
    scale,
    renoise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None,
    parameterization: str = "eps",
    cfg_rescale: float = 0.0,
) -> torch.Tensor:
    """SDXL-base img2img: z0 forward-diffused to the entry step of the last
    t_enc entries of the schedule (pipeline/ddim.py:stochastic_tail_entry,
    with `renoise`, else a draw from `generator`), then that tail denoised
    by sdxl_txt2img."""
    tail, x_T = stochastic_tail_entry(schedule, t_enc, z0, renoise, generator)
    return sdxl_txt2img(unet, tail, x_T, ctx_cond, ctx_uncond, y_cond, y_uncond, scale,
                        generator=generator, noise=noise, dtype=dtype,
                        parameterization=parameterization, cfg_rescale=cfg_rescale)


# ------------------------------------------------------------------ refiner


def sdxl_refiner_unet() -> UNetConfig:
    """SDXL-refiner UNet (sgm configs/inference/sd_xl_refiner.yaml): 384 base
    channels over 4 levels, transformer depth 4 at the ds-2/4 attention sites
    and in the middle block, bigG-only context (1280), ADM 2560 (pooled 1280
    + 5 x 256 aesthetic/size fourier ids). The ladder (0, 4, 4, 4) leaves
    level 3 (ds 8) without attention while the middle block takes
    depth_for(last level) = 4 (models/unet.py:encoder_plan)."""
    return UNetConfig(
        model_channels=384,
        channel_mult=(1, 2, 4, 4),
        num_res_blocks=2,
        attention_resolutions=(2, 4),
        transformer_depth=(0, 4, 4, 4),
        context_dim=1280,
        num_head_channels=64,
        adm_in_channels=2560,
    )


@dataclasses.dataclass(frozen=True)
class SDXLRefinerConfig:
    """The refiner conditions on the bigG tower ONLY (no CLIP-L) and swaps
    the size/crop micro-conditioning tail for (orig_hw, crop_tl,
    aesthetic_score)."""

    unet: UNetConfig = dataclasses.field(default_factory=sdxl_refiner_unet)
    clip_g: CLIPTextConfig = dataclasses.field(default_factory=clip_bigg_sdxl)
    vae: VAEConfig = dataclasses.field(default_factory=sdxl_vae)
    diffusion: DiffusionConfig = dataclasses.field(
        default_factory=DiffusionConfig)
    dtype: str = "bfloat16"


def tiny_sdxl_refiner() -> SDXLRefinerConfig:
    """Miniature refiner topology: 4 levels, no-attn top level feeding a
    transformer middle block, bigG-only conditioning."""
    unet = UNetConfig(
        model_channels=32, channel_mult=(1, 1, 2, 2), num_res_blocks=1,
        attention_resolutions=(2, 4), transformer_depth=(0, 1, 1, 1),
        context_dim=16, num_head_channels=16, adm_in_channels=16 + 5 * 8,
        groups=8,
    )
    return SDXLRefinerConfig(
        unet=unet,
        clip_g=CLIPTextConfig(
            vocab_size=1000, hidden_size=16, intermediate_size=32,
            num_layers=2, num_heads=2, max_length=16,
            layer="penultimate_raw", act="gelu", projection_dim=16),
        vae=VAEConfig(ch=16, ch_mult=(1, 1, 1, 1), num_res_blocks=1,
                      groups=8, scale_factor=0.13025),
        dtype="float32",
    )


# (prefix, documented leftovers) of each tree of an sgm SDXL-refiner file,
# the JAX load_sdxl_refiner_pipeline's jobs
SDXL_REFINER_TREES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("model.diffusion_model.", ()),
    ("conditioner.embedders.0.model.", OPENCLIP_IGNORES),
    ("first_stage_model.", ()),
)


class SDXLRefiner(nn.Module):
    """The three networks of an SDXL-refiner checkpoint under sgm's names."""

    def __init__(self, cfg: SDXLRefinerConfig):
        super().__init__()
        self.cfg = cfg
        self.model = nn.Module()
        self.model.diffusion_model = UNetModel(cfg.unet)
        self.conditioner = nn.Module()
        self.conditioner.embedders = nn.ModuleList([nn.Module()])
        self.conditioner.embedders[0].model = OpenCLIPTextModel(cfg.clip_g)
        self.first_stage_model = AutoencoderKL(cfg.vae)

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    @property
    def clip_g(self) -> OpenCLIPTextModel:
        return self.conditioner.embedders[0].model

    @property
    def vae(self) -> AutoencoderKL:
        return self.first_stage_model

    def load_checkpoint(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Strict load of an sgm-layout refiner state dict (see ControlLDM's)."""
        account_checkpoint(self, state_dict, tree_ignores(SDXL_REFINER_TREES)
                           ).assert_complete("SDXLRefiner")
        copy_checkpoint_(self, state_dict)


def refiner_add_time_ids(
    original_size: Tuple[int, int],
    crop_coords: Tuple[int, int],
    aesthetic_score: float,
    batch: int,
    fourier_dim: int = 256,
    *,
    device,
) -> torch.Tensor:
    """Refiner micro-conditioning: fourier features of (orig_h, orig_w,
    crop_top, crop_left, aesthetic_score), 5 ids (sgm's refiner conditioner:
    the target-size pair is replaced by the aesthetic score). Returns
    (B, 5 * fourier_dim) fp32 on `device`."""
    ids = torch.tensor(list(original_size) + list(crop_coords) + [aesthetic_score],
                       dtype=torch.float32, device=device)
    return timestep_embedding(ids, fourier_dim).reshape(1, -1).repeat(batch, 1)


def sdxl_refiner_conditioning(
    model: SDXLRefiner,
    ids_g: torch.Tensor,
    size_hw: Tuple[int, int],
    aesthetic_score: float = 6.0,
    original_size: Optional[Tuple[int, int]] = None,
    crop_coords: Tuple[int, int] = (0, 0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context (B, 77, 1280) in the tower's dtype, y (B, 2560) fp32) for ONE
    CFG branch: the branches differ in aesthetic score too (sgm's defaults,
    6.0 for cond, 2.5 for uncond), so call once a branch. ids_g uses bigG's
    padding convention (sdxl_tokenize's second output); the time ids are made
    on the tower's device."""
    cfg = model.cfg
    hg, pooled = clip_text_apply_with_pooled(model.clip_g, ids_g)
    proj = cfg.clip_g.projection_dim or cfg.clip_g.hidden_size
    tids = refiner_add_time_ids(original_size or size_hw, crop_coords, aesthetic_score,
                                ids_g.shape[0],
                                fourier_dim=(cfg.unet.adm_in_channels - proj) // 5,
                                device=pooled.device)
    return hg, torch.cat([pooled.float(), tids], dim=-1)


# The refine is SDXL img2img with the refiner's UNet and conditioning (the
# JAX sdxl_refine_latents and sdxl_img2img_latents are one loop): the base
# model's latents z0 forward-diffused to the entry step of the last t_enc
# entries of the schedule, the tail denoised, in latent space (both stages
# share the VAE, so there is no decode and re-encode between them).
sdxl_refine_latents = sdxl_img2img_latents
