"""Stable Diffusion 3.5 Medium: its configuration, its five networks under
the checkpoint's names, and its conditioning.

`SD3` holds them as the single-file layout with the text encoders included
(sd3.5_medium.safetensors, with text_encoders/{clip_l, clip_g,
t5xxl_fp16}.safetensors under `text_encoders.<name>.transformer.`):
  model.diffusion_model.*                 -> MMDiTX (models/mmdit.py)
  first_stage_model.*                     -> AutoencoderKL, 16 channels
                                             (config.FlowVAEConfig)
  text_encoders.clip_l.transformer.*      -> CLIPTextModel + projection (HF)
  text_encoders.clip_g.transformer.*      -> CLIPTextModel + projection (HF bigG)
  text_encoders.t5xxl.transformer.*       -> T5Encoder (T5 v1.1 XXL)

Conditioning contract (diffusers StableDiffusion3Pipeline.encode_prompt):
  clip    = concat(CLIP-L hidden state -2 (B, 77, 768),
                   bigG hidden state -2 (B, 77, 1280)) -> (B, 77, 2048),
            zero-padded to T5's width (B, 77, 4096)
  context = concat(clip, T5-XXL last state (B, 256, 4096), no attention
            mask) over tokens -> (B, 333, 4096)
  pooled  = concat(CLIP-L pooled projected (B, 768),
                   bigG pooled projected (B, 1280)) -> (B, 2048)
Token ids come in as the towers take them: CLIP-L padded with EOT after the
first EOT, bigG with zeros (as SDXL's, models/sdxl.py:sdxl_tokenize), T5
with EOS 1 then pad 0. The sampler is pipeline/flow_match.py; the captured
request is runtime/engine.py:sd3_sample_decode_engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.checkpoint.accounting import (
    HF_CLIP_IGNORES,
    account_checkpoint,
    copy_checkpoint_,
    tree_ignores,
)
from stablediffusioneo_tpu_torch.config import CLIPTextConfig, FlowVAEConfig
from stablediffusioneo_tpu_torch.models.clip import CLIPTextModel, clip_text_apply_with_pooled
from stablediffusioneo_tpu_torch.models.mmdit import MMDiTConfig, MMDiTX
from stablediffusioneo_tpu_torch.models.t5 import T5Config, T5Encoder, t5_encode
from stablediffusioneo_tpu_torch.models.vae import AutoencoderKL
from stablediffusioneo_tpu_torch.runtime import profiling


def clip_l_sd3() -> CLIPTextConfig:
    """CLIP ViT-L/14 with its projection (text_encoder/config.json),
    hidden state -2 as it is."""
    return CLIPTextConfig(layer="penultimate_raw", projection_dim=768)


def clip_g_sd3() -> CLIPTextConfig:
    """OpenCLIP bigG/14's text tower in HF layout (text_encoder_2)."""
    return CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_layers=32,
                          num_heads=20, layer="penultimate_raw", act="gelu",
                          projection_dim=1280)


def t5_xxl() -> T5Config:
    """google/t5-v1_1-xxl's encoder (text_encoder_3), 256 tokens."""
    return T5Config(d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
                    max_length=256)


@dataclasses.dataclass(frozen=True)
class SD3Config:
    transformer: MMDiTConfig = dataclasses.field(default_factory=MMDiTConfig)
    clip_l: CLIPTextConfig = dataclasses.field(default_factory=clip_l_sd3)
    clip_g: CLIPTextConfig = dataclasses.field(default_factory=clip_g_sd3)
    t5: T5Config = dataclasses.field(default_factory=t5_xxl)
    vae: FlowVAEConfig = dataclasses.field(default_factory=FlowVAEConfig)
    shift: float = 3.0                 # scheduler_config.json
    dtype: str = "bfloat16"


def tiny_sd3() -> SD3Config:
    """Miniature SD3 for tests: 4 blocks, the first 2 dual-attention, the
    last pre-only; towers of 16 tokens (T5 24) and 1,000 ids."""
    mk = lambda d, p, act: CLIPTextConfig(  # noqa: E731
        vocab_size=1000, hidden_size=d, intermediate_size=2 * d, num_layers=2,
        num_heads=2, max_length=16, layer="penultimate_raw", act=act, projection_dim=p)
    return SD3Config(
        transformer=MMDiTConfig(sample_size=8, num_layers=4, attention_head_dim=16,
                                num_attention_heads=2, joint_attention_dim=64,
                                caption_projection_dim=32, pooled_projection_dim=40,
                                pos_embed_max_size=12, dual_attention_layers=(0, 1)),
        clip_l=mk(16, 16, "quick_gelu"), clip_g=mk(32, 24, "gelu"),
        t5=T5Config(vocab_size=300, d_model=64, d_kv=8, d_ff=96, num_layers=2,
                    num_heads=4, max_length=24),
        vae=FlowVAEConfig(ch=16, ch_mult=(1, 1, 1, 1), num_res_blocks=1, groups=8),
        dtype="float32",
    )


# (prefix, documented leftovers) of each tree: HF towers may carry
# position_ids; T5 its second copy of the token embedding; the MMDiT its
# fixed sin-cos position table (computed, models/mmdit.py)
SD3_TREES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("model.diffusion_model.", (r"pos_embed",)),
    ("first_stage_model.", ()),
    ("text_encoders.clip_l.transformer.", HF_CLIP_IGNORES),
    ("text_encoders.clip_g.transformer.", HF_CLIP_IGNORES),
    ("text_encoders.t5xxl.transformer.", (r"encoder\.embed_tokens\.weight",)),
)


class SD3(nn.Module):
    """The five networks of an SD 3.5 checkpoint under their names."""

    def __init__(self, cfg: SD3Config):
        super().__init__()
        self.cfg = cfg
        self.model = nn.Module()
        self.model.diffusion_model = MMDiTX(cfg.transformer)
        self.first_stage_model = AutoencoderKL(cfg.vae)
        self.text_encoders = nn.Module()
        for name, tower in (("clip_l", CLIPTextModel(cfg.clip_l)),
                            ("clip_g", CLIPTextModel(cfg.clip_g)),
                            ("t5xxl", T5Encoder(cfg.t5))):
            setattr(self.text_encoders, name, nn.Module())
            getattr(self.text_encoders, name).transformer = tower

    @property
    def mmdit(self) -> MMDiTX:
        return self.model.diffusion_model

    @property
    def vae(self) -> AutoencoderKL:
        return self.first_stage_model

    @property
    def clip_l(self) -> CLIPTextModel:
        return self.text_encoders.clip_l.transformer

    @property
    def clip_g(self) -> CLIPTextModel:
        return self.text_encoders.clip_g.transformer

    @property
    def t5(self) -> T5Encoder:
        return self.text_encoders.t5xxl.transformer

    def load_checkpoint(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Strict load: every key of the model present with its shape, every
        key of the file consumed or a documented leftover (SD3_TREES)."""
        account_checkpoint(self, state_dict, tree_ignores(SD3_TREES)).assert_complete("SD3")
        copy_checkpoint_(self, state_dict)


def sd3_conditioning(model: SD3, ids_l: torch.Tensor, ids_g: torch.Tensor,
                     ids_t5: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context (B, 77 + T5 tokens, T5 width), pooled (B, 768 + 1280)) in the
    towers' dtype, from each tower's ids (see the module's docstring). The
    `text.encode` span, device time on the current stream; T5 inside its own
    `text.t5` span (models/t5.py:t5_encode)."""
    with profiling.span("text.encode", device=ids_l.device):
        hl, pl = clip_text_apply_with_pooled(model.clip_l, ids_l)
        hg, pg = clip_text_apply_with_pooled(model.clip_g, ids_g)
        t5 = t5_encode(model.t5, ids_t5)
        clip = torch.cat([hl, hg], dim=-1)
        clip = F.pad(clip, (0, t5.shape[-1] - clip.shape[-1]))
        return torch.cat([clip, t5], dim=1), torch.cat([pl, pg], dim=-1)
