"""The networks under the checkpoints' top-level names, and the seeded
initialiser for runs without real weights.

A `control_sd15_*.pth` state dict loads into `ControlLDM` by name:
  model.diffusion_model.*          -> UNetModel
  control_model.*                  -> ControlNet (control_model.<i>.* for
                                      net i of a multi-ControlNet model)
  first_stage_model.*              -> AutoencoderKL (encoder and decoder)
  cond_stage_model.transformer.*   -> CLIPTextModel (SD-1.x)
  cond_stage_model.model.*         -> OpenCLIPTextModel (SD-2.x: where
                                      cfg.clip.layer is "penultimate", the
                                      JAX loaders' rule)
`LatentDiffusion` is the same without the ControlNet: a plain SD-1.x / 2.x
checkpoint (v1-5-pruned, v2-1_768-ema-pruned). Every other key must be one
that checkpoint/accounting.py:SD_KNOWN_UNUSED documents (schedule buffers,
logvar, model_ema.*, CLIP's position_ids, OpenCLIP's mask and logit scale).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.checkpoint.accounting import (
    account_checkpoint,
    copy_checkpoint_,
)
from stablediffusioneo_tpu_torch.config import PipelineConfig
from stablediffusioneo_tpu_torch.models.clip import (
    CLIPTextModel,
    OpenCLIPAttention,
    OpenCLIPTextModel,
)
from stablediffusioneo_tpu_torch.models.controlnet import ControlNet
from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.models.vae import AutoencoderKL


def openclip_text(cfg: PipelineConfig) -> bool:
    """Whether the family's text tower is OpenCLIP's (SD-2.x)."""
    return cfg.clip.layer == "penultimate"


class LatentDiffusion(nn.Module):
    """UNet, VAE and text tower of a ControlNet-free SD checkpoint."""

    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        self.cfg = cfg
        self.model = nn.Module()
        self.model.diffusion_model = UNetModel(cfg.unet)
        self.first_stage_model = AutoencoderKL(cfg.vae)
        self.cond_stage_model = nn.Module()
        if openclip_text(cfg):
            self.cond_stage_model.model = OpenCLIPTextModel(cfg.clip)
        else:
            self.cond_stage_model.transformer = CLIPTextModel(cfg.clip)

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    @property
    def clip(self) -> nn.Module:
        return getattr(self.cond_stage_model,
                       "model" if openclip_text(self.cfg) else "transformer")

    def load_checkpoint(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Strict load of a full checkpoint state dict: every parameter must
        be present with its shape (a Linear-stored proj_in / proj_out fits
        its 1x1 conv), and every extra key must match SD_KNOWN_UNUSED
        (checkpoint/accounting.py), else ConversionAccountingError names the
        keys."""
        account_checkpoint(self, state_dict).assert_complete(type(self).__name__)
        copy_checkpoint_(self, state_dict)


class ControlLDM(LatentDiffusion):
    """n_controlnets > 1: multi-ControlNet (the JAX package's tuple of
    ControlNet trees), the nets in an nn.ModuleList under
    control_model.<i>.*, their scaled taps summed into the UNet
    (models/controlnet.py:controlled_unet_forward). One net keeps the
    checkpoint's control_model.* names."""

    def __init__(self, cfg: PipelineConfig, n_controlnets: int = 1):
        super().__init__(cfg)
        if n_controlnets < 1:
            raise ValueError(f"n_controlnets must be >= 1, got {n_controlnets}")
        self.control_model = (ControlNet(cfg.controlnet) if n_controlnets == 1 else
                              nn.ModuleList([ControlNet(cfg.controlnet)
                                             for _ in range(n_controlnets)]))

    @property
    def control(self):
        """What the loops take as `control`: the ControlNet, or a tuple of
        them (multi-ControlNet)."""
        cm = self.control_model
        return tuple(cm) if isinstance(cm, nn.ModuleList) else cm


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from `generator` (on the parameters' device).

    Convs and linears take torch's default U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weight and bias (the JAX package's ops/layers.py initialisers), as
    does OpenCLIP's packed q/k/v projection. The convs a fresh SD net
    zero-initialises (ResBlock conv2, proj_out, the ControlNet taps and the
    hint block's last conv, the UNet's out conv) get the same non-zero draw,
    as a trained net has non-zero weights there, so a broken control path
    shows in the output. Norms start at weight 1, bias 0; the text towers'
    token and position embeddings at N(0, 0.02) and N(0, 0.01), an OpenCLIP
    text_projection (d, proj) at N(0, 1 / d), as the JAX init_clip_text.
    """
    done = set()

    def fill(p, bound):
        p.uniform_(-bound, bound, generator=generator)
        done.add(id(p))

    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    fill(p, bound)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            done.update((id(m.weight), id(m.bias)))
        elif isinstance(m, nn.Embedding):
            std = 0.01 if name.endswith("position_embedding") else 0.02
            m.weight.normal_(0.0, std, generator=generator)
            done.add(id(m.weight))
        elif isinstance(m, OpenCLIPAttention):
            bound = 1.0 / math.sqrt(m.in_proj_weight.shape[1])
            fill(m.in_proj_weight, bound)
            fill(m.in_proj_bias, bound)
        elif isinstance(m, OpenCLIPTextModel):
            m.positional_embedding.normal_(0.0, 0.01, generator=generator)
            done.add(id(m.positional_embedding))
            if m.cfg.projection_dim:
                m.text_projection.normal_(0.0, m.cfg.hidden_size ** -0.5,
                                          generator=generator)
                done.add(id(m.text_projection))
    left = [n for n, p in model.named_parameters() if id(p) not in done]
    if left:
        raise RuntimeError(f"init_weights left parameters unset: {left[:8]}")
