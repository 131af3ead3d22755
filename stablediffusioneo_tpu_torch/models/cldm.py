"""The four networks under the checkpoint's top-level names (ControlLDM,
cldm/cldm.py), and the seeded initialiser for runs without real weights.

A `control_sd15_*.pth` state dict loads into `ControlLDM` by name:
  model.diffusion_model.*          -> UNetModel
  control_model.*                  -> ControlNet
  first_stage_model.*              -> AutoencoderKL (encoder and decoder)
  cond_stage_model.transformer.*   -> CLIPTextModel
Every other key must be one that checkpoint/accounting.py:SD_KNOWN_UNUSED
documents (schedule buffers, logvar, model_ema.*, CLIP's position_ids).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.checkpoint.accounting import account_checkpoint
from stablediffusioneo_tpu_torch.config import PipelineConfig
from stablediffusioneo_tpu_torch.models.clip import CLIPTextModel
from stablediffusioneo_tpu_torch.models.controlnet import ControlNet
from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.models.vae import AutoencoderKL


class ControlLDM(nn.Module):
    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        self.cfg = cfg
        self.model = nn.Module()
        self.model.diffusion_model = UNetModel(cfg.unet)
        self.control_model = ControlNet(cfg.controlnet)
        self.first_stage_model = AutoencoderKL(cfg.vae)
        self.cond_stage_model = nn.Module()
        self.cond_stage_model.transformer = CLIPTextModel(cfg.clip)

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    @property
    def clip(self) -> CLIPTextModel:
        return self.cond_stage_model.transformer

    def load_checkpoint(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Strict load of a full ControlNet checkpoint state dict: every
        parameter must be present with its shape, and every extra key must
        match SD_KNOWN_UNUSED (checkpoint/accounting.py), else
        ConversionAccountingError names the keys."""
        account_checkpoint(self, state_dict).assert_complete("ControlLDM")
        self.load_state_dict({k: state_dict[k] for k in self.state_dict()})


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from `generator` (on the parameters' device).

    Convs and linears take torch's default U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weight and bias (the JAX package's ops/layers.py initialisers). The
    convs a fresh SD net zero-initialises (ResBlock conv2, proj_out, the
    ControlNet taps and the hint block's last conv, the UNet's out conv) get
    the same non-zero draw, as a trained net has non-zero weights there, so
    a broken control path shows in the output. Norms start at weight 1,
    bias 0; CLIP's token and position embeddings at N(0, 0.02) and N(0, 0.01).
    """
    done = set()
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            for p in (m.weight, m.bias):
                if p is not None:
                    p.uniform_(-bound, bound, generator=generator)
                    done.add(id(p))
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            done.update((id(m.weight), id(m.bias)))
        elif isinstance(m, nn.Embedding):
            std = 0.01 if name.endswith("position_embedding") else 0.02
            m.weight.normal_(0.0, std, generator=generator)
            done.add(id(m.weight))
    left = [n for n, p in model.named_parameters() if id(p) not in done]
    if left:
        raise RuntimeError(f"init_weights left parameters unset: {left[:8]}")
