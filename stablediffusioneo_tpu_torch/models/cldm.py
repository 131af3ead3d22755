"""The four networks under the checkpoint's top-level names (ControlLDM,
cldm/cldm.py), and the seeded initialiser for runs without real weights.

A `control_sd15_*.pth` state dict loads into `ControlLDM` by name:
  model.diffusion_model.*          -> UNetModel
  control_model.*                  -> ControlNet
  first_stage_model.*              -> AutoencoderKL (decoder half)
  cond_stage_model.transformer.*   -> CLIPTextModel
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch
import torch.nn as nn

from stablediffusioneo_tpu.config import PipelineConfig
from stablediffusioneo_tpu_torch.models.clip import CLIPTextModel
from stablediffusioneo_tpu_torch.models.controlnet import ControlNet
from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.models.vae import AutoencoderKL

# checkpoint keys the port reads nothing from: the VAE encoder half (it
# comes with img2img) and HF CLIP's position-id buffer
UNUSED_KEYS = re.compile(
    r"^(first_stage_model\.(encoder\.|quant_conv\.)"
    r"|cond_stage_model\.transformer\.text_model\.embeddings\.position_ids$)")


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
        parameter must be present, and every extra key must be one the port
        knowingly skips (UNUSED_KEYS)."""
        sd = {k: v for k, v in state_dict.items() if not UNUSED_KEYS.match(k)}
        missing, unexpected = self.load_state_dict(sd, strict=False)
        if missing or unexpected:
            raise KeyError(f"checkpoint mismatch: missing {missing[:8]} "
                           f"({len(missing)}), unexpected {unexpected[:8]} "
                           f"({len(unexpected)})")


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
