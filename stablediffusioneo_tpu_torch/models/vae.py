"""AutoencoderKL decoder (counterpart of stablediffusioneo_tpu/models/vae.py).

Names follow `first_stage_model.*` (ldm/modules/diffusionmodules/model.py):
post_quant_conv and the decoder tower with its single-head mid-block
attention. All GroupNorms use eps 1e-6 (cfg.norm_eps). The encoder and
quant_conv come with img2img (ROADMAP queue 1: The other samplers); their
checkpoint keys are skipped at load.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.config import VAEConfig
from stablediffusioneo_tpu_torch.models.unet import GroupNorm32, conv1x1_as_linear
from stablediffusioneo_tpu_torch.ops.attention import attention
from stablediffusioneo_tpu_torch.ops.dispatch import const_tensor
from stablediffusioneo_tpu_torch.ops.layers import nchw, nhwc, upsample_nearest_2x


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: VAEConfig):
        super().__init__()
        self.norm1 = GroupNorm32(cfg.groups, cin, eps=cfg.norm_eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm32(cfg.groups, cout, eps=cfg.norm_eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(self.norm1(x, swish=True))
        h = self.conv2(self.norm2(h, swish=True))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the whole grid (model.py:152-203)."""

    def __init__(self, c: int, cfg: VAEConfig):
        super().__init__()
        self.norm = GroupNorm32(cfg.groups, c, eps=cfg.norm_eps)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        n, c, h, w = x.shape
        t = nhwc(self.norm(x)).reshape(n, h * w, c)
        # (n, 1, hw, c): an explicit head axis, so at >= 1024 tokens the
        # fused kernel's split entry takes it (4096 x 512 at 512x512)
        q, k, v = (conv1x1_as_linear(t, m)[:, None] for m in (self.q, self.k, self.v))
        out = attention(q, k, v)[:, 0]
        out = conv1x1_as_linear(out, self.proj_out)
        return x + nchw(out.reshape(n, h, w, c))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        bi = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, bi, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(bi, bi, cfg)
        self.mid.attn_1 = AttnBlock(bi, cfg)
        self.mid.block_2 = ResnetBlock(bi, bi, cfg)
        up = [None] * len(cfg.ch_mult)
        for i in reversed(range(len(cfg.ch_mult))):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(bi, cfg.ch * cfg.ch_mult[i], cfg))
                bi = cfg.ch * cfg.ch_mult[i]
            if i != 0:
                level.upsample = Upsample(bi)
            up[i] = level
        self.up = nn.ModuleList(up)  # up[0] is the highest resolution
        self.norm_out = GroupNorm32(cfg.groups, bi, eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(bi, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, swish=True))


class AutoencoderKL(nn.Module):
    """The decoding half of SD's first stage."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)


def vae_decode(vae: AutoencoderKL, z, scaled: bool = True):
    """NHWC latent (N, h, w, 4) -> NHWC image (N, 8h, 8w, 3) in about [-1, 1].
    scaled=True: z is in LatentDiffusion units and is divided by the scale
    factor (in z's dtype) first."""
    if scaled:
        z = z / const_tensor(float(vae.cfg.scale_factor), z.dtype, z.device)
    return nhwc(vae.decoder(vae.post_quant_conv(nchw(z))))
