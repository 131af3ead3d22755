"""AutoencoderKL, both towers (counterpart of stablediffusioneo_tpu/models/vae.py).

Names follow `first_stage_model.*` (ldm/modules/diffusionmodules/model.py):
the encoder tower and quant_conv (img2img and inpainting encode with them),
post_quant_conv and the decoder tower, each with its single-head mid-block
attention; SD3's first stage (config.FlowVAEConfig) has neither quant conv
and shifts its latents as well as scaling them. All GroupNorms use eps 1e-6
(cfg.norm_eps). The encoder's
downsample pads right and bottom by one before its stride-2 conv
(model.py:80-87), not symmetrically. `vae_encode` returns the
DiagonalGaussian of quant_conv(encoder(x)); its sample takes the noise from
outside (a captured graph draws nothing).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.config import VAEConfig
from stablediffusioneo_tpu_torch.models.unet import GroupNorm32, conv1x1_as_linear
from stablediffusioneo_tpu_torch.ops.attention import grid_attention
from stablediffusioneo_tpu_torch.ops.dispatch import const_tensor
from stablediffusioneo_tpu_torch.ops.layers import nchw, nhwc, upsample_nearest_2x
from stablediffusioneo_tpu_torch.parallel.mesh import conv2d_padded


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
        out = grid_attention(q, k, v)[:, 0]
        out = conv1x1_as_linear(out, self.proj_out)
        return x + nchw(out.reshape(n, h, w, c))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class Downsample(nn.Module):
    """Stride-2 conv after a one-pixel pad on the right and bottom only
    (model.py:80-87): a symmetric padding=1 gives other results."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return conv2d_padded(self.conv, x, (0, 1, 0, 1))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        bi = cfg.ch
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(bi, cfg.ch * mult, cfg))
                bi = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(bi)
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(bi, bi, cfg)
        self.mid.attn_1 = AttnBlock(bi, cfg)
        self.mid.block_2 = ResnetBlock(bi, bi, cfg)
        self.norm_out = GroupNorm32(cfg.groups, bi, eps=cfg.norm_eps)
        z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(bi, z_out, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h, swish=True))


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
    """SD's first stage: encoder + quant_conv, post_quant_conv + decoder
    (the quant convs None where cfg.quant_convs is off)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = self.post_quant_conv = None
        if cfg.quant_convs:
            q_in = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
            q_out = 2 * cfg.embed_dim if cfg.double_z else cfg.embed_dim
            self.quant_conv = nn.Conv2d(q_in, q_out, 1)
            self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)


class DiagonalGaussian:
    """DiagonalGaussianDistribution (distributions.py:24-62) over NHWC
    moments: the first half of the channels is the mean, the second the
    log-variance, clipped to [-30, 20]. Everything stays in the moments'
    dtype."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def mode(self) -> torch.Tensor:
        return self.mean

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """mean + std * eps; eps (the mean's shape) comes from the caller."""
        return self.mean + self.std * eps.to(self.mean.dtype)


def vae_encode(vae: AutoencoderKL, x) -> DiagonalGaussian:
    """NHWC image (N, H, W, 3) in [-1, 1] -> the posterior over NHWC latents
    (N, H/8, W/8, embed_dim), unscaled (callers multiply by scale_factor)."""
    if not vae.cfg.double_z:
        raise ValueError("vae_encode needs double_z (mean and log-variance moments)")
    moments = vae.encoder(nchw(x))
    if vae.quant_conv is not None:
        moments = vae.quant_conv(moments)
    return DiagonalGaussian(nhwc(moments))


def vae_decode(vae: AutoencoderKL, z, scaled: bool = True):
    """NHWC latent (N, h, w, embed_dim) -> NHWC image (N, 8h, 8w, 3) in about
    [-1, 1]. scaled=True: z is in LatentDiffusion units and is divided by the
    scale factor (in z's dtype) first, then shifted by the shift factor where
    the configuration has one (SD3: z / 1.5305 + 0.0609)."""
    if scaled:
        z = z / const_tensor(float(vae.cfg.scale_factor), z.dtype, z.device)
        if vae.cfg.shift_factor:
            z = z + const_tensor(float(vae.cfg.shift_factor), z.dtype, z.device)
    z = nchw(z)
    if vae.post_quant_conv is not None:
        z = vae.post_quant_conv(z)
    return nhwc(vae.decoder(z))
