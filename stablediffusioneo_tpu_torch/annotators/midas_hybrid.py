"""MiDaS DPT-hybrid of the port (counterpart of
stablediffusioneo_tpu/annotators/midas_hybrid.py): ResNetV2 + ViT-B/16.

The reference's default MiDaS variant (annotator/midas/api.py:98) and
SD-2.0 depth2img's `depth_model`: a ResNetV2 stem (weight-standardised
convs, GroupNorm(32) + ReLU, pre-activation bottlenecks in stages of 3, 4
and 9 blocks) feeds a ViT-B/16 (12 heads); DPT reassembles from the two
ResNet stage outputs (256 channels at 1/4, 512 at 1/8) and the tokens after
blocks HYBRID_HOOKS = (8, 11), then fuses as DPT-L (annotators/midas.py).
Upstream names: `pretrained.model.patch_embed.backbone.*` (the ResNet),
`pretrained.model.patch_embed.proj` (1x1 to 768), `pretrained.model.*`,
`pretrained.act_postprocess{3,4}`, `scratch.*` (dpt_hybrid.txt.gz, 358
keys).

  * `StdConv2d` standardises its weight in fp32 (population variance, eps
    1e-6) and convolves in the input's dtype, as the JAX `_std_conv`;
  * the GroupNorms (eps 1e-5) go through ops/norms.py:group_norm, so with
    the fused-norm configuration the one-pass GroupNorm kernel takes them;
    the ReLU stays outside (the kernel fuses SiLU or nothing);
  * the stem's 3x3 stride-2 max-pool pads with -inf (F.max_pool2d's
    padding), as the JAX stem.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.annotators.midas import (
    Scratch,
    act_postprocess,
    make_vit,
    reassemble_stage,
    vit_tokens,
)
from stablediffusioneo_tpu_torch.ops.norms import group_norm

STAGE_BLOCKS = (3, 4, 9)
STAGE_OUT = (256, 512, 1024)
STAGE_MID = (64, 128, 256)
HYBRID_HOOKS = (8, 11)
GN_GROUPS = 32
DIM, HEADS = 768, 12


class StdConv2d(nn.Conv2d):
    """A weight-standardised conv (timm StdConv2d): each output channel's
    kernel at zero mean and unit variance, in fp32, then a plain conv."""

    def forward(self, x):
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) * torch.rsqrt(var + 1e-6)).to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding)


def gn_relu(x, norm: nn.GroupNorm):
    return F.relu(group_norm(x, norm.weight, norm.bias, GN_GROUPS, 1e-5))


class PreActBottleneck(nn.Module):
    """ResNetV2 pre-activation bottleneck: one pre-activation feeds both the
    residual branch and the (optional) projection shortcut."""

    def __init__(self, cin: int, cout: int, mid: int, stride: int, downsample: bool):
        super().__init__()
        self.norm1 = nn.GroupNorm(GN_GROUPS, cin)
        self.conv1 = StdConv2d(cin, mid, 1, bias=False)
        self.norm2 = nn.GroupNorm(GN_GROUPS, mid)
        self.conv2 = StdConv2d(mid, mid, 3, stride=stride, padding=1, bias=False)
        self.norm3 = nn.GroupNorm(GN_GROUPS, mid)
        self.conv3 = StdConv2d(mid, cout, 1, bias=False)
        if downsample:
            self.downsample = nn.Module()
            self.downsample.conv = StdConv2d(cin, cout, 1, stride=stride, bias=False)

    def forward(self, x):
        x_pre = gn_relu(x, self.norm1)
        shortcut = self.downsample.conv(x_pre) if hasattr(self, "downsample") else x
        h = self.conv1(x_pre)
        h = self.conv2(gn_relu(h, self.norm2))
        h = self.conv3(gn_relu(h, self.norm3))
        return h + shortcut


class ResNetV2(nn.Module):
    """Stem + 3 stages -> (the 1/16 feature, [stage 1 at 1/4, stage 2 at
    1/8])."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = StdConv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem.norm = nn.GroupNorm(GN_GROUPS, 64)
        self.stages = nn.ModuleList()
        cin = 64
        for si, (n, cout, mid) in enumerate(zip(STAGE_BLOCKS, STAGE_OUT, STAGE_MID)):
            stage = nn.Module()
            stage.blocks = nn.ModuleList([
                PreActBottleneck(cin if bi == 0 else cout, cout, mid,
                                 2 if (bi == 0 and si > 0) else 1, bi == 0)
                for bi in range(n)])
            self.stages.append(stage)
            cin = cout

    def forward(self, x):
        h = gn_relu(self.stem.conv(x), self.stem.norm)
        h = F.max_pool2d(h, 3, 2, padding=1)
        taps = []
        for si, stage in enumerate(self.stages):
            for blk in stage.blocks:
                h = blk(h)
            if si < 2:
                taps.append(h)
        return h, taps


class DPTHybrid(nn.Module):
    """x (N, 3, H, W) ImageNet-normalised, H and W multiples of 32 ->
    inverse depth (N, H, W). grid: the position table's side (24: 577
    tokens); features: the fusion width (256); head: the head's last width
    (32). A file's own are read by `hybrid_shape` (the repository's
    dpt_hybrid universe holds 4, 32 and 8)."""

    def __init__(self, grid: int = 24, features: int = 256, n_blocks: int = 12,
                 head: int = 32):
        super().__init__()
        patch = nn.Module()
        patch.backbone = ResNetV2()
        patch.proj = nn.Conv2d(STAGE_OUT[-1], DIM, 1)
        self.pretrained = nn.Module()
        self.pretrained.model = make_vit(patch, DIM, n_blocks, grid, 4 * DIM)
        self.pretrained.act_postprocess3 = act_postprocess(DIM, DIM, None)
        self.pretrained.act_postprocess4 = act_postprocess(
            DIM, DIM, nn.Conv2d(DIM, DIM, 3, stride=2, padding=1))
        self.scratch = Scratch((STAGE_OUT[0], STAGE_OUT[1], DIM, DIM), features, head)

    def forward(self, x):
        vit = self.pretrained.model
        backbone, taps = vit.patch_embed.backbone(x)
        gh, gw = backbone.shape[2:]
        hooked = vit_tokens(vit, vit.patch_embed.proj(backbone), HEADS, HYBRID_HOOKS)
        stages = taps + [reassemble_stage(getattr(self.pretrained, f"act_postprocess{i + 3}"),
                                          tok, gh, gw) for i, tok in enumerate(hooked)]
        return self.scratch(stages)


def hybrid_shape(sd: Mapping, prefix: str = "") -> dict:
    """DPTHybrid's constructor arguments read off a state dict's shapes."""
    vm = prefix + "pretrained.model."
    return dict(grid=int(round((sd[f"{vm}pos_embed"].shape[1] - 1) ** 0.5)),
                features=sd[f"{prefix}scratch.layer1_rn.weight"].shape[0],
                head=sd[f"{prefix}scratch.output_conv.2.weight"].shape[0],
                n_blocks=1 + max(int(k[len(vm):].split(".")[1]) for k in sd
                                 if k.startswith(f"{vm}blocks.")))


def init_dpt_hybrid(generator: Optional[torch.Generator] = None, **kw) -> DPTHybrid:
    """A DPTHybrid with weights drawn from `generator` (default seed 0), on
    the generator's device."""
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    generator = generator or torch.Generator().manual_seed(0)
    with torch.device(generator.device):
        net = DPTHybrid(**kw)
    init_weights(net, generator)
    return net
