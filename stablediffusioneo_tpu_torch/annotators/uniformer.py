"""UniFormer-S + UperNet segmentation annotator of the port (counterpart of
stablediffusioneo_tpu/annotators/uniformer.py).

The one inference path of the reference's UniFormer annotator
(annotator/uniformer/__init__.py:15-28) as nn.Modules under mmseg's names
(the 398 keys of the `uniformer` universe, upernet_global_small.pth):
  * `backbone.patch_embed{1..4}`: `proj` (a 4x4 / 2x2 stride-k conv) and
    `norm` (LayerNorm over channels, eps 1e-6);
  * `backbone.blocks{1,2}.{j}` (CBlock, depths 3 and 4, widths 64 and 128):
    x + pos_embed(x) (3x3 depthwise); x + conv2(attn(conv1(norm1(x))))
    (1x1, 5x5 depthwise, 1x1); x + mlp.fc2(gelu(mlp.fc1(norm2(x)))) (1x1
    convs). norm1 / norm2 are BatchNorms, which at inference are a
    per-channel scale and shift, as the JAX converter folds them;
  * `backbone.blocks{3,4}.{j}` (SABlock, depths 8 and 3, widths 320 and
    512): x + pos_embed(x), then on the tokens LayerNorm (1e-6), one qkv
    projection, heads of 64 channels through ops/attention.py:attention
    (q / k / v as views of the projection, as the MiDaS ViT blocks), the
    output projection, LayerNorm and a GELU MLP of 4x the width. At a
    512x512 detection stage 3 holds 32 x 32 = 1,024 tokens, so each of its
    8 blocks launches the split attention kernel at (1, 5, 1024, 64), as
    the JAX package's gate sends them to its Pallas kernel; stage 4 (256
    tokens) stays on plain math in both;
  * `decode_head` (UperNet): `psp_modules.{i}` (adaptive average pool to
    1, 2, 3 and 6 bins, torch's AdaptiveAvgPool2d, then a 1x1 ConvModule),
    `bottleneck` (3x3 over the last stage and the four pooled maps resized
    to it), `lateral_convs.{0,1,2}` (1x1), the top-down sum, `fpn_convs`
    (3x3), `fpn_bottleneck` (3x3 over the four levels at 1/4) and
    `conv_seg` (1x1 to the 150 ADE20K classes). A ConvModule is a conv
    without bias, a BatchNorm and a ReLU.
The LayerNorms go through ops/norms.py:layer_norm (the kernel where the
fused-norm configuration is on and its gate admits the site, as the JAX
gate). Resizes are half-pixel bilinear (F.interpolate, align_corners
False): at every input of at least 192 pixels they only upsample, where
they equal jax.image.resize; below it the PPM's 6-bin map would shrink,
where jax.image.resize antialiases and this does not.

`UniformerDetector` keeps the JAX detector: a /32-aligned INTER_AREA resize,
uint8 upload, ImageNet normalisation on the device, the argmax over the
class logits at 1/4 on the device, a nearest resize to the input size and
the ADE20K palette (numpy, seed 42).
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import cv2
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.annotators._dtype import cast_module, default_device
from stablediffusioneo_tpu_torch.ops.attention import attention
from stablediffusioneo_tpu_torch.ops.layers import gelu, linear
from stablediffusioneo_tpu_torch.ops.norms import layer_norm

DEPTHS = (3, 4, 8, 3)
DIMS = (64, 128, 320, 512)
HEAD_DIM = 64
UPER_CH = 512
NUM_CLASSES = 150
PPM_BINS = (1, 2, 3, 6)


def _dwconv(c: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(c, c, k, padding=k // 2, groups=c)


class CMlp(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc1 = nn.Conv2d(c, 4 * c, 1)
        self.fc2 = nn.Conv2d(4 * c, c, 1)


class CBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.pos_embed = _dwconv(c, 3)
        self.norm1 = nn.BatchNorm2d(c)
        self.conv1 = nn.Conv2d(c, c, 1)
        self.attn = _dwconv(c, 5)
        self.conv2 = nn.Conv2d(c, c, 1)
        self.norm2 = nn.BatchNorm2d(c)
        self.mlp = CMlp(c)

    def forward(self, x):
        x = x + self.pos_embed(x)
        x = x + self.conv2(self.attn(self.conv1(self.norm1(x))))
        return x + self.mlp.fc2(gelu(self.mlp.fc1(self.norm2(x))))


class Attention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)


class Mlp(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc1 = nn.Linear(c, 4 * c)
        self.fc2 = nn.Linear(4 * c, c)


class SABlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.pos_embed = _dwconv(c, 3)
        self.norm1 = nn.LayerNorm(c, eps=1e-6)
        self.attn = Attention(c)
        self.norm2 = nn.LayerNorm(c, eps=1e-6)
        self.mlp = Mlp(c)

    def forward(self, x):
        x = x + self.pos_embed(x)
        b, c, h, w = x.shape
        heads = c // HEAD_DIM
        t = x.flatten(2).transpose(1, 2)  # (B, T, C)
        hh = layer_norm(t, self.norm1.weight, self.norm1.bias, 1e-6)
        qkv = linear(hh, self.attn.qkv.weight, self.attn.qkv.bias)
        # (3, B, heads, T, d) views of the one projection: token stride 3C
        q, k, v = qkv.view(b, h * w, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0)
        o = attention(q, k, v).transpose(1, 2).reshape(b, h * w, c)
        t = t + linear(o, self.attn.proj.weight, self.attn.proj.bias)
        hh = layer_norm(t, self.norm2.weight, self.norm2.bias, 1e-6)
        hh = gelu(linear(hh, self.mlp.fc1.weight, self.mlp.fc1.bias))
        t = t + linear(hh, self.mlp.fc2.weight, self.mlp.fc2.bias)
        return t.transpose(1, 2).reshape(b, c, h, w)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, c: int, k: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, c, k, stride=k)
        self.norm = nn.LayerNorm(c, eps=1e-6)

    def forward(self, x):
        x = self.proj(x).permute(0, 2, 3, 1)
        return layer_norm(x, self.norm.weight, self.norm.bias, 1e-6).permute(0, 3, 1, 2)


class UniFormer(nn.Module):
    """UniFormer-S: x (N, 3, H, W) normalised -> the 4 stage features at
    1/4, 1/8, 1/16 and 1/32."""

    def __init__(self):
        super().__init__()
        cin = 3
        for si, (depth, dim) in enumerate(zip(DEPTHS, DIMS)):
            setattr(self, f"patch_embed{si + 1}", PatchEmbed(cin, dim, 4 if si == 0 else 2))
            block = CBlock if si < 2 else SABlock
            setattr(self, f"blocks{si + 1}", nn.ModuleList([block(dim) for _ in range(depth)]))
            cin = dim

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for si in range(len(DEPTHS)):
            x = getattr(self, f"patch_embed{si + 1}")(x)
            for blk in getattr(self, f"blocks{si + 1}"):
                x = blk(x)
            feats.append(x)
        return feats


class ConvModule(nn.Module):
    """mmcv's ConvModule: conv (no bias), BatchNorm, ReLU."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _resize_to(x, h: int, w: int):
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class UPerHead(nn.Module):
    """4 stage features -> (N, num_classes, H/4, W/4) logits."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.psp_modules = nn.ModuleList(
            [nn.Sequential(nn.AdaptiveAvgPool2d(bins), ConvModule(DIMS[-1], UPER_CH, 1))
             for bins in PPM_BINS])
        self.bottleneck = ConvModule(DIMS[-1] + len(PPM_BINS) * UPER_CH, UPER_CH, 3)
        self.lateral_convs = nn.ModuleList([ConvModule(DIMS[i], UPER_CH, 1) for i in range(3)])
        self.fpn_convs = nn.ModuleList([ConvModule(UPER_CH, UPER_CH, 3) for _ in range(3)])
        self.fpn_bottleneck = ConvModule(4 * UPER_CH, UPER_CH, 3)
        self.conv_seg = nn.Conv2d(UPER_CH, num_classes, 1)

    def forward(self, feats: List[torch.Tensor]):
        f4 = feats[3]
        h4, w4 = f4.shape[2:]
        pooled = [f4] + [_resize_to(psp(f4), h4, w4) for psp in self.psp_modules]
        top = self.bottleneck(torch.cat(pooled, dim=1))
        laterals = [conv(feats[i]) for i, conv in enumerate(self.lateral_convs)] + [top]
        for i in range(2, -1, -1):
            laterals[i] = laterals[i] + _resize_to(laterals[i + 1], *laterals[i].shape[2:])
        outs = [conv(laterals[i]) for i, conv in enumerate(self.fpn_convs)] + [top]
        h0, w0 = outs[0].shape[2:]
        fused = self.fpn_bottleneck(torch.cat([_resize_to(o, h0, w0) for o in outs], dim=1))
        return self.conv_seg(fused)


class UniformerSegmentor(nn.Module):
    """`backbone` + `decode_head`: x (N, 3, H, W) -> (N, 150, H/4, W/4)."""

    def __init__(self):
        super().__init__()
        self.backbone = UniFormer()
        self.decode_head = UPerHead()

    def forward(self, x):
        return self.decode_head(self.backbone(x))


def init_uniformer(generator: Optional[torch.Generator] = None) -> UniformerSegmentor:
    """A UniFormer-S + UperNet with weights drawn from `generator` (default
    seed 0; BatchNorms at identity), on the generator's device."""
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    generator = generator or torch.Generator().manual_seed(0)
    with torch.device(generator.device):
        net = UniformerSegmentor()
    init_weights(net, generator)
    return net


# ------------------------------------------------------------------ detector

_IMAGENET_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
_IMAGENET_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


def ade20k_palette() -> np.ndarray:
    """Deterministic 150-color palette (ADE20K rendering convention)."""
    rng = np.random.default_rng(42)
    return rng.integers(0, 255, (NUM_CLASSES, 3)).astype(np.uint8)


class UniformerDetector:
    """Drop-in UniformerDetector (annotator/uniformer/__init__.py:15-28):
    uint8 HWC image -> uint8 color-coded segmentation map. params: a state
    dict under mmseg's names; ckpt_path: upernet_global_small.pth (a nested
    `state_dict` unwrapped), both loaded with strict accounting; neither:
    seeded weights (seed 0). device: the card unless the caller names
    another; the dtype follows annotators/_dtype.py."""

    def __init__(self, params: Optional[Mapping] = None, ckpt_path: Optional[str] = None,
                 device=None):
        from stablediffusioneo_tpu_torch.checkpoint.accounting import load_strict
        from stablediffusioneo_tpu_torch.checkpoint.torch_reader import load_torch_state_dict

        self.device = default_device(device)
        if params is None and ckpt_path is not None:
            params = load_torch_state_dict(ckpt_path)
        if params is None:
            net = init_uniformer()
        else:
            net = UniformerSegmentor()
            load_strict(net, params, "uniformer")
        self.net = cast_module(net, self.device)
        self.palette = ade20k_palette()
        self._mean = torch.from_numpy(_IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(_IMAGENET_STD).to(self.device)

    @torch.no_grad()
    def logits(self, x_u8: torch.Tensor) -> torch.Tensor:
        """(1, H, W, 3) uint8 on the device -> (1, 150, H/4, W/4) fp32."""
        x = (x_u8.float() - self._mean) / self._std
        dtype = next(self.net.parameters()).dtype
        return self.net(x.permute(0, 3, 1, 2).to(dtype)).float()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        nh, nw = max(32, (h // 32) * 32), max(32, (w // 32) * 32)
        x = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
        u8 = torch.from_numpy(np.ascontiguousarray(x[None])).to(self.device)
        seg = self.logits(u8)[0].argmax(0).to(torch.int32).cpu().numpy()
        seg = cv2.resize(seg, (w, h), interpolation=cv2.INTER_NEAREST)
        return self.palette[seg]
