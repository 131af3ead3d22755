"""MiDaS depth annotator of the port: DPT-L (counterpart of
stablediffusioneo_tpu/annotators/midas.py).

`DPT` is the reference's DPTDepthModel over ViT-L/16 (annotator/midas/midas/
dpt_depth.py, vit.py; model type dpt_large) as an nn.Module under the
upstream names: `pretrained.model.*` (the ViT: patch_embed.proj, cls_token,
pos_embed, blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}),
`pretrained.act_postprocess{1..4}` (the "project" readout `0.project.0`, the
1x1 conv `3`, the resampler `4`), `scratch.layer{i}_rn`,
`scratch.refinenet{i}` and `scratch.output_conv`. Activations are hooked
after blocks HOOKS = (5, 11, 17, 23); the readout concatenates the class
token onto every patch token; the four stages are resampled to 1/4, 1/8,
1/16 and 1/32 of the input, fused coarse to fine with 2x align-corners
upsamples, and the head gives inverse depth.

The ViT blocks go through the port's ops: LayerNorm eps 1e-6
(ops/norms.py:layer_norm) and ops/attention.py:attention on the q/k/v views
of the one qkv projection, so a (1, 16, 1025, 64) site of a 512x512 input
(at least 1024 queries) launches the split attention kernel.

Two rules differ from a naive copy of the JAX code:
  * the position table is resized with `antialias=True`: jax.image.resize
    antialiases when it downsamples (an input under 384), F.interpolate
    does not unless asked;
  * stages 1 and 2 resample with nn.ConvTranspose2d on the upstream weight,
    the upstream semantics. The JAX package applies those kernels spatially
    mirrored (lax.conv_transpose without transpose_kernel, on a weight
    convert_dpt only permutes); checkpoint/convert.py:
    annotator_state_dict_from_jax flips them, so one JAX tree gives the
    same function in both packages, while a checkpoint file loads here as
    upstream runs it.

`MidasDetector` keeps the JAX detector: a /32-aligned INTER_AREA resize,
uint8 upload, ImageNet normalisation on the device, fp32 depth back, a cubic
resize to the input size, min/max to uint8, and the Sobel normal map.
model_type "dpt_hybrid" takes annotators/midas_hybrid.py's tower.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.annotators._dtype import cast_module, default_device
from stablediffusioneo_tpu_torch.ops.attention import attention
from stablediffusioneo_tpu_torch.ops.layers import gelu, linear
from stablediffusioneo_tpu_torch.ops.norms import layer_norm

HOOKS = (5, 11, 17, 23)
STAGE_CHANNELS = (256, 512, 1024, 1024)
FEATURES = 256
# timm's final norm and classifier head ride along in a DPT file; the hooks
# read the blocks, so DPT never runs them
VIT_LEFTOVERS = (r"pretrained\.model\.(norm|head)\.(weight|bias)",)


# ------------------------------------------------------------- ViT backbone


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """A timm ViT block: x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x, heads: int):
        b, t, c = x.shape
        h = layer_norm(x, self.norm1.weight, self.norm1.bias, 1e-6)
        qkv = linear(h, self.attn.qkv.weight, self.attn.qkv.bias)
        # (3, B, heads, T, d) views of the one projection: token stride 3C
        q, k, v = qkv.view(b, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4).unbind(0)
        o = attention(q, k, v).transpose(1, 2).reshape(b, t, c)
        x = x + linear(o, self.attn.proj.weight, self.attn.proj.bias)
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, 1e-6)
        h = gelu(linear(h, self.mlp.fc1.weight, self.mlp.fc1.bias))
        return x + linear(h, self.mlp.fc2.weight, self.mlp.fc2.bias)


class TokenParams(nn.Module):
    """Holds a ViT's class token and position table (the upstream names)."""

    def init_bare_(self, generator):
        """N(0, 0.02) for both, as the JAX init_dpt."""
        for p in (self.cls_token, self.pos_embed):
            p.normal_(0.0, 0.02, generator=generator)
        return self.cls_token, self.pos_embed


def make_vit(patch_embed: nn.Module, dim: int, n_blocks: int, grid: int,
             hidden: int) -> nn.Module:
    """`pretrained.model`: patch_embed, cls_token (1, 1, dim), pos_embed
    (1, 1 + grid^2, dim) and the blocks."""
    vit = TokenParams()
    vit.patch_embed = patch_embed
    vit.cls_token = nn.Parameter(torch.zeros((1, 1, dim)))
    vit.pos_embed = nn.Parameter(torch.zeros((1, 1 + grid * grid, dim)))
    vit.blocks = nn.ModuleList([Block(dim, hidden) for _ in range(n_blocks)])
    return vit


def resize_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """The (1, 1 + G0^2, C) table for a (gh, gw) grid: bilinear, half-pixel,
    antialiased where it shrinks, as jax.image.resize."""
    cls_pos, grid_pos = pos[:, :1], pos[:, 1:]
    g0 = int(round(float(np.sqrt(grid_pos.shape[1]))))
    c = grid_pos.shape[-1]
    grid = grid_pos.reshape(1, g0, g0, c).permute(0, 3, 1, 2)
    if (gh, gw) != (g0, g0):
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False,
                             antialias=True)
    return torch.cat([cls_pos, grid.permute(0, 2, 3, 1).reshape(1, gh * gw, c)], dim=1)


def vit_tokens(vit: nn.Module, patches: torch.Tensor, heads: int,
               hooks: Sequence[int]) -> List[torch.Tensor]:
    """patches (N, C, gh, gw) from the patch embedding -> the hooked token
    sequences (N, 1 + gh*gw, C)."""
    n, c, gh, gw = patches.shape
    tokens = patches.flatten(2).transpose(1, 2)
    cls = vit.cls_token.to(tokens.dtype).expand(n, 1, c)
    tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + resize_pos_embed(vit.pos_embed, gh, gw).to(tokens.dtype)
    hooked = []
    for i, blk in enumerate(vit.blocks):
        tokens = blk(tokens, heads)
        if i in hooks:
            hooked.append(tokens)
    return hooked


# --------------------------------------------------------------- reassemble


class ProjectReadout(nn.Module):
    """The "project" readout: the class token concatenated onto every patch
    token, Linear 2C -> C, GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tok, gh: int, gw: int):
        n, t, c = tok.shape
        cat = torch.cat([tok[:, 1:], tok[:, :1].expand(n, t - 1, c)], dim=-1)
        return self.project(cat).transpose(1, 2).reshape(n, c, gh, gw)


def act_postprocess(dim: int, channels: int, resample: Optional[nn.Module]) -> nn.Module:
    """`pretrained.act_postprocess{i}`: readout `0`, 1x1 conv `3`, resampler
    `4` (absent at stage 3 of DPT-L and stage 3 of the hybrid)."""
    m = nn.Module()
    m.add_module("0", ProjectReadout(dim))
    m.add_module("3", nn.Conv2d(dim, channels, 1))
    if resample is not None:
        m.add_module("4", resample)
    return m


def reassemble_stage(post: nn.Module, tok, gh: int, gw: int):
    y = getattr(post, "0")(tok, gh, gw)
    y = getattr(post, "3")(y)
    if hasattr(post, "4"):
        y = getattr(post, "4")(y)
    return y


# ------------------------------------------------------------- fusion + head


def up2x_align_corners(x):
    """Bilinear 2x upsample with align_corners=True, the DPT fusion / head
    convention (midas/blocks.py:223,336, dpt_depth.py:94)."""
    return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear",
                         align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return self.out_conv(up2x_align_corners(x))


class Scratch(nn.Module):
    """`scratch`: the per-stage 3x3 convs to `features`, the four fusion
    blocks and the head `output_conv` (0: 3x3 to features/2, 2x upsample,
    2: 3x3 to `head` (32) + ReLU, 4: 1x1 to 1 + ReLU)."""

    def __init__(self, stage_channels: Sequence[int], features: int, head: int = 32):
        super().__init__()
        for i, ch in enumerate(stage_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(ch, features, 3, padding=1,
                                                        bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))
        oc = nn.Module()
        oc.add_module("0", nn.Conv2d(features, features // 2, 3, padding=1))
        oc.add_module("2", nn.Conv2d(features // 2, head, 3, padding=1))
        oc.add_module("4", nn.Conv2d(head, 1, 1))
        self.output_conv = oc

    def forward(self, stages: Sequence[torch.Tensor]) -> torch.Tensor:
        l1, l2, l3, l4 = (getattr(self, f"layer{i + 1}_rn")(s) for i, s in enumerate(stages))
        path = self.refinenet4(l4)
        path = self.refinenet3(path, l3)
        path = self.refinenet2(path, l2)
        path = self.refinenet1(path, l1)
        oc = self.output_conv
        y = up2x_align_corners(getattr(oc, "0")(path))
        y = F.relu(getattr(oc, "2")(y))
        return F.relu(getattr(oc, "4")(y))[:, 0]


# ---------------------------------------------------------------------- DPT


class DPT(nn.Module):
    """DPT-L: x (N, 3, H, W) ImageNet-normalised, H and W multiples of 32 ->
    inverse depth (N, H, W). dim, n_blocks, grid (the position table's side),
    heads, hidden (the MLP width), features, head (the head's last width):
    ViT-L/16's 1024, 24, 24, 16, 4096, 256 and 32 by default; narrower ones
    for tests (the hooks need 24 blocks)."""

    def __init__(self, dim: int = 1024, n_blocks: int = 24, grid: int = 24,
                 heads: int = 16, hidden: Optional[int] = None, features: int = FEATURES,
                 stage_channels: Sequence[int] = STAGE_CHANNELS, head: int = 32):
        super().__init__()
        self.heads = heads
        patch = nn.Module()
        patch.proj = nn.Conv2d(3, dim, 16, stride=16)
        self.pretrained = nn.Module()
        self.pretrained.model = make_vit(patch, dim, n_blocks, grid, hidden or 4 * dim)
        ch = stage_channels
        resample = (nn.ConvTranspose2d(ch[0], ch[0], 4, stride=4),
                    nn.ConvTranspose2d(ch[1], ch[1], 2, stride=2), None,
                    nn.Conv2d(ch[3], ch[3], 3, stride=2, padding=1))
        for i in range(4):
            setattr(self.pretrained, f"act_postprocess{i + 1}",
                    act_postprocess(dim, ch[i], resample[i]))
        self.scratch = Scratch(ch, features, head)

    def forward(self, x):
        vit = self.pretrained.model
        patches = vit.patch_embed.proj(x)
        gh, gw = patches.shape[2:]
        hooked = vit_tokens(vit, patches, self.heads, HOOKS)
        stages = [reassemble_stage(getattr(self.pretrained, f"act_postprocess{i + 1}"),
                                   tok, gh, gw) for i, tok in enumerate(hooked)]
        return self.scratch(stages)


def dpt_shape(sd: Mapping, prefix: str = "") -> dict:
    """DPT's constructor arguments read off a state dict's shapes."""
    vm = prefix + "pretrained.model."
    dim = sd[f"{vm}cls_token"].shape[-1]
    return dict(dim=dim,
                n_blocks=1 + max(int(k[len(vm):].split(".")[1]) for k in sd
                                 if k.startswith(f"{vm}blocks.")),
                grid=int(round((sd[f"{vm}pos_embed"].shape[1] - 1) ** 0.5)),
                hidden=sd[f"{vm}blocks.0.mlp.fc1.weight"].shape[0],
                features=sd[f"{prefix}scratch.layer1_rn.weight"].shape[0],
                head=sd[f"{prefix}scratch.output_conv.2.weight"].shape[0],
                stage_channels=tuple(sd[f"{prefix}pretrained.act_postprocess{i}.3.weight"]
                                     .shape[0] for i in range(1, 5)))


def init_dpt(generator: Optional[torch.Generator] = None, dim: int = 1024,
             n_blocks: int = 24, grid: int = 24, **kw) -> DPT:
    """A DPT with weights drawn from `generator` (default seed 0), on the
    generator's device; the JAX init_dpt's seeded counterpart."""
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    generator = generator or torch.Generator().manual_seed(0)
    with torch.device(generator.device):
        net = DPT(dim, n_blocks, grid, **kw)
    init_weights(net, generator)
    return net


# ---------------------------------------------------------------- detector

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def depth_of(net: nn.Module, u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 on the net's device -> fp32 inverse depth (N, H,
    W): the ImageNet normalisation in the net's dtype, as the JAX detector's
    graph."""
    dtype = next(net.parameters()).dtype
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=u8.device)
    x = (u8.to(dtype) / 255.0 - mean) / std
    return net(x.permute(0, 3, 1, 2)).float()


def depth_maps(depth: np.ndarray, h: int, w: int, a: float,
               bg_th: float) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX MidasDetector's host tail: net-resolution depth -> (depth
    uint8, normal uint8) at (h, w)."""
    depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_CUBIC)

    depth_pt = depth - depth.min()
    depth_pt = depth_pt / max(depth_pt.max(), 1e-8)
    depth_image = (depth_pt * 255.0).clip(0, 255).astype(np.uint8)

    gx = cv2.Sobel(depth, cv2.CV_32F, 1, 0, ksize=3)
    gy = cv2.Sobel(depth, cv2.CV_32F, 0, 1, ksize=3)
    z = np.ones_like(gx) * a
    gx[depth_pt < bg_th] = 0
    gy[depth_pt < bg_th] = 0
    normal = np.stack([gx, gy, z], axis=2)
    normal /= np.sum(normal ** 2.0, axis=2, keepdims=True) ** 0.5
    normal_image = (normal * 127.5 + 127.5).clip(0, 255).astype(np.uint8)
    return depth_image, normal_image


class MidasDetector:
    """Drop-in MidasDetector (annotator/midas/__init__.py:13-42): uint8 HWC
    in -> (depth uint8, normal uint8). model_type "dpt_large" (ViT-L/16) or
    "dpt_hybrid" (ResNetV2 + ViT-B/16, annotators/midas_hybrid.py). params: a
    state dict under the upstream names (checkpoint/convert.py:
    annotator_state_dict_from_jax); ckpt_path: dpt_large-midas-2f21e586.pt /
    dpt_hybrid-midas-501f0c75.pt, read by checkpoint/torch_reader.py (the
    widths read off the file); neither: seeded full-width weights (seed 0).
    device: the card unless the caller names another."""

    def __init__(self, params: Optional[Mapping] = None, ckpt_path: Optional[str] = None,
                 model_type: str = "dpt_large", device=None):
        from stablediffusioneo_tpu_torch.checkpoint.accounting import load_strict
        from stablediffusioneo_tpu_torch.checkpoint.torch_reader import load_torch_state_dict

        if model_type == "dpt_large":
            cls, init, shape = DPT, init_dpt, dpt_shape
        elif model_type == "dpt_hybrid":
            from stablediffusioneo_tpu_torch.annotators.midas_hybrid import (
                DPTHybrid,
                hybrid_shape,
                init_dpt_hybrid,
            )

            cls, init, shape = DPTHybrid, init_dpt_hybrid, hybrid_shape
        else:
            raise ValueError(f"model_type {model_type!r}: dpt_large or dpt_hybrid")
        self.device = default_device(device)
        if params is None and ckpt_path is not None:
            params = load_torch_state_dict(ckpt_path)
        if params is None:
            net = init()
        else:
            net = cls(**shape(params))
            load_strict(net, params, model_type, VIT_LEFTOVERS)
        self.net = cast_module(net, self.device)

    @torch.no_grad()
    def __call__(self, input_image: np.ndarray, a: float = np.pi * 2.0,
                 bg_th: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
        assert input_image.ndim == 3
        h, w = input_image.shape[:2]
        # DPT runs on /32-aligned inputs (ViT/16 then 1/2 head upsample)
        nh, nw = max(32, (h // 32) * 32), max(32, (w // 32) * 32)
        img = cv2.resize(input_image, (nw, nh), interpolation=cv2.INTER_AREA)
        u8 = torch.from_numpy(np.ascontiguousarray(img[None])).to(self.device)
        depth = depth_of(self.net, u8)[0].cpu().numpy()
        return depth_maps(depth, h, w, a, bg_th)
