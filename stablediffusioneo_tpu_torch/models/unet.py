"""The SD UNet (counterpart of stablediffusioneo_tpu/models/unet.py): SD-1.x,
SD-2.x (64-channel heads) and SDXL base (per-level transformer depth, a level
of depth 0 holding no SpatialTransformer, and ADM conditioning: `label_emb`
under sgm's names `label_emb.0.0` / `label_emb.0.2`, fed `y`).

nn.Modules with the original checkpoint's state-dict names
(openaimodel.py / ldm/modules/attention.py), so a `model.diffusion_model.*`
state dict loads as it is. proj_in / proj_out are held as 1x1 convs (C, C, 1,
1); SD-2.x and SDXL files store them as Linear weights (C, C), which the
loaders accept (checkpoint/accounting.py:proj_weight_fits). Blocks work on NCHW inside; the model-level
entry point (models/controlnet.py:controlled_unet_apply) takes and returns
the JAX package's NHWC.

As in the JAX package: self-attention runs one fused QKV projection,
proj_in/proj_out (1x1 convs in the checkpoint) run as linears over the
token view, and samplers hoist every cross-attention K/V projection of the
step-invariant context out of the loop (`precompute_context_kv`).
`tome` (ops/tome.py:ToMe, or None) merges tokens around every self-attention
of at least `min_tokens` tokens; it is an argument of each evaluation, not a
module attribute, so engines built with and without it share the modules.
Eps: ResBlock GroupNorm cfg.norm_eps (1e-5); SpatialTransformer GroupNorm
1e-6; transformer LayerNorms 1e-5. With the remat flag on
(`dispatch.set_kernels(remat=True)`, the JAX package's SDEO_REMAT) and grad
enabled, each ResBlock and SpatialTransformer runs through
torch.utils.checkpoint (`remat`), the JAX `_maybe_remat`.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from stablediffusioneo_tpu_torch.config import UNetConfig
from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.attention import (
    context_kv,
    multi_head_attention,
)
from stablediffusioneo_tpu_torch.ops.layers import (
    dense,
    geglu,
    linear,
    nchw,
    nhwc,
    silu,
    upsample_nearest_2x,
)
from stablediffusioneo_tpu_torch.ops.norms import group_norm, layer_norm
from stablediffusioneo_tpu_torch.ops.schedule import timestep_embedding
from stablediffusioneo_tpu_torch.ops.tome import build_merge, merge_count

ATTN_NORM_EPS = 1e-6  # ldm/modules/attention.py Normalize eps
LN_EPS = 1e-5


# ---------------------------------------------------------------- plans


def encoder_plan(cfg: UNetConfig) -> List[dict]:
    """Static plan of "input_blocks" (openaimodel.py:496-563); same entries
    as the JAX package's encoder_plan."""
    plan = [{"kind": "conv", "cin": cfg.in_channels,
             "cout": cfg.model_channels, "attn": False, "ds": 1}]
    ch, ds = cfg.model_channels, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            cout = mult * cfg.model_channels
            plan.append({"kind": "res", "cin": ch, "cout": cout,
                         "attn": (ds in cfg.attention_resolutions
                                  and cfg.depth_for(level) > 0),
                         "depth": cfg.depth_for(level), "ds": ds})
            ch = cout
        if level != len(cfg.channel_mult) - 1:
            plan.append({"kind": "down", "cin": ch, "cout": ch,
                         "attn": False, "ds": ds})
            ds *= 2
    return plan


def decoder_plan(cfg: UNetConfig) -> List[dict]:
    """Static plan of "output_blocks" (openaimodel.py:606-661)."""
    skip_chs = [e["cout"] for e in encoder_plan(cfg)]
    plan = []
    ch = cfg.model_channels * cfg.channel_mult[-1]
    ds = 2 ** (len(cfg.channel_mult) - 1)
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            cout = cfg.model_channels * mult
            plan.append({"cin": ch + skip_chs.pop(), "cout": cout,
                         "attn": (ds in cfg.attention_resolutions
                                  and cfg.depth_for(level) > 0),
                         "depth": cfg.depth_for(level),
                         "up": level != 0 and i == cfg.num_res_blocks,
                         "ds": ds})
            ch = cout
        if level != 0:
            ds //= 2
    return plan


# ---------------------------------------------------------------- layers


class _Bound(nn.Module):
    """`fn`, a method of `module`, as the forward of a module holding it, so
    that torch.func.functional_call can hand the method tensors by name."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.inner = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def remat(module: nn.Module, fn, *args):
    """fn(*args), the forward of one block, as the JAX package's
    `_maybe_remat`: with the remat flag on and grad enabled, through
    torch.utils.checkpoint (non-reentrant), which keeps none of the block's
    activations and runs it again in the backward. The recomputation comes
    after the caller's call has returned, so it is handed the tensors the
    block holds now (a trainer's torch.func.functional_call puts its
    dtype-cast or merged weights in the parameters' places)."""
    if not (dispatch.kernels_enabled("remat") and torch.is_grad_enabled()):
        return fn(*args)
    tensors = {f"inner.{n}": t for n, t in module.named_parameters()}
    bound = _Bound(module, fn)
    return checkpoint(lambda *a: torch.func.functional_call(bound, tensors, a), *args,
                      use_reentrant=False)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm holding the checkpoint's weight/bias; fp32 statistics."""

    def forward(self, x, swish: bool = False):
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, swish=swish)


class LayerNorm(nn.LayerNorm):
    """LayerNorm holding the checkpoint's weight/bias; fp32 statistics."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def conv1x1_as_linear(x, conv: nn.Conv2d):
    """A 1x1 conv applied to tokens (..., C) as the linear it is."""
    return linear(x, conv.weight[:, :, 0, 0], conv.bias)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        context_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(query_dim, query_dim),
                                    nn.Dropout(0.0))

    def forward(self, x, context=None, kv=None):
        out = self.to_out[0]
        return multi_head_attention(
            x, context, self.to_q.weight, self.to_k.weight, self.to_v.weight,
            out.weight, out.bias, self.heads, kv=kv)

    def context_kv(self, context):
        return context_kv(context, self.to_k.weight, self.to_v.weight)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        return geglu(x, self.proj)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        return dense(self.net[0](x), self.net[2])


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention, GEGLU FF (attention.py:355-385).
    With `tome` and the token grid `grid_hw`, the self-attention runs on the
    merged tokens (the JAX transformer_block_apply); the merge is matched on
    the block input x, before norm1, as tomesd does."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.norm3 = LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, context, ctx_kv=None, tome=None, grid_hw=None):
        r = 0
        if tome is not None and grid_hw is not None and x.shape[1] >= tome.min_tokens:
            r = merge_count(grid_hw[0], grid_hw[1], tome.ratio, tome.sx, tome.sy)
        h = self.norm1(x)
        if r > 0:
            merge, unmerge, _ = build_merge(x, grid_hw[0], grid_hw[1], r,
                                            tome.sx, tome.sy)
            x = x + unmerge(self.attn1(merge(h)))
        else:
            x = x + self.attn1(h)
        x = x + self.attn2(self.norm2(x), context, kv=ctx_kv)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """SpatialTransformer, conv-projection flavour (attention.py:388-450)."""

    def __init__(self, channels: int, heads: int, depth: int,
                 context_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm32(groups, channels, eps=ATTN_NORM_EPS)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim)
             for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context, ctx_kv=None, tome=None):
        """x: NCHW; ctx_kv: optional per-block list of hoisted (k, v)."""
        return remat(self, self._forward, x, context, ctx_kv, tome)

    def _forward(self, x, context, ctx_kv, tome):
        n, c, h, w = x.shape
        t = nhwc(self.norm(x)).reshape(n, h * w, c)
        t = conv1x1_as_linear(t, self.proj_in)
        for i, blk in enumerate(self.transformer_blocks):
            t = blk(t, context, None if ctx_kv is None else ctx_kv[i], tome, (h, w))
        t = conv1x1_as_linear(t, self.proj_out)
        return nchw(t.reshape(n, h, w, c)) + x

    def context_kv(self, context):
        return [blk.attn2.context_kv(context) for blk in self.transformer_blocks]


class ResBlock(nn.Module):
    """GN+SiLU+conv, + time embedding, GN+SiLU+conv, skip (openaimodel.py:162-276)."""

    def __init__(self, cin: int, emb_dim: int, cout: int, groups: int,
                 eps: float):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(groups, cin, eps=eps),
                                       nn.SiLU(), nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, cout))
        self.out_layers = nn.Sequential(GroupNorm32(groups, cout, eps=eps),
                                        nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = (nn.Conv2d(cin, cout, 1) if cin != cout
                                else nn.Identity())

    def forward(self, x, emb):
        return remat(self, self._forward, x, emb)

    def _forward(self, x, emb):
        h = self.in_layers[2](self.in_layers[0](x, swish=True))
        emb_out = dense(silu(emb), self.emb_layers[1])
        h = h + emb_out[:, :, None, None].to(h.dtype)
        h = self.out_layers[3](self.out_layers[0](h, swish=True))
        return self.skip_connection(x) + h


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class TimestepEmbedSequential(nn.Sequential):
    """A block of layers fed (x, emb, context, ctx_kv, tome), as in openaimodel."""

    def forward(self, x, emb=None, context=None, ctx_kv=None, tome=None):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context, ctx_kv, tome)
            else:
                x = layer(x)
        return x

    def transformer(self) -> Optional[SpatialTransformer]:
        return next((m for m in self if isinstance(m, SpatialTransformer)), None)


def _check_supported(cfg: UNetConfig) -> None:
    if cfg.use_scale_shift_norm:
        raise NotImplementedError(
            "scale-shift norm is not in the port yet (no family the port "
            "runs uses it)")


def time_embed_modules(cfg: UNetConfig) -> nn.Sequential:
    d = cfg.time_embed_dim
    return nn.Sequential(nn.Linear(cfg.model_channels, d), nn.SiLU(),
                         nn.Linear(d, d))


def label_emb_modules(cfg: UNetConfig) -> Optional[nn.Sequential]:
    """sgm's ADM MLP, a Sequential in a Sequential (`label_emb.0.0`,
    `label_emb.0.2`), or None without ADM conditioning."""
    if not cfg.adm_in_channels:
        return None
    d = cfg.time_embed_dim
    return nn.Sequential(nn.Sequential(nn.Linear(cfg.adm_in_channels, d), nn.SiLU(),
                                       nn.Linear(d, d)))


def input_block_modules(cfg: UNetConfig) -> nn.ModuleList:
    blocks = nn.ModuleList()
    for desc in encoder_plan(cfg):
        if desc["kind"] == "conv":
            blocks.append(TimestepEmbedSequential(
                nn.Conv2d(desc["cin"], desc["cout"], 3, padding=1)))
        elif desc["kind"] == "down":
            blocks.append(TimestepEmbedSequential(Downsample(desc["cout"])))
        else:
            layers = [ResBlock(desc["cin"], cfg.time_embed_dim, desc["cout"],
                               cfg.groups, cfg.norm_eps)]
            if desc["attn"]:
                layers.append(SpatialTransformer(
                    desc["cout"], cfg.heads_for(desc["cout"]), desc["depth"],
                    cfg.context_dim, cfg.groups))
            blocks.append(TimestepEmbedSequential(*layers))
    return blocks


def middle_block_modules(cfg: UNetConfig) -> TimestepEmbedSequential:
    ch = cfg.model_channels * cfg.channel_mult[-1]
    return TimestepEmbedSequential(
        ResBlock(ch, cfg.time_embed_dim, ch, cfg.groups, cfg.norm_eps),
        SpatialTransformer(ch, cfg.heads_for(ch),
                           cfg.depth_for(len(cfg.channel_mult) - 1),
                           cfg.context_dim, cfg.groups),
        ResBlock(ch, cfg.time_embed_dim, ch, cfg.groups, cfg.norm_eps),
    )


class UNetModel(nn.Module):
    """openaimodel UNetModel with `model.diffusion_model.*` names."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.time_embed = time_embed_modules(cfg)
        self.label_emb = label_emb_modules(cfg)
        self.input_blocks = input_block_modules(cfg)
        self.middle_block = middle_block_modules(cfg)
        self.output_blocks = nn.ModuleList()
        for desc in decoder_plan(cfg):
            layers = [ResBlock(desc["cin"], cfg.time_embed_dim, desc["cout"],
                               cfg.groups, cfg.norm_eps)]
            if desc["attn"]:
                layers.append(SpatialTransformer(
                    desc["cout"], cfg.heads_for(desc["cout"]), desc["depth"],
                    cfg.context_dim, cfg.groups))
            if desc["up"]:
                layers.append(Upsample(desc["cout"]))
            self.output_blocks.append(TimestepEmbedSequential(*layers))
        ch = cfg.model_channels
        self.out = nn.Sequential(GroupNorm32(cfg.groups, ch, eps=cfg.norm_eps),
                                 nn.SiLU(), nn.Conv2d(ch, cfg.out_channels, 3,
                                                      padding=1))


# ---------------------------------------------------------------- apply


def embed_timesteps(net, model_channels: int, timesteps, dtype, y=None):
    """A UNet's or ControlNet's sinusoidal embedding through its time MLP,
    plus with ADM conditioning its label_emb(y) (y taken to fp32), all in
    fp32; rounded once to dtype."""
    time_embed = net.time_embed
    emb = dense(timestep_embedding(timesteps, model_channels), time_embed[0])
    emb = dense(silu(emb), time_embed[2])
    if net.label_emb is not None:
        if y is None:
            raise ValueError("this UNet is ADM-conditioned (adm_in_channels set): "
                             "pass y")
        mlp = net.label_emb[0]
        emb = emb + dense(silu(dense(y.float(), mlp[0])), mlp[2])
    return emb.to(dtype)


def _site_kv(blocks, context):
    return [None if blk.transformer() is None
            else blk.transformer().context_kv(context) for blk in blocks]


def precompute_context_kv(unet: UNetModel, context):
    """Per-site cross-attention (k, v) of the step-invariant context:
    {"input": [site|None per input block], "middle": site,
    "output": [site|None per output block]}, site = per-depth (k, v) list."""
    return {"input": _site_kv(unet.input_blocks, context),
            "middle": unet.middle_block.transformer().context_kv(context),
            "output": _site_kv(unet.output_blocks, context)}


def unet_encode(unet: UNetModel, x, emb, context, ctx_kv=None, tome=None):
    """Input blocks on NCHW x; returns (h, skip list)."""
    kvs = ctx_kv["input"] if ctx_kv is not None else None
    hs, h = [], x
    for i, blk in enumerate(unet.input_blocks):
        h = blk(h, emb, context, None if kvs is None else kvs[i], tome)
        hs.append(h)
    return h, hs


def unet_middle(model, h, emb, context, ctx_kv=None, tome=None):
    return model.middle_block(h, emb, context,
                              None if ctx_kv is None else ctx_kv["middle"], tome)


def unet_decode(unet: UNetModel, h, hs, emb, context, control=None,
                only_mid_control: bool = False, ctx_kv=None, tome=None):
    """Output blocks; control (NCHW taps) adds to the skips, consumed from
    the end like the reference's control.pop()."""
    kvs = ctx_kv["output"] if ctx_kv is not None else None
    hs = list(hs)
    ctrl = list(control) if control is not None else None
    for i, blk in enumerate(unet.output_blocks):
        skip = hs.pop()
        if ctrl is not None and not only_mid_control:
            skip = skip + ctrl.pop()
        h = torch.cat([h, skip.to(h.dtype)], dim=1)
        h = blk(h, emb, context, None if kvs is None else kvs[i], tome)
    return h


def unet_out(unet: UNetModel, h):
    return unet.out[2](unet.out[0](h, swish=True))


def unet_forward(unet: UNetModel, x, timesteps, context, control=None,
                 only_mid_control: bool = False, ctx_kv=None, tome=None, y=None):
    """ControlledUnetModel.forward on NCHW x and NCHW control taps; y: the
    (N, adm_in_channels) ADM vector, required iff the UNet has label_emb."""
    emb = embed_timesteps(unet, unet.cfg.model_channels, timesteps, x.dtype, y)
    h, hs = unet_encode(unet, x, emb, context, ctx_kv, tome)
    h = unet_middle(unet, h, emb, context, ctx_kv, tome)
    if control is not None:
        control = list(control)
        h = h + control.pop().to(h.dtype)  # middle-block control
    h = unet_decode(unet, h, hs, emb, context, control, only_mid_control,
                    ctx_kv, tome)
    return unet_out(unet, h)


def unet_apply(unet: UNetModel, x, timesteps, context, control=None,
               only_mid_control: bool = False, ctx_kv=None, y=None):
    """The JAX unet_apply's interface: NHWC x (N, h, w, C) and NHWC control
    taps -> NHWC output (unet_forward on NCHW tensors)."""
    if control is not None:
        control = [nchw(c) for c in control]
    return nhwc(unet_forward(unet, nchw(x), timesteps, context, control,
                             only_mid_control, ctx_kv=ctx_kv, y=y))
