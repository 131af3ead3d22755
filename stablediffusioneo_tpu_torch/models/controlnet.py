"""ControlNet + controlled UNet (counterpart of stablediffusioneo_tpu/models/controlnet.py).

The ControlNet is the UNet encoder's copy branch (cldm/cldm.py:48-305) with
the 8-conv hint block (three stride-2 convs: image -> latent resolution)
and one 1x1 zero-conv tap per input block plus one for the middle block:
13 taps for SD-1.5. Names follow `control_model.*` of the checkpoint. An
ADM-conditioned UNet configuration (SDXL) gives the copy branch its own
`label_emb`, and `y` rides beside the context through both branches.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.config import ControlNetConfig
from stablediffusioneo_tpu_torch.models.unet import (
    TimestepEmbedSequential,
    UNetModel,
    _check_supported,
    _site_kv,
    embed_timesteps,
    encoder_plan,
    input_block_modules,
    label_emb_modules,
    middle_block_modules,
    time_embed_modules,
    unet_forward,
    unet_middle,
)
from stablediffusioneo_tpu_torch.ops.dispatch import const_tensor
from stablediffusioneo_tpu_torch.ops.layers import nchw, nhwc

# (cout, stride) of the hint block's convs before the last, cldm/cldm.py:209-225
HINT_CHAIN = [(16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2)]


class ControlNet(nn.Module):
    def __init__(self, cfg: ControlNetConfig):
        super().__init__()
        ucfg = cfg.unet
        _check_supported(ucfg)
        self.cfg = cfg
        self.time_embed = time_embed_modules(ucfg)
        self.label_emb = label_emb_modules(ucfg)
        layers, cin = [], cfg.hint_channels
        for cout, stride in HINT_CHAIN:
            layers += [nn.Conv2d(cin, cout, 3, stride=stride, padding=1),
                       nn.SiLU()]
            cin = cout
        layers.append(nn.Conv2d(cin, ucfg.model_channels, 3, padding=1))
        self.input_hint_block = nn.Sequential(*layers)
        self.input_blocks = input_block_modules(ucfg)
        self.zero_convs = nn.ModuleList([
            TimestepEmbedSequential(nn.Conv2d(d["cout"], d["cout"], 1))
            for d in encoder_plan(ucfg)])
        self.middle_block = middle_block_modules(ucfg)
        mid = ucfg.model_channels * ucfg.channel_mult[-1]
        self.middle_block_out = TimestepEmbedSequential(nn.Conv2d(mid, mid, 1))


def hint_block_apply(hint_block: nn.Sequential, hint):
    """input_hint_block on NCHW: conv+SiLU x7 (three stride-2), then a conv."""
    return hint_block(hint)


def precompute_controlnet_context_kv(control: ControlNet, context):
    """{"input": [site|None], "middle": site}: the encoder+middle subset of
    unet.precompute_context_kv."""
    return {"input": _site_kv(control.input_blocks, context),
            "middle": control.middle_block.transformer().context_kv(context)}


def controlnet_forward(control: ControlNet, x, hint, timesteps, context,
                       guided_hint=None, ctx_kv=None, tome=None,
                       y=None) -> List[torch.Tensor]:
    """ControlNet.forward on NCHW: 13 NCHW taps. guided_hint: optional
    precomputed hint-block output (samplers hoist it out of the loop); tome:
    token merging at its self-attention sites (ops/tome.py); y: the ADM
    vector of an ADM-conditioned copy branch."""
    emb = embed_timesteps(control, control.cfg.unet.model_channels, timesteps,
                          x.dtype, y)
    if guided_hint is None:
        guided_hint = hint_block_apply(control.input_hint_block,
                                       hint.to(x.dtype))
    kvs = ctx_kv["input"] if ctx_kv is not None else None
    outs, h = [], x
    for i, (blk, zc) in enumerate(zip(control.input_blocks, control.zero_convs)):
        h = blk(h, emb, context, None if kvs is None else kvs[i], tome)
        if i == 0:
            h = h + guided_hint
        outs.append(zc(h))
    h = unet_middle(control, h, emb, context, ctx_kv, tome)
    outs.append(control.middle_block_out(h))
    return outs


def controlnet_apply(control: ControlNet, x, hint, timesteps, context,
                     guided_hint=None, ctx_kv=None, y=None) -> List[torch.Tensor]:
    """NHWC x (N, h, w, 4) and hint (N, H, W, 3) in [0, 1] -> 13 NHWC taps."""
    gh = None if guided_hint is None else nchw(guided_hint)
    hint = None if hint is None else nchw(hint)
    return [nhwc(t) for t in controlnet_forward(
        control, nchw(x), hint, timesteps, context, gh, ctx_kv, y=y)]


def scale_control(control: List[torch.Tensor], control_scales):
    """Per-tap strengths: a length-13 sequence or (13,) tensor shared by the
    batch, or a (B, 13) tensor of per-sample strengths."""
    if isinstance(control_scales, torch.Tensor) and control_scales.dim() == 2:
        return [c * control_scales[:, i].to(c.device, c.dtype)[:, None, None, None]
                for i, c in enumerate(control)]
    return [c * const_tensor(float(s), c.dtype, c.device)
            for c, s in zip(control, control_scales)]


def per_net(v, i: int):
    """Net i's value of a multi-ControlNet argument: per-net values are
    tuples (a list of 13 numbers is one scale vector shared by the nets)."""
    return v[i] if isinstance(v, tuple) else v


def controlled_unet_forward(unet: UNetModel, control, x, hint,
                            timesteps, context, control_scales=None,
                            only_mid_control: bool = False, guided_hint=None,
                            unet_ctx_kv=None, ctrl_ctx_kv=None, tome=None, y=None):
    """ControlLDM.apply_model (cldm/cldm.py:328-341) on NCHW tensors.
    hint=None and guided_hint=None run the UNet without control (the uncond
    branch of guess mode). tome: token merging in both nets (ops/tome.py);
    y: the ADM vector of ADM-conditioned nets, to both.

    Multi-ControlNet (the JAX controlled_unet_apply): `control` a tuple of N
    nets, with hint / guided_hint / control_scales / ctrl_ctx_kv tuples of
    N (or one value shared by the nets); the residual taps enter the UNet
    linearly, so the nets' scaled taps are summed, in net order."""
    if hint is None and guided_hint is None:
        return unet_forward(unet, x, timesteps, context, ctx_kv=unet_ctx_kv,
                            tome=tome, y=y)
    nets = control if isinstance(control, tuple) else (control,)
    taps = None
    for i, net in enumerate(nets):
        net_taps = controlnet_forward(net, x, per_net(hint, i), timesteps, context,
                                      guided_hint=per_net(guided_hint, i),
                                      ctx_kv=per_net(ctrl_ctx_kv, i), tome=tome, y=y)
        if control_scales is not None:
            net_taps = scale_control(net_taps, per_net(control_scales, i))
        taps = net_taps if taps is None else [a + b for a, b in zip(taps, net_taps)]
    return unet_forward(unet, x, timesteps, context, taps, only_mid_control,
                        ctx_kv=unet_ctx_kv, tome=tome, y=y)


def _map(fn, v):
    """fn over a per-net tuple, or over the one value; None stays None."""
    if v is None:
        return None
    return tuple(fn(a) for a in v) if isinstance(v, tuple) else fn(v)


def controlled_unet_apply(unet: UNetModel, control, x, hint,
                          timesteps, context,
                          control_scales: Optional[Sequence[float]] = None,
                          only_mid_control: bool = False, guided_hint=None,
                          unet_ctx_kv=None, ctrl_ctx_kv=None, tome=None, y=None):
    """NHWC x, hint and guided_hint (or per-net tuples of them) -> NHWC eps
    prediction."""
    return nhwc(controlled_unet_forward(
        unet, control, nchw(x), _map(nchw, hint), timesteps, context,
        control_scales, only_mid_control, _map(nchw, guided_hint),
        unet_ctx_kv, ctrl_ctx_kv, tome, y))


def guess_mode_scales(strength: float, n: int = 13) -> List[float]:
    """Guess-mode decay strength * 0.825^(12-i) (canny2image_TRT.py:78)."""
    return [strength * (0.825 ** float(n - 1 - i)) for i in range(n)]
