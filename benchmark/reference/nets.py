"""Plain float32 PyTorch reference of the benchmark's networks.

A frozen copy of `stablediffusioneo_tpu/testing/torch_ref.py` (the SD-1.5 UNet,
ControlNet and VAE under the checkpoints' state-dict names), extended with
the text towers (HF CLIP ViT-L/14 and OpenCLIP bigG with its pooled,
projected output) and SDXL's layout (per-level transformer depth, 64-channel
heads, linear proj_in / proj_out, the ADM input). It imports nothing of the
measured program or of the JAX package: sizes come from the benchmark's
configuration files (`benchmark/configs/*.json`), as plain dicts.

Departures from the published modules: dropout layers are left out (p = 0
at inference); attention is written out (einsum, softmax) rather than any
fused call.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class UNetSpec:
    """The numbers of a UNet section of a configuration file."""

    def __init__(self, d: dict):
        self.in_channels = d["in_channels"]
        self.out_channels = d["out_channels"]
        self.model_channels = d["model_channels"]
        self.channel_mult = tuple(d["channel_mult"])
        self.num_res_blocks = d["num_res_blocks"]
        self.attention_resolutions = set(d["attention_resolutions"])
        self.transformer_depth = d["transformer_depth"]
        self.context_dim = d["context_dim"]
        self.num_heads = d.get("num_heads")
        self.num_head_channels = d.get("num_head_channels")
        self.adm_in_channels = d.get("adm_in_channels")
        self.use_linear = bool(d.get("use_linear_in_transformer", False))
        self.groups = d.get("groups", 32)

    def heads_for(self, ch: int) -> int:
        if self.num_head_channels:
            return ch // self.num_head_channels
        return self.num_heads

    def depth_for(self, level: int) -> int:
        td = self.transformer_depth
        return td[level] if isinstance(td, (list, tuple)) else td


def timestep_embedding(timesteps, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attend(q, k, v, heads, mask=None):
    """(B, Tq, C) x (B, Tk, C) multi-head attention, written out."""
    b, tq, c = q.shape
    tk = k.shape[1]
    hd = c // heads
    q = q.reshape(b, tq, heads, hd).transpose(1, 2)
    k = k.reshape(b, tk, heads, hd).transpose(1, 2)
    v = v.reshape(b, tk, heads, hd).transpose(1, 2)
    sim = torch.einsum("bhid,bhjd->bhij", q, k) * hd ** -0.5
    if mask is not None:
        sim = sim + mask
    out = torch.einsum("bhij,bhjd->bhid", sim.softmax(dim=-1), v)
    return out.transpose(1, 2).reshape(b, tq, c)


# ------------------------------------------------------------------ UNet


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim=None, heads=8):
        super().__init__()
        context_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(query_dim, query_dim))

    def forward(self, x, context=None):
        context = x if context is None else context
        return self.to_out(attend(self.to_q(x), self.to_k(context), self.to_v(context),
                                  self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        # index 1 is the published module's Dropout, which holds no weights
        self.net = nn.ModuleDict({"0": GEGLU(dim, dim * mult), "2": nn.Linear(dim * mult, dim)})

    def forward(self, x):
        return self.net["2"](self.net["0"](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=heads)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim=context_dim, heads=heads)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """ldm/sgm SpatialTransformer; use_linear: SDXL's linear proj_in / proj_out."""

    def __init__(self, ch, heads, depth, context_dim, groups, use_linear):
        super().__init__()
        self.use_linear = use_linear
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        proj = (lambda: nn.Linear(ch, ch)) if use_linear else (lambda: nn.Conv2d(ch, ch, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, context_dim) for _ in range(depth)])
        self.proj_out = proj()

    def forward(self, x, context):
        b, c, h, w = x.shape
        x_in = x
        x = self.norm(x)
        if not self.use_linear:
            x = self.proj_in(x)
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.use_linear:
            x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.use_linear:
            x = self.proj_out(x)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if not self.use_linear:
            x = self.proj_out(x)
        return x + x_in


class ResBlock(nn.Module):
    def __init__(self, cin, emb_dim, cout, groups):
        super().__init__()
        self.in_layers = nn.Sequential(nn.GroupNorm(groups, cin), nn.SiLU(),
                                       nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, cout))
        self.out_layers = nn.ModuleDict({"0": nn.GroupNorm(groups, cout),
                                         "3": nn.Conv2d(cout, cout, 3, padding=1)})
        self.skip_connection = nn.Conv2d(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        h = self.out_layers["3"](F.silu(self.out_layers["0"](h)))
        return self.skip_connection(x) + h


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Seq(nn.Sequential):
    """TimestepEmbedSequential."""

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


def _embeddings(net, s: UNetSpec):
    emb_dim = s.model_channels * 4
    net.time_embed = nn.Sequential(nn.Linear(s.model_channels, emb_dim), nn.SiLU(),
                                   nn.Linear(emb_dim, emb_dim))
    if s.adm_in_channels:
        # real SDXL checkpoints name the MLP label_emb.0.0 / label_emb.0.2
        net.label_emb = nn.Sequential(nn.Sequential(
            nn.Linear(s.adm_in_channels, emb_dim), nn.SiLU(), nn.Linear(emb_dim, emb_dim)))
    return emb_dim


def _embed(net, timesteps, y):
    emb = net.time_embed(timestep_embedding(timesteps, net.spec.model_channels))
    return emb if y is None else emb + net.label_emb(y)


def _encoder(net, s: UNetSpec, emb_dim, tap=None):
    """The input blocks (and, with tap, the ControlNet's zero convs); returns
    the channel list of the skips and the last width."""
    net.input_blocks = nn.ModuleList([Seq(nn.Conv2d(s.in_channels, s.model_channels, 3,
                                                    padding=1))])
    chs, ch, ds = [s.model_channels], s.model_channels, 1
    if tap is not None:
        tap.append(Seq(nn.Conv2d(ch, ch, 1)))
    for level, m in enumerate(s.channel_mult):
        for _ in range(s.num_res_blocks):
            layers = [ResBlock(ch, emb_dim, m * s.model_channels, s.groups)]
            ch = m * s.model_channels
            if ds in s.attention_resolutions and s.depth_for(level) > 0:
                layers.append(SpatialTransformer(ch, s.heads_for(ch), s.depth_for(level),
                                                 s.context_dim, s.groups, s.use_linear))
            net.input_blocks.append(Seq(*layers))
            chs.append(ch)
            if tap is not None:
                tap.append(Seq(nn.Conv2d(ch, ch, 1)))
        if level != len(s.channel_mult) - 1:
            net.input_blocks.append(Seq(Downsample(ch)))
            chs.append(ch)
            if tap is not None:
                tap.append(Seq(nn.Conv2d(ch, ch, 1)))
            ds *= 2
    last = len(s.channel_mult) - 1
    net.middle_block = Seq(
        ResBlock(ch, emb_dim, ch, s.groups),
        SpatialTransformer(ch, s.heads_for(ch), s.depth_for(last), s.context_dim, s.groups,
                           s.use_linear),
        ResBlock(ch, emb_dim, ch, s.groups))
    return chs, ch, ds


class UNet(nn.Module):
    def __init__(self, d: dict):
        super().__init__()
        s = self.spec = UNetSpec(d)
        emb_dim = _embeddings(self, s)
        chs, ch, ds = _encoder(self, s, emb_dim)
        self.output_blocks = nn.ModuleList()
        for level, m in reversed(list(enumerate(s.channel_mult))):
            for i in range(s.num_res_blocks + 1):
                layers = [ResBlock(ch + chs.pop(), emb_dim, m * s.model_channels, s.groups)]
                ch = m * s.model_channels
                if ds in s.attention_resolutions and s.depth_for(level) > 0:
                    layers.append(SpatialTransformer(ch, s.heads_for(ch), s.depth_for(level),
                                                     s.context_dim, s.groups, s.use_linear))
                if level != 0 and i == s.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(Seq(*layers))
        self.out = nn.Sequential(nn.GroupNorm(s.groups, ch), nn.SiLU(),
                                 nn.Conv2d(ch, s.out_channels, 3, padding=1))

    def forward(self, x, timesteps, context, control=None, y=None):
        emb = _embed(self, timesteps, y)
        hs, h = [], x
        for module in self.input_blocks:
            h = module(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        control = None if control is None else list(control)
        if control is not None:
            h = h + control.pop()
        for module in self.output_blocks:
            skip = hs.pop()
            if control is not None:
                skip = skip + control.pop()
            h = module(torch.cat([h, skip], dim=1), emb, context)
        return self.out(h)


class ControlNet(nn.Module):
    def __init__(self, d: dict, hint_channels: int):
        super().__init__()
        s = self.spec = UNetSpec(d)
        emb_dim = _embeddings(self, s)
        mc = s.model_channels
        convs = [(hint_channels, 16, 1), (16, 16, 1), (16, 32, 2), (32, 32, 1),
                 (32, 96, 2), (96, 96, 1), (96, 256, 2), (256, mc, 1)]
        # the published block interleaves SiLUs: convs at the even indices
        self.input_hint_block = nn.ModuleDict({
            str(2 * i): nn.Conv2d(a, b, 3, padding=1, stride=st)
            for i, (a, b, st) in enumerate(convs)})
        self.zero_convs = nn.ModuleList()
        _, ch, _ = _encoder(self, s, emb_dim, tap=self.zero_convs)
        self.middle_block_out = Seq(nn.Conv2d(ch, ch, 1))

    def hint_embedding(self, hint):
        n = len(self.input_hint_block)
        for i in range(n):
            hint = self.input_hint_block[str(2 * i)](hint)
            if i != n - 1:
                hint = F.silu(hint)
        return hint

    def forward(self, x, hint, timesteps, context, y=None):
        emb = _embed(self, timesteps, y)
        guided = self.hint_embedding(hint)
        outs, h = [], x
        for module, zero_conv in zip(self.input_blocks, self.zero_convs):
            h = module(h, emb, context)
            if guided is not None:
                h, guided = h + guided, None
            outs.append(zero_conv(h, emb, context))
        h = self.middle_block(h, emb, context)
        outs.append(self.middle_block_out(h, emb, context))
        return outs


# ------------------------------------------------------------------- VAE


def Normalize(c, groups):
    return nn.GroupNorm(groups, c, eps=1e-6)


class VAEResnetBlock(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = Normalize(cin, groups)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = Normalize(cout, groups)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.norm = Normalize(c, groups)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        h_ = self.norm(x)
        b, c, h, w = x.shape
        q, k, v = (m(h_).reshape(b, c, h * w).transpose(1, 2) for m in (self.q, self.k, self.v))
        out = attend(q, k, v, 1).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class VAEDown(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class AutoencoderKL(nn.Module):
    """Encoder + decoder + quant convs under first_stage_model's names (the
    encoder is held because the checkpoint holds it; the benchmark decodes)."""

    def __init__(self, d: dict):
        super().__init__()
        ch, mult, nrb, groups = d["ch"], d["ch_mult"], d["num_res_blocks"], d["groups"]
        z, double_z = d["z_channels"], d["double_z"]
        self.scale_factor = d["scale_factor"]
        enc = nn.Module()
        enc.conv_in = nn.Conv2d(d["in_channels"], ch, 3, padding=1)
        enc.down = nn.ModuleList()
        bi = ch
        for i, m in enumerate(mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(nrb):
                level.block.append(VAEResnetBlock(bi, ch * m, groups))
                bi = ch * m
            if i != len(mult) - 1:
                level.downsample = VAEDown(bi)
            enc.down.append(level)
        enc.mid = nn.Module()
        enc.mid.block_1 = VAEResnetBlock(bi, bi, groups)
        enc.mid.attn_1 = VAEAttnBlock(bi, groups)
        enc.mid.block_2 = VAEResnetBlock(bi, bi, groups)
        enc.norm_out = Normalize(bi, groups)
        enc.conv_out = nn.Conv2d(bi, 2 * z if double_z else z, 3, padding=1)
        self.encoder = enc

        dec = nn.Module()
        bi = ch * mult[-1]
        dec.conv_in = nn.Conv2d(z, bi, 3, padding=1)
        dec.mid = nn.Module()
        dec.mid.block_1 = VAEResnetBlock(bi, bi, groups)
        dec.mid.attn_1 = VAEAttnBlock(bi, groups)
        dec.mid.block_2 = VAEResnetBlock(bi, bi, groups)
        up = [None] * len(mult)
        for i in reversed(range(len(mult))):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(nrb + 1):
                level.block.append(VAEResnetBlock(bi, ch * mult[i], groups))
                bi = ch * mult[i]
            if i != 0:
                level.upsample = Upsample(bi)
            up[i] = level
        dec.up = nn.ModuleList(up)
        dec.norm_out = Normalize(bi, groups)
        dec.conv_out = nn.Conv2d(bi, d["out_channels"], 3, padding=1)
        self.decoder = dec
        e = d["embed_dim"]
        self.quant_conv = nn.Conv2d(2 * z if double_z else z, 2 * e if double_z else e, 1)
        self.post_quant_conv = nn.Conv2d(e, z, 1)

    def decode(self, z):
        """Scaled latents (NCHW) -> pixels in about [-1, 1]."""
        dec = self.decoder
        h = dec.conv_in(self.post_quant_conv(z / self.scale_factor))
        h = dec.mid.block_2(dec.mid.attn_1(dec.mid.block_1(h)))
        for i in reversed(range(len(dec.up))):
            level = dec.up[i]
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return dec.conv_out(F.silu(dec.norm_out(h)))


# ------------------------------------------------------------ text towers


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def causal_mask(t, device):
    return torch.triu(torch.full((t, t), float("-inf"), device=device), diagonal=1)


class HFCLIPLayer(nn.Module):
    def __init__(self, d, inner, heads, act):
        super().__init__()
        self.heads, self.act = heads, act
        self.layer_norm1 = nn.LayerNorm(d)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.layer_norm2 = nn.LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, inner)
        self.mlp.fc2 = nn.Linear(inner, d)

    def forward(self, x, mask):
        a, h = self.self_attn, self.layer_norm1(x)
        x = x + a.out_proj(attend(a.q_proj(h), a.k_proj(h), a.v_proj(h), self.heads, mask))
        return x + self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))


class HFCLIPText(nn.Module):
    """HF CLIPTextModel (`text_model.*`): SD-1.5's tower and SDXL's first."""

    def __init__(self, d: dict):
        super().__init__()
        self.layer = d["layer"]
        act = quick_gelu if d["act"] == "quick_gelu" else F.gelu
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(d["vocab_size"], d["hidden_size"])
        tm.embeddings.position_embedding = nn.Embedding(d["max_length"], d["hidden_size"])
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [HFCLIPLayer(d["hidden_size"], d["intermediate_size"], d["num_heads"], act)
             for _ in range(d["num_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d["hidden_size"])

    def forward(self, ids):
        """(B, T) ids -> the hidden state the configuration's `layer` names:
        "last" (final LN of the last layer) or "penultimate_raw" (the state
        after the second-to-last layer, no LN)."""
        tm = self.text_model
        x = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding.weight[None, :ids.shape[1]])
        mask = causal_mask(ids.shape[1], ids.device)
        layers = tm.encoder.layers
        n = len(layers) if self.layer == "last" else len(layers) - 1
        for layer in layers[:n]:
            x = layer(x, mask)
        return tm.final_layer_norm(x) if self.layer == "last" else x


class OpenCLIPBlock(nn.Module):
    def __init__(self, d, inner, heads):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(d)
        self.attn = nn.Module()
        self.attn.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.attn.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.attn.out_proj = nn.Linear(d, d)
        self.ln_2 = nn.LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(d, inner)
        self.mlp.c_proj = nn.Linear(inner, d)

    def forward(self, x, mask):
        a = self.attn
        q, k, v = F.linear(self.ln_1(x), a.in_proj_weight, a.in_proj_bias).chunk(3, dim=-1)
        x = x + a.out_proj(attend(q, k, v, self.heads, mask))
        return x + self.mlp.c_proj(F.gelu(self.mlp.c_fc(self.ln_2(x))))


class OpenCLIPText(nn.Module):
    """open_clip's text tower (`model.*`): SDXL's bigG, penultimate hidden
    state (no LN) as context, the final-LN state at the EOT token through
    text_projection as the pooled output."""

    def __init__(self, d: dict):
        super().__init__()
        w = d["hidden_size"]
        self.token_embedding = nn.Embedding(d["vocab_size"], w)
        self.positional_embedding = nn.Parameter(torch.empty(d["max_length"], w))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [OpenCLIPBlock(w, d["intermediate_size"], d["num_heads"])
             for _ in range(d["num_layers"])])
        self.ln_final = nn.LayerNorm(w)
        self.text_projection = nn.Parameter(torch.empty(w, d["projection_dim"]))

    def forward(self, ids):
        x = self.token_embedding(ids) + self.positional_embedding[None, :ids.shape[1]]
        mask = causal_mask(ids.shape[1], ids.device)
        blocks = self.transformer.resblocks
        for blk in blocks[:-1]:
            x = blk(x, mask)
        hidden = x
        last = self.ln_final(blocks[-1](x, mask))
        pooled = last[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)]
        return hidden, pooled @ self.text_projection
