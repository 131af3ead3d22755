"""Plain float32 PyTorch reference of Stable Diffusion 3.5 Medium: the
MMDiT-X, the three text towers, the 16-channel VAE and the flow-matching
sampler, written from the published description (Esser et al.,
arXiv:2403.03206; Stability AI's sd3.5 `mmditx.py`, `sd3_impls.py`;
diffusers' StableDiffusion3Pipeline, FlowMatchEulerDiscreteScheduler, HF
CLIPTextModelWithProjection and T5EncoderModel). It imports nothing of the
port or of the JAX package: sizes come as plain dicts (the sections of
`benchmark/configs/sd35-medium.json`), weights from the caller's state dict
under the single-file checkpoint's names. No kernels, no graphs; `sd3_request`
turns TF32 off while it runs.

Departures from the published modules, none of which changes a number in
float32 beyond rounding:
  * dropout is left out (p = 0 at inference);
  * attention is written out (einsum, softmax over float32 logits), in
    blocks of query rows so that the 4429-token joint sites and the VAE's
    16,384-token mid-block hold at most about 1 GiB of logits;
  * the joint attention puts the context tokens first, as mmditx.py
    (diffusers puts the image first; the keys' order does not change a
    softmax);
  * the RMSNorms (q/k norms, T5's) are LayerNorm modules without a bias
    whose forward is the RMS form, and the adaLN LayerNorms have no
    parameters, so every parameter is a conv, a linear, a norm gain or an
    embedding;
  * the 2-D sin-cos position table is computed (diffusers'
    get_2d_sincos_pos_embed at pos_embed_max_size, base size sample_size /
    patch_size), not read: the checkpoint's `pos_embed` is that table;
  * CLIP's causal mask is -inf above the diagonal (HF adds the dtype's
    lowest value: the same softmax);
  * the sampler carries the latents in float32 (the pipeline carries its
    compute dtype); the decode's pixels are truncated to uint8 after
    x * 127.5 + 127.5, as the other families' references.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LOGITS_BYTES = 1 << 30


def attend(q, k, v, heads: int, mask=None):
    """(B, Tq, C) x (B, Tk, C) multi-head attention, scale d^-1/2, written
    out over blocks of query rows."""
    b, tq, c = q.shape
    tk, d = k.shape[1], c // heads
    q = q.reshape(b, tq, heads, d).transpose(1, 2)
    k = k.reshape(b, tk, heads, d).transpose(1, 2)
    v = v.reshape(b, tk, heads, d).transpose(1, 2)
    rows = max(1, LOGITS_BYTES // (4 * b * heads * tk))
    outs = []
    for i in range(0, tq, rows):
        sim = torch.einsum("bhid,bhjd->bhij", q[:, :, i:i + rows], k) * d ** -0.5
        if mask is not None:
            sim = sim + mask[i:i + rows]
        outs.append(torch.einsum("bhij,bhjd->bhid", sim.softmax(dim=-1), v))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, tq, c)


class RMSNorm(nn.LayerNorm):
    """x / sqrt(mean(x^2) + eps) * weight."""

    def __init__(self, d: int, eps: float):
        super().__init__(d, eps=eps, bias=False)

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


def plain_ln(x, eps=1e-6):
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


def modulate(x, shift, scale):
    return x * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)


# ------------------------------------------------------------------ MMDiT-X


class Attention(nn.Module):
    def __init__(self, c, heads, pre_only):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(c, 3 * c)
        self.ln_q = RMSNorm(c // heads, 1e-6)
        self.ln_k = RMSNorm(c // heads, 1e-6)
        if not pre_only:
            self.proj = nn.Linear(c, c)

    def pre(self, x):
        b, t, c = x.shape
        q, k, v = self.qkv(x).reshape(b, t, 3, self.heads, c // self.heads).unbind(2)
        return self.ln_q(q).reshape(b, t, c), self.ln_k(k).reshape(b, t, c), v.reshape(b, t, c)


class Mlp(nn.Module):
    def __init__(self, c, ratio):
        super().__init__()
        self.fc1 = nn.Linear(c, ratio * c)
        self.fc2 = nn.Linear(ratio * c, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Stream(nn.Module):
    """mmditx.py's DismantledBlock."""

    def __init__(self, c, heads, ratio, pre_only=False, dual=False):
        super().__init__()
        self.pre_only, self.dual = pre_only, dual
        n = 9 if dual else (2 if pre_only else 6)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(c, n * c))
        self.attn = Attention(c, heads, pre_only)
        if dual:
            self.attn2 = Attention(c, heads, False)
        if not pre_only:
            self.mlp = Mlp(c, ratio)


class JointBlock(nn.Module):
    def __init__(self, c, heads, ratio, pre_only, dual):
        super().__init__()
        self.context_block = Stream(c, heads, ratio, pre_only=pre_only)
        self.x_block = Stream(c, heads, ratio, dual=dual)

    def forward(self, ctx, x, c):
        cb, xb = self.context_block, self.x_block
        cm = cb.adaLN_modulation(c).chunk(2 if cb.pre_only else 6, dim=1)
        xm = xb.adaLN_modulation(c).chunk(9 if xb.dual else 6, dim=1)
        cq, ck, cv = cb.attn.pre(modulate(plain_ln(ctx), cm[0], cm[1]))
        xn = plain_ln(x)
        xq, xk, xv = xb.attn.pre(modulate(xn, xm[0], xm[1]))
        heads = xb.attn.heads
        att = attend(torch.cat([cq, xq], 1), torch.cat([ck, xk], 1), torch.cat([cv, xv], 1),
                     heads)
        ca, xa = att[:, :ctx.shape[1]], att[:, ctx.shape[1]:]
        x = x + xm[2].unsqueeze(1) * xb.attn.proj(xa)
        if xb.dual:
            q2, k2, v2 = xb.attn2.pre(modulate(xn, xm[6], xm[7]))
            x = x + xm[8].unsqueeze(1) * xb.attn2.proj(attend(q2, k2, v2, heads))
        x = x + xm[5].unsqueeze(1) * xb.mlp(modulate(plain_ln(x), xm[3], xm[4]))
        if cb.pre_only:
            return None, x
        ctx = ctx + cm[2].unsqueeze(1) * cb.attn.proj(ca)
        ctx = ctx + cm[5].unsqueeze(1) * cb.mlp(modulate(plain_ln(ctx), cm[3], cm[4]))
        return ctx, x


class Embedder(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(cin, c), nn.SiLU(), nn.Linear(c, c))

    def forward(self, x):
        return self.mlp(x)


def timestep_features(t, dim=256, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sincos_table(dim, grid, base):
    """diffusers' get_2d_sincos_pos_embed(dim, grid, base_size=base), float64,
    (grid * grid, dim)."""
    def one_d(d, pos):
        omega = torch.arange(d // 2, dtype=torch.float64) / (d / 2.0)
        out = pos.reshape(-1)[:, None] * (1.0 / 10000 ** omega)[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    gh = torch.arange(grid, dtype=torch.float64) / (grid / base)
    gw = torch.arange(grid, dtype=torch.float64) / (grid / base)
    g = torch.stack(torch.meshgrid(gw, gh, indexing="xy"), dim=0)
    return torch.cat([one_d(dim // 2, g[0]), one_d(dim // 2, g[1])], dim=1)


class MMDiTX(nn.Module):
    def __init__(self, t: dict):
        super().__init__()
        self.t = t
        c = t["num_attention_heads"] * t["attention_head_dim"]
        heads, p = t["num_attention_heads"], t["patch_size"]
        self.x_embedder = nn.Module()
        self.x_embedder.proj = nn.Conv2d(t["in_channels"], c, p, stride=p)
        self.t_embedder = Embedder(256, c)
        self.y_embedder = Embedder(t["pooled_projection_dim"], c)
        self.context_embedder = nn.Linear(t["joint_attention_dim"], c)
        n = t["num_layers"]
        self.joint_blocks = nn.ModuleList([
            JointBlock(c, heads, t.get("mlp_ratio", 4), i == n - 1,
                       i in set(t["dual_attention_layers"])) for i in range(n)])
        self.final_layer = nn.Module()
        self.final_layer.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(c, 2 * c))
        self.final_layer.linear = nn.Linear(c, p * p * t["out_channels"])
        self._pe = {}

    def cropped_pos_embed(self, hp, wp, device):
        key = (hp, wp, str(device))
        if key not in self._pe:
            t = self.t
            m = t["pos_embed_max_size"]
            table = sincos_table(self.context_embedder.out_features, m,
                                 t["sample_size"] // t["patch_size"])
            table = table.reshape(m, m, -1)
            top, left = (m - hp) // 2, (m - wp) // 2
            crop = table[top:top + hp, left:left + wp].reshape(1, hp * wp, -1)
            self._pe[key] = crop.float().to(device)
        return self._pe[key]

    def forward(self, x, t, context, pooled):
        """x NCHW (B, 16, h, w); t (B,) = 1000 sigma; context (B, L, 4096);
        pooled (B, 2048) -> the velocity, NCHW."""
        b, _, h, w = x.shape
        p, co = self.t["patch_size"], self.t["out_channels"]
        x = self.x_embedder.proj(x).flatten(2).transpose(1, 2)
        x = x + self.cropped_pos_embed(h // p, w // p, x.device)
        c = self.t_embedder(timestep_features(t)) + self.y_embedder(pooled)
        ctx = self.context_embedder(context)
        for blk in self.joint_blocks:
            ctx, x = blk(ctx, x, c)
        shift, scale = self.final_layer.adaLN_modulation(c).chunk(2, dim=1)
        x = self.final_layer.linear(modulate(plain_ln(x), shift, scale))
        x = x.reshape(b, h // p, w // p, p, p, co)
        return torch.einsum("nhwpqc->nchpwq", x).reshape(b, co, h, w)


# ------------------------------------------------------------------ towers


class CLIPLayer(nn.Module):
    def __init__(self, d, inner, heads, act):
        super().__init__()
        self.heads, self.act = heads, act
        self.layer_norm1 = nn.LayerNorm(d)
        self.self_attn = nn.Module()
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, n, nn.Linear(d, d))
        self.layer_norm2 = nn.LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, inner)
        self.mlp.fc2 = nn.Linear(inner, d)

    def forward(self, x, mask):
        a = self.self_attn
        h = self.layer_norm1(x)
        x = x + a.out_proj(attend(a.q_proj(h), a.k_proj(h), a.v_proj(h), self.heads, mask))
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp.fc2(h)


class CLIPTextWithProjection(nn.Module):
    """HF CLIPTextModelWithProjection: (hidden state -2, text_embeds)."""

    def __init__(self, t: dict):
        super().__init__()
        d = t["hidden_size"]
        self.text_model = nn.Module()
        self.text_model.embeddings = nn.Module()
        self.text_model.embeddings.token_embedding = nn.Embedding(t["vocab_size"], d)
        self.text_model.embeddings.position_embedding = nn.Embedding(t["max_length"], d)
        self.text_model.encoder = nn.Module()
        self.text_model.encoder.layers = nn.ModuleList([
            CLIPLayer(d, t["intermediate_size"], t["num_heads"], t["act"])
            for _ in range(t["num_layers"])])
        self.text_model.final_layer_norm = nn.LayerNorm(d)
        self.text_projection = nn.Linear(d, t["projection_dim"], bias=False)

    def forward(self, ids):
        tm = self.text_model
        n = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:n]
        mask = torch.full((n, n), float("-inf"), device=ids.device).triu(1)
        states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, mask)
            states.append(x)
        last = tm.final_layer_norm(x)
        eos = ids.argmax(dim=-1)  # each row's first EOT, the largest id
        pooled = last[torch.arange(ids.shape[0], device=ids.device), eos]
        return states[-2], self.text_projection(pooled)


def t5_buckets(n, num_buckets=32, max_distance=128):
    """HF T5's bidirectional relative-position buckets, (n, n)."""
    rel = torch.arange(n)[None, :] - torch.arange(n)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).long() * nb
    rel = rel.abs()
    exact = nb // 2
    large = exact + (torch.log(rel.float() / exact) / math.log(max_distance / exact)
                     * (nb - exact)).long()
    large = torch.minimum(large, torch.full_like(large, nb - 1))
    return out + torch.where(rel < exact, rel, large)


class T5Layer(nn.Module):
    def __init__(self, d, inner, d_ff):
        super().__init__()
        attn, ff = nn.Module(), nn.Module()
        attn.SelfAttention = nn.Module()
        for n in ("q", "k", "v"):
            setattr(attn.SelfAttention, n, nn.Linear(d, inner, bias=False))
        attn.SelfAttention.o = nn.Linear(inner, d, bias=False)
        attn.layer_norm = RMSNorm(d, 1e-6)
        ff.DenseReluDense = nn.Module()
        ff.DenseReluDense.wi_0 = nn.Linear(d, d_ff, bias=False)
        ff.DenseReluDense.wi_1 = nn.Linear(d, d_ff, bias=False)
        ff.DenseReluDense.wo = nn.Linear(d_ff, d, bias=False)
        ff.layer_norm = RMSNorm(d, 1e-6)
        self.layer = nn.ModuleList([attn, ff])


class T5Encoder(nn.Module):
    """HF T5EncoderModel (v1.1: gated-GELU, no logit scale, the relative
    bias of block 0 shared): the last hidden state."""

    def __init__(self, t: dict):
        super().__init__()
        d, heads = t["d_model"], t["num_heads"]
        inner = heads * t["d_kv"]
        self.heads = heads
        self.shared = nn.Embedding(t["vocab_size"], d)
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList()
        for i in range(t["num_layers"]):
            blk = T5Layer(d, inner, t["d_ff"])
            if i == 0:
                blk.layer[0].SelfAttention.relative_attention_bias = nn.Embedding(
                    t.get("relative_attention_num_buckets", 32), heads)
            self.encoder.block.append(blk)
        self.encoder.final_layer_norm = RMSNorm(d, 1e-6)
        self.buckets = t.get("relative_attention_num_buckets", 32)
        self.max_distance = t.get("relative_attention_max_distance", 128)

    def forward(self, ids):
        b, n = ids.shape
        x = self.shared(ids)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        bias = table(t5_buckets(n, self.buckets, self.max_distance).to(ids.device))
        bias = bias.permute(2, 0, 1)[None]
        for blk in self.encoder.block:
            a, ff = blk.layer[0], blk.layer[1]
            h = a.layer_norm(x)
            q, k, v = (m(h).reshape(b, n, self.heads, -1).transpose(1, 2)
                       for m in (a.SelfAttention.q, a.SelfAttention.k, a.SelfAttention.v))
            w = (torch.einsum("bhid,bhjd->bhij", q, k) + bias).softmax(dim=-1)
            out = torch.einsum("bhij,bhjd->bhid", w, v).transpose(1, 2).reshape(b, n, -1)
            x = x + a.SelfAttention.o(out)
            h = ff.layer_norm(x)
            d = ff.DenseReluDense
            x = x + d.wo(F.gelu(d.wi_0(h), approximate="tanh") * d.wi_1(h))
        return self.encoder.final_layer_norm(x)


# --------------------------------------------------------------------- VAE


class ResBlock(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class AttnBlock(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.q, self.k, self.v = (nn.Conv2d(c, c, 1) for _ in range(3))
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.norm(x)
        q, k, v = (m(t).flatten(2).transpose(1, 2) for m in (self.q, self.k, self.v))
        out = attend(q, k, v, 1).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class VAE(nn.Module):
    """ldm's AutoencoderKL towers without quant convs (SD3's first stage);
    the encoder is held for the checkpoint's layout, the request decodes
    only."""

    def __init__(self, v: dict):
        super().__init__()
        ch, mult, nrb, g = v["ch"], v["ch_mult"], v["num_res_blocks"], v["groups"]
        z = v["z_channels"]
        enc = self.encoder = nn.Module()
        enc.conv_in = nn.Conv2d(v["in_channels"], ch, 3, padding=1)
        enc.down = nn.ModuleList()
        c = ch
        for i, m in enumerate(mult):
            lvl = nn.Module()
            lvl.block = nn.ModuleList()
            for _ in range(nrb):
                lvl.block.append(ResBlock(c, ch * m, g))
                c = ch * m
            if i != len(mult) - 1:
                lvl.downsample = nn.Module()
                lvl.downsample.conv = nn.Conv2d(c, c, 3, stride=2)
            enc.down.append(lvl)
        enc.mid = nn.Module()
        enc.mid.block_1, enc.mid.attn_1, enc.mid.block_2 = (ResBlock(c, c, g), AttnBlock(c, g),
                                                             ResBlock(c, c, g))
        enc.norm_out = nn.GroupNorm(g, c, eps=1e-6)
        enc.conv_out = nn.Conv2d(c, 2 * z, 3, padding=1)
        dec = self.decoder = nn.Module()
        c = ch * mult[-1]
        dec.conv_in = nn.Conv2d(z, c, 3, padding=1)
        dec.mid = nn.Module()
        dec.mid.block_1, dec.mid.attn_1, dec.mid.block_2 = (ResBlock(c, c, g), AttnBlock(c, g),
                                                             ResBlock(c, c, g))
        up = [None] * len(mult)
        for i in reversed(range(len(mult))):
            lvl = nn.Module()
            lvl.block = nn.ModuleList()
            for _ in range(nrb + 1):
                lvl.block.append(ResBlock(c, ch * mult[i], g))
                c = ch * mult[i]
            if i != 0:
                lvl.upsample = nn.Module()
                lvl.upsample.conv = nn.Conv2d(c, c, 3, padding=1)
            up[i] = lvl
        dec.up = nn.ModuleList(up)
        dec.norm_out = nn.GroupNorm(g, c, eps=1e-6)
        dec.conv_out = nn.Conv2d(c, v["out_channels"], 3, padding=1)

    def decode(self, z):
        d = self.decoder
        h = d.conv_in(z)
        h = d.mid.block_2(d.mid.attn_1(d.mid.block_1(h)))
        for lvl in reversed(d.up):
            for blk in lvl.block:
                h = blk(h)
            if hasattr(lvl, "upsample"):
                h = lvl.upsample.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return d.conv_out(F.silu(d.norm_out(h)))


# ----------------------------------------------------------------- request


class SD3(nn.Module):
    """The five networks under the single-file checkpoint's names."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.model = nn.Module()
        self.model.diffusion_model = MMDiTX(cfg["transformer"])
        self.first_stage_model = VAE(cfg["vae"])
        self.text_encoders = nn.Module()
        for name, tower in (("clip_l", CLIPTextWithProjection(cfg["clip_l"])),
                            ("clip_g", CLIPTextWithProjection(cfg["clip_g"])),
                            ("t5xxl", T5Encoder(cfg["t5"]))):
            setattr(self.text_encoders, name, nn.Module())
            getattr(self.text_encoders, name).transformer = tower


def conditioning(net: SD3, ids_l, ids_g, ids_t5):
    """diffusers' encode_prompt: (context (B, 77 + T5 tokens, T5 width),
    pooled (B, 2048))."""
    te = net.text_encoders
    hl, pl = te.clip_l.transformer(ids_l)
    hg, pg = te.clip_g.transformer(ids_g)
    t5 = te.t5xxl.transformer(ids_t5)
    clip = torch.cat([hl, hg], dim=-1)
    clip = F.pad(clip, (0, t5.shape[-1] - clip.shape[-1]))
    return torch.cat([clip, t5], dim=1), torch.cat([pl, pg], dim=-1)


def flow_sigmas(steps: int, shift: float):
    """diffusers' FlowMatchEulerDiscreteScheduler.set_timesteps (1000
    training steps, no dynamic shifting), with the final 0."""
    def sh(s):
        return shift * s / (1 + (shift - 1) * s)

    ts = np.linspace(1000 * sh(1.0), 1000 * sh(1 / 1000), steps)
    return np.concatenate([sh(ts / 1000), [0.0]])


def draw_x_T(seed: int, h: int, w: int, channels: int, device) -> torch.Tensor:
    """The initial latents of a request of `seed`, NCHW (1, channels, h, w):
    torch.randn((h, w, channels)) from a generator on `device`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((h, w, channels), generator=g, device=device).permute(2, 0, 1)[None]


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@torch.no_grad()
def sd3_sample(net: SD3, cfg: dict, context, pooled, x):
    """The flow-matching Euler loop with guidance from x (NCHW, batch 1):
    context and pooled hold the cond then the uncond row. Returns x_0."""
    s = cfg["sampling"]
    mm = net.model.diffusion_model
    sig = flow_sigmas(s["steps"], s["shift"])
    for a, b in zip(sig[:-1], sig[1:]):
        t = torch.full((2,), 1000 * float(a), device=x.device)
        v_c, v_u = mm(torch.cat([x, x]), t, context, pooled).chunk(2)
        x = x + (float(b) - float(a)) * (v_u + s["scale"] * (v_c - v_u))
    return x


@torch.no_grad()
def sd3_request(net: SD3, cfg: dict, ids_l, ids_g, ids_t5, seed: int):
    """One txt2img request, batch 1: (x_0 latents NHWC fp32, uint8 image
    NHWC). ids_*: (2, T) the cond and uncond rows of each tower."""
    with no_tf32():
        dev = next(net.parameters()).device
        context, pooled = conditioning(net, *(torch.as_tensor(i, device=dev)
                                              for i in (ids_l, ids_g, ids_t5)))
        v, res = cfg["vae"], cfg["sampling"]["resolution"]
        f = 2 ** (len(v["ch_mult"]) - 1)
        x = draw_x_T(seed, res // f, res // f, v["z_channels"], dev)
        z = sd3_sample(net, cfg, context, pooled, x)
        img = net.first_stage_model.decode(z / v["scale_factor"] + v["shift_factor"])
        u8 = torch.clamp(img.permute(0, 2, 3, 1) * 127.5 + 127.5, 0, 255).to(torch.uint8)
        return z.permute(0, 2, 3, 1), u8
