"""MMDiT-X, the rectified-flow transformer of Stable Diffusion 3.5 Medium
(Esser et al., arXiv:2403.03206; Stability AI's sd3.5 reference `mmditx.py`),
under the checkpoint's names (`model.diffusion_model.*` of
sd3.5_medium.safetensors):

  x_embedder.proj                 2x2 stride-2 conv, 16 -> hidden
  t_embedder.mlp.{0,2}            256-channel [cos, sin] timestep features -> hidden
  y_embedder.mlp.{0,2}            pooled text (2048) -> hidden
  context_embedder                T5 / CLIP tokens (4096) -> hidden
  joint_blocks.N.{context_block,x_block}
      .adaLN_modulation.1         SiLU(c) -> 6 chunks (9 in a dual-attention x
                                  block, 2 in the pre-only last context block)
      .attn.{qkv, ln_q, ln_k, proj}
      .attn2.{qkv, ln_q, ln_k, proj}   x blocks of `dual_attention_layers`
      .mlp.{fc1, fc2}             GELU-tanh, ratio 4
  final_layer.{adaLN_modulation.1, linear}

A block: both streams LayerNorm (no affine, eps 1e-6) then adaLN modulate
(x * (1 + scale) + shift); q, k, v from each stream's own projection, q and
k RMS-normed per head (`ops/norms.py:rms_norm`); ONE attention over the
concatenated tokens, context first (`ops/attention.py:packed_attention`: at
1024x1024 the joint sites are 333 + 4096 = 4429 tokens); each stream's part
through its own output projection, gated into its residual, then its gated
MLP. A dual-attention x block also attends over its own 4096 tokens with
`attn2`, from the same LayerNorm under its own shift and scale, gated in
before the MLP. The last block's context stream is pre-only: it feeds the
joint attention and stops.

Position: fixed 2-D sin-cos (diffusers' get_2d_sincos_pos_embed: a
`pos_embed_max_size`^2 grid whose positions are scaled by sample_size /
patch_size / pos_embed_max_size), centre-cropped to the latent's patch grid
(`sincos_pos_embed`). It is not a parameter: the checkpoint's `pos_embed`
copy of it is a documented leftover, computed here once an engine.

The sampling loop hoists what does not change over the steps
(`embed_context`, `embed_pooled`, the position table) and calls `velocity`
once a step on the batch-2 CFG concat, NHWC latents in and out.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.ops.attention import packed_attention
from stablediffusioneo_tpu_torch.ops.layers import dense, nchw
from stablediffusioneo_tpu_torch.ops.norms import layer_norm, rms_norm
from stablediffusioneo_tpu_torch.ops.schedule import timestep_embedding

TIME_FEATURES = 256


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """SD 3.5 Medium's transformer/config.json (diffusers' names); mlp_ratio
    and eps are the reference implementation's constants."""

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 384
    dual_attention_layers: Tuple[int, ...] = tuple(range(13))
    qk_norm: str = "rms_norm"
    mlp_ratio: int = 4
    eps: float = 1e-6

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    def __post_init__(self):
        if self.qk_norm != "rms_norm":
            raise ValueError(f"MMDiT-X here takes qk_norm 'rms_norm', got {self.qk_norm!r}")
        if self.caption_projection_dim != self.hidden_size:
            raise ValueError("caption_projection_dim must equal the hidden size")


# ------------------------------------------------------------------ modules


class RMSNorm(nn.Module):
    """RMSNorm with a gain (the q/k norms, `ln_q` / `ln_k`)."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class SelfAttention(nn.Module):
    def __init__(self, c: int, head_dim: int, eps: float, pre_only: bool):
        super().__init__()
        self.qkv = nn.Linear(c, 3 * c)
        self.ln_q = RMSNorm(head_dim, eps)
        self.ln_k = RMSNorm(head_dim, eps)
        if not pre_only:
            self.proj = nn.Linear(c, c)

    def project(self, h, heads: int):
        """(B, T, C) -> q, k, v (B, T, C): q and k RMS-normed per head
        (new tensors), v a column view of the fused projection."""
        b, t, c = h.shape
        q, k, v = dense(h, self.qkv).view(b, t, 3, heads, c // heads).unbind(2)
        return (self.ln_q(q).reshape(b, t, c), self.ln_k(k).reshape(b, t, c),
                v.reshape(b, t, c))


class Mlp(nn.Module):
    def __init__(self, c: int, ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(c, ratio * c)
        self.fc2 = nn.Linear(ratio * c, c)

    def forward(self, x):
        return dense(F.gelu(dense(x, self.fc1), approximate="tanh"), self.fc2)


def _modulation(c: int, chunks: int) -> nn.Sequential:
    return nn.Sequential(nn.SiLU(), nn.Linear(c, chunks * c))


def modulate(xn, shift, scale):
    """xn * (1 + scale) + shift, the (B, C) pair broadcast over tokens."""
    return torch.addcmul(shift[:, None], xn, 1 + scale[:, None])


def gated(x, gate, y):
    """x + gate * y, the (B, C) gate broadcast over tokens."""
    return torch.addcmul(x, gate[:, None], y)


class DismantledBlock(nn.Module):
    """One stream of a joint block (the reference's name)."""

    def __init__(self, cfg: MMDiTConfig, pre_only: bool = False, dual: bool = False):
        super().__init__()
        c = cfg.hidden_size
        self.pre_only, self.dual, self.eps = pre_only, dual, cfg.eps
        self.adaLN_modulation = _modulation(c, 9 if dual else 2 if pre_only else 6)
        self.attn = SelfAttention(c, cfg.attention_head_dim, cfg.eps, pre_only)
        if dual:
            self.attn2 = SelfAttention(c, cfg.attention_head_dim, cfg.eps, False)
        if not pre_only:
            self.mlp = Mlp(c, cfg.mlp_ratio)

    def norm(self, x):
        return layer_norm(x, None, None, self.eps)

    def post(self, x, attn_out, mods):
        """The residual stream after the joint attention's part `attn_out`
        (and, dual, the image-only attention, mods[-1]) and the MLP."""
        _, _, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods[:6]
        x = gated(x, gate_msa, dense(attn_out, self.attn.proj))
        if self.dual:
            x = gated(x, mods[8], dense(mods[-1], self.attn2.proj))
        return gated(x, gate_mlp, self.mlp(modulate(self.norm(x), shift_mlp, scale_mlp)))


class JointBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, pre_only: bool, dual: bool):
        super().__init__()
        self.context_block = DismantledBlock(cfg, pre_only=pre_only)
        self.x_block = DismantledBlock(cfg, dual=dual)

    def forward(self, ctx, x, silu_c, heads: int):
        """(ctx or None after a pre-only block, x)."""
        cb, xb = self.context_block, self.x_block
        cm = dense(silu_c, cb.adaLN_modulation[1]).chunk(2 if cb.pre_only else 6, dim=1)
        xm = list(dense(silu_c, xb.adaLN_modulation[1]).chunk(9 if xb.dual else 6, dim=1))
        cq, ck, cv = cb.attn.project(modulate(cb.norm(ctx), cm[0], cm[1]), heads)
        xn = xb.norm(x)
        xq, xk, xv = xb.attn.project(modulate(xn, xm[0], xm[1]), heads)
        if xb.dual:  # the image-only attention, from the same norm
            xm.append(packed_attention(*xb.attn2.project(modulate(xn, xm[6], xm[7]), heads),
                                       heads))
        n_ctx = ctx.shape[1]
        joint = packed_attention(torch.cat([cq, xq], 1), torch.cat([ck, xk], 1),
                                 torch.cat([cv, xv], 1), heads)
        x = xb.post(x, joint[:, n_ctx:], xm)
        ctx = None if cb.pre_only else cb.post(ctx, joint[:, :n_ctx], cm)
        return ctx, x


class PatchEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_size, cfg.patch_size,
                              stride=cfg.patch_size)


class MLPEmbedder(nn.Module):
    """Linear, SiLU, Linear at `mlp.0` / `mlp.2` (the timestep and pooled
    embedders)."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(cin, c), nn.SiLU(), nn.Linear(c, c))

    def forward(self, x):
        return dense(F.silu(dense(x, self.mlp[0])), self.mlp[2])


class FinalLayer(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        c, p = cfg.hidden_size, cfg.patch_size
        self.adaLN_modulation = _modulation(c, 2)
        self.linear = nn.Linear(c, p * p * cfg.out_channels)


def sincos_pos_embed(c: int, grid: int, base: int, hp: int, wp: int) -> np.ndarray:
    """(hp * wp, c) float64: the rows of diffusers' 2-D sin-cos table of a
    grid x grid layout (positions scaled by base / grid) centre-cropped to
    hp x wp, row-major; each token's features are [sin, cos](column
    position), then [sin, cos](row position), c / 4 frequencies each."""
    omega = 1.0 / 10000 ** (np.arange(c // 4, dtype=np.float64) / (c / 4))
    top, left = (grid - hp) // 2, (grid - wp) // 2
    rows = (top + np.arange(hp)) * (base / grid)
    cols = (left + np.arange(wp)) * (base / grid)

    def one_d(pos):
        out = pos[:, None] * omega[None]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    col = np.broadcast_to(one_d(cols)[None], (hp, wp, c // 2))
    row = np.broadcast_to(one_d(rows)[:, None], (hp, wp, c // 2))
    return np.concatenate([col, row], axis=-1).reshape(hp * wp, c)


class MMDiTX(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        self.x_embedder = PatchEmbed(cfg)
        self.t_embedder = MLPEmbedder(TIME_FEATURES, c)
        self.y_embedder = MLPEmbedder(cfg.pooled_projection_dim, c)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, c)
        n = cfg.num_layers
        self.joint_blocks = nn.ModuleList(
            [JointBlock(cfg, pre_only=i == n - 1, dual=i in cfg.dual_attention_layers)
             for i in range(n)])
        self.final_layer = FinalLayer(cfg)

    def pos_embed(self, h: int, w: int, dtype: torch.dtype, device) -> torch.Tensor:
        """(1, patches, hidden) position table of an h x w latent, in
        `dtype` on `device` (made from the host: call it outside a capture)."""
        cfg = self.cfg
        p = cfg.patch_size
        table = sincos_pos_embed(cfg.hidden_size, cfg.pos_embed_max_size,
                                 cfg.sample_size // p, h // p, w // p)
        return torch.from_numpy(table).float()[None].to(device=device, dtype=dtype)

    def embed_context(self, context):
        """(B, L, joint_attention_dim) text tokens -> (B, L, hidden)."""
        return dense(context, self.context_embedder)

    def embed_pooled(self, pooled):
        """(B, 2048) pooled text -> (B, hidden)."""
        return self.y_embedder(pooled)

    def velocity(self, x, t, ctx, y, pe):
        """x NHWC (B, h, w, in_channels); t (B,) fp32 timesteps (1000 sigma);
        ctx (B, L, hidden) = embed_context; y (B, hidden) = embed_pooled;
        pe = pos_embed(h, w). Returns NHWC (B, h, w, out_channels) in x's
        dtype."""
        cfg = self.cfg
        b, h, w, _ = x.shape
        p, heads = cfg.patch_size, cfg.num_attention_heads
        tok = self.x_embedder.proj(nchw(x)).flatten(2).transpose(1, 2) + pe
        c = self.t_embedder(timestep_embedding(t, TIME_FEATURES).to(x.dtype)) + y
        silu_c = F.silu(c)
        for blk in self.joint_blocks:
            ctx, tok = blk(ctx, tok, silu_c, heads)
        fl = self.final_layer
        shift, scale = dense(silu_c, fl.adaLN_modulation[1]).chunk(2, dim=1)
        out = dense(modulate(layer_norm(tok, None, None, cfg.eps), shift, scale), fl.linear)
        out = out.reshape(b, h // p, w // p, p, p, cfg.out_channels)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, cfg.out_channels)

    def forward(self, x, t, context, pooled):
        """One evaluation from the raw conditioning: NHWC x, (B,) timesteps,
        (B, L, joint_attention_dim) context, (B, pooled_projection_dim)."""
        pe = self.pos_embed(x.shape[1], x.shape[2], x.dtype, x.device)
        return self.velocity(x, t, self.embed_context(context), self.embed_pooled(pooled), pe)
