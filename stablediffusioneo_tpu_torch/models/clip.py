"""CLIP ViT-L/14 text tower (counterpart of stablediffusioneo_tpu/models/clip.py).

HF CLIPTextModel names under `cond_stage_model.transformer.*`: token and
position embeddings, pre-LN layers (biased q/k/v/out, quick_gelu MLP), final
LayerNorm, causal mask as a large negative finite number (bf16-safe).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stablediffusioneo_tpu.config import CLIPTextConfig
from stablediffusioneo_tpu_torch.models.unet import LayerNorm
from stablediffusioneo_tpu_torch.ops.attention import attention
from stablediffusioneo_tpu_torch.ops.layers import gelu, linear

MASK_NEG = -10000.0


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class CLIPMLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inner)
        self.fc2 = nn.Linear(inner, d)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.act = quick_gelu if cfg.act == "quick_gelu" else gelu
        self.layer_norm1 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(d)
        self.layer_norm2 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(d, cfg.intermediate_size)

    def forward(self, x, mask):
        b, t, d = x.shape
        a = self.self_attn
        h = self.layer_norm1(x)
        q, k, v = (linear(h, m.weight, m.bias)
                   .reshape(b, t, self.heads, d // self.heads).transpose(1, 2)
                   for m in (a.q_proj, a.k_proj, a.v_proj))
        o = attention(q, k, v, mask=mask).transpose(1, 2).reshape(b, t, d)
        x = x + linear(o, a.out_proj.weight, a.out_proj.bias)
        h = self.layer_norm2(x)
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        return x + linear(self.act(linear(h, fc1.weight, fc1.bias)),
                          fc2.weight, fc2.bias)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.embeddings.position_embedding = nn.Embedding(cfg.max_length,
                                                          cfg.hidden_size)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.layer != "last" or cfg.projection_dim:
            raise NotImplementedError(
                "penultimate-layer and projected CLIP towers (SD-2.x, SDXL) "
                "are not in the port yet (ROADMAP queue 1: The other model "
                "families)")
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)


def clip_text_apply(clip: CLIPTextModel, input_ids, clip_skip: int = 0):
    """(B, T) token ids -> (B, T, hidden): the final-LN last hidden state, or
    with clip_skip = k > 1 the final LN of hidden state -k (cldm/hack.py)."""
    tm = clip.text_model
    t = input_ids.shape[1]
    emb = tm.embeddings
    x = emb.token_embedding.weight[input_ids]
    x = x + emb.position_embedding.weight[None, :t].to(x.dtype)
    mask = torch.triu(torch.full((t, t), MASK_NEG, dtype=torch.float32,
                                 device=x.device), diagonal=1)[None, None]
    hidden = [x]
    for layer in tm.encoder.layers:
        x = layer(x, mask)
        hidden.append(x)
    target = hidden[-clip_skip] if clip_skip > 1 else x
    return tm.final_layer_norm(target)
