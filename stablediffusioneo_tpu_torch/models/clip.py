"""CLIP text towers (counterpart of stablediffusioneo_tpu/models/clip.py).

Two towers under their checkpoints' own names:
  * `CLIPTextModel`, HF names (`text_model.embeddings.*`,
    `text_model.encoder.layers.N.*`, `text_model.final_layer_norm`): SD-1.x's
    ViT-L at `cond_stage_model.transformer.`, SDXL's first tower at
    `conditioner.embedders.0.transformer.` (no projection: no HF-layout
    checkpoint the JAX package loads holds one).
  * `OpenCLIPTextModel`, OpenCLIP names (`token_embedding`,
    `positional_embedding`, `transformer.resblocks.N.{ln_1, attn.in_proj_*,
    attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_final`,
    `text_projection`): SD-2.x's ViT-H at `cond_stage_model.model.`, SDXL's
    bigG at `conditioner.embedders.1.model.`. `in_proj` packs q, k, v in
    that order; `text_projection` is stored (d, proj) and applied as x @ W.
Both: pre-LN blocks (biased q/k/v/out; quick_gelu or exact gelu MLP), the
causal mask as a large negative finite number (bf16-safe). The output is
the final-LN last hidden state ("last"), the final LN of hidden state -2
("penultimate", SD-2.x) or hidden state -2 as it is ("penultimate_raw",
SDXL's towers; only their pooled path sees the final LN).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.config import CLIPTextConfig
from stablediffusioneo_tpu_torch.models.unet import LayerNorm
from stablediffusioneo_tpu_torch.ops.attention import attention
from stablediffusioneo_tpu_torch.ops.layers import dense, gelu, linear
from stablediffusioneo_tpu_torch.parallel.mesh import copy_to

MASK_NEG = -10000.0


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _act(cfg: CLIPTextConfig):
    return quick_gelu if cfg.act == "quick_gelu" else gelu


def _attend(q, k, v, heads: int, mask):
    """(B, T, d) projections -> (B, T, d) causal multi-head attention."""
    b, t, d = q.shape
    q, k, v = (x.reshape(b, t, heads, d // heads).transpose(1, 2) for x in (q, k, v))
    return attention(q, k, v, mask=mask).transpose(1, 2).reshape(b, t, d)


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
        self.act = _act(cfg)
        self.layer_norm1 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(d)
        self.layer_norm2 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(d, cfg.intermediate_size)

    def forward(self, x, mask):
        a = self.self_attn
        h = self.layer_norm1(x)
        q, k, v = (dense(h, m) for m in (a.q_proj, a.k_proj, a.v_proj))
        x = x + dense(_attend(q, k, v, self.heads, mask), a.out_proj)
        h = self.layer_norm2(x)
        return x + dense(self.act(dense(h, self.mlp.fc1)), self.mlp.fc2)


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
    """HF CLIPTextModel."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.projection_dim:
            raise ValueError("a projected text tower is OpenCLIP's "
                             "(OpenCLIPTextModel, as SDXL's bigG)")
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def embed(self, input_ids):
        emb = self.text_model.embeddings
        x = emb.token_embedding.weight[input_ids]
        return x + emb.position_embedding.weight[None, :input_ids.shape[1]].to(x.dtype)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.text_model.encoder.layers

    @property
    def final_ln(self) -> LayerNorm:
        return self.text_model.final_layer_norm

    def projection(self) -> Optional[torch.Tensor]:
        """The pooled output's projection as a (d, proj) matrix, or None."""
        return None


class OpenCLIPAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)


class OpenCLIPResidualBlock(nn.Module):
    """open_clip ResidualAttentionBlock: the same block as CLIPEncoderLayer,
    with q, k, v packed in one projection."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.act = _act(cfg)
        self.ln_1 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = OpenCLIPAttention(d)
        self.ln_2 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(d, cfg.intermediate_size)
        self.mlp.c_proj = nn.Linear(cfg.intermediate_size, d)

    def forward(self, x, mask):
        a = self.attn
        h = copy_to(self.ln_1(x), getattr(a, "tp_col", None))
        q, k, v = linear(h, a.in_proj_weight, a.in_proj_bias).chunk(3, dim=-1)
        x = x + dense(_attend(q, k, v, self.heads, mask), a.out_proj)
        return x + dense(self.act(dense(self.ln_2(x), self.mlp.c_fc)), self.mlp.c_proj)


class OpenCLIPTextModel(nn.Module):
    """open_clip's text tower (the `model.` of FrozenOpenCLIPEmbedder)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.max_length, d))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [OpenCLIPResidualBlock(cfg) for _ in range(cfg.num_layers)])
        self.ln_final = LayerNorm(d, eps=cfg.layer_norm_eps)
        if cfg.projection_dim:
            self.text_projection = nn.Parameter(torch.empty(d, cfg.projection_dim))

    def embed(self, input_ids):
        x = self.token_embedding.weight[input_ids]
        return x + self.positional_embedding[None, :input_ids.shape[1]].to(x.dtype)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.transformer.resblocks

    @property
    def final_ln(self) -> LayerNorm:
        return self.ln_final

    def projection(self) -> Optional[torch.Tensor]:
        return self.text_projection if self.cfg.projection_dim else None


def _causal_mask(t: int, device) -> torch.Tensor:
    return torch.triu(torch.full((t, t), MASK_NEG, dtype=torch.float32, device=device),
                      diagonal=1)[None, None]


def _run_blocks(clip, input_ids, n: int):
    """The residual stream after the first n blocks, and the causal mask."""
    x = clip.embed(input_ids)
    mask = _causal_mask(input_ids.shape[1], x.device)
    for blk in clip.blocks[:n]:
        x = blk(x, mask)
    return x, mask


def clip_text_apply(clip, input_ids, clip_skip: int = 0, layer: Optional[str] = None):
    """(B, T) token ids -> (B, T, hidden), by `layer` (default the tower's
    cfg.layer): "last" the final-LN last hidden state, "penultimate" the
    final LN of hidden state -2, "penultimate_raw" hidden state -2. With
    clip_skip = k > 1: the final LN of hidden state -k (cldm/hack.py),
    whatever the layer. Blocks past the one the output needs are not run."""
    n = len(clip.blocks)
    if clip_skip > 1:
        return clip.final_ln(_run_blocks(clip, input_ids, n + 1 - clip_skip)[0])
    layer = layer or clip.cfg.layer
    if layer == "last":
        return clip.final_ln(_run_blocks(clip, input_ids, n)[0])
    x = _run_blocks(clip, input_ids, n - 1)[0]
    return x if layer == "penultimate_raw" else clip.final_ln(x)


def _layer_fn(clip):
    """One block as a (p, x, mask) -> x function of that block's tensors p:
    the tower's own block module (the last, as a template) run by
    torch.func.functional_call, so the sequential and pipelined paths run
    the same code (the JAX _layer_fn)."""
    template = clip.blocks[-1]
    return lambda p, x, mask: torch.func.functional_call(template, p, (x, mask))


def clip_text_apply_pp(clip, input_ids, mesh, layer: Optional[str] = None,
                       microbatches: Optional[int] = None, remat: bool = False,
                       stacked=None):
    """clip_text_apply with the block stack pipeline-parallel over the mesh's
    `pp` axis (parallel/pipeline.py: GPipe, batch over dp), on every rank
    of the mesh; every rank returns the whole batch. Every `layer` mode of
    the sequential path (no clip_skip). stacked: the blocks' tensors
    pre-stacked once (parallel.stack_layer_params(clip.blocks)) or this
    rank's stage of them (parallel.pp_shard_params); default: stacked from
    the tower at each call."""
    from stablediffusioneo_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        stack_layer_params,
    )

    layer = layer or clip.cfg.layer
    x = clip.embed(input_ids)
    mask = _causal_mask(input_ids.shape[1], x.device)
    if stacked is None:
        stacked = stack_layer_params(clip.blocks)
    out, pen = pipeline_apply(_layer_fn(clip), stacked, x, mesh, extra=(mask,),
                              microbatches=microbatches, capture_last_input=True,
                              remat=remat)
    if layer == "penultimate":
        return clip.final_ln(pen)
    if layer == "penultimate_raw":
        return pen
    return clip.final_ln(out)


def clip_text_apply_with_pooled(clip, input_ids, eot_id: Optional[int] = None):
    """ONE tower forward -> (hidden by cfg.layer, pooled): the SDXL bigG tower
    needs its penultimate hidden state (the context) and its pooled,
    projected output (the ADM vector). The last block runs once, on the
    residual stream the hidden state came from."""
    layer = clip.cfg.layer
    if layer == "last":
        last = clip_text_apply(clip, input_ids)
        hidden = last
    else:
        x, mask = _run_blocks(clip, input_ids, len(clip.blocks) - 1)
        hidden = x if layer == "penultimate_raw" else clip.final_ln(x)
        last = clip.final_ln(clip.blocks[-1](x, mask))
    return hidden, _pool_projected(clip, last, input_ids, eot_id)


def _pool_projected(clip, last, input_ids, eot_id: Optional[int]):
    """The final-LN state at each row's EOT (the argmax id, OpenCLIP's
    convention, or the first `eot_id`), through the projection if any, in
    fp32, rounded to the states' dtype."""
    key = input_ids if eot_id is None else (input_ids == eot_id).to(torch.int32)
    pos = key.argmax(dim=-1)
    pooled = last[torch.arange(last.shape[0], device=last.device), pos]
    proj = clip.projection()
    if proj is not None:
        pooled = (pooled.float() @ proj.float()).to(last.dtype)
    return pooled


def clip_text_pooled(clip, input_ids, eot_id: Optional[int] = None):
    """(B, proj or hidden): the pooled output of the final-LN last hidden
    state (sgm FrozenOpenCLIPEmbedder2 pooling)."""
    return _pool_projected(clip, clip_text_apply(clip, input_ids, layer="last"),
                           input_ids, eot_id)
