"""T5 v1.1 text encoder (counterpart of stablediffusioneo_tpu/models/t5.py),
under HF `T5EncoderModel`'s key names.

Covers the reference's `FrozenT5Embedder` and `FrozenCLIPT5Encoder`
(ldm/modules/encoders/modules.py:60-87, 209-225): the HF `T5EncoderModel`
tower (google/t5-v1_1-{large,xl,xxl}) as an alternative or secondary
conditioning stack. Architecture (T5 v1.1):

  embed -> N x [ RMSNorm -> self-attn (+ the shared relative-position bias)
                 -> residual;
                 RMSNorm -> gated-GELU MLP -> residual ]
        -> final RMSNorm

T5 quirks kept, as in the JAX package:
  - attention logits are NOT scaled by 1/sqrt(d_kv) (HF T5Attention has no
    scale; it is folded into the init);
  - the relative-position bias table lives on block 0 and is shared by all
    blocks;
  - logits and bias are fp32, the softmax is cast back to the compute dtype;
    the padding mask adds -1e9 in fp32;
  - the v1.1 MLP is gated: wo(gelu_tanh(wi_0(x)) * wi_1(x));
  - RMSNorm (no mean subtraction, no bias, eps 1e-6) normalises in fp32,
    casts to the compute dtype, then multiplies by g in that dtype;
  - no biases on any linear; embeddings are not scaled.
T5's attention takes an additive bias, which the attention kernels do not,
and the JAX package runs it as plain einsums: here plain torch.matmul and
softmax. `t5_encode_pp` runs the block stack pipeline-parallel over a
mesh's pp axis (parallel/pipeline.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.annotators._dtype import default_device

__all__ = ["T5Config", "T5Encoder", "clip_t5_encode", "convert_t5", "init_t5",
           "t5_encode", "t5_encode_pp", "tiny_t5"]


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Defaults = google/t5-v1_1-large (the reference's default version)."""

    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    max_length: int = 77


def tiny_t5() -> T5Config:
    return T5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=64,
                    num_layers=2, num_heads=4, max_length=16)


# --------------------------------------------------------------- modules


class T5LayerNorm(nn.Module):
    """T5's RMSNorm: a gain, no bias, no mean subtraction."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight.to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class T5Block(nn.Module):
    """encoder.block.{i}: layer.0 = (SelfAttention, layer_norm), layer.1 =
    (DenseReluDense, layer_norm)."""

    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        attn, ff = nn.Module(), nn.Module()
        attn.SelfAttention = T5Attention(cfg, has_bias)
        attn.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        ff.DenseReluDense = T5DenseGatedActDense(cfg)
        ff.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        self.layer = nn.ModuleList([attn, ff])

    def forward(self, x, bias, heads: int):
        b, t, _ = x.shape
        dtype = x.dtype
        a = self.layer[0].SelfAttention
        h = self.layer[0].layer_norm(x)
        q, k, v = (F.linear(h, m.weight.to(dtype)).reshape(b, t, heads, -1).transpose(1, 2)
                   for m in (a.q, a.k, a.v))
        # no 1/sqrt(d_kv); fp32 logits + bias, softmax back to the compute dtype
        logits = torch.matmul(q, k.transpose(-1, -2)).float() + bias
        w = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, t, -1)
        x = x + F.linear(out, a.o.weight.to(dtype))
        ff = self.layer[1].DenseReluDense
        h = self.layer[1].layer_norm(x)
        hidden = F.gelu(F.linear(h, ff.wi_0.weight.to(dtype)), approximate="tanh")
        hidden = hidden * F.linear(h, ff.wi_1.weight.to(dtype))
        return x + F.linear(hidden, ff.wo.weight.to(dtype))


class T5Encoder(nn.Module):
    """HF T5EncoderModel's parameters under its names: shared.weight (the
    token embedding; HF's encoder.embed_tokens.weight is the same tensor),
    encoder.block.{i}.*, encoder.final_layer_norm.weight."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList(
            [T5Block(cfg, has_bias=i == 0) for i in range(cfg.num_layers)])
        self.encoder.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    @property
    def rel_bias(self) -> torch.Tensor:
        """The (num_buckets, heads) table every block shares."""
        return self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight


# ----------------------------------------------------------------- init


@torch.no_grad()
def init_t5(generator: torch.Generator, cfg: T5Config,
            device: Optional[torch.device] = None) -> T5Encoder:
    """A T5Encoder of `cfg` drawn from `generator` on the generator's device
    (one seed gives the same weights wherever they go), fp32, on `device`
    (the card unless the caller names another), with the JAX init_t5's
    distributions: token embedding N(0, 1), relative bias N(0, 1) x 0.05,
    norms 1, q N(0, 1) x (d_model d_kv)^-1/2, k / v / wi_0 / wi_1 N(0, 1) x
    d_model^-1/2, o N(0, 1) x (heads d_kv)^-1/2, wo N(0, 1) x d_ff^-1/2."""
    with torch.device("meta"):
        model = T5Encoder(cfg)
    model.to_empty(device=generator.device)
    inner = cfg.num_heads * cfg.d_kv

    def normal(p, scale=1.0):
        p.normal_(0.0, 1.0, generator=generator).mul_(scale)

    normal(model.shared.weight)
    normal(model.rel_bias, 0.05)
    for blk in model.encoder.block:
        a, ff = blk.layer[0].SelfAttention, blk.layer[1].DenseReluDense
        normal(a.q.weight, (cfg.d_model * cfg.d_kv) ** -0.5)
        normal(a.k.weight, cfg.d_model ** -0.5)
        normal(a.v.weight, cfg.d_model ** -0.5)
        normal(a.o.weight, inner ** -0.5)
        normal(ff.wi_0.weight, cfg.d_model ** -0.5)
        normal(ff.wi_1.weight, cfg.d_model ** -0.5)
        normal(ff.wo.weight, cfg.d_ff ** -0.5)
        blk.layer[0].layer_norm.weight.fill_(1.0)
        blk.layer[1].layer_norm.weight.fill_(1.0)
    model.encoder.final_layer_norm.weight.fill_(1.0)
    return model.to(default_device(device)).eval().requires_grad_(False)


# ------------------------------------------------------------- converter


def convert_t5(sd: Mapping, cfg: T5Config, prefix: str = "",
               dtype: Optional[torch.dtype] = None, device="cuda") -> T5Encoder:
    """HF T5EncoderModel state dict (keys under `prefix`) -> a T5Encoder on
    `device` (in `dtype`, default fp32), by the strict load of
    checkpoint/__init__.py:_convert. HF keeps the token embedding twice
    (shared.weight, encoder.embed_tokens.weight: one tied tensor); either
    name is taken, and the other copy is the documented leftover."""
    from stablediffusioneo_tpu_torch.checkpoint import _convert

    shared, alias = prefix + "shared.weight", prefix + "encoder.embed_tokens.weight"
    if shared not in sd and alias in sd:
        sd = {(shared if k == alias else k): v for k, v in sd.items()}
    return _convert(sd, prefix, lambda: T5Encoder(cfg), (r"encoder\.embed_tokens\.weight",),
                    device, dtype, "t5")


# --------------------------------------------------------------- forward


def _rel_pos_buckets(q_len: int, k_len: int, num_buckets: int,
                     max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative-position bucketing, evaluated host-side:
    for fixed (static) sequence lengths this is a compile-time constant,
    so the per-layer bias is a single static gather on device."""
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    rel = mem - ctx  # key pos - query pos
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    is_small = n < max_exact
    with np.errstate(divide="ignore"):
        val_large = max_exact + (
            np.log(np.maximum(n, 1) / max_exact)
            / math.log(max_distance / max_exact)
            * (nb - max_exact)
        ).astype(np.int64)
    val_large = np.minimum(val_large, nb - 1)
    buckets += np.where(is_small, n, val_large)
    return buckets  # (q_len, k_len) int


def t5_encode(t5: T5Encoder, ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, T) int token ids [+ (B, T) 0/1 attention mask] -> (B, T, d_model)
    last hidden state in the compute `dtype` (default: the weights'),
    T5EncoderModel.forward semantics."""
    cfg = t5.cfg
    dtype = dtype or t5.shared.weight.dtype
    x = t5.shared.weight[ids].to(dtype)
    bias = _attn_bias(t5, ids, mask)
    for blk in t5.encoder.block:
        x = blk(x, bias, cfg.num_heads)
    return t5.encoder.final_layer_norm(x)


def _attn_bias(t5: T5Encoder, ids: torch.Tensor, mask: Optional[torch.Tensor]):
    """The fp32 additive attention bias: the relative-position bias (1, H,
    T, T), shared by every block (HF block 0's table), plus -1e9 at the
    padded keys of each row where a (B, T) mask is given (then (B, H, T, T))."""
    cfg, t = t5.cfg, ids.shape[1]
    buckets = torch.from_numpy(_rel_pos_buckets(
        t, t, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)).to(ids.device)
    bias = t5.rel_bias[buckets].float().permute(2, 0, 1)[None]
    if mask is not None:
        neg = torch.where(mask[:, None, None, :].bool(), 0.0, -1e9)
        bias = bias + neg.float()
    return bias


def stacked_blocks(t5: T5Encoder):
    """The blocks' tensors stacked for parallel.pipeline_apply, by the names
    of a block without the relative-bias table (block 0 holds it; it stays
    out of the stack and reaches every block through the bias)."""
    from stablediffusioneo_tpu_torch.parallel.pipeline import stack_layer_params

    names = [n for n, _ in t5.encoder.block[-1].named_parameters()]
    return stack_layer_params([{n: dict(b.named_parameters())[n] for n in names}
                               for b in t5.encoder.block])


def t5_encode_pp(t5: T5Encoder, ids: torch.Tensor, mesh, mask: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None, microbatches: Optional[int] = None,
                 remat: bool = False, stacked=None) -> torch.Tensor:
    """t5_encode with the block stack pipeline-parallel over the mesh's `pp`
    axis (parallel/pipeline.py), on every rank of the mesh; every rank
    returns the whole batch. The bias is the GPipe-subtle part, as in the
    JAX package: without a mask it is batch-independent and reaches every
    stage whole (`extra`); with a padding mask it is per sample and is
    microbatched with the activations (`batched_extra`: each stage takes
    the microbatch it is working on). The block is the sequential path's
    own module (the last block as a template, by torch.func.functional_call).
    stacked: `stacked_blocks(t5)` made once, or this rank's stage of it
    (parallel.pp_shard_params)."""
    from stablediffusioneo_tpu_torch.parallel.pipeline import pipeline_apply

    cfg = t5.cfg
    dtype = dtype or t5.shared.weight.dtype
    x = t5.shared.weight[ids].to(dtype)
    bias = _attn_bias(t5, ids, mask)
    template = t5.encoder.block[-1]

    def block(p, h, b):
        return torch.func.functional_call(template, p, (h, b, cfg.num_heads))

    stacked = stacked_blocks(t5) if stacked is None else stacked
    if mask is not None:
        bias = bias.expand(ids.shape[0], *bias.shape[1:])
        x = pipeline_apply(block, stacked, x, mesh, batched_extra=(bias,),
                           microbatches=microbatches, remat=remat)
    else:
        x = pipeline_apply(block, stacked, x, mesh, extra=(bias,),
                           microbatches=microbatches, remat=remat)
    return t5.encoder.final_layer_norm(x)


def clip_t5_encode(clip, t5: T5Encoder, clip_ids: torch.Tensor, t5_ids: torch.Tensor,
                   t5_mask: Optional[torch.Tensor] = None):
    """FrozenCLIPT5Encoder.forward (modules.py:209-225): encode the prompt
    with both towers and return [clip_z, t5_z]."""
    from stablediffusioneo_tpu_torch.models.clip import clip_text_apply

    clip_z = clip_text_apply(clip, clip_ids)
    t5_z = t5_encode(t5, t5_ids, mask=t5_mask)
    return [clip_z, t5_z]
