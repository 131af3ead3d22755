"""Stable Diffusion 3.5 Medium on the program: its configuration, its seeded
model, its entry and its work counts. The entry: the three towers'
conditioning (`models/sd3.py:sd3_conditioning`, eager, T5-XXL inside its
`text.t5` span), one replay of the flow-matching sample+decode engine
(`runtime/engine.py:sd3_sample_decode_engine`), then the fetch. The
program's SD3 modules are imported when the family builds, not when the
benchmark starts."""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn as nn

from benchmark import work
from benchmark.families import Output, program_model
from benchmark.families.sdxl import token_ids as clip_ids

T5_EOS, T5_PAD, T5_FIRST, T5_WORDS = 1, 0, 3, 32000


def t5_ids(texts, length):
    """Stand-in for T5's SentencePiece tokenizer (its model is not in the
    repository): one hashed id a word in [3, 32000), then EOS 1, padded with
    0 to `length`."""
    rows = []
    for t in texts:
        ids = [T5_FIRST + zlib.crc32(w.encode()) % (T5_WORDS - T5_FIRST)
               for w in t.replace(",", " ").split()][:length - 1] + [T5_EOS]
        rows.append(ids + [T5_PAD] * (length - len(ids)))
    return np.asarray(rows, np.int64)


def token_ids(req, cfg):
    """(CLIP-L, bigG, T5) ids of [prompt, ""], each (2, T): the CLIP towers'
    as SDXL's (CLIP-L pads with EOT, bigG with zeros after the first EOT)."""
    return (*clip_ids(req), t5_ids([req.prompt, ""], cfg["t5"]["max_length"]))


def program_config(cfg: dict):
    from stablediffusioneo_tpu_torch.config import CLIPTextConfig, FlowVAEConfig
    from stablediffusioneo_tpu_torch.models.mmdit import MMDiTConfig
    from stablediffusioneo_tpu_torch.models.sd3 import SD3Config
    from stablediffusioneo_tpu_torch.models.t5 import T5Config

    t = dict(cfg["transformer"], dual_attention_layers=tuple(
        cfg["transformer"]["dual_attention_layers"]))
    return SD3Config(transformer=MMDiTConfig(**t), clip_l=CLIPTextConfig(**cfg["clip_l"]),
                     clip_g=CLIPTextConfig(**cfg["clip_g"]), t5=T5Config(**cfg["t5"]),
                     vae=FlowVAEConfig(**dict(cfg["vae"], ch_mult=tuple(cfg["vae"]["ch_mult"]))),
                     shift=cfg["sampling"]["shift"], dtype=cfg["dtype"])


def build(cfg: dict, seed: int, device):
    from stablediffusioneo_tpu_torch.models.sd3 import SD3

    pcfg = program_config(cfg)
    return program_model(lambda: SD3(pcfg), lambda: reference_module(cfg), seed, device,
                         cfg["dtype"]), pcfg


class EngineEntry:
    """Conditioning, engine replay and fetch, batch 1; one caller at a
    time."""

    clients_max = 1

    def __init__(self, model, pcfg, cfg, traffic, device):
        from stablediffusioneo_tpu_torch.runtime.engine import sd3_sample_decode_engine

        s = cfg["sampling"]
        self.model, self.cfg, self.device = model, cfg, torch.device(device)
        self.res, self.f = s["resolution"], pcfg.vae.downsample_factor
        self.channels = pcfg.transformer.in_channels
        self.engine = sd3_sample_decode_engine(model, s["steps"], 1, self.res, self.res)
        self.scale = torch.full((1,), float(s["scale"]), device=self.device)
        self.dtype = next(model.mmdit.parameters()).dtype

    def warm(self, reqs):
        for req in reqs:
            self.run(req)

    def run(self, req) -> Output:
        from stablediffusioneo_tpu_torch.models.sd3 import sd3_conditioning

        ids = [torch.as_tensor(a, dtype=torch.long, device=self.device)
               for a in token_ids(req, self.cfg)]
        with torch.no_grad():
            ctx, y = sd3_conditioning(self.model, *ids)
        lat = self.res // self.f
        x = draw_x_T(req.seed, lat, self.channels, self.device).to(self.dtype)
        img, z = self.engine(x, ctx[:1], ctx[1:], y[:1], y[1:], self.scale)
        z = z.clone()  # the engine's next call overwrites its output
        return Output(img[0].cpu().numpy(), z, {})

    def engines(self):
        return {self.engine.name: self.engine.get_engine_infor()}

    def counters(self):
        return {}

    def reset(self):
        pass

    def close(self):
        self.engine = None


ENTRIES = {"pipeline": EngineEntry}


def draw_x_T(seed: int, side: int, channels: int, device) -> torch.Tensor:
    """The initial latents of a request of `seed`, NHWC (1, side, side,
    channels): torch.randn((side, side, channels)) from a generator on
    `device` seeded with it (the reference's draw)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((side, side, channels), generator=g, device=device)[None]


def reference_module(cfg: dict) -> nn.Module:
    """The float32 reference under the checkpoint's names."""
    from benchmark.reference.sd3 import SD3

    return SD3(cfg)


def reference_request(net, cfg, req):
    """(latents, image) of the reference for a request, on net's device."""
    from benchmark.reference.sd3 import sd3_request

    return sd3_request(net, cfg, *token_ids(req, cfg), req.seed)


# ------------------------------------------------------------------- work


def mmdit_flops(t: dict, side: int, ctx_len: int) -> int:
    """One row of the MMDiT-X at latent side `side` with `ctx_len` text
    tokens: the patch, timestep, pooled and context embedders; in every
    block both streams' adaLN, q/k/v, output projections and MLPs (the
    pre-only last context stream: adaLN and q/k/v only), the joint
    attention's products over ctx_len + patches tokens, the dual blocks'
    second projections and products over the patches; the final layer."""
    c = t["num_attention_heads"] * t["attention_head_dim"]
    p, r, n_layers = t["patch_size"], t.get("mlp_ratio", 4), t["num_layers"]
    n = (side // p) ** 2
    fl = 2 * n * t["in_channels"] * p * p * c
    fl += 2 * (256 * c + c * c) + 2 * (t["pooled_projection_dim"] * c + c * c)
    fl += 2 * ctx_len * t["joint_attention_dim"] * c
    for i in range(n_layers):
        dual, pre = i in t["dual_attention_layers"], i == n_layers - 1
        fl += 2 * c * c * ((9 if dual else 6) + (2 if pre else 6))
        fl += 2 * n * c * c * (4 + 2 * r)
        fl += 2 * ctx_len * c * c * (3 if pre else 4 + 2 * r)
        fl += 4 * (n + ctx_len) ** 2 * c
        if dual:
            fl += 2 * n * c * c * 4 + 4 * n * n * c
    return fl + 2 * c * 2 * c + 2 * n * c * p * p * t["out_channels"]


def t5_flops(t: dict, rows: int) -> int:
    """`rows` rows through every T5 layer: q, k, v, o, the gated MLP and the
    two attention products."""
    d, inner, length = t["d_model"], t["num_heads"] * t["d_kv"], t["max_length"]
    per_layer = 2 * length * (4 * d * inner + 3 * d * t["d_ff"]) + 4 * length * length * inner
    return rows * t["num_layers"] * per_layer


def flops_per_image(cfg: dict) -> int:
    """The MMDiT-X on every row of every step, the three towers on the cond
    and uncond rows, the decode (no post_quant_conv)."""
    v, side = cfg["vae"], work.latent_side(cfg)
    ctx_len = cfg["clip_l"]["max_length"] + cfg["t5"]["max_length"]
    text = (work.text_flops(cfg["clip_l"], 2) + work.text_flops(cfg["clip_g"], 2)
            + t5_flops(cfg["t5"], 2))
    decode = work.vae_decode_flops(v, side) - 2 * v["embed_dim"] * v["z_channels"] * side ** 2
    return (2 * cfg["sampling"]["steps"] * mmdit_flops(cfg["transformer"], side, ctx_len)
            + text + decode)


def attention_calls(cfg: dict, batch: int):
    """The sites the attention kernels compute: each step's joint attention
    in every block over text + image tokens and the image-only attention of
    the dual blocks, on the batch-2 CFG concat; the decoder's mid-block. The
    towers' attention (CLIP at 77 causal tokens, T5 with its relative bias)
    is plain math and is not listed."""
    t, s = cfg["transformer"], cfg["sampling"]
    heads, d = t["num_attention_heads"], t["attention_head_dim"]
    n = (work.latent_side(cfg) // t["patch_size"]) ** 2
    joint = n + cfg["clip_l"]["max_length"] + cfg["t5"]["max_length"]
    calls = []
    for _ in range(s["steps"]):
        for i in range(t["num_layers"]):
            calls.append((2 * batch, heads, joint, joint, d))
            if i in t["dual_attention_layers"]:
                calls.append((2 * batch, heads, n, n, d))
    side = work.latent_side(cfg)
    v = cfg["vae"]
    calls.append((batch, 1, side * side, side * side, v["ch"] * v["ch_mult"][-1]))
    return calls
