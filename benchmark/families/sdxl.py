"""SDXL base on the program: its configuration, its seeded model, and its
entry: the towers' conditioning (`models/sdxl.py:sdxl_conditioning`, eager),
then one replay of the sample+decode engine
(`runtime/engine.py:sdxl_sample_decode_engine`), then the fetch."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn as nn

from benchmark import work
from benchmark.families import Output, program_model
from benchmark.reference.nets import HFCLIPText, OpenCLIPText
from benchmark.reference.sample import draw_x_T, unet_vae_module
from benchmark.traffic import stand_in_tokenizer

EOT = 49407


def token_ids(req):
    """Both towers' ids of [prompt, ""] (sgm's conventions: tower 1 pads
    with EOT, tower 2 with zeros after the first EOT)."""
    ids_l = stand_in_tokenizer([req.prompt, ""])
    ids_g = ids_l.copy()
    for row in ids_g:
        row[np.argmax(row == EOT) + 1:] = 0
    return ids_l, ids_g


def program_config(cfg: dict):
    from stablediffusioneo_tpu_torch.config import (
        CLIPTextConfig,
        DiffusionConfig,
        UNetConfig,
        VAEConfig,
    )
    from stablediffusioneo_tpu_torch.models.sdxl import SDXLConfig

    u = dict(cfg["unet"])
    u.pop("use_linear_in_transformer", None)
    for k in ("channel_mult", "attention_resolutions", "transformer_depth"):
        u[k] = tuple(u[k])
    return SDXLConfig(unet=UNetConfig(**u), clip_l=CLIPTextConfig(**cfg["clip_l"]),
                      clip_g=CLIPTextConfig(**cfg["clip_g"]),
                      vae=VAEConfig(**dict(cfg["vae"], ch_mult=tuple(cfg["vae"]["ch_mult"]))),
                      diffusion=DiffusionConfig(**cfg["diffusion"]), dtype=cfg["dtype"])


def build(cfg: dict, seed: int, device):
    from stablediffusioneo_tpu_torch.models.sdxl import SDXL

    pcfg = program_config(cfg)
    return program_model(lambda: SDXL(pcfg), lambda: reference_module(cfg), seed,
                         device,
                         cfg["dtype"]), pcfg


class EngineEntry:
    """Conditioning, engine replay and fetch, batch 1; one caller at a time.
    The span `pipeline.text_ms` is the conditioning, ended by a device
    synchronisation (the towers run eagerly)."""

    clients_max = 1

    def __init__(self, model, pcfg, cfg, traffic, device):
        from stablediffusioneo_tpu_torch.runtime.engine import sdxl_sample_decode_engine

        s = cfg["sampling"]
        self.model, self.device, self.res = model, torch.device(device), s["resolution"]
        self.f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
        self.engine = sdxl_sample_decode_engine(model, s["steps"], 1, self.res, self.res)
        self.scale = torch.full((1,), float(s["scale"]), device=self.device)
        self.dtype = next(model.unet.parameters()).dtype

    def warm(self, reqs):
        for req in reqs:
            self.run(req)

    def run(self, req) -> Output:
        from stablediffusioneo_tpu_torch.models.sdxl import sdxl_conditioning

        t0 = time.perf_counter()
        ids = [torch.as_tensor(a, dtype=torch.long, device=self.device)
               for a in token_ids(req)]
        with torch.no_grad():
            ctx, y = sdxl_conditioning(self.model, ids[0], ids[1], (self.res, self.res))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        text_ms = (time.perf_counter() - t0) * 1e3
        lat = self.res // self.f
        x = draw_x_T(req.seed, lat, lat, self.device).permute(0, 2, 3, 1).to(self.dtype)
        img, z = self.engine(x, ctx[:1], ctx[1:], y[:1], y[1:], self.scale)
        z = z.clone()  # the engine's next call overwrites its output
        return Output(img[0].cpu().numpy(), z, {"pipeline.text_ms": text_ms})

    def engines(self):
        return {self.engine.name: self.engine.get_engine_infor()}

    def counters(self):
        return {}

    def reset(self):
        pass

    def close(self):
        self.engine = None


ENTRIES = {"pipeline": EngineEntry}


def reference_module(cfg: dict) -> nn.Module:
    """The float32 reference under the checkpoint's top-level names (so
    `state_dict()` keys are the checkpoint's keys): UNet, VAE, the CLIP-L and
    OpenCLIP bigG towers of sgm's conditioner."""
    m = unet_vae_module(cfg)
    m.conditioner = nn.Module()
    m.conditioner.embedders = nn.ModuleList([nn.Module(), nn.Module()])
    m.conditioner.embedders[0].transformer = HFCLIPText(cfg["clip_l"])
    m.conditioner.embedders[1].model = OpenCLIPText(cfg["clip_g"])
    return m


def flops_per_image(cfg: dict) -> int:
    """The UNet (its ADM input included) on every row of every step, both
    towers on the cond and uncond rows, the decode."""
    text = work.text_flops(cfg["clip_l"], 2) + work.text_flops(cfg["clip_g"], 2)
    per_row = work.unet_flops(cfg["unet"], work.latent_side(cfg), cfg["clip_l"]["max_length"])
    return work.ldm_flops_per_image(cfg, per_row, text)


def attention_calls(cfg: dict, batch: int):
    """Both towers' layers; the UNet's transformers; the decoder's
    mid-block."""
    return work.ldm_attention_calls(cfg, [cfg["clip_l"], cfg["clip_g"]], 1, batch)


def reference_request(net, cfg, req):
    """(latents, image) of the reference for a request, on net's device."""
    from benchmark.reference.sample import sdxl_request

    ids_l, ids_g = token_ids(req)
    return sdxl_request(net, cfg, ids_l, ids_g, req.seed)
