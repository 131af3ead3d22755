"""Tiny presets of the benchmark's configurations for CPU tests: the same
families and layouts as the files in `benchmark/configs/`, tiny widths, a
64x64 request and 2 steps. The towers keep CLIP's 49,408 ids and 77
positions, which the stand-in tokenizer needs."""

import copy
import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _tower(hidden, layers=2, heads=2, **kw):
    return dict({"vocab_size": 49408, "hidden_size": hidden, "intermediate_size": 2 * hidden,
                 "num_layers": layers, "num_heads": heads, "max_length": 77}, **kw)


TINY_VAE = {"ch": 16, "ch_mult": [1, 1, 1, 1], "num_res_blocks": 1, "groups": 8}


def tiny_sd15():
    cfg = json.loads((CONFIGS / "sd15-controlnet-canny.json").read_text())
    cfg["unet"].update(model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
                       attention_resolutions=[1, 2], context_dim=64, num_heads=2, groups=8)
    cfg["vae"].update(TINY_VAE)
    cfg["clip"] = dict(cfg["clip"], **_tower(64))
    cfg["sampling"].update(resolution=64, steps=2)
    cfg["dtype"] = "float32"
    return cfg


def tiny_sdxl():
    cfg = json.loads((CONFIGS / "sdxl-base.json").read_text())
    cfg["unet"].update(model_channels=32, channel_mult=[1, 2, 4], num_res_blocks=1,
                       attention_resolutions=[2, 4], transformer_depth=[0, 1, 2],
                       context_dim=48, num_head_channels=16, adm_in_channels=16 + 6 * 8,
                       groups=8)
    cfg["vae"].update(TINY_VAE)
    cfg["clip_l"] = dict(cfg["clip_l"], **_tower(32))
    cfg["clip_g"] = dict(cfg["clip_g"], **_tower(16), projection_dim=16)
    cfg["sampling"].update(resolution=64, steps=2)
    cfg["dtype"] = "float32"
    return cfg


def tiny(name):
    return {"sd15-controlnet-canny": tiny_sd15, "sdxl-base": tiny_sdxl}[name]()


def tiny_traffic(traffic):
    t = copy.deepcopy(traffic)
    t.update(pool=min(t["pool"], 6), warm=min(t["warm"], 2), trace_requests=2)
    if "server" in t:
        # 4 clients, or 8 arrivals in a 1 s window, and a batching window long
        # enough to wait for each batch of 4: every batch is full whatever the
        # CPU's speed, so a fault that mixes a batch's rows shows
        if t["loop"] == "closed":
            t["clients"] = 4
        else:
            t.update(rate_per_s=8.0, max_outstanding=16)
        t["server"] = dict(t["server"], max_wait_ms=5000)
    return t
