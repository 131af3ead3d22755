"""The ControlNet family (SD-1.x + ControlNet, canny2image) on the program:
its configuration, its seeded model, and its two entries, the pipeline
(`Canny2ImagePipeline.process`, one request at a time) and the server
(`DiffusionServer.submit`, requests batched across clients)."""

from __future__ import annotations

import torch.nn as nn

from benchmark import work
from benchmark.families import Output, program_model
from benchmark.reference.nets import ControlNet, HFCLIPText
from benchmark.reference.sample import unet_vae_module
from benchmark.traffic import stand_in_tokenizer

# the request texts both sides take (the program's own defaults, handed in)
A_PROMPT = "best quality, extremely detailed"
N_PROMPT = ("longbody, lowres, bad anatomy, bad hands, missing fingers, extra digit, "
            "fewer digits, cropped, worst quality, low quality")


def texts(req):
    """The cond and uncond texts of a request, as the pipeline joins them."""
    return [req.prompt + ", " + A_PROMPT, N_PROMPT]


def program_config(cfg: dict):
    from stablediffusioneo_tpu_torch.config import (
        CLIPTextConfig,
        ControlNetConfig,
        DiffusionConfig,
        PipelineConfig,
        UNetConfig,
        VAEConfig,
    )

    u = dict(cfg["unet"])
    u.pop("use_linear_in_transformer", None)
    for k in ("channel_mult", "attention_resolutions"):
        u[k] = tuple(u[k])
    if isinstance(u["transformer_depth"], list):
        u["transformer_depth"] = tuple(u["transformer_depth"])
    unet = UNetConfig(**u)
    v = dict(cfg["vae"], ch_mult=tuple(cfg["vae"]["ch_mult"]))
    return PipelineConfig(
        unet=unet, controlnet=ControlNetConfig(unet=unet, **cfg["controlnet"]),
        vae=VAEConfig(**v), clip=CLIPTextConfig(**cfg["clip"]),
        diffusion=DiffusionConfig(**cfg["diffusion"]), dtype=cfg["dtype"])


def build(cfg: dict, seed: int, device):
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM

    pcfg = program_config(cfg)
    return program_model(lambda: ControlLDM(pcfg), lambda: reference_module(cfg), seed,
                         device,
                         cfg["dtype"]), pcfg


def _process_kw(cfg):
    s = cfg["sampling"]
    return dict(a_prompt=A_PROMPT, n_prompt=N_PROMPT, num_samples=1,
                image_resolution=s["resolution"], ddim_steps=s["steps"], scale=s["scale"],
                eta=s["eta"], strength=s["strength"], low_threshold=s["low_threshold"],
                high_threshold=s["high_threshold"])


class PipelineEntry:
    """`Canny2ImagePipeline.process`, batch 1; one caller at a time."""

    clients_max = 1

    def __init__(self, model, pcfg, cfg, traffic, device):
        from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

        self.pipe = Canny2ImagePipeline(model, stand_in_tokenizer, pcfg, device=device)
        self.kw = _process_kw(cfg)

    def warm(self, reqs):
        for req in reqs:
            self.run(req)

    def run(self, req) -> Output:
        out = self.pipe.process(req.image, req.prompt, seed=req.seed, **self.kw)
        return Output(out[1], self.pipe.last_latents,
                      {"pipeline.preprocess_ms": self.pipe.last_timings["preprocess_ms"]})

    def engines(self):
        return {e.name: e.get_engine_infor() for e in self.pipe.runtime._engines.values()}

    def counters(self):
        return {}

    def reset(self):
        pass

    def close(self):
        self.pipe.runtime.release()


class ServerEntry:
    """`DiffusionServer.submit` over the pipeline, its buckets and batching
    window from the traffic file; any number of callers."""

    clients_max = None

    def __init__(self, model, pcfg, cfg, traffic, device):
        from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline
        from stablediffusioneo_tpu_torch.serving import DiffusionServer

        s = traffic["server"]
        self.pipe = Canny2ImagePipeline(model, stand_in_tokenizer, pcfg, device=device)
        self.server = DiffusionServer(self.pipe, batch_buckets=tuple(s["batch_buckets"]),
                                      max_wait_ms=s["max_wait_ms"],
                                      max_inflight_batches=s["max_inflight_batches"])
        kw = _process_kw(cfg)
        kw.pop("num_samples")
        self.kw = kw
        self.cfg = cfg

    def warm(self, reqs):
        """Capture every bucket's engines, then serve one burst of each
        bucket's size, so that every engine has replayed before the window."""
        s = self.cfg["sampling"]
        self.server.warmup(resolutions=(s["resolution"],), steps=s["steps"])
        self.server.start()
        for b in self.server.buckets:
            futures = [self._submit(reqs[i % len(reqs)]) for i in range(b)]
            for f in futures:
                f.result()

    def _submit(self, req):
        from stablediffusioneo_tpu_torch.serving import GenRequest

        return self.server.submit(GenRequest(image=req.image, prompt=req.prompt,
                                             seed=req.seed, **self.kw))

    def run(self, req) -> Output:
        return Output(self._submit(req).result()[1], None, {})

    def engines(self):
        return {e.name: e.get_engine_infor() for e in self.pipe.runtime._engines.values()}

    def counters(self):
        return {"server": self.server.stats.snapshot()}

    def reset(self):
        with self.server._lock:
            self.server.stats.reset()

    def close(self):
        self.server.stop(drain=True)
        self.pipe.runtime.release()


ENTRIES = {"pipeline": PipelineEntry, "server": ServerEntry}


def reference_module(cfg: dict) -> nn.Module:
    """The float32 reference under the checkpoint's top-level names (so
    `state_dict()` keys are the checkpoint's keys): UNet, VAE, ControlNet,
    CLIP ViT-L's text tower."""
    m = unet_vae_module(cfg)
    m.control_model = ControlNet(cfg["unet"], cfg["controlnet"]["hint_channels"])
    m.cond_stage_model = nn.Module()
    m.cond_stage_model.transformer = HFCLIPText(cfg["clip"])
    return m


def flops_per_image(cfg: dict) -> int:
    """ControlNet (hint block included) and UNet on every row of every step,
    CLIP on the cond and uncond rows, the decode."""
    s, u = cfg["sampling"], cfg["unet"]
    side, ctx_len = work.latent_side(cfg), cfg["clip"]["max_length"]
    per_row = work.unet_flops(u, side, ctx_len) + work.controlnet_flops(
        u, side, ctx_len, cfg["controlnet"]["hint_channels"], s["resolution"])
    return work.ldm_flops_per_image(cfg, per_row, work.text_flops(cfg["clip"], 2))


def attention_calls(cfg: dict, batch: int):
    """CLIP's layers; the UNet's and the ControlNet's transformers (the
    encoder's and middle block's twice); the decoder's mid-block."""
    return work.ldm_attention_calls(cfg, [cfg["clip"]], 2, batch)


def reference_request(net, cfg, req):
    """(latents, image) of the reference for a request, on net's device."""
    from benchmark.reference.sample import sd_request

    return sd_request(net, cfg, req.image, stand_in_tokenizer(texts(req)), req.seed)
