"""The reference's requests: text towers, ControlNet + UNet (or SDXL's UNet
with its ADM input) under classifier-free guidance in a DDIM loop (eta 0),
and the VAE decode to uint8, all in float32 with TF32 off.

The published sampling math (ldm `DDIMSampler.p_sample_ddim`, cldm
`ControlLDM.apply_model`, sgm's SDXL conditioner): the DDIM timesteps
range(0, T, ceil(T / steps)) + 1 over SD's linear-in-sqrt(beta) schedule;
e = e_uncond + scale * (e_cond - e_uncond); x_prev = sqrt(a_prev) * pred_x0
+ sqrt(1 - a_prev) * e. Inputs are worked out here from what the benchmark
handed the program: the image (Canny map by cv2, as the published
annotator), the token ids, the seed (x_T drawn as the program documents:
`torch.randn((h, w, 4), generator=torch.Generator(device).manual_seed(seed))`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference.nets import AutoencoderKL, UNet, timestep_embedding


def unet_vae_module(cfg: dict) -> nn.Module:
    """The UNet and the VAE under the checkpoint's top-level names (so
    `state_dict()` keys are the checkpoint's keys); a family adds its other
    networks after them (`benchmark/families/<family>.py:reference_module`)."""
    m = nn.Module()
    m.model = nn.Module()
    m.model.diffusion_model = UNet(cfg["unet"])
    m.first_stage_model = AutoencoderKL(cfg["vae"])
    return m


def ddim_schedule(diffusion: dict, steps: int):
    """(timesteps, alphas, alphas_prev), float64, in sampling order."""
    betas = np.linspace(diffusion["linear_start"] ** 0.5, diffusion["linear_end"] ** 0.5,
                        diffusion["timesteps"], dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    c = -(-diffusion["timesteps"] // steps)
    ts = np.arange(0, diffusion["timesteps"], c) + 1
    prev = np.concatenate([[ac[0]], ac[ts[:-1]]])
    return ts[::-1], ac[ts][::-1], prev[::-1]


def draw_x_T(seed: int, h: int, w: int, device) -> torch.Tensor:
    """The initial latents of a request of `seed`, NCHW (1, 4, h, w)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((h, w, 4), generator=g, device=device).permute(2, 0, 1)[None]


def canny_hint(image: np.ndarray, low: int, high: int, device) -> torch.Tensor:
    """The ControlNet's hint of an image already at the request's size:
    cv2.Canny, three channels, / 255, NCHW."""
    import cv2

    edges = cv2.Canny(image, low, high).astype(np.float32) / 255.0
    return torch.from_numpy(edges).to(device)[None, None].expand(1, 3, *edges.shape)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Decoded NCHW pixels -> uint8 NHWC, the published denormalisation
    (x * 127.5 + 127.5, clipped, truncated)."""
    return torch.clamp(x.permute(0, 2, 3, 1) * 127.5 + 127.5, 0, 255).to(torch.uint8)


def ddim_loop(eps_fn, x, sampling: dict, diffusion: dict):
    """eta-0 DDIM with guidance: eps_fn(x2 (2B, ...), t) -> (e_cond, e_uncond)."""
    scale = sampling["scale"]
    for t, a, a_prev in zip(*ddim_schedule(diffusion, sampling["steps"])):
        tt = torch.full((2 * x.shape[0],), float(t), device=x.device)
        e_c, e_u = eps_fn(torch.cat([x, x]), tt)
        e = e_u + scale * (e_c - e_u)
        pred_x0 = (x - (1 - a) ** 0.5 * e) / a ** 0.5
        x = a_prev ** 0.5 * pred_x0 + (1 - a_prev) ** 0.5 * e
    return x


@torch.no_grad()
def sd_request(net: nn.Module, cfg: dict, image: np.ndarray, ids: np.ndarray, seed: int):
    """One canny2image request of the ControlNet family: (x_0 latents NHWC
    fp32, uint8 image NHWC), batch 1. ids: (2, T) cond and uncond rows."""
    s = cfg["sampling"]
    dev = next(net.parameters()).device
    ctx = net.cond_stage_model.transformer(torch.as_tensor(ids, device=dev))
    hint = canny_hint(image, s["low_threshold"], s["high_threshold"], dev)
    f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    x = draw_x_T(seed, image.shape[0] // f, image.shape[1] // f, dev)
    unet, control = net.model.diffusion_model, net.control_model
    hint2 = torch.cat([hint, hint])

    def eps(x2, t):
        taps = [c * s["strength"] for c in control(x2, hint2, t, ctx)]
        return unet(x2, t, ctx, control=taps).chunk(2)

    z = ddim_loop(eps, x, s, cfg["diffusion"])
    return z.permute(0, 2, 3, 1), to_uint8(net.first_stage_model.decode(z))


def sdxl_conditioning(net: nn.Module, cfg: dict, ids_l, ids_g, size_hw):
    """sgm's SDXL conditioner for the rows of ids: context (B, 77, 2048) =
    [CLIP-L penultimate, bigG penultimate], y (B, 2816) = [bigG pooled,
    fourier(orig_hw, crop (0, 0), target_hw), 256 each]."""
    emb = net.conditioner.embedders
    hl = emb[0].transformer(ids_l)
    hg, pooled = emb[1].model(ids_g)
    proj = cfg["clip_g"]["projection_dim"]
    dim = (cfg["unet"]["adm_in_channels"] - proj) // 6
    tids = torch.tensor([*size_hw, 0, 0, *size_hw], dtype=torch.float32, device=ids_l.device)
    tid = timestep_embedding(tids, dim).reshape(1, -1).expand(ids_l.shape[0], -1)
    return torch.cat([hl, hg], dim=-1), torch.cat([pooled, tid], dim=-1)


@torch.no_grad()
def sdxl_request(net: nn.Module, cfg: dict, ids_l: np.ndarray, ids_g: np.ndarray, seed: int):
    """One SDXL-base txt2img request: (x_0 latents NHWC fp32, uint8 image
    NHWC), batch 1. ids_*: (2, T) cond and uncond rows of each tower."""
    s = cfg["sampling"]
    dev = next(net.parameters()).device
    res = s["resolution"]
    ctx, y = sdxl_conditioning(net, cfg, torch.as_tensor(ids_l, device=dev),
                               torch.as_tensor(ids_g, device=dev), (res, res))
    f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    x = draw_x_T(seed, res // f, res // f, dev)
    unet = net.model.diffusion_model

    def eps(x2, t):
        return unet(x2, t, ctx, y=y).chunk(2)

    z = ddim_loop(eps, x, s, cfg["diffusion"])
    return z.permute(0, 2, 3, 1), to_uint8(net.first_stage_model.decode(z))
