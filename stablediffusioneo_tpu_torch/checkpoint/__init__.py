"""Checkpoints: reading a file, accounting for its keys, loading the model.

The loaders are the counterparts of the JAX package's checkpoint/convert.py
loaders of the same names: a file (.pth / .ckpt / .safetensors) becomes the
port's model holding its weights.
  load_controlnet_pipeline  control_sd15_* (or an SD-2.1 ControlNet file with
                            cfg=sd21_pipeline()) -> ControlLDM
  load_sd_pipeline          v1-5-pruned / v2-1_768-ema-pruned -> LatentDiffusion
  load_sdxl_pipeline        sd_xl_base_1.0 (sgm layout) -> SDXL
  load_sdxl_refiner_pipeline  sd_xl_refiner_1.0 (sgm layout) -> SDXLRefiner
  load_inpaint_pipeline     sd-v1-5-inpainting / 512-inpainting-ema (a
                            9-channel UNet) -> LatentDiffusion
  load_depth2img_pipeline   512-depth-ema (a 5-channel UNet and its MiDaS
                            DPT-hybrid tower) -> Depth2ImgModel
One network of a file loads with `convert_unet` / `convert_controlnet` /
`convert_vae` / `convert_clip` (the keys under its prefix, strictly, into
its module); a diffusers-layout network's state dict comes out of
`convert_{unet,vae,clip,clip_g}_diffusers` under the sgm / OpenCLIP names
those take (checkpoint/diffusers.py, prefix="").
Textual-inversion concepts load with `load_concept` and go into a tower
with `add_concepts` / into a live runtime with `apply_textual_inversion`
(checkpoint/textual_inversion.py).
The port keeps the checkpoints' key names, so nothing is converted; every
key is accounted for (checkpoint/accounting.py): per tree, each tree's
documented leftovers by pattern under its prefix (the JAX jobs' ignore
lists), and a key outside every tree that SD_KNOWN_UNUSED does not name is
an orphan (the JAX `_load_concat_family`'s global-scope rule).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from stablediffusioneo_tpu_torch.checkpoint.accounting import (
    HF_CLIP_IGNORES,
    OPENCLIP_IGNORES,
    account_checkpoint,
    copy_checkpoint_,
    tree_ignores,
)
from stablediffusioneo_tpu_torch.checkpoint.diffusers import (
    convert_clip_diffusers,
    convert_clip_g_diffusers,
    convert_unet_diffusers,
    convert_vae_diffusers,
)
from stablediffusioneo_tpu_torch.checkpoint.textual_inversion import (
    add_concepts,
    apply_textual_inversion,
    load_concept,
)
from stablediffusioneo_tpu_torch.checkpoint.torch_reader import load_torch_state_dict
from stablediffusioneo_tpu_torch.config import (
    PipelineConfig,
    sd2_depth_pipeline,
    sd15_inpaint_pipeline,
    sd15_pipeline,
)

__all__ = [
    "load_torch_state_dict",
    "convert_unet",
    "convert_controlnet",
    "convert_vae",
    "convert_clip",
    "convert_unet_diffusers",
    "convert_vae_diffusers",
    "convert_clip_diffusers",
    "convert_clip_g_diffusers",
    "load_controlnet_pipeline",
    "load_sdxl_pipeline",
    "load_sdxl_refiner_pipeline",
    "load_inpaint_pipeline",
    "load_depth2img_pipeline",
    "convert_depth_tower",
    "load_sd_pipeline",
    "load_concept",
    "add_concepts",
    "apply_textual_inversion",
]


def _sd_trees(cfg: PipelineConfig, control: bool) -> Tuple[Tuple[str, Tuple[str, ...]], ...]:
    """(prefix, documented leftovers) of each tree of an SD-1.x / 2.x file:
    the text tower is OpenCLIP's under cond_stage_model.model. where
    cfg.clip.layer is "penultimate" (SD-2.x), else HF CLIP's."""
    from stablediffusioneo_tpu_torch.models.cldm import openclip_text

    clip = (("cond_stage_model.model.", OPENCLIP_IGNORES) if openclip_text(cfg)
            else ("cond_stage_model.transformer.", HF_CLIP_IGNORES))
    return (("model.diffusion_model.", ()),) \
        + ((("control_model.", ()),) if control else ()) \
        + (("first_stage_model.", ()), clip)


def _load(path: str, build: Callable[[Mapping], torch.nn.Module],
          trees: Sequence[Tuple[str, Sequence[str]]], device, strict: bool,
          dtype: Optional[torch.dtype], tag: str):
    """Build on the meta device (build(sd): the model; the file's shapes
    may decide a tower's widths), account for every key of the file, then
    materialise on `device` only and copy the weights in (in `dtype`, default
    fp32), so the full width never passes through host memory twice.
    strict=True raises ConversionAccountingError on any key the model does
    not consume and that no tree's leftovers or SD_KNOWN_UNUSED name;
    missing keys and wrong shapes raise either way. The accounting is kept
    as `model.load_report`."""
    sd = load_torch_state_dict(path)
    return _strict_load(lambda: build(sd), sd, tree_ignores(trees), device, strict, dtype,
                        tag)


def _strict_load(make: Callable[[], torch.nn.Module], sd: Mapping, ignores: Sequence[str],
                 device, strict: bool, dtype: Optional[torch.dtype], tag: str):
    """make() built on the meta device, every key of `sd` accounted for
    (`ignores`: the documented leftovers), then materialised on `device` in
    `dtype` (default fp32) and filled from `sd`; the report kept as
    `model.load_report`."""
    with torch.device("meta"):
        model = make()
        if dtype is not None:
            model.to(dtype)
    report = account_checkpoint(model, sd, ignores).assert_complete(tag, orphans=strict)
    model.to_empty(device=device)
    copy_checkpoint_(model, sd)
    model.load_report = report
    return model.eval().requires_grad_(False)


def _convert(sd: Mapping, prefix: str, make: Callable[[], torch.nn.Module],
             ignores: Sequence[str], device, dtype: Optional[torch.dtype], tag: str):
    """The keys of `sd` under `prefix`, stripped of it, loaded strictly into
    make(): any other key under the prefix that `ignores` does not name, a
    missing key or a wrong shape raises ConversionAccountingError."""
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return _strict_load(make, sub, ignores, device, True, dtype, tag)


def convert_unet(sd: Mapping, cfg, prefix: str = "model.diffusion_model.", device="cuda",
                 dtype: Optional[torch.dtype] = None):
    """The UNetModel of `cfg` (a UNetConfig) holding the keys of `sd` under
    `prefix` (prefix="" for a network's own state dict, e.g. the output of
    convert_unet_diffusers)."""
    from stablediffusioneo_tpu_torch.models.unet import UNetModel

    return _convert(sd, prefix, lambda: UNetModel(cfg), (), device, dtype, "unet")


def convert_controlnet(sd: Mapping, cfg, prefix: str = "control_model.", device="cuda",
                       dtype: Optional[torch.dtype] = None):
    """The ControlNet of `cfg` (a ControlNetConfig) from the keys under
    `prefix`."""
    from stablediffusioneo_tpu_torch.models.controlnet import ControlNet

    return _convert(sd, prefix, lambda: ControlNet(cfg), (), device, dtype, "controlnet")


def convert_vae(sd: Mapping, cfg, prefix: str = "first_stage_model.", device="cuda",
                dtype: Optional[torch.dtype] = None):
    """The AutoencoderKL of `cfg` (a VAEConfig) from the keys under
    `prefix`."""
    from stablediffusioneo_tpu_torch.models.vae import AutoencoderKL

    return _convert(sd, prefix, lambda: AutoencoderKL(cfg), (), device, dtype, "vae")


def convert_clip(sd: Mapping, cfg, prefix: str = "cond_stage_model.transformer.",
                 device="cuda", dtype: Optional[torch.dtype] = None):
    """The HF-named CLIPTextModel of `cfg` (a CLIPTextConfig) from the keys
    under `prefix` (its position_ids leftover named by HF_CLIP_IGNORES)."""
    from stablediffusioneo_tpu_torch.models.clip import CLIPTextModel

    return _convert(sd, prefix, lambda: CLIPTextModel(cfg), HF_CLIP_IGNORES, device, dtype,
                    "clip")


def load_controlnet_pipeline(path: str, cfg: Optional[PipelineConfig] = None,
                             device="cuda", strict: bool = True,
                             dtype: Optional[torch.dtype] = None):
    """The ControlLDM of `cfg` (default SD-1.5) holding the weights of the
    checkpoint at `path` on `device`."""
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM

    cfg = cfg or sd15_pipeline()
    return _load(path, lambda sd: ControlLDM(cfg), _sd_trees(cfg, True), device, strict,
                 dtype, "controlnet_pipeline")


def load_sd_pipeline(path: str, cfg: Optional[PipelineConfig] = None,
                     device="cuda", strict: bool = True,
                     dtype: Optional[torch.dtype] = None):
    """The LatentDiffusion (UNet, VAE, text tower; no control_model scope)
    of a plain SD-1.x / 2.x checkpoint; sample it with
    pipeline/concat_cond.py:sd_txt2img."""
    from stablediffusioneo_tpu_torch.models.cldm import LatentDiffusion

    cfg = cfg or sd15_pipeline()
    return _load(path, lambda sd: LatentDiffusion(cfg), _sd_trees(cfg, False), device,
                 strict, dtype, "sd_pipeline")


def load_sdxl_pipeline(path: str, cfg=None, device="cuda", strict: bool = True,
                       dtype: Optional[torch.dtype] = None):
    """The SDXL (models/sdxl.py; default SDXLConfig()) of an SDXL-base
    checkpoint in sgm's layout, its Linear-stored proj_in / proj_out
    included."""
    from stablediffusioneo_tpu_torch.models.sdxl import SDXL, SDXL_TREES, SDXLConfig

    cfg = cfg or SDXLConfig()
    return _load(path, lambda sd: SDXL(cfg), SDXL_TREES, device, strict, dtype,
                 "sdxl_pipeline")


def load_inpaint_pipeline(path: str, cfg: Optional[PipelineConfig] = None,
                          device="cuda", strict: bool = True,
                          dtype: Optional[torch.dtype] = None):
    """The LatentDiffusion (9-channel UNet, VAE, text tower) of a dedicated
    inpainting checkpoint (default sd15_inpaint_pipeline(); SD-2.0's
    512-inpainting-ema with cfg=sd2_inpaint_pipeline(): the text tower's
    layout follows cfg.clip.layer, as for load_sd_pipeline); sample it with
    pipeline/concat_cond.py (inpaint_to_concat + sd_concat_sample)."""
    from stablediffusioneo_tpu_torch.models.cldm import LatentDiffusion

    cfg = cfg or sd15_inpaint_pipeline()
    return _load(path, lambda sd: LatentDiffusion(cfg), _sd_trees(cfg, False), device,
                 strict, dtype, "inpaint")


def load_sdxl_refiner_pipeline(path: str, cfg=None, device="cuda", strict: bool = True,
                               dtype: Optional[torch.dtype] = None):
    """The SDXLRefiner (models/sdxl.py; default SDXLRefinerConfig()) of an
    SDXL-refiner checkpoint in sgm's layout: the UNet, bigG at
    conditioner.embedders.0.model. and the VAE; sample it with
    models/sdxl.py:sdxl_refine_latents on the base model's latents."""
    from stablediffusioneo_tpu_torch.models.sdxl import (
        SDXL_REFINER_TREES,
        SDXLRefiner,
        SDXLRefinerConfig,
    )

    cfg = cfg or SDXLRefinerConfig()
    return _load(path, lambda sd: SDXLRefiner(cfg), SDXL_REFINER_TREES, device, strict,
                 dtype, "sdxl_refiner")


DEPTH_PREFIX = "depth_model.model."


def convert_depth_tower(sd: Mapping, prefix: str = DEPTH_PREFIX) -> Dict[str, torch.Tensor]:
    """The MiDaS DPT-hybrid tower embedded in an SD-2.0 depth checkpoint
    (LatentDepth2ImageDiffusion's `depth_model`; the reference vendors the
    same net under ldm/modules/midas/) as the tower's own state dict: the
    keys under `prefix`, stripped of it, e.g. for
    MidasDetector(params=..., model_type="dpt_hybrid")."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_depth2img_pipeline(path: str, cfg: Optional[PipelineConfig] = None,
                            device="cuda", strict: bool = True,
                            dtype: Optional[torch.dtype] = None):
    """The Depth2ImgModel (models/cldm.py) of an SD-2.0 depth2img checkpoint
    in the 512-depth-ema layout (default cfg sd2_depth_pipeline()):
      model.diffusion_model.*   -> the 5-channel UNet
      first_stage_model.*       -> the VAE
      cond_stage_model.model.*  -> the OpenCLIP ViT-H text tower
      depth_model.model.*       -> the MiDaS DPT-hybrid tower (its position
                                   grid and widths read off the file)
    with the JAX _load_concat_family's accounting: each tree's own (OpenCLIP's
    two leftovers by pattern), and a key outside every tree that
    SD_KNOWN_UNUSED does not name is an orphan. Sample it with
    pipeline/concat_cond.py: the tower's depth of the init image through
    depth_to_concat, then sd_concat_sample (or concat_sample_decode_engine)."""
    from stablediffusioneo_tpu_torch.annotators.midas_hybrid import hybrid_shape
    from stablediffusioneo_tpu_torch.models.cldm import Depth2ImgModel

    cfg = cfg or sd2_depth_pipeline()
    trees = _sd_trees(cfg, False) + ((DEPTH_PREFIX, ()),)
    return _load(path, lambda sd: Depth2ImgModel(cfg, **hybrid_shape(sd, DEPTH_PREFIX)),
                 trees, device, strict, dtype, "depth2img")
