"""The networks as nn.Modules under the checkpoints' names (counterpart of
stablediffusioneo_tpu/models/, with its exports). `init_<name>(generator,
cfg)` makes a network with seeded weights (models/cldm.py:init_weights),
`<name>_apply` runs it on NHWC tensors; the T5 tower is models/t5.py."""

from stablediffusioneo_tpu_torch.models.unet import unet_apply
from stablediffusioneo_tpu_torch.models.controlnet import (
    controlnet_apply,
    controlled_unet_apply,
)
from stablediffusioneo_tpu_torch.models.vae import (
    vae_decode,
    vae_encode,
    DiagonalGaussian,
)
from stablediffusioneo_tpu_torch.models.clip import clip_text_apply, clip_text_pooled
from stablediffusioneo_tpu_torch.models.cldm import (
    init_clip_text,
    init_controlnet,
    init_unet,
    init_vae,
)
from stablediffusioneo_tpu_torch.models.t5 import (
    T5Config,
    clip_t5_encode,
    convert_t5,
    init_t5,
    t5_encode,
)

__all__ = [
    "T5Config",
    "clip_t5_encode",
    "convert_t5",
    "init_t5",
    "t5_encode",
    "init_unet",
    "unet_apply",
    "init_controlnet",
    "controlnet_apply",
    "controlled_unet_apply",
    "init_vae",
    "vae_decode",
    "vae_encode",
    "DiagonalGaussian",
    "init_clip_text",
    "clip_text_apply",
    "clip_text_pooled",
]
