"""Model / pipeline configuration dataclasses of the PyTorch port.

The port's own copy of the JAX package's `stablediffusioneo_tpu/config.py`
(the port imports nothing of that package): the same names, fields,
defaults and helper methods, so the parity tests can build both packages'
configurations from the same numbers and compare them field by field
(`tests/test_torch_imports.py`). `sd15_*` encode the SD-1.5 / ControlNet-1.0
architecture constants (320 base ch, mult (1,2,4,4), 2 res blocks/level,
attention at ds 1/2/4, context dim 768, 8 heads; VAE f=8 with 4-ch latent;
CLIP ViT-L/14 text tower). `sd21_*` / `openclip_vit_h_text` are the SD-2.x
family (64-channel heads, OpenCLIP ViT-H context, v-prediction);
`sd15_inpaint_*` / `sd2_inpaint_*` the 9-channel inpainting UNets; the SDXL
configurations live beside their model, in models/sdxl.py, as in the JAX
package.

Configs are frozen, so they are hashable and can key caches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD UNet (reference: ldm/modules/diffusionmodules/openaimodel.py:443-788)."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)  # downsample factors with attn
    # transformer blocks per attention site: an int (SD-1.x/2.x) or a
    # per-LEVEL tuple (SDXL: (1, 2, 10) over channel_mult (1, 2, 4))
    transformer_depth: "int | Tuple[int, ...]" = 1
    context_dim: int = 768
    num_heads: int = 8
    # ADM conditioning width (SDXL label_emb: pooled text + time-id
    # fourier features = 2816); None = no y input (SD-1.x/2.x)
    adm_in_channels: Optional[int] = None
    # SD-2.x style: fixed per-head channel count instead of fixed head count
    # (openaimodel num_head_channels); None -> use num_heads
    num_head_channels: Optional[int] = None
    dropout: float = 0.0
    use_scale_shift_norm: bool = False
    groups: int = 32
    norm_eps: float = 1e-5
    # Token Merging (ToMe, arXiv:2303.17604; ops/tome.py): fraction of
    # self-attention tokens merged at sites with >= tome_min_tokens
    # tokens. 0.0 (default) = off, bit-identical to the plain path.
    tome_ratio: float = 0.0
    tome_min_tokens: int = 4096
    tome_sx: int = 2
    tome_sy: int = 2

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4

    def heads_for(self, channels: int) -> int:
        if self.num_head_channels is not None:
            return channels // self.num_head_channels
        return self.num_heads

    def depth_for(self, level: int) -> int:
        """Transformer blocks per attention site at channel_mult level."""
        td = self.transformer_depth
        return td[level] if isinstance(td, tuple) else td


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """ControlNet copy-encoder (reference: cldm/cldm.py:48-305).

    Shares the UNet encoder architecture; adds the 8-conv hint block and a
    zero-conv tap per input block plus one for the middle block (13 taps for
    SD-1.5: 12 input blocks + middle).
    """

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    hint_channels: int = 3


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL towers (reference: ldm/modules/diffusionmodules/model.py).

    SD-1.5 first stage: 128 base ch, mult (1,2,4,4), 2 res blocks, attention
    only in the mid block, z_channels 4, double_z on the encoder,
    GroupNorm eps 1e-6 (model.py:46-47 — NOT the UNet's 1e-5).
    """

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_channels: int = 3
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True
    groups: int = 32
    norm_eps: float = 1e-6
    scale_factor: float = 0.18215  # LatentDiffusion first-stage scaling

    @property
    def downsample_factor(self) -> int:
        """Spatial image->latent factor (f=8 for SD: 3 stride-2 stages)."""
        return 2 ** (len(self.ch_mult) - 1)

    @property
    def quant_convs(self) -> bool:
        """Whether quant_conv and post_quant_conv sit between the towers and
        the latents (SD-1.x, 2.x and XL: yes; FlowVAEConfig sets it)."""
        return True

    @property
    def shift_factor(self) -> float:
        """The latents' shift: z = (x - shift_factor) * scale_factor (0 here;
        FlowVAEConfig sets it)."""
        return 0.0


@dataclasses.dataclass(frozen=True)
class FlowVAEConfig(VAEConfig):
    """SD3's first stage (diffusers AutoencoderKL of
    stabilityai/stable-diffusion-3.5-medium, vae/config.json): the same
    towers with 16 latent channels, no quant_conv or post_quant_conv, and
    latents both scaled and shifted."""

    z_channels: int = 16
    embed_dim: int = 16
    scale_factor: float = 1.5305
    shift_factor: float = 0.0609
    quant_convs: bool = False


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP ViT-L/14 text tower (reference: FrozenCLIPEmbedder,
    ldm/modules/encoders/modules.py:90-144 — HF openai/clip-vit-large-patch14)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    layer_norm_eps: float = 1e-5
    # "last" = final LN output (SD1.5), "penultimate" = hidden layer -2 (SD2.x)
    layer: str = "last"
    # "quick_gelu" (OpenAI CLIP / SD1.5) vs "gelu" (OpenCLIP ViT-H / SD2.x)
    act: str = "quick_gelu"
    # pooled-output projection width (SDXL's bigG tower: 1280); None = no
    # text_projection parameter
    projection_dim: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """DDPM/DDIM schedule constants (reference: ldm/modules/diffusionmodules/util.py
    + the missing ldm.models.diffusion.ddpm defaults for SD-1.5)."""

    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    schedule: str = "linear"  # sqrt-linear in beta, as SD uses
    # v-parameterization unsupported in SD1.5/ControlNet; eps-pred only
    parameterization: str = "eps"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full CNSD pipeline = the four nets + schedule + runtime policy."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    controlnet: ControlNetConfig = dataclasses.field(default_factory=ControlNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    clip: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    # compute dtype for the hot path; params kept fp32 unless cast
    dtype: str = "bfloat16"
    # kept for field parity with the JAX package's config; the port's kernel
    # choice is ops/dispatch.py's
    use_pallas: bool = True


def sd15_unet() -> UNetConfig:
    return UNetConfig()


def sd15_controlnet() -> ControlNetConfig:
    return ControlNetConfig()


def sd15_vae() -> VAEConfig:
    return VAEConfig()


def clip_vit_l14() -> CLIPTextConfig:
    return CLIPTextConfig()


def sd15_pipeline(dtype: str = "bfloat16", use_pallas: bool = True) -> PipelineConfig:
    return PipelineConfig(dtype=dtype, use_pallas=use_pallas)


def sd21_unet() -> UNetConfig:
    """SD-2.1 UNet: per-head 64 channels, OpenCLIP ViT-H context (1024)."""
    return UNetConfig(num_head_channels=64, context_dim=1024)


def openclip_vit_h_text() -> CLIPTextConfig:
    """OpenCLIP ViT-H/14 text tower (FrozenOpenCLIPEmbedder, SD-2.x:
    penultimate layer, plain gelu)."""
    return CLIPTextConfig(
        hidden_size=1024, intermediate_size=4096, num_layers=24,
        num_heads=16, layer="penultimate", act="gelu",
    )


def sd21_pipeline(
    dtype: str = "bfloat16", v_prediction: bool = True, use_pallas: bool = True
) -> PipelineConfig:
    unet = sd21_unet()
    return PipelineConfig(
        unet=unet,
        controlnet=ControlNetConfig(unet=unet),
        clip=openclip_vit_h_text(),
        diffusion=DiffusionConfig(
            parameterization="v" if v_prediction else "eps"
        ),
        dtype=dtype,
        use_pallas=use_pallas,
    )


def sd2_depth_pipeline(
    dtype: str = "bfloat16", use_pallas: bool = True
) -> PipelineConfig:
    """SD-2.0 depth2img (512-depth-ema): 5-channel hybrid-conditioned UNet
    (latent + MiDaS depth at latent resolution), OpenCLIP ViT-H context,
    eps parameterization. Sampled via pipeline/concat_cond.py; the
    controlnet field is structural only (this family has no ControlNet)."""
    unet = UNetConfig(in_channels=5, num_head_channels=64, context_dim=1024)
    return PipelineConfig(
        unet=unet,
        controlnet=ControlNetConfig(unet=unet),
        clip=openclip_vit_h_text(),
        dtype=dtype,
        use_pallas=use_pallas,
    )


def sd15_inpaint_pipeline(
    dtype: str = "bfloat16", use_pallas: bool = True
) -> PipelineConfig:
    """sd-v1-5-inpainting: 9-channel hybrid-conditioned UNet (latent +
    mask + masked-image latent), otherwise SD-1.5. Sampled via
    pipeline/concat_cond.py; controlnet field structural only."""
    unet = UNetConfig(in_channels=9)
    return PipelineConfig(
        unet=unet,
        controlnet=ControlNetConfig(unet=unet),
        dtype=dtype,
        use_pallas=use_pallas,
    )


def sd2_inpaint_pipeline(
    dtype: str = "bfloat16", use_pallas: bool = True
) -> PipelineConfig:
    """SD-2.0 inpainting (512-inpainting-ema): the 9-channel UNet at SD-2.x
    dimensions (per-head 64 channels, OpenCLIP ViT-H context, eps)."""
    unet = UNetConfig(in_channels=9, num_head_channels=64, context_dim=1024)
    return PipelineConfig(
        unet=unet,
        controlnet=ControlNetConfig(unet=unet),
        clip=openclip_vit_h_text(),
        dtype=dtype,
        use_pallas=use_pallas,
    )


def tiny_pipeline() -> PipelineConfig:
    """Miniature config for tests: same topology, tiny widths."""
    unet = UNetConfig(
        model_channels=32,
        channel_mult=(1, 2),
        num_res_blocks=1,
        attention_resolutions=(1, 2),
        context_dim=64,
        num_heads=2,
        groups=8,
    )
    return PipelineConfig(
        unet=unet,
        controlnet=ControlNetConfig(unet=unet),
        # 4 levels -> f=8, matching the ControlNet hint block's fixed /8
        vae=VAEConfig(ch=16, ch_mult=(1, 1, 1, 1), num_res_blocks=1, groups=8),
        clip=CLIPTextConfig(
            vocab_size=1000, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=2, max_length=16,
        ),
        dtype="float32",
        use_pallas=False,
    )
