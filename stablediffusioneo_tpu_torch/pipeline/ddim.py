"""DDIM sampler (counterpart of stablediffusioneo_tpu/pipeline/ddim.py).

The JAX package's `lax.scan` becomes a Python loop. As there:
  * classifier-free guidance runs cond and uncond as one batch-2 concat
    through ControlNet + UNet per step (guess mode: cond with control,
    uncond without, as two evaluations);
  * the hint-block embedding and every cross-attention K/V projection of
    the step-invariant contexts are computed once, before the loop
    (`_hoist_context_kv`; `_cfg_eval` runs one CFG evaluation, and the other
    samplers, pipeline/{plms,dpm_solver,unipc,k_diffusion}.py, use both);
  * the DDIM update runs in fp32, whatever dtype the nets run in, and x is
    carried between steps in the nets' dtype: rounded to it on entry and once
    per step, after the noise is added (in fp32 that rounding changes nothing);
  * `encoder_cache_interval > 1` runs ControlNet and the UNet's encoder and
    middle block on key steps only and the decoder on the cached features in
    between (`_ddim_loop_enc_cached`); `inpaint_latent` / `inpaint_mask`
    re-impose the kept region at every step's noise level; `cfg_rescale`
    renormalises the combined prediction; `parameterization="v"` reads the
    nets' output as a v-prediction.

The loop's per-step constants are Python floats taken from the schedule and
its branches are taken on the host, so a CUDA graph captured around
`ddim_sample` (runtime/engine.py) holds one schedule: after its first pass
the loop copies nothing from the host (ops/dispatch.py: const_tensor), and
every random number it uses can be handed in (`noise`, `inpaint_noise`).

Update (p_sample_ddim, ddim_hacked.py:208-231):
    e_t     = e_uncond + scale * (e_cond - e_uncond)
    pred_x0 = (x - sqrt(1 - a_t) * e_t) / sqrt(a_t)
    dir_xt  = sqrt(1 - a_prev - sigma_t^2) * e_t
    x_prev  = sqrt(a_prev) * pred_x0 + dir_xt + sigma_t * noise * temperature
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from stablediffusioneo_tpu_torch.config import PipelineConfig
from stablediffusioneo_tpu_torch.models.controlnet import (
    ControlNet,
    controlled_unet_forward,
    controlnet_forward,
    guess_mode_scales,
    hint_block_apply,
    per_net,
    precompute_controlnet_context_kv,
    scale_control,
)
from stablediffusioneo_tpu_torch.models.unet import (
    UNetModel,
    embed_timesteps,
    encoder_plan,
    precompute_context_kv,
    unet_decode,
    unet_encode,
    unet_middle,
    unet_out,
)
from stablediffusioneo_tpu_torch.ops.dispatch import const_tensor
from stablediffusioneo_tpu_torch.ops.layers import nchw, nhwc
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule


def _tile_cfg(control_scales):
    """Per-sample (B, 13) scales tiled to the batch-2B concat; shared
    scales broadcast as they are; a tuple (multi-ControlNet: one entry a
    net) tiles net by net."""
    if isinstance(control_scales, tuple):
        return tuple(_tile_cfg(c) for c in control_scales)
    if isinstance(control_scales, torch.Tensor) and control_scales.dim() == 2:
        return torch.cat([control_scales, control_scales], dim=0)
    return control_scales


def _bc_scale(scale, like: torch.Tensor):
    """Guidance scale, a number or a (B,) tensor, broadcast against NCHW."""
    if not isinstance(scale, torch.Tensor):
        return const_tensor(float(scale), like.dtype, like.device)
    s = scale.to(like.device, like.dtype)
    return s.reshape(-1, 1, 1, 1) if s.dim() == 1 else s


def _cfg_combine(e_c: torch.Tensor, e_u: torch.Tensor, scale,
                 rescale: float = 0.0) -> torch.Tensor:
    """The CFG combine e_u + scale * (e_c - e_u). rescale > 0 (Lin et
    al., arXiv:2305.08891, section 3.4): its per-sample standard deviation
    is pulled towards the conditional branch's, in fp32, and the result is
    rescale * renormalised + (1 - rescale) * plain, rounded once. rescale 0
    is the plain combine, to the bit."""
    out = e_u + _bc_scale(scale, e_u) * (e_c - e_u)
    if rescale:
        dims = tuple(range(1, out.dim()))
        of = out.float()
        std_pos = e_c.float().std(dim=dims, keepdim=True, unbiased=False)
        std_cfg = of.std(dim=dims, keepdim=True, unbiased=False)
        renorm = of * (std_pos / torch.clamp(std_cfg, min=1e-8))
        out = (rescale * renorm + (1.0 - rescale) * of).to(out.dtype)
    return out


class CfgInputs(NamedTuple):
    """The step-invariant inputs of a CFG evaluation, made once before a
    sampler's loop by `_hoist_context_kv`. Normal mode: the hint embedding
    and the control scales tiled to the batch-2B concat, ctx = (ctx2,), kv =
    (UNet K/V, ControlNet K/V) of ctx2, and the ADM vectors' concat y2 (or
    None). Guess mode: the hint embedding and scales as given, ctx =
    (ctx_cond, ctx_uncond), kv = (UNet K/V of cond, ControlNet K/V of cond,
    UNet K/V of uncond). Without a ControlNet: no hint embedding, scales or
    ControlNet K/V (None); c_concat, the concat-conditioned families'
    extra channels (NCHW) tiled to the batch-2B concat, or None.
    Multi-ControlNet: the hint embeddings, the ControlNet K/V and the scales
    are tuples, one entry a net."""

    guided_hint: Optional[torch.Tensor]
    ctx: Tuple[torch.Tensor, ...]
    kv: tuple
    control_scales: object
    y: Optional[torch.Tensor] = None
    c_concat: Optional[torch.Tensor] = None


def _hoist_context_kv(unet: UNetModel, control: Optional[ControlNet],
                      hint: Optional[torch.Tensor], ctx_cond: torch.Tensor,
                      ctx_uncond: torch.Tensor, control_scales, guess_mode: bool,
                      dtype, y_cond=None, y_uncond=None, c_concat=None) -> CfgInputs:
    """Everything an evaluation needs that does not change from step to step
    (the JAX `_hoist_context_kv`, with the hint-block embedding the JAX scans
    hoist beside it): every cross-attention K/V projection of the contexts,
    the embedding of the NHWC hint, and in normal mode the batch-2 concats,
    so that no step repeats them. control=None: the UNet alone (the JAX
    sd_txt2img_scan / sdxl_txt2img_scan, y_cond / y_uncond their ADM
    vectors; c_concat (B, h, w, in_channels - 4) NHWC, the JAX
    sd_concat_sample_scan's conditioning channels, which both branches take,
    as the JAX scan: concatenated once here, joined to x at every
    evaluation)."""
    y2 = None if y_cond is None else torch.cat([y_cond, y_uncond], dim=0)
    if control is None:
        if guess_mode:
            raise ValueError("guess mode needs a ControlNet")
        cc2 = None
        if c_concat is not None:
            want = unet.cfg.in_channels - 4
            if c_concat.shape[-1] != want:
                raise ValueError(
                    f"c_concat has {c_concat.shape[-1]} channels; this UNet "
                    f"(in_channels={unet.cfg.in_channels}) expects {want}")
            cc = nchw(c_concat).to(dtype)
            cc2 = torch.cat([cc, cc], dim=0)
        ctx2 = torch.cat([ctx_cond, ctx_uncond], dim=0)
        return CfgInputs(None, (ctx2,), (precompute_context_kv(unet, ctx2), None),
                         None, y2, cc2)
    if c_concat is not None:
        raise ValueError("c_concat is the ControlNet-free loop's (control=None)")
    if guess_mode and y2 is not None:
        raise NotImplementedError("guess mode with ADM conditioning")
    nets = control if isinstance(control, tuple) else None

    def each(fn, *args):  # per net for a tuple of nets (multi-ControlNet)
        if nets is None:
            return fn(control, *args)
        return tuple(fn(net, *(per_net(a, i) for a in args))
                     for i, net in enumerate(nets))

    guided_hint = each(lambda net, h: hint_block_apply(net.input_hint_block,
                                                       nchw(h).to(dtype)), hint)
    if guess_mode:
        return CfgInputs(guided_hint, (ctx_cond, ctx_uncond),
                         (precompute_context_kv(unet, ctx_cond),
                          each(precompute_controlnet_context_kv, ctx_cond),
                          precompute_context_kv(unet, ctx_uncond)),
                         control_scales)
    ctx2 = torch.cat([ctx_cond, ctx_uncond], dim=0)
    return CfgInputs(each(lambda net, g: torch.cat([g, g], dim=0), guided_hint), (ctx2,),
                     (precompute_context_kv(unet, ctx2),
                      each(precompute_controlnet_context_kv, ctx2)),
                     _tile_cfg(control_scales), y2)


def _cfg_eval(unet: UNetModel, control: Optional[ControlNet], xn: torch.Tensor,
              t: float, hoisted: CfgInputs, guess_mode: bool, tome=None):
    """One CFG evaluation at timestep t (a float: Karras spacings evaluate
    between the trained steps) on NCHW x: (e_cond, e_uncond), NCHW. Normal
    mode: cond and uncond as one batch-2 concat through ControlNet + UNet
    (the UNet alone without a ControlNet, with the hoisted c_concat joined to
    the batch on the channel axis); guess mode: cond with control, uncond
    without (cldm/cldm.py:334-335)."""
    b = xn.shape[0]
    if guess_mode:
        tb = torch.full((b,), t, dtype=torch.float32, device=xn.device)
        kv_c, ckv_c, kv_u = hoisted.kv
        e_cond = controlled_unet_forward(
            unet, control, xn, None, tb, hoisted.ctx[0],
            control_scales=hoisted.control_scales, guided_hint=hoisted.guided_hint,
            unet_ctx_kv=kv_c, ctrl_ctx_kv=ckv_c, tome=tome)
        e_uncond = controlled_unet_forward(
            unet, control, xn, None, tb, hoisted.ctx[1], unet_ctx_kv=kv_u, tome=tome)
        return e_cond, e_uncond
    tb = torch.full((2 * b,), t, dtype=torch.float32, device=xn.device)
    x2 = torch.cat([xn, xn], dim=0)
    if hoisted.c_concat is not None:
        x2 = torch.cat([x2, hoisted.c_concat], dim=1)
    eps2 = controlled_unet_forward(
        unet, control, x2, None, tb, hoisted.ctx[0],
        control_scales=hoisted.control_scales, guided_hint=hoisted.guided_hint,
        unet_ctx_kv=hoisted.kv[0], ctrl_ctx_kv=hoisted.kv[1], tome=tome, y=hoisted.y)
    return eps2[:b], eps2[b:]


def guided_model(unet: UNetModel, control: ControlNet, hoisted: CfgInputs,
                 guess_mode: bool, scale, cfg_rescale: float = 0.0, tome=None):
    """The guided prediction as a function (x NHWC, t) -> NHWC, in the nets'
    dtype: `_cfg_eval` then `_cfg_combine`. The samplers of the other
    modules (plms, dpm_solver, unipc, k_diffusion) evaluate through it."""
    def model(x: torch.Tensor, t: float) -> torch.Tensor:
        e_c, e_u = _cfg_eval(unet, control, nchw(x), t, hoisted, guess_mode, tome)
        return nhwc(_cfg_combine(e_c, e_u, scale, cfg_rescale))

    return model


def ddim_update(x: torch.Tensor, e_t: torch.Tensor,
                schedule: Dict[str, np.ndarray], i: int,
                noise: Optional[torch.Tensor] = None,
                temperature: float = 1.0,
                parameterization: str = "eps") -> torch.Tensor:
    """Step i of the schedule: x_prev from x and the guided prediction e_t
    (same layout). The arithmetic is fp32 (sqrt of the fp32 constants, as the
    JAX package), the noise is added in fp32, and the result is rounded once
    to x's dtype, which is how the loop carries x. parameterization "v": e_t
    is a v-prediction (eps = sqrt(a_t) v + sqrt(1 - a_t) x, pred_x0 =
    sqrt(a_t) x - sqrt(1 - a_t) v)."""
    a_t = np.float32(schedule["alphas"][i])
    a_prev = np.float32(schedule["alphas_prev"][i])
    sigma = np.float32(schedule["sigmas"][i])
    sqrt_1m_at = np.float32(schedule["sqrt_one_minus_alphas"][i])
    sqrt_at = float(np.sqrt(a_t))
    ef = e_t.float()
    if parameterization == "v":
        xf = x.float()
        pred_x0 = sqrt_at * xf - float(sqrt_1m_at) * ef
        ef = sqrt_at * ef + float(sqrt_1m_at) * xf
    else:
        pred_x0 = (x.float() - float(sqrt_1m_at) * ef) / sqrt_at
    dir_coef = np.sqrt(np.maximum(np.float32(1.0) - a_prev - sigma * sigma,
                                  np.float32(0.0)))
    x_prev = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * ef
    if sigma > 0:
        x_prev = x_prev + float(sigma) * noise.to(x.device, torch.float32) * temperature
    return x_prev.to(x.dtype)


def _ddim_loop_enc_cached(unet, control, schedule, x, hoisted: CfgInputs, scale,
                          step_noise, temperature, parameterization,
                          interval: int, cfg_rescale: float, tome=None) -> torch.Tensor:
    """Encoder-cached loop (arXiv:2312.09608; the JAX `_ddim_scan_enc_cached`):
    steps `[::interval]` and the last two run ControlNet and the UNet's
    encoder and middle block and refresh the cached control-merged features;
    the others run only the UNet's decoder and output layers on the cache,
    with the step's own timestep embedding. Which steps run in full is decided
    on the host."""
    n_steps = len(schedule["timesteps"])
    b = x.shape[0]
    run_full = np.zeros(n_steps, bool)
    run_full[::interval] = True
    run_full[-2:] = True
    mc = unet.cfg.model_channels
    gh2, (ctx2,), kv2, cscales2 = hoisted[:4]
    cache = None
    for i in range(n_steps):
        t2 = torch.full((2 * b,), float(schedule["timesteps"][i]),
                        dtype=torch.float32, device=x.device)
        if run_full[i]:
            xn = nchw(x)
            x2 = torch.cat([xn, xn], dim=0)
            emb = embed_timesteps(unet, mc, t2, x2.dtype)
            ctrl = scale_control(
                controlnet_forward(control, x2, None, t2, ctx2, guided_hint=gh2,
                                   ctx_kv=kv2[1], tome=tome), cscales2)
            h, hs = unet_encode(unet, x2, emb, ctx2, kv2[0], tome)
            h = unet_middle(unet, h, emb, ctx2, kv2[0], tome) + ctrl[-1].to(x2.dtype)
            cache = (h, [s + c.to(s.dtype) for s, c in zip(hs, ctrl[:-1])])
        emb = embed_timesteps(unet, mc, t2, cache[0].dtype)
        eps2 = unet_out(unet, unet_decode(unet, cache[0], cache[1], emb, ctx2,
                                          ctx_kv=kv2[0], tome=tome))
        e_t = _cfg_combine(eps2[:b], eps2[b:], scale, cfg_rescale)
        x = ddim_update(x, nhwc(e_t), schedule, i, step_noise(i, x),
                        temperature, parameterization)
    return x


def ddim_sample(
    unet: UNetModel,
    control: Optional[ControlNet],
    schedule: Dict[str, np.ndarray],
    x_T: torch.Tensor,
    hint: Optional[torch.Tensor],
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    scale,
    control_scales,
    guess_mode: bool = False,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None,
    parameterization: str = "eps",
    encoder_cache_interval: int = 1,
    inpaint_latent: Optional[torch.Tensor] = None,
    inpaint_mask: Optional[torch.Tensor] = None,
    inpaint_noise: Optional[Sequence[torch.Tensor]] = None,
    cfg_rescale: float = 0.0,
    tome=None,
    y_cond: Optional[torch.Tensor] = None,
    y_uncond: Optional[torch.Tensor] = None,
    c_concat: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full DDIM loop; returns the x_0 latents, NHWC (B, h, w, 4), as fp32
    (with bf16 nets: the bf16 values the loop carries, widened).

    schedule: DiffusionSchedule.ddim(...) (sampling order). x_T: NHWC
    latents; hint: NHWC (B, H, W, 3) in [0, 1]; ctx_*: (B, T, C) contexts in
    the nets' dtype. scale: a number or (B,) tensor; control_scales: 13
    numbers or a (B, 13) tensor. With eta > 0 the step noise comes from
    `noise[i]` (NHWC, one per step: a sequence or a (steps, B, h, w, 4)
    tensor) when given, else from `generator`.

    inpaint_latent (B, h, w, 4) + inpaint_mask (B, h, w, 1; 1 = generate):
    blended-latent inpainting (Avrahami et al., arXiv:2206.02779). After
    every update the kept region (mask 0) is replaced by the original latent
    forward-diffused to the step's level with `inpaint_noise[i]` (else a
    draw from `generator`), and the final x_0 blends the clean original
    back in. Not together with encoder caching. encoder_cache_interval > 1:
    see `_ddim_loop_enc_cached`; in guess mode it is ignored, as in the JAX
    package. tome: token merging in both nets (ops/tome.py:ToMe, or None).

    control a tuple of N ControlNets (multi-ControlNet): hint and
    control_scales are tuples of N, one a net (a shared scale vector may
    stand for all); not with encoder caching.

    control=None (hint and control_scales None): the UNet alone, the loop of
    the ControlNet-free families (pipeline/concat_cond.py:sd_txt2img,
    models/sdxl.py:sdxl_txt2img), with y_cond / y_uncond (B, adm) the ADM
    vectors of an ADM-conditioned UNet, c_concat (B, h, w, in_channels - 4)
    the extra input channels of a concat-conditioned UNet (the 9-channel
    inpainting family: pipeline/concat_cond.py); no encoder caching there.
    """
    dtype = dtype or ctx_cond.dtype
    b = x_T.shape[0]
    inpaint = inpaint_latent is not None
    if inpaint and inpaint_mask is None:
        raise ValueError("inpaint_latent requires inpaint_mask")
    if control is None and encoder_cache_interval > 1:
        raise ValueError("encoder caching needs a ControlNet loop")
    if isinstance(control, tuple) and encoder_cache_interval > 1:
        raise ValueError("multi-ControlNet + encoder caching is unsupported")
    if inpaint and encoder_cache_interval > 1:
        raise ValueError("inpainting + encoder caching is unsupported "
                         "(the cached-step features would mix blended and "
                         "unblended latents)")
    hoisted = _hoist_context_kv(unet, control, hint, ctx_cond, ctx_uncond,
                                control_scales, guess_mode, dtype, y_cond, y_uncond,
                                c_concat)

    def drawn(given, i, like):
        return (given[i] if given is not None else
                torch.randn(like.shape, generator=generator, device=like.device))

    def step_noise(i, like):
        return drawn(noise, i, like) if schedule["sigmas"][i] > 0 else None

    x = x_T.to(dtype)
    if encoder_cache_interval > 1 and not guess_mode:
        return _ddim_loop_enc_cached(
            unet, control, schedule, x, hoisted, scale, step_noise, temperature,
            parameterization, encoder_cache_interval, cfg_rescale, tome).float()
    if inpaint:
        keep = 1.0 - inpaint_mask.to(x.device, torch.float32)
        mask = inpaint_mask.to(x.device, torch.float32)
        original = inpaint_latent.to(x.device, torch.float32)
    for i in range(len(schedule["timesteps"])):
        e_cond, e_uncond = _cfg_eval(unet, control, nchw(x),
                                     float(schedule["timesteps"][i]), hoisted,
                                     guess_mode, tome)
        e_t = _cfg_combine(e_cond, e_uncond, scale, cfg_rescale)
        x = ddim_update(x, nhwc(e_t), schedule, i, step_noise(i, x), temperature,
                        parameterization)
        if inpaint:
            a_prev = np.float32(schedule["alphas_prev"][i])
            noised = (float(np.sqrt(a_prev)) * original
                      + float(np.sqrt(np.float32(1.0) - a_prev))
                      * drawn(inpaint_noise, i, x).to(x.device, torch.float32))
            x = (mask * x.float() + keep * noised).to(x.dtype)
    if inpaint:
        x = (mask * x.float() + keep * original).to(x.dtype)
    return x.float()


def stochastic_encode(x0: torch.Tensor, alpha_cumprod_t: float,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Forward-diffuse x0 to the level alpha_cumprod_t
    (DDIMSampler.stochastic_encode, ddim_hacked.py:257-269): sqrt(a) x0 +
    sqrt(1 - a) noise in fp32, rounded to x0's dtype. noise (x0's shape) is
    drawn from `generator` and rounded to x0's dtype unless given."""
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator,
                            device=x0.device).to(x0.dtype)
    a = np.float32(alpha_cumprod_t)
    return (float(np.sqrt(a)) * x0.float()
            + float(np.sqrt(np.float32(1.0) - a))
            * noise.to(x0.device, torch.float32)).to(x0.dtype)


def stochastic_tail_entry(
    schedule: Dict[str, np.ndarray],
    t_enc: int,
    z0: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Dict[str, np.ndarray], torch.Tensor]:
    """img2img / hires-refine entry (the JAX package's ddim.py
    stochastic_tail_entry): the LAST t_enc entries of a DDIM schedule
    (sampling order), and z0 forward-diffused to the entry step's level,
    x_T = sqrt(a0) z0 + sqrt(1 - a0) noise in fp32, rounded to z0's dtype.
    noise (z0's shape) is drawn from `generator`, in fp32, unless given."""
    tail = schedule_tail(schedule, t_enc)
    if noise is None:
        noise = torch.randn(z0.shape, generator=generator, device=z0.device)
    return tail, stochastic_encode(z0, tail["alphas"][0], noise)


def schedule_tail(schedule: Dict[str, np.ndarray], t_enc: int) -> Dict[str, np.ndarray]:
    """The last t_enc entries of a DDIM schedule (sampling order)."""
    n = len(schedule["timesteps"])
    if not 0 < t_enc <= n:
        raise ValueError(f"t_enc must be in (0, {n}], got {t_enc}")
    return {k: np.asarray(v)[n - t_enc:] for k, v in schedule.items()}


class DDIMSampler:
    """The loop on given networks, without a runtime (the JAX package's
    DDIMSampler, its eager and debugging path): holds the DDPM schedule,
    assembles the loop's inputs and runs `ddim_sample`. Random numbers come
    from a torch.Generator or are handed in."""

    def __init__(self, pipeline_cfg: PipelineConfig, unet: UNetModel,
                 control: ControlNet):
        self.cfg = pipeline_cfg
        self.unet = unet
        self.control = control
        d = pipeline_cfg.diffusion
        self.schedule = DiffusionSchedule(d.timesteps, d.linear_start,
                                          d.linear_end, d.schedule)
        self.n_taps = len(encoder_plan(pipeline_cfg.unet)) + 1
        self.dtype = (torch.bfloat16 if pipeline_cfg.dtype == "bfloat16"
                      else torch.float32)

    def control_scales(self, strength: float, guess_mode: bool) -> np.ndarray:
        """[strength] * 13, or the guess-mode decay."""
        if guess_mode:
            return np.asarray(guess_mode_scales(strength, self.n_taps), np.float32)
        return np.full((self.n_taps,), strength, np.float32)

    def _run(self, sched, x, hint, ctx_cond, ctx_uncond, guidance_scale,
             strength, guess_mode, temperature, generator, noise):
        return ddim_sample(
            self.unet, self.control, sched, x.to(self.dtype),
            hint.to(self.dtype), ctx_cond.to(self.dtype),
            ctx_uncond.to(self.dtype), float(guidance_scale),
            [float(s) for s in self.control_scales(strength, guess_mode)],
            guess_mode=guess_mode, temperature=temperature,
            generator=generator, noise=noise, dtype=self.dtype,
            parameterization=self.cfg.diffusion.parameterization)

    @torch.no_grad()
    def sample(self, num_steps: int, shape: Tuple[int, int, int, int],
               hint: torch.Tensor, ctx_cond: torch.Tensor,
               ctx_uncond: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               guidance_scale: float = 9.0, eta: float = 0.0,
               strength: float = 1.0, guess_mode: bool = False,
               x_T: Optional[torch.Tensor] = None, temperature: float = 1.0,
               noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """x_T (NHWC, `shape`) is drawn from `generator` unless given; with
        eta > 0 the step noise is `noise` or further draws."""
        sched = self.schedule.ddim(num_steps, eta=eta)
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=hint.device)
        return self._run(sched, x_T, hint, ctx_cond, ctx_uncond, guidance_scale,
                         strength, guess_mode, temperature, generator, noise)

    @torch.no_grad()
    def img2img(self, init_latent: torch.Tensor, denoise_strength: float,
                num_steps: int, hint: torch.Tensor, ctx_cond: torch.Tensor,
                ctx_uncond: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                guidance_scale: float = 9.0, eta: float = 0.0,
                strength: float = 1.0, guess_mode: bool = False,
                renoise: Optional[torch.Tensor] = None,
                noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """stochastic_encode to step t_enc = round(denoise_strength *
        num_steps) (at least 1), then the remaining steps of the schedule
        (DDIMSampler.encode/decode, ddim_hacked.py:233-317). renoise: the
        forward-diffusion noise, drawn from `generator` unless given."""
        sched = self.schedule.ddim(num_steps, eta=eta)
        t_enc = max(1, min(num_steps, int(round(denoise_strength * num_steps))))
        tail = schedule_tail(sched, t_enc)
        x_t = stochastic_encode(init_latent, float(tail["alphas"][0]), renoise,
                                generator)
        return self._run(tail, x_t, hint, ctx_cond, ctx_uncond, guidance_scale,
                         strength, guess_mode, 1.0, generator, noise)
