"""ControlNet fine-tuning: diffusion loss and AdamW train step (counterpart of
stablediffusioneo_tpu/training/trainer.py).

The reference trains the ControlNet branch with AdamW (cldm/cldm.py:416-423)
on the DDPM eps-prediction MSE (ldm.models.diffusion.ddpm `p_losses`,
parameterization "eps", l_simple weight 1):

    x_t  = sqrt(abar_t) x_0 + sqrt(1-abar_t) eps,   eps ~ N(0,1)
    loss = mean || eps_hat(x_t, t, ctx, hint) - eps ||^2

As in the JAX package: the trainable weights are fp32 masters, and the
forward and backward run in cfg.dtype. The cast sits inside the
differentiated function (`torch.func.functional_call` with the masters cast
to cfg.dtype in the ControlNet's parameters' places), so each gradient comes
back to its master in fp32. The frozen UNet rides along as a network that
requires no grad; `frozen` casts it to cfg.dtype once, outside the step (a
cast that is not differentiated gives the same numbers inside or outside).
The optimiser is optax's `adamw(lr, weight_decay=0.01)`: torch.optim.AdamW
with b1 0.9, b2 0.999, eps 1e-8 and decay on every parameter. Batches are
NHWC tensors, as the JAX contract has them; a uint8 hint is divided by 255
on the device. `t ~ randint(0, T)` and `noise ~ N(0, 1)` come from a
torch.Generator seeded from (key, step), the counterpart of `fold_in(key,
step)`: a resumed run draws what an uninterrupted one draws (the draws are
not JAX's bits; the parity tests hand the JAX draws in through `t=` and
`noise=`).

Unlike the JAX step, which returns a new state, the port's step updates the
state's tensors in place (the optimiser's way) and returns the same state.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.config import PipelineConfig
from stablediffusioneo_tpu_torch.models.controlnet import controlled_unet_apply
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.training.lora import leaves


@dataclasses.dataclass
class TrainState:
    """Trainable fp32 tensors + AdamW + step counter.

    params: the trainable tensors, {name: tensor} by the ControlNet's
    parameter names (or, for LoRA, the adapter tree, training/lora.py);
    opt_state: the torch.optim.AdamW over them, which holds both moments;
    step: the steps taken; net: the network whose parameters `params` take
    the place of (for LoRA, the network the adapters merge into); ema: the
    EMA shadow of params that training/loop.py:train kept, else None."""

    params: Dict
    opt_state: torch.optim.AdamW
    step: int
    net: nn.Module
    ema: Optional[Dict] = None


def create_train_state(
    net: nn.Module,
    learning_rate: float = 1e-5,
    weight_decay: float = 0.01,
    params: Optional[Dict] = None,
    device=None,
) -> Tuple[TrainState, torch.optim.AdamW]:
    """The state of a fine-tuning run of `net`: fp32 copies of its
    parameters on `device` (default: the net's) that require grad (the
    network itself is not changed), or the given `params` tree (LoRA
    adapters), and an AdamW over them. Returns (state, tx) as the JAX
    function does; tx is state.opt_state."""
    if params is None:
        params = {n: p.detach().to(device, torch.float32, copy=True)
                  for n, p in net.named_parameters()}
    for p in leaves(params):
        p.requires_grad_(True)
    tx = torch.optim.AdamW(list(leaves(params)), lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=weight_decay)
    return TrainState(params=params, opt_state=tx, step=0, net=net), tx


def frozen(net: nn.Module, dtype, device=None) -> nn.Module:
    """`net` with every tensor in `dtype` on `device` (default: where it is)
    and no grad: itself where it is so already, else a copy (the caller's
    network is not changed)."""
    dtype = _dtype(dtype)
    device = torch.device(device) if device is not None else None
    if all(p.dtype == dtype and not p.requires_grad
           and (device is None or p.device == device) for p in net.parameters()):
        return net
    return copy.deepcopy(net).to(device=device, dtype=dtype).requires_grad_(False)


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class _Pair(nn.Module):
    """The UNet and the ControlNet under one module, so that one
    torch.func.functional_call hands both their tensors by name."""

    def __init__(self, unet: nn.Module, control: nn.Module):
        super().__init__()
        self.unet = unet
        self.control = control

    def forward(self, x, hint, t, ctx):
        return controlled_unet_apply(self.unet, self.control, x, hint, t, ctx)


def _cast(net: nn.Module, params: Optional[Dict], dtype: torch.dtype, prefix: str) -> Dict:
    """{prefix + name: tensor in dtype} for every parameter of `net`: the
    given tensor where `params` has one, else the net's own (a tensor
    already in dtype is passed as it is)."""
    params = params or {}
    return {prefix + n: params.get(n, p).to(dtype) for n, p in net.named_parameters()}


def diffusion_loss(
    controlnet: nn.Module,
    unet: nn.Module,
    cfg: PipelineConfig,
    sqrt_abar: torch.Tensor,          # (T,) precomputed schedule buffers
    sqrt_one_minus_abar: torch.Tensor,
    x0: torch.Tensor,                 # (B, h, w, 4) clean latents
    hint: torch.Tensor,               # (B, H, W, 3)
    ctx: torch.Tensor,                # (B, T, C)
    t: torch.Tensor,                  # (B,) int timesteps
    noise: torch.Tensor,              # (B, h, w, 4)
    controlnet_params: Optional[Dict] = None,
    unet_params: Optional[Dict] = None,
) -> torch.Tensor:
    """The eps-prediction MSE of the ControlNet-controlled UNet (the JAX
    `diffusion_loss`). controlnet_params / unet_params: {parameter name:
    tensor} taking the place of the networks' own parameters in this call
    (the fp32 masters, or weights with LoRA merged in); every one, given or
    the network's own, is cast to cfg.dtype inside the differentiated
    function, as are x_t, the hint and the context."""
    a = sqrt_abar[t][:, None, None, None]
    s = sqrt_one_minus_abar[t][:, None, None, None]
    x_t = a * x0 + s * noise  # noising at input precision
    dt = _dtype(cfg.dtype)
    tensors = {**_cast(unet, unet_params, dt, "unet."),
               **_cast(controlnet, controlnet_params, dt, "control.")}
    eps_hat = torch.func.functional_call(
        _Pair(unet, controlnet), tensors,
        (x_t.to(dt), hint.to(dt), t.float(), ctx.to(dt)))
    return torch.mean(torch.square(eps_hat.float() - noise.float()))


def fold_in(key: int, step: int) -> int:
    """The seed of step `step` of a run seeded `key` (the counterpart of
    jax.random.fold_in): a function of both, the same in every run."""
    return int(np.random.SeedSequence([int(key), int(step)]).generate_state(1, np.uint64)[0])


def step_draws(key: int, step: int, x0: torch.Tensor, timesteps: int):
    """(t, noise) of one step: t (B,) ~ randint(0, timesteps), noise ~ N(0, 1)
    in x0's shape, drawn in fp32 and rounded to x0's dtype, from a generator
    on x0's device seeded by fold_in(key, step)."""
    g = torch.Generator(device=x0.device).manual_seed(fold_in(key, step))
    t = torch.randint(0, timesteps, (x0.shape[0],), generator=g, device=x0.device)
    noise = torch.randn(x0.shape, generator=g, device=x0.device, dtype=torch.float32)
    return t, noise.to(x0.dtype)


def prepare_batch(batch: Dict) -> Dict[str, torch.Tensor]:
    """{x0, hint, ctx} as tensors where x0 is, the uint8 hint divided by 255
    there and put in x0's dtype, as the JAX step normalises it in-graph."""
    x0 = torch.as_tensor(batch["x0"])
    out = {k: torch.as_tensor(batch[k], device=x0.device) for k in ("hint", "ctx")}
    out["x0"] = x0
    if out["hint"].dtype == torch.uint8:
        out["hint"] = (out["hint"].float() / 255.0).to(x0.dtype)
    return out


def apply_gradients(state: TrainState, loss: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
    """Backward of `loss` into the state's tensors, one AdamW step, step+1."""
    state.opt_state.zero_grad(set_to_none=True)
    loss.backward()
    state.opt_state.step()
    state.step += 1
    return state, loss.detach()


def train_step(
    state: TrainState,
    tx: torch.optim.AdamW,
    unet: nn.Module,
    cfg: PipelineConfig,
    sqrt_abar: torch.Tensor,
    sqrt_one_minus_abar: torch.Tensor,
    batch: Dict,
    key: int,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[TrainState, torch.Tensor]:
    """One AdamW step on the ControlNet branch. batch: {x0, hint, ctx}
    (NHWC; a uint8 hint is normalised on the device). key: the run's seed;
    t / noise: the step's draws, to hand in instead of drawing them
    (`step_draws(key, state.step, ...)`). tx is state.opt_state (an
    argument for the JAX signature). Returns (state, loss), the loss
    before the update, as a tensor on the device."""
    del tx
    batch = prepare_batch(batch)
    if t is None or noise is None:
        t, noise = step_draws(key, state.step, batch["x0"], cfg.diffusion.timesteps)
    loss = diffusion_loss(
        state.net, unet, cfg, sqrt_abar, sqrt_one_minus_abar,
        batch["x0"], batch["hint"], batch["ctx"], t, noise,
        controlnet_params=state.params)
    return apply_gradients(state, loss)


def make_schedule_buffers(cfg: PipelineConfig, device="cuda"):
    """(sqrt(abar), sqrt(1 - abar)), fp32 (T,) tensors on `device`."""
    d = cfg.diffusion
    sched = DiffusionSchedule(d.timesteps, d.linear_start, d.linear_end, d.schedule)
    ac = sched.alphas_cumprod
    return tuple(torch.from_numpy(np.asarray(v, np.float32)).to(device)
                 for v in (np.sqrt(ac), np.sqrt(1.0 - ac)))
