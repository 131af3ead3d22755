"""The training loop: ControlNet fine-tuning on one card (counterpart of
stablediffusioneo_tpu/training/loop.py).

The reference delegates its loop to pytorch-lightning; the JAX package
iterates one jitted train_step (training/trainer.py) over a device mesh
host-side, with EMA, periodic checkpoints (orbax) and the ImageLogger /
MetricsLogger hooks. The port runs the same loop on one card: `train()`
takes the JAX package's arguments, and the mesh arguments other than one
device (dp, tp > 1, fsdp) raise: multi-card training is ROADMAP queue 1
item 10.

Checkpoints are the counterpart of the JAX package's orbax ones, not their
format: one `torch.save` file of the trainable fp32 tensors, both AdamW
moments (the optimizer's state dict) and the step, read back with
`torch.load(weights_only=True)`, so that a resumed run continues exactly.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Iterator, Optional

import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.config import PipelineConfig
from stablediffusioneo_tpu_torch.training.ema import ema_init, ema_update
from stablediffusioneo_tpu_torch.training.logger import ImageLogger, MetricsLogger
from stablediffusioneo_tpu_torch.training.lora import leaves, tree_map
from stablediffusioneo_tpu_torch.training.trainer import (
    TrainState,
    create_train_state,
    frozen,
    make_schedule_buffers,
    train_step,
)


def save_checkpoint(path: str, state: TrainState) -> None:
    """The full train state, params AND optimizer moments, in one file (the
    torch .pth save of export_onnx_all.py:173-181 and mmcv's
    runner/checkpoint.py)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"params": tree_map(torch.Tensor.detach, state.params),
                "opt_state": state.opt_state.state_dict(),
                "step": int(state.step)}, path)


def restore_checkpoint(path: str, like_state: TrainState) -> TrainState:
    """`like_state` (a fresh state of the same run: same network, same
    parameters or adapter sites) with the file's params, moments and step
    written into it; the file's tensors must match its tensors in number
    and shape."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    got, want = list(leaves(saved["params"])), list(leaves(like_state.params))
    if [tuple(t.shape) for t in got] != [tuple(t.shape) for t in want]:
        raise ValueError(f"{path}: its {len(got)} params do not match the state's "
                         f"{len(want)} in order and shape")
    with torch.no_grad():
        for dst, src in zip(want, got):
            dst.copy_(src)
    like_state.opt_state.load_state_dict(saved["opt_state"])
    like_state.step = int(saved["step"])
    return like_state


def train(
    cfg: PipelineConfig,
    unet: nn.Module,
    controlnet: nn.Module,
    data_iter: Iterator[Dict],
    num_steps: int,
    learning_rate: float = 1e-5,
    dp: Optional[int] = None,
    tp: int = 1,
    seed: int = 0,
    ema_decay: Optional[float] = 0.9999,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 1000,
    image_logger: Optional[ImageLogger] = None,
    metrics_path: Optional[str] = "train_metrics.jsonl",
    lora_rank: Optional[int] = None,
    lora_scale: float = 1.0,
    fsdp: bool = False,
    device="cuda",
) -> TrainState:
    """Run `num_steps` of ControlNet fine-tuning on `device`. data_iter
    yields {x0: (B,h,w,4), hint: (B,H,W,3), ctx: (B,T,768)} batches (numpy
    arrays or tensors; each is put on the device). The networks are not
    changed: the trainable fp32 tensors live in the returned state's params
    ({name: tensor}; load them with `controlnet.load_state_dict(state.params)`)
    and its EMA, where ema_decay is set, in `state.ema` (the shadow tree).

    lora_rank: train rank-r LoRA adapters on the (frozen) ControlNet
    branch instead of the full branch (training/lora.py); the returned
    state's params are the adapter tree: `merge_lora` / `save_lora` it.
    dp, tp, fsdp: the JAX package's mesh; one device is all the port trains
    on (dp None or 1, tp 1, fsdp False), the rest raises."""
    if dp not in (None, 1) or tp != 1 or fsdp:
        raise NotImplementedError(
            f"train(dp={dp}, tp={tp}, fsdp={fsdp}): the port trains on one device; "
            "multi-card training (data, tensor and FSDP parallelism) is ROADMAP "
            "queue 1 item 10")
    device = torch.device(device)
    unet = frozen(unet, cfg.dtype, device)
    sqrt_a, sqrt_1ma = make_schedule_buffers(cfg, device)
    if lora_rank:
        from stablediffusioneo_tpu_torch.training.lora import init_lora, lora_train_step

        base = frozen(controlnet, torch.float32, device)
        lora = init_lora(torch.Generator(device=device).manual_seed(seed + 1), base,
                         rank=lora_rank)
        state, tx = create_train_state(base, learning_rate, params=lora)
        step_fn = functools.partial(lora_train_step, tx=tx, cfg=cfg,
                                    frozen={"unet": unet, "controlnet": base},
                                    on="controlnet", scale=lora_scale)
    else:
        state, tx = create_train_state(controlnet, learning_rate, device=device)
        step_fn = functools.partial(train_step, tx=tx, cfg=cfg, unet=unet)
    ema_state = ema_init(state.params) if ema_decay else None
    metrics = MetricsLogger(metrics_path) if metrics_path else None

    for step in range(num_steps):
        host_batch = next(data_iter)
        batch = {k: torch.as_tensor(v, device=device) for k, v in host_batch.items()}
        state, loss = step_fn(state, sqrt_abar=sqrt_a, sqrt_one_minus_abar=sqrt_1ma,
                              batch=batch, key=seed)
        if ema_state is not None:
            ema_state = ema_update(ema_state, state.params, ema_decay)
        if metrics:
            metrics.log(step, loss=float(loss))
        if image_logger:
            image_logger.on_step(step)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(os.path.join(ckpt_dir, f"step_{step + 1:09d}.pt"), state)
    state.ema = None if ema_state is None else ema_state[0]
    return state
