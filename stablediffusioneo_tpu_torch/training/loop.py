"""The training loop: ControlNet fine-tuning (counterpart of
stablediffusioneo_tpu/training/loop.py).

The reference delegates its loop to pytorch-lightning; the JAX package
iterates one jitted train_step (training/trainer.py) over a device mesh
host-side, with EMA, periodic checkpoints (orbax) and the ImageLogger /
MetricsLogger hooks. The port runs the same loop: `train()` takes the JAX
package's arguments, on one device, or, with an initialised
torch.distributed process group, on a mesh of its ranks (dp, tp, fsdp:
parallel/mesh.py; every rank calls train() with the same arguments and the
same global batches, and training/trainer.py says how a step is split).

Checkpoints are the counterpart of the JAX package's orbax ones, not their
format: one `torch.save` file of the trainable fp32 tensors, both AdamW
moments (the optimizer's state dict) and the step, read back with
`torch.load(weights_only=True)`, so that a resumed run continues exactly. A
run on a mesh writes the whole tensors (its tp and FSDP slices gathered),
from the mesh's first rank, so a file restores into a state of any layout.
"""

from __future__ import annotations

import copy
import functools
import os
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from stablediffusioneo_tpu_torch.config import PipelineConfig
from stablediffusioneo_tpu_torch.training.ema import ema_init, ema_update
from stablediffusioneo_tpu_torch.training.logger import ImageLogger, MetricsLogger
from stablediffusioneo_tpu_torch.training.lora import leaves, tree_map
from stablediffusioneo_tpu_torch.training.trainer import (
    TrainState,
    create_train_state,
    frozen,
    fsdp_frozen,
    make_schedule_buffers,
    train_step,
)


def _layouts(state: TrainState) -> List[Tuple]:
    """[(name, TP spec or None, FSDP dim or None)] of the state's params in
    order (a LoRA tree's factors are whole)."""
    from stablediffusioneo_tpu_torch.parallel.mesh import fsdp_dim

    tp = getattr(state.net, "tp_specs", None) or {}
    specs = state.fsdp_specs or {}
    if not isinstance(state.params, dict) or not (tp or specs):
        return [("", None, None)] * len(list(leaves(state.params)))
    return [(n, tp.get(n), fsdp_dim(specs.get(n, ()))) for n in state.params]


def _unshard(state: TrainState, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    from stablediffusioneo_tpu_torch.parallel.mesh import all_gather, tp_whole

    out = []
    for t, (name, tp, fd) in zip(tensors, _layouts(state)):
        if fd is not None:
            t = all_gather(t, state.mesh.axis("dp"), fd)
        if tp is not None:
            t = tp_whole(t, name, tp, state.mesh.axis("tp"))
        out.append(t)
    return out


def _reshard(state: TrainState, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    from stablediffusioneo_tpu_torch.parallel.mesh import local_slice, tp_local

    out = []
    for t, (name, tp, fd) in zip(tensors, _layouts(state)):
        if tp is not None:
            t = tp_local(t, name, tp, state.mesh.axis("tp"))
        if fd is not None:
            t = local_slice(t, state.mesh.axis("dp"), fd)
        out.append(t)
    return out


def _moments(opt_state: Dict, n: int) -> List[Tuple[int, str]]:
    """(param index, key) of every moment tensor of an AdamW state dict."""
    return [(i, k) for i in range(n) for k in ("exp_avg", "exp_avg_sq")
            if i in opt_state["state"]]


def save_checkpoint(path: str, state: TrainState) -> None:
    """The full train state, params AND optimizer moments, in one file (the
    torch .pth save of export_onnx_all.py:173-181 and mmcv's
    runner/checkpoint.py). On a mesh every rank calls it; the slices are
    gathered and the mesh's first rank writes the whole tensors."""
    params = tree_map(torch.Tensor.detach, state.params)
    opt = state.opt_state.state_dict()
    if state.mesh is not None:
        n = len(list(leaves(params)))
        if any(lay != ("", None, None) for lay in _layouts(state)):  # a flat {name: tensor}
            params = dict(zip(params, _unshard(state, list(params.values()))))
        for key in ("exp_avg", "exp_avg_sq"):
            idx = [i for i, k in _moments(opt, n) if k == key]
            got = _unshard(state, [opt["state"][i][key] for i in idx])
            for i, t in zip(idx, got):
                opt["state"][i][key] = t
        if state.mesh.rank != state.mesh.ranks[0]:
            return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"params": params, "opt_state": opt, "step": int(state.step)}, path)


def restore_checkpoint(path: str, like_state: TrainState) -> TrainState:
    """`like_state` (a fresh state of the same run: same network, same
    parameters or adapter sites) with the file's params, moments and step
    written into it; the file's tensors must match its tensors in number
    and shape."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    got, want = list(leaves(saved["params"])), list(leaves(like_state.params))
    if like_state.mesh is not None:  # the file's whole tensors, cut to this rank's
        got = _reshard(like_state, got)
        opt = saved["opt_state"]
        for key in ("exp_avg", "exp_avg_sq"):
            idx = [i for i, k in _moments(opt, len(got)) if k == key]
            for i, t in zip(idx, _reshard(like_state, [opt["state"][i][key] for i in idx])):
                opt["state"][i][key] = t.clone()
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
    dp, tp, fsdp: the JAX package's mesh. With an initialised
    torch.distributed process group (or dp / tp > 1, or fsdp, which need
    one) every rank calls train() alike and the run is on
    parallel.make_mesh(dp=dp, tp=tp) of its ranks, each on the mesh's
    device: the networks tensor-parallel (`shard_params`, in copies), with
    fsdp=True both the ControlNet's masters and moments and the frozen
    UNet in FSDP slices; the state's params (and EMA) are then this rank's
    slices (save_checkpoint writes them whole). Without a process group:
    one device, `device`."""
    mesh = None
    if dist.is_initialized() or dp not in (None, 1) or tp != 1 or fsdp:
        from stablediffusioneo_tpu_torch.parallel.mesh import make_mesh, shard_params

        mesh = make_mesh(dp=dp, tp=tp)
        device = mesh.device
    device = torch.device(device)
    unet = frozen(unet, cfg.dtype, device)
    if mesh is not None:
        unet = shard_params(copy.deepcopy(unet), mesh)
        if fsdp:
            unet = fsdp_frozen(unet, mesh)
    sqrt_a, sqrt_1ma = make_schedule_buffers(cfg, device)
    if lora_rank:
        from stablediffusioneo_tpu_torch.training.lora import init_lora, lora_train_step

        base = frozen(controlnet, torch.float32, device)
        lora = init_lora(torch.Generator(device=device).manual_seed(seed + 1), base,
                         rank=lora_rank)
        if mesh is not None:
            base = shard_params(copy.deepcopy(base), mesh)
        state, tx = create_train_state(base, learning_rate, params=lora, mesh=mesh)
        step_fn = functools.partial(lora_train_step, tx=tx, cfg=cfg,
                                    frozen={"unet": unet, "controlnet": base},
                                    on="controlnet", scale=lora_scale)
    else:
        net = controlnet
        if mesh is not None:
            net = shard_params(copy.deepcopy(controlnet).to(device), mesh)
        state, tx = create_train_state(net, learning_rate, device=device, mesh=mesh,
                                       fsdp=fsdp)
        step_fn = functools.partial(train_step, tx=tx, cfg=cfg, unet=unet)
    ema_state = ema_init(state.params) if ema_decay else None
    lead = mesh is None or mesh.rank == mesh.ranks[0]  # the rank that logs
    metrics = MetricsLogger(metrics_path) if metrics_path and lead else None

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
