"""Pipeline parallelism, GPipe, over a `pp` mesh axis (counterpart of
stablediffusioneo_tpu/parallel/pipeline.py).

Where pp applies, as in the JAX package: homogeneous transformer stacks,
the CLIP / OpenCLIP text towers and the T5 encoder
(models/clip.py:clip_text_apply_pp, models/t5.py:t5_encode_pp), never the
UNet, whose skip connections would carry every encoder activation across
each stage cut.

The schedule is the JAX one: the local batch splits into M microbatches; at
tick t stage s runs microbatch t - s; an activation moves one hop a tick;
M + S - 1 ticks, bubble (S - 1) / (M + S - 1). The JAX package runs it as a
shard_map program with `ppermute`; the port runs one process a rank, and a
hop is a `send` on stage s at the end of tick t and a `recv` on stage s + 1
at the start of tick t + 1 (over gloo tagged by call and microbatch, staged
through pinned host memory for CUDA tensors; parallel/mesh.py). A stage's
layers run as a Python loop over its slice of the stacked parameters,
each layer `layer_fn(p, x, *batched_extra, *extra)` with p that layer's
{name: tensor}; a stage works only on ticks that hold one of its
microbatches.

Side inputs: `extra` reaches every layer call whole; `batched_extra`
entries carry x's batch dim and are microbatched with it, each stage
indexing ITS OWN microbatch t - s (not tick t's), the GPipe subtlety the
JAX package keeps.

Autograd: the sends and receives are autograd functions whose backward
sends the gradient one hop back, so `backward()` through `pipeline_apply`
on every rank is the GPipe backward; each stage's parameter gradients land
on its own rank. The last stage publishes its buffers to every pp peer (the
JAX psum), and the loss on the other ranks reaches their stages through
the send tokens. Under dp each replica's gradients are those of its batch
slice, to be summed over dp as any data-parallel step does.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from stablediffusioneo_tpu_torch.parallel.mesh import (
    Axis,
    Mesh,
    Sharding,
    all_gather,
    broadcast,
    local_slice,
)

_CALLS = itertools.count()
_PENDING: List[Any] = []  # (work, buffer) of sends in flight


def stack_layer_params(layers: Sequence) -> Dict[str, torch.Tensor]:
    """{name: (L, ...)}: identically named per-layer tensors (dicts, or
    modules, whose parameters are taken by name) stacked on a leading layer
    dim, the layout `pipeline_apply` cuts into stages."""
    dicts = [dict(m.named_parameters()) if isinstance(m, torch.nn.Module) else m
             for m in layers]
    return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}


def unstack_layer_params(stacked: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """The inverse of `stack_layer_params`."""
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


class StageParams(dict):
    """One stage's slice of stacked layer parameters ({name: (L / S, ...)}),
    as `pp_shard_params` leaves it on a rank: `n_layers` is the whole
    stack's L, `stage` the slice's stage."""

    n_layers: int
    stage: int


def pp_stage_sharding(mesh: Mesh, stacked: Dict[str, torch.Tensor],
                      axis: str = "pp") -> Dict[str, Sharding]:
    """{name: Sharding}: each leaf's leading layer dim over `axis`."""
    return {k: Sharding(mesh, (axis,) + (None,) * (v.dim() - 1))
            for k, v in stacked.items()}


def pp_shard_params(stacked: Dict[str, torch.Tensor], mesh: Mesh,
                    axis: str = "pp") -> StageParams:
    """This rank's stage of the stacked parameters, copied (the other
    stages' tensors can then be freed)."""
    ax = mesh.axis(axis)
    out = StageParams({k: local_slice(v, ax, 0).clone() for k, v in stacked.items()})
    out.n_layers = next(iter(stacked.values())).shape[0]
    out.stage = ax.index
    return out


def wait_pending() -> None:
    """Wait for every send in flight (the gradients a backward sent)."""
    while _PENDING:
        work, _ = _PENDING.pop()
        work.wait()


def _isend(x: torch.Tensor, ax: Axis, peer: int, tag: int) -> None:
    buf = x.detach().contiguous()
    if ax.mesh.backend == "gloo" and buf.is_cuda:
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf)
        buf = host
    _PENDING.append((dist.isend(buf, ax.ranks[peer], group=ax.group, tag=tag), buf))


def _recv(shape, dtype, device, ax: Axis, peer: int, tag: int) -> torch.Tensor:
    staged = ax.mesh.backend == "gloo" and torch.device(device).type == "cuda"
    buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
           else torch.empty(shape, dtype=dtype, device=device))
    dist.irecv(buf, ax.ranks[peer], group=ax.group, tag=tag).wait()
    return buf.to(device) if staged else buf


_GRAD = 1 << 20  # tag offset of a gradient's hop


class _Send(torch.autograd.Function):
    """Forward: send y to stage `peer`, return an empty token. Backward:
    receive y's gradient from `peer`."""

    @staticmethod
    def forward(ctx, y, ax, peer, tag):
        ctx.meta = (y.shape, y.dtype, y.device, ax, peer, tag + _GRAD)
        _isend(y, ax, peer, tag)
        return y.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device, ax, peer, tag = ctx.meta
        return _recv(shape, dtype, device, ax, peer, tag), None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive an activation from stage `peer` (`anchor`, an empty
    tensor that requires grad, puts the op in the graph). Backward: send its
    gradient back to `peer`."""

    @staticmethod
    def forward(ctx, anchor, ax, peer, tag, shape, dtype):
        ctx.meta = (ax, peer, tag + _GRAD)
        return _recv(shape, dtype, anchor.device, ax, peer, tag)

    @staticmethod
    def backward(ctx, g):
        ax, peer, tag = ctx.meta
        _isend(g, ax, peer, tag)
        return None, None, None, None, None, None


class _Attach(torch.autograd.Function):
    """The published output on a stage other than the last: its value is
    the last stage's; its backward hands the send tokens an (empty)
    gradient, which runs this stage's backward."""

    @staticmethod
    def forward(ctx, value, *tokens):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(g.new_zeros(0) for _ in ctx.needs_input_grad[1:])


class _GatherReplicated(torch.autograd.Function):
    """all-gather of the dp replicas' pieces of a result every rank then
    uses whole: backward takes this rank's piece of the gradient (the loss
    is the same on every rank, so nothing is summed)."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.ax, ctx.dim).contiguous(), None, None


def pipeline_apply(layer_fn: Callable, stacked_params, x: torch.Tensor, mesh: Mesh, *,
                   extra=(), batched_extra=(), axis: str = "pp",
                   microbatches: Optional[int] = None, batch_axis: Optional[str] = "dp",
                   capture_last_input: bool = False, remat: bool = False):
    """Run x through L stacked layers pipelined over the mesh's `axis`, on
    every rank of the mesh with the same arguments.

    layer_fn(p, x, *batched_extra, *extra) -> y, y.shape == x.shape (a
    residual block), p one layer's {name: tensor}. stacked_params: the
    whole stack ({name: (L, ...)}, `stack_layer_params`; a rank takes its
    stage's slice) or this rank's stage (`pp_shard_params`). L must tile
    the stage count S. x's batch additionally splits over `batch_axis` when
    the mesh has it and the batch tiles it (each dp replica runs its own
    pipeline); the local batch splits into `microbatches` (default
    min(S, local batch)), which must tile it.

    capture_last_input=True also returns the input of the globally last
    layer (CLIP's penultimate hidden state). remat=True runs each layer
    under torch.utils.checkpoint. Returns y (and that input), the whole
    batch on every rank (the last stage's buffers published over pp, the
    dp pieces gathered)."""
    wait_pending()
    ax = mesh.axis(axis)
    S, s = (ax.size, ax.index) if ax is not None else (1, 0)
    local = isinstance(stacked_params, StageParams)
    L = stacked_params.n_layers if local else next(iter(stacked_params.values())).shape[0]
    if L % S:
        raise ValueError(f"{L} layers do not tile {S} pipeline stages")
    bax = mesh.axis(batch_axis) if batch_axis else None
    dp = bax.size if bax is not None else 1
    b_total = int(x.shape[0])
    use_dp = dp > 1 and b_total % dp == 0
    b_local = b_total // dp if use_dp else b_total
    M = int(microbatches) if microbatches else min(S, b_local)
    if b_local % M:
        raise ValueError(f"local batch {b_local} does not tile {M} microbatches")
    for e in batched_extra:
        if int(e.shape[0]) != b_total:
            raise ValueError(f"batched_extra leading dim {e.shape[0]} != batch {b_total}")

    per = L // S
    if local:
        p_local = stacked_params
    else:
        p_local = {k: v.narrow(0, s * per, per) for k, v in stacked_params.items()}
    layers = [{k: v[i] for k, v in p_local.items()} for i in range(per)]
    if use_dp:
        x = local_slice(x, bax, 0)
        batched_extra = [local_slice(e, bax, 0) for e in batched_extra]
    f = ((lambda p, h, *a: checkpoint(layer_fn, p, h, *a, use_reentrant=False))
         if remat else layer_fn)
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p_local.values()))
    xm = x.chunk(M)
    exm = [e.chunk(M) for e in batched_extra]
    call = next(_CALLS) % 512
    outs: List = [None] * M
    pens: List = [None] * M
    tokens = []
    for t in range(M + S - 1):
        m = t - s  # this stage's microbatch at tick t
        if not 0 <= m < M:
            continue
        tag = call * 1024 + m
        if s == 0:
            h = xm[m]
        elif grad:
            anchor = torch.empty(0, device=x.device, requires_grad=True)
            h = _Recv.apply(anchor, ax, s - 1, tag, xm[m].shape, x.dtype)
        else:
            h = _recv(xm[m].shape, x.dtype, x.device, ax, s - 1, tag)
        bex = [e[m] for e in exm]
        pen = h
        for i, p in enumerate(layers):
            if i == per - 1:
                pen = h
            h = f(p, h, *bex, *extra)
        if s < S - 1:
            if grad:
                tokens.append(_Send.apply(h, ax, s + 1, tag))
            else:
                _isend(h, ax, s + 1, tag)
        else:
            outs[m], pens[m] = h, pen

    results = [outs, pens] if capture_last_input else [outs]
    final = []
    for bufs in results:
        mine = torch.cat(bufs) if s == S - 1 else torch.empty_like(x)
        if S > 1:
            pub = broadcast(mine.detach(), ax, S - 1)
            if s == S - 1:
                y = mine
            elif grad:
                y = _Attach.apply(pub, *tokens)
            else:
                y = pub
        else:
            y = mine
        if use_dp:
            y = _GatherReplicated.apply(y, bax, 0) if grad else all_gather(y, bax, 0)
        final.append(y)
    if not grad:
        wait_pending()
    return (final[0], final[1]) if capture_last_input else final[0]
