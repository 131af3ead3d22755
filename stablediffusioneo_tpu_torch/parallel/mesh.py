"""The mesh, its collectives and the sharding rules (counterpart of
stablediffusioneo_tpu/parallel/mesh.py).

The JAX package is one controller: it annotates shardings on a
`jax.sharding.Mesh` and GSPMD inserts every collective. The port is SPMD
over processes: one process a rank, every rank running the same calls on
its own part of the work, and every collective written out. They are all in
this file, each beside the JAX line whose GSPMD behaviour it replaces:

  dp  batch rows: a rank runs its slice of the batch (`data_sharding`);
      outputs are all-gathered, so every rank returns the whole batch.
  tp  Megatron tensor parallelism on the attention and MLP linears
      (`shard_params`): q/k/v, GEGLU ff1 and CLIP fc1 keep a rank's slice of
      their output features (column-parallel), wo/out, ff2 and fc2 its slice
      of their input features (row-parallel); one all-reduce a row-parallel
      projection sums the partial outputs and the bias is added once after
      it (`row_linear`), where GSPMD inserted a psum from the param specs.
      In training the Megatron pair of autograd functions carries the
      gradients (`copy_to`: identity forward, all-reduce backward, at a
      column-parallel input; `reduce_from`: the reverse, at a row-parallel
      output).
  sp  one image's rows (`latent_sharding`): convolutions exchange halos
      (`SpatialConv2d`, `halo_conv`), GroupNorm all-reduces its fp32
      moments (`sp_group_norm`; with the fused norms the stats kernel's
      partial sums, ops/norms.py), and self-attention keeps a rank's queries
      against K/V all-gathered over sp (ops/attention.py): what GSPMD's
      spatial partitioning and the partition-aware Pallas attention did.
  FSDP the ZeRO-3 rule of the JAX package (`fsdp_param_sharding_rules`): a
      large leaf keeps a 1/dp slice on one rank, all-gathered at use
      (`fsdp_gather`, whose backward is the reduce-scatter of the grads).
  pp  the GPipe schedule (parallel/pipeline.py), over `send` / `recv`.

Backends. NCCL with one rank a card; gloo for the CPU, and for ranks that
share one card (NCCL refuses two ranks on one device). With gloo and CUDA
tensors every helper stages its tensor through pinned host memory: that is
the transport of the mesh, chosen when it is built (`Mesh.transport`), not
a fallback taken on an error. Only NCCL collectives can be captured in a
CUDA graph (runtime/engine.py).

Axes of size 1 that the mesh holds (dp and tp always, as in the JAX mesh)
still run their collectives, so a mesh of one card runs the same code as
a mesh of many.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

FSDP_MIN_SIZE = 1 << 14


@dataclasses.dataclass(eq=False)
class Axis:
    """One named axis of the mesh as this rank sees it: its size, this
    rank's coordinate on it, the global ranks along it (in coordinate
    order) and their process group."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: object
    mesh: "Mesh"

    def __repr__(self) -> str:
        return f"Axis({self.name}, {self.index}/{self.size})"


class Mesh:
    """The port's counterpart of a `jax.sharding.Mesh`: `axis_names` and
    `shape` as the JAX mesh's, plus this rank's view of every axis
    (`axes`), the torch device it computes on and the transport of its
    collectives. Built by `make_mesh`."""

    def __init__(self, shape: Dict[str, int], ranks: Sequence[int],
                 device: torch.device, backend: str):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.ranks = tuple(int(r) for r in ranks)
        self.device = torch.device(device)
        self.backend = backend
        self.rank = dist.get_rank()
        self.transport = ("gloo, staged through pinned host memory"
                          if backend == "gloo" and self.device.type == "cuda"
                          else backend)
        self.axes: Dict[str, Axis] = {}
        grid = np.asarray(self.ranks).reshape(tuple(shape.values()))
        member = self.rank in self.ranks
        self.coords = (dict(zip(self.axis_names, np.argwhere(grid == self.rank)[0]))
                       if member else None)
        # every rank creates every group, in the same order (new_group is
        # collective over the world)
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if member and self.rank in line:
                    self.axes[name] = Axis(name, int(grid.shape[i]),
                                           int(list(line).index(self.rank)),
                                           tuple(int(r) for r in line), g, self)
        # object broadcasts (a server's batch cuts) go over gloo, whatever
        # the tensors' backend
        self.control = (dist.new_group(list(self.ranks), backend="gloo")
                        if backend != "gloo" else dist.new_group(list(self.ranks)))
        if not member:
            raise ValueError(f"rank {self.rank} is not in the mesh's ranks "
                             f"{self.ranks}")

    def axis(self, name: str) -> Optional[Axis]:
        return self.axes.get(name)

    def size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({dims}; rank {self.rank}, {self.device}, {self.transport})"


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence[int]] = None, sp: int = 1, pp: int = 1,
              device=None) -> Mesh:
    """A (dp, tp) / (dp, sp, tp) / (pp, dp[, sp], tp) mesh over the ranks of
    the initialised default process group (`devices`: the global ranks to
    lay out, default all). dp=None takes the ranks left. Size-1 axes other
    than dp and tp are dropped, and pp is outermost, tp innermost, as in
    the JAX make_mesh (collective cost order). device: this rank's torch
    device (default: over NCCL the card of index rank mod cards; over gloo
    with CUDA the card 0, the ranks sharing it; else the CPU). Every rank
    of the world must call it, with the same arguments; a rank outside the
    mesh's ranks gets ValueError after the groups are made."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    ranks = list(devices if devices is not None else range(dist.get_world_size()))
    n = len(ranks)
    if dp is None:
        if n % (tp * sp * pp):
            raise ValueError(f"{n} ranks not divisible by tp={tp}*sp={sp}*pp={pp}")
        dp = n // (tp * sp * pp)
    if pp * dp * sp * tp > n:
        raise ValueError(f"mesh {pp}x{dp}x{sp}x{tp} > {n} ranks")
    dims = [("pp", pp), ("dp", dp), ("sp", sp), ("tp", tp)]
    keep = {name: int(size) for name, size in dims if size > 1 or name in ("dp", "tp")}
    backend = dist.get_backend()
    if device is None:
        if torch.cuda.is_available() and backend == "nccl":
            device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        elif torch.cuda.is_available():
            device = torch.device("cuda", 0)
        else:
            device = torch.device("cpu")
    return Mesh(keep, ranks[: int(np.prod(list(keep.values())))], device, backend)


# ------------------------------------------------------------ collectives


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (the gloo transport's buffer)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of x over the axis, a new tensor on x's device."""
    if _staged(axis.mesh, x):
        h = _host(x)
        dist.all_reduce(h, group=axis.group)
        return h.to(x.device, non_blocking=False)
    out = x.clone()
    dist.all_reduce(out, group=axis.group)
    return out


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The axis's pieces of x concatenated on `dim` in coordinate order."""
    x = x.contiguous()
    if _staged(axis.mesh, x):
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(axis.size)]
        dist.all_gather(parts, h, group=axis.group)
        return torch.cat(parts, dim=dim).to(x.device)
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """x of the rank at coordinate `src` on every rank of the axis."""
    x = x.contiguous()
    if _staged(axis.mesh, x):
        h = _host(x)
        dist.broadcast(h, axis.ranks[src], group=axis.group)
        return h.to(x.device)
    out = x.clone()
    dist.broadcast(out, axis.ranks[src], group=axis.group)
    return out


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """A picklable object of mesh rank `src` (index into mesh.ranks) on
    every rank of the mesh, over the gloo control group."""
    box = [obj if mesh.rank == mesh.ranks[src] else None]
    dist.broadcast_object_list(box, src=mesh.ranks[src], group=mesh.control)
    return box[0]


def local_slice(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's equal piece of x on `dim` (a view)."""
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _GatherFrom(torch.autograd.Function):
    """all-gather on `dim` forward; backward: the sum of the ranks' grads
    of this rank's piece (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(all_reduce(g, ctx.axis), ctx.axis, ctx.dim).contiguous(), None, None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over the axis; under autograd the gradient passes as it is."""
    return _ReduceFrom.apply(x, axis) if _grad(x) else all_reduce(x, axis)


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """x as it is; under autograd its gradient is summed over the axis (the
    input of a column-parallel linear)."""
    if axis is None or not _grad(x):
        return x
    return _CopyTo.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, axis, dim) if _grad(x) else all_gather(x, axis, dim)


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               axis: Optional[Axis]) -> torch.Tensor:
    """A row-parallel linear: x holds this rank's slice of the input
    features and weight its columns of them; the partial products are
    summed by one all-reduce and the bias is added once, after it (the psum
    GSPMD inserted for a P("tp", None) weight). axis None: the plain
    linear."""
    w = weight.to(x.dtype)
    if axis is None:
        return F.linear(x, w, None if bias is None else bias.to(x.dtype))
    y = reduce_from(F.linear(x, w), axis)
    return y if bias is None else y + bias.to(y.dtype)


# ------------------------------------------------------------- shardings


class Sharding:
    """What a JAX NamedSharding of a batch or latent input says, as the two
    things the port does with it: take this rank's part of a global tensor
    (`local`) and gather the parts back (`gather`). spec: the JAX
    PartitionSpec's entries, an axis name or None a dim."""

    def __init__(self, mesh: Mesh, spec: Tuple[Optional[str], ...]):
        self.mesh = mesh
        self.spec = tuple(spec)

    def _dims(self, x):
        return [(d, self.mesh.axis(name)) for d, name in enumerate(self.spec)
                if name is not None and d < x.dim() and self.mesh.axis(name)]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        for d, ax in self._dims(x):
            if x.shape[d] % ax.size:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not tile "
                                 f"{ax.name}={ax.size}")
            x = local_slice(x, ax, d)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        for d, ax in reversed(self._dims(x)):
            x = all_gather(x, ax, d)
        return x

    def __repr__(self) -> str:
        return f"Sharding{self.spec}"


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def data_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """The leading (batch) dim over dp, the rest whole."""
    return Sharding(mesh, ("dp",) + (None,) * (ndim - 1))


def latent_sharding(mesh: Mesh, ndim: int = 4) -> Sharding:
    """An NHWC latent or image: batch over dp, H over sp where the mesh has
    sp (ndim < 2: dp only)."""
    if "sp" not in mesh.shape or ndim < 2:
        return data_sharding(mesh, ndim)
    return Sharding(mesh, ("dp", "sp") + (None,) * (ndim - 2))


# ---------------------------------------------------------- spatial (sp)

_local = threading.local()


def spatial_axis() -> Optional[Axis]:
    """The sp axis the current call's NHWC tensors are split on by rows, or
    None (set by `spatial`, around a mesh engine's function)."""
    return getattr(_local, "sp", None)


@contextlib.contextmanager
def spatial(axis: Optional[Axis]):
    """Inside, the models' convolutions, GroupNorms and attentions treat
    their activations as this rank's rows of `axis` (None: whole rows)."""
    was = spatial_axis()
    _local.sp = axis
    try:
        yield
    finally:
        _local.sp = was


def halo_conv(conv: nn.Conv2d, x: torch.Tensor, axis: Axis,
              pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """conv over this rank's rows of an image split by rows over `axis`,
    with zero padding `pad` = (left, right, top, bottom) of the whole image
    and the conv's own padding 0. A rank takes `top` rows from the rank
    above and k - stride - top rows from the rank below (zeros at the
    image's edges), which gives it exactly its rows of the output (the
    halo exchange XLA's spatial partitioning inserted). One all-gather of
    every rank's edge rows."""
    k, s = conv.kernel_size[0], conv.stride[0]
    pt = pad[2]
    pb = k - s - pt
    h = x.shape[2]
    if h % s or pb < 0:
        raise ValueError(f"sp halo: {h} rows at stride {s}, kernel {k}, top pad {pt}")
    strip = torch.cat([x[:, :, :pb], x[:, :, h - pt:]], dim=2)
    parts = all_gather(strip, axis, 2).split(pb + pt, dim=2)
    r = axis.index
    zeros = x.new_zeros
    top = parts[r - 1][:, :, pb:] if r > 0 else zeros(x.shape[0], x.shape[1], pt, x.shape[3])
    bot = (parts[r + 1][:, :, :pb] if r < axis.size - 1
           else zeros(x.shape[0], x.shape[1], pb, x.shape[3]))
    xp = F.pad(torch.cat([top, x, bot], dim=2), (pad[0], pad[1], 0, 0))
    return F.conv2d(xp, conv.weight, conv.bias, conv.stride, 0, conv.dilation, conv.groups)


class SpatialConv2d(nn.Conv2d):
    """nn.Conv2d that, inside `spatial(axis)`, convolves this rank's rows
    with halos from its neighbours (`halo_conv`); outside, nn.Conv2d.
    `spatial_modules` turns a model's row-mixing convs into it in place
    (the state dict does not change)."""

    def forward(self, x):
        ax = spatial_axis()
        if ax is None or self.kernel_size[0] == 1:
            return super().forward(x)
        ph, pw = self.padding
        return halo_conv(self, x, ax, (pw, pw, ph, ph))


def spatial_modules(model: nn.Module) -> int:
    """Make every nn.Conv2d of `model` whose kernel mixes rows a
    SpatialConv2d; returns how many."""
    n = 0
    for m in model.modules():
        if type(m) is nn.Conv2d and m.kernel_size[0] > 1:
            m.__class__ = SpatialConv2d
            n += 1
    return n


def conv2d_padded(conv: nn.Conv2d, x: torch.Tensor,
                  pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """conv (padding 0) after an explicit zero pad (left, right, top,
    bottom), such as the VAE encoder's one-sided downsample pad; split by
    rows inside `spatial`."""
    ax = spatial_axis()
    if ax is None:
        return conv(F.pad(x, pad))
    return halo_conv(conv, x, ax, pad)


def sp_group_norm(x, weight, bias, groups: int, eps: float, swish: bool,
                  axis: Axis):
    """GroupNorm of NCHW x split by rows over `axis`: the fp32 moments
    (sum and sum of squares of every group) are all-reduced over sp, one
    collective a norm (the cross-shard reductions GSPMD inserted)."""
    n, c = x.shape[:2]
    g = x.float().reshape(n, groups, -1)
    sums = torch.stack([g.sum(-1), (g * g).sum(-1)])
    sums = reduce_from(sums, axis)
    count = g.shape[-1] * axis.size
    mean = sums[0] / count
    var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
    y = (g - mean[..., None]) * torch.rsqrt(var + eps)[..., None]
    y = y.reshape(x.shape) * weight.float().reshape(1, c, *([1] * (x.dim() - 2)))
    y = y + bias.float().reshape(1, c, *([1] * (x.dim() - 2)))
    if swish:
        y = F.silu(y)
    return y.to(x.dtype)


def sp_std(x: torch.Tensor, dims: Tuple[int, ...], axis: Axis) -> torch.Tensor:
    """The population standard deviation over `dims` of an NHWC tensor split
    by rows over `axis` (keepdim), fp32: one all-reduce of the sums."""
    x = x.float()
    s = torch.cat([x.sum(dims, keepdim=True), (x * x).sum(dims, keepdim=True)], dim=0)
    s = reduce_from(s, axis)
    b = x.shape[0]
    count = x[0].numel() * axis.size
    mean = s[:b] / count
    return torch.sqrt(torch.clamp(s[b:] / count - mean * mean, min=0.0))


# ------------------------------------------------------------- TP rules


def _linear(m) -> bool:
    return type(m) is nn.Linear


def _rows(t: torch.Tensor, r: int, tp: int, parts: int = 1) -> torch.Tensor:
    """This rank's slice of each of `parts` equal blocks of t's dim 0 (the
    GEGLU value and gate halves, OpenCLIP's packed q, k, v thirds),
    concatenated: a column-parallel weight or bias."""
    blocks = t.chunk(parts, dim=0)
    return torch.cat([b.chunk(tp, dim=0)[r] for b in blocks], dim=0).contiguous()


def _cols(t: torch.Tensor, r: int, tp: int) -> torch.Tensor:
    return t.chunk(tp, dim=1)[r].contiguous()


def tp_parts(name: str) -> int:
    """The blocks a column-parallel tensor of this name is cut in: GEGLU's
    ff1 [value; gate] 2, OpenCLIP's packed q, k, v 3, else 1."""
    if name.endswith(("net.0.proj.weight", "net.0.proj.bias")):
        return 2
    return 3 if name.endswith(("in_proj_weight", "in_proj_bias")) else 1


def tp_local(t: torch.Tensor, name: str, spec: Tuple, axis: Axis) -> torch.Tensor:
    """This rank's slice of a whole tensor under its TP spec (as
    `shard_params` cuts it)."""
    if spec[0] == "tp":
        return _rows(t, axis.index, axis.size, tp_parts(name))
    return _cols(t, axis.index, axis.size)


def tp_whole(t: torch.Tensor, name: str, spec: Tuple, axis: Axis) -> torch.Tensor:
    """The whole tensor from the ranks' slices: the inverse of `tp_local`."""
    d = spec.index("tp")
    parts = tp_parts(name) if d == 0 else 1
    pieces = all_gather(t, axis, d).chunk(axis.size, dim=d)
    blocks = [p.chunk(parts, dim=d) for p in pieces]
    return torch.cat([b[j] for j in range(parts) for b in blocks], dim=d)


def _tp_sites(model: nn.Module):
    """(prefix, module, kind) of every block the rules shard, by the port's
    modules (models/unet.py, models/clip.py): the UNet's (and ControlNet's,
    SDXL's) CrossAttention and GEGLU FeedForward, CLIP's encoder layers."""
    from stablediffusioneo_tpu_torch.models.clip import (
        CLIPEncoderLayer,
        OpenCLIPResidualBlock,
    )
    from stablediffusioneo_tpu_torch.models.unet import CrossAttention, FeedForward

    for name, m in model.named_modules():
        if isinstance(m, CrossAttention):
            yield name, m, "attn"
        elif isinstance(m, FeedForward):
            yield name, m, "ff"
        elif isinstance(m, CLIPEncoderLayer):
            yield name, m, "clip"
        elif isinstance(m, OpenCLIPResidualBlock):
            yield name, m, "openclip"


def _site_specs(m, kind: str, tp: int, heads: int) -> Dict[str, Tuple]:
    """{parameter name within the site: spec in torch's layout} of one site
    (weights (out, in): a JAX P(None, "tp") is ("tp", None) here). Linears
    only, and only nn.Linear: the int8 form (ops/quant.py) has no leaf the
    JAX rule names (it matches leaf `w`), so it stays whole. Attention
    also needs heads % tp == 0: the port splits heads, where GSPMD could
    reshard inside a head."""
    col, row, colb = ("tp", None), (None, "tp"), ("tp",)
    if kind == "attn":
        lin = (m.to_q, m.to_k, m.to_v, m.to_out[0])
        if not all(map(_linear, lin)) or heads % tp:
            return {}
        return {"to_q.weight": col, "to_k.weight": col, "to_v.weight": col,
                "to_out.0.weight": row}
    if kind == "ff":
        proj, out = m.net[0].proj, m.net[2]
        # the JAX _tp_spec guard: ff1 = [value; gate] shards only when each
        # half tiles tp
        if not (_linear(proj) and _linear(out)) or proj.out_features % (2 * tp):
            return {}
        return {"net.0.proj.weight": col, "net.0.proj.bias": colb, "net.2.weight": row}
    specs = {}
    if kind == "clip":
        a, mlp = m.self_attn, m.mlp
        if all(map(_linear, (a.q_proj, a.k_proj, a.v_proj, a.out_proj))) and heads % tp == 0:
            specs.update({f"self_attn.{p}_proj.weight": col for p in "qkv"})
            specs.update({f"self_attn.{p}_proj.bias": colb for p in "qkv"})
            specs["self_attn.out_proj.weight"] = row
        if _linear(mlp.fc1) and _linear(mlp.fc2) and mlp.fc1.out_features % tp == 0:
            specs.update({"mlp.fc1.weight": col, "mlp.fc1.bias": colb,
                          "mlp.fc2.weight": row})
        return specs
    # openclip: q, k, v packed in in_proj (thirds)
    if heads % tp == 0 and _linear(m.attn.out_proj):
        specs.update({"attn.in_proj_weight": col, "attn.in_proj_bias": colb,
                      "attn.out_proj.weight": row})
    if _linear(m.mlp.c_fc) and m.mlp.c_fc.out_features % tp == 0:
        specs.update({"mlp.c_fc.weight": col, "mlp.c_fc.bias": colb,
                      "mlp.c_proj.weight": row})
    return specs


def unet_param_sharding_rules(mesh: Mesh, model: nn.Module) -> Dict[str, Tuple]:
    """{state-dict key: spec} of every parameter the TP rules shard, in
    torch's layout (a weight is (out, in): column-parallel ("tp", None),
    row-parallel (None, "tp"), a column bias ("tp",)); every other key is
    replicated. The JAX _spec_for_path / _tp_spec rules on the port's
    names: q/k/v, ff1 (GEGLU guard), CLIP fc1 and fc1's bias column; wo /
    out, ff2, fc2 row; convs (the VAE's conv attention too), norms,
    embeddings and every other linear whole."""
    tp = mesh.size("tp")
    out = {}
    for prefix, m, kind in _tp_sites(model):
        pre = prefix + "." if prefix else ""
        for k, spec in _site_specs(m, kind, tp, getattr(m, "heads", 1)).items():
            out[pre + k] = spec
    return out


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Apply the TP rules to `model` in place: each sharded parameter is
    replaced by this rank's slice (GEGLU's ff1 and OpenCLIP's packed
    in_proj: the rank's slice of each half / third), a site's heads become
    heads / tp, row-parallel linears are tagged with the tp axis (their
    forward is `row_linear`) and column-parallel ones too (`copy_to` at
    their input under autograd). Sites whose rules do not hold stay whole.
    Returns the model; `model.tp_specs` holds the specs applied. A model
    sharded once is not sharded again."""
    if getattr(model, "tp_specs", None) is not None:
        return model
    ax = mesh.axis("tp")
    tp, r = ax.size, ax.index
    applied = {}
    for prefix, m, kind in _tp_sites(model):
        specs = _site_specs(m, kind, tp, getattr(m, "heads", 1))
        if not specs:
            continue
        pre = prefix + "." if prefix else ""
        for name, spec in specs.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = m.get_submodule(mod_name) if mod_name else m
            t = getattr(mod, leaf).data
            if spec[0] == "tp":
                new = _rows(t, r, tp, tp_parts(name))
                mod.tp_col = ax
            else:
                new = _cols(t, r, tp)
                mod.tp_row = ax
            setattr(mod, leaf, nn.Parameter(new, requires_grad=t.requires_grad))
            applied[pre + name] = spec
        if kind in ("attn", "clip", "openclip") and any(
                k.startswith(("to_q", "self_attn.q", "attn.in_proj")) for k in specs):
            m.heads //= tp
    for mod in model.modules():  # nn.Linear in/out features follow the slices
        if isinstance(mod, nn.Linear):
            mod.out_features, mod.in_features = mod.weight.shape
    model.tp_specs = applied
    return model


# ------------------------------------------------------------------ FSDP


def fsdp_param_sharding_rules(mesh: Mesh, params: Dict[str, torch.Tensor],
                              min_size: int = FSDP_MIN_SIZE,
                              tp_specs: Optional[Dict[str, Tuple]] = None
                              ) -> Dict[str, Tuple]:
    """ZeRO-3 specs (the JAX fsdp_param_sharding_rules): every leaf of at
    least `min_size` elements is sharded over dp on its largest dim that is
    not taken by tp and whose size tiles dp; smaller leaves, and leaves with
    no such dim, keep their TP spec. params: {name: tensor}, this rank's
    (under TP a tp-sharded leaf is its slice: the rule reads the global
    size, and picks among the dims tp leaves whole). tp_specs: the TP
    rules' specs (`model.tp_specs`)."""
    dp, tp = mesh.size("dp"), mesh.size("tp")
    tp_specs = tp_specs or {}
    out = {}
    for name, t in params.items():
        nd = t.dim()
        spec = list(tp_specs.get(name, ())) + [None] * (nd - len(tp_specs.get(name, ())))
        shape = list(t.shape)
        size = t.numel() * (tp if "tp" in spec else 1)  # the global leaf's
        if dp > 1 and size >= min_size:
            cands = [i for i in range(nd) if spec[i] is None and shape[i] % dp == 0]
            if cands:
                spec[max(cands, key=lambda i: shape[i])] = "dp"
        out[name] = tuple(spec)
    return out


def fsdp_dim(spec: Tuple) -> Optional[int]:
    return spec.index("dp") if "dp" in spec else None


def fsdp_shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                      min_size: int = FSDP_MIN_SIZE,
                      tp_specs: Optional[Dict[str, Tuple]] = None):
    """(this rank's tensors, specs): each leaf the FSDP rules shard cut to
    its 1/dp slice on the rule's dim (a copy), the rest as they are.
    `fsdp_gather` puts a leaf back together at use."""
    ax = mesh.axis("dp")
    specs = fsdp_param_sharding_rules(mesh, params, min_size, tp_specs)
    out = {}
    for name, t in params.items():
        d = fsdp_dim(specs[name])
        out[name] = t if d is None else local_slice(t.detach(), ax, d).clone()
    return out, specs


def fsdp_gather(t: torch.Tensor, spec: Tuple, mesh: Mesh) -> torch.Tensor:
    """A leaf whole again from its FSDP slices (the all-gather GSPMD
    inserted at use); under autograd the gradient of the whole leaf comes
    back summed over dp onto this rank's slice (the reduce-scatter)."""
    d = fsdp_dim(spec)
    return t if d is None else gather_from(t, mesh.axis("dp"), d)
