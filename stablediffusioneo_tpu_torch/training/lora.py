"""LoRA adapters, the inference half (counterpart of
stablediffusioneo_tpu/training/lora.py; arXiv:2106.09685).

An adapter holds rank-r factor pairs for the targeted linears of one network,
w' = w + scale * a @ b, with a (in, r) and b (r, out). The adapter tree is the
JAX package's: nested dicts named by the JAX parameter tree's paths
(`input_blocks/1/attn/blocks/0/attn1/wq`, `layers/3/fc1`; list positions as
int keys), each site {"a", "b"}, so that an `sdeo-lora-v1` file saved by
either package loads in the other. The port names each site's tensor through
checkpoint/convert.py's map (`leaf_target`, the one `state_dict_from_jax`
uses): its nn.Linear weight is (out, in), so the delta added is (a @ b)^T;
OpenCLIP's q / k / v are a third each of the packed `attn.in_proj_weight`;
a projected tower's `text_projection` is stored (in, out), as in JAX.

`merge_lora` merges in place (`param.data` is written, never replaced), so a
CUDA graph captured before the merge replays the merged weights: the JAX
guarantee that every compiled engine stays valid
(runtime/engine.py:CNSDRuntime.apply_lora). The delta accumulates in fp32 and
is rounded once to the weight's dtype, the JAX order
`(w.f32 + delta).astype(w.dtype)`.

`lora_train_step` trains the factors on a frozen network: each step merges
them into copies of the site weights inside the differentiated function
(`merged_weights`, the same sites and the same fp32 order), hands those to
training/trainer.py's `diffusion_loss` through torch.func.functional_call,
and so the gradients reach the rank-r factors only; the network's own
tensors are never written.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.checkpoint.convert import leaf_target, linear_nodes

# attention projections + MLP linears, UNet and CLIP naming
DEFAULT_TARGETS = (
    "wq", "wk", "wv", "wo", "ff1", "ff2",   # models/unet.py transformer blocks
    "q", "k", "v", "out", "fc1", "fc2",     # models/clip.py layers
)


def net_kind(net: nn.Module) -> str:
    """The JAX tree kind of a port network (checkpoint/convert.py)."""
    from stablediffusioneo_tpu_torch.models.clip import CLIPTextModel, OpenCLIPTextModel
    from stablediffusioneo_tpu_torch.models.controlnet import ControlNet
    from stablediffusioneo_tpu_torch.models.unet import UNetModel
    from stablediffusioneo_tpu_torch.models.vae import AutoencoderKL

    for cls, kind in ((UNetModel, "unet"), (ControlNet, "controlnet"),
                      (CLIPTextModel, "clip"), (OpenCLIPTextModel, "openclip"),
                      (AutoencoderKL, "vae")):
        if isinstance(net, cls):
            return kind
    raise TypeError(f"no JAX tree kind for a {type(net).__name__}")


def _nets(net) -> Dict:
    """{adapter key prefix: network}: one network under (), or the nets of a
    multi-ControlNet (a tuple or ModuleList) under their positions."""
    if isinstance(net, (tuple, list, nn.ModuleList)):
        return {(i,): n for i, n in enumerate(net)}
    return {(): net}


def _ucfg(net):
    """The UNet configuration of a UNet or ControlNet (else unused)."""
    return getattr(net.cfg, "unet", net.cfg)


def _site_tensor(net, kind: str, path: Tuple) -> Tuple[Optional[torch.Tensor], str]:
    """The port tensor an adapter site's weight lives in (a row third of
    OpenCLIP's in_proj), and its layout; (None, "") where the path names no
    tensor of `net`."""
    try:
        t = leaf_target(kind, _ucfg(net), tuple(path) + ("w",))
        w = net.get_parameter(t.name).data
    except (KeyError, IndexError, ValueError, AttributeError):
        return None, ""
    if t.rows is not None:
        d = w.shape[0] // 3
        w = w[t.rows * d:(t.rows + 1) * d]
    return w, t.layout


def lora_sites(net, targets: Sequence[str] = DEFAULT_TARGETS) -> Tuple[Tuple, ...]:
    """JAX paths (key tuples) of every targeted linear site of the port's
    network `net` (a multi-ControlNet's under each net's position), in the
    JAX tree's order: a site's key is in `targets` and it holds a 2-D weight
    (convs never match)."""
    out = []
    for prefix, n in _nets(net).items():
        kind = net_kind(n)
        out += sorted((prefix + node for node in linear_nodes(kind, n)
                       if node[-1] in targets), key=_order)
    return tuple(out)


def _order(path):
    return tuple((0, p) if isinstance(p, int) else (1, p) for p in path)


def init_lora(generator: torch.Generator, net, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS,
              dtype: torch.dtype = torch.float32) -> Dict:
    """Sparse adapter tree: {"a": (in, r) N(0, 1/r), "b": (r, out) zeros}
    at every targeted site, drawn from `generator` on its device in site
    order (zero "b" => merge is the identity at init, the standard LoRA warm
    start)."""
    sites = lora_sites(net, targets)
    if not sites:
        raise ValueError(f"no LoRA sites matched targets {targets}")
    nets = _nets(net)
    tree: Dict = {}
    for path in sites:
        prefix = () if () in nets else path[:1]
        n = nets[prefix]
        w, layout = _site_tensor(n, net_kind(n), path[len(prefix):])
        cin, cout = (w.shape[1], w.shape[0]) if layout == "linear" else w.shape
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        a = torch.randn((cin, rank), generator=generator, device=generator.device)
        node[path[-1]] = {"a": (a / math.sqrt(rank)).to(dtype),
                          "b": torch.zeros((rank, cout), dtype=dtype,
                                           device=generator.device)}
    return tree


@torch.no_grad()
def merge_lora(net, lora: Dict, scale: float = 1.0) -> int:
    """w' = w + scale * a @ b at every adapter site of `lora`, written into
    the port's network `net` in place (a multi-ControlNet: a tuple of nets,
    the adapter a tuple of trees or a dict keyed by position). Returns the
    number of sites merged.

    The outer product accumulates in fp32 on the weight's device and is
    rounded once to the weight's dtype; untargeted tensors are untouched.
    Strict accounting, checked before any weight changes: every adapter
    site must land on a linear of `net` of the right shape; a mismatched
    tree (e.g. a UNet adapter merged into the ControlNet) fails loudly
    naming the orphan sites instead of silently part-merging."""
    nets = _nets(net)
    if () not in nets and isinstance(lora, (tuple, list)):
        lora = dict(enumerate(lora))
    plan = _merge_plan(nets, lora)
    for _, w, layout, a, b in plan:
        w.copy_(_merged(w, layout, a, b, scale))
    return len(plan)


def _merge_plan(nets: Dict, lora: Dict):
    """[(path, weight tensor, layout, a, b)] of every adapter site, checked
    before anything is merged: every site must land on a linear of the
    right shape."""
    plan, orphans = [], []
    for path in _site_paths(lora):
        prefix = () if () in nets else path[:1]
        n = nets.get(prefix)
        site = _get(lora, path)
        w, layout = (None, "") if n is None or set(site) != {"a", "b"} else \
            _site_tensor(n, net_kind(n), path[len(prefix):])
        if w is None:
            orphans.append("/".join(map(str, path)))
            continue
        a, b = site["a"], site["b"]
        shape = (b.shape[1], a.shape[0]) if layout == "linear" else (a.shape[0], b.shape[1])
        if layout == "conv" or tuple(w.shape) != shape:
            raise ValueError(
                f"merge_lora: adapter site {'/'.join(map(str, path))} "
                "does not match a linear of the right shape in the target tree")
        plan.append((path, w, layout, a, b))
    if orphans:
        raise ValueError(
            f"merge_lora: {len(orphans)} adapter site(s) have no matching "
            f"path in the target tree (wrong 'on' tree?): {orphans[:5]}")
    return plan


def _merged(w, layout: str, a, b, scale: float):
    """w + scale * a @ b (transposed for an (out, in) linear), the product
    and the sum in fp32, rounded once to w's dtype."""
    delta = (torch.as_tensor(a, device=w.device).float()
             @ torch.as_tensor(b, device=w.device).float()) * scale
    return (w.float() + (delta.T if layout == "linear" else delta)).to(w.dtype)


def merged_weights(net: nn.Module, lora: Dict, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """{parameter name of `net`: merged weight} at every adapter site, new
    tensors that autograd follows back to the factors (the network is not
    written): the JAX `merge_lora` inside a differentiated function. One
    network (not a multi-ControlNet); its sites are whole linears."""
    kind = net_kind(net)
    out = {}
    if getattr(net, "tp_specs", None):  # a tensor-parallel net: slices of the update
        lora = shard_lora(net, lora)
    for path, w, layout, a, b in _merge_plan({(): net}, lora):
        t = leaf_target(kind, _ucfg(net), tuple(path) + ("w",))
        if t.rows is not None:
            raise ValueError(f"merged_weights: site {'/'.join(map(str, path))} is a "
                             "third of a packed projection")
        out[t.name] = _merged(w, layout, a, b, scale)
    return out


def count_params(tree) -> int:
    return sum(int(np.prod(tuple(x.shape))) for x in leaves(tree))


def n_sites(lora: Dict) -> int:
    """Number of adapter sites in a LoRA tree."""
    return sum(1 for _ in _site_paths(lora))


# ------------------------------------------------------------- train step


def lora_train_step(
    state,
    tx,
    frozen: Dict[str, nn.Module],
    cfg,
    sqrt_abar: torch.Tensor,
    sqrt_one_minus_abar: torch.Tensor,
    batch: Dict,
    key: int,
    on: str = "controlnet",
    scale: float = 1.0,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
):
    """One AdamW step on a LoRA tree riding the frozen pipeline (the JAX
    `lora_train_step`). `state.params` is the adapter tree
    (training/trainer.py:create_train_state(net, params=tree)); `frozen`
    holds the networks {"unet", "controlnet"}; `on` picks the one the
    adapters merge into. The merge happens inside the differentiated
    function, so the gradients flow to the rank-r factors only. key, t,
    noise: as in trainer.train_step."""
    from stablediffusioneo_tpu_torch.training.trainer import (
        apply_gradients, diffusion_loss, dp_local, prepare_batch, step_draws,
    )

    if on not in ("unet", "controlnet"):
        raise ValueError(f"lora_train_step trains adapters on 'unet' or 'controlnet', "
                         f"got {on!r}")
    del tx
    batch = prepare_batch(batch)
    if t is None or noise is None:
        t, noise = step_draws(key, state.step, batch["x0"], cfg.diffusion.timesteps)
    tp_summed = ()
    if state.mesh is not None:
        batch, t, noise = dp_local(state.mesh, batch, t, noise)
        # a tensor-parallel site's factors: each rank's merge reaches only
        # its slice of the update, so their gradients are summed over tp
        tp_summed = tuple(f for path, *_ in _tp_sites({(): frozen[on]}, state.params)
                          for f in _get(state.params, path).values())
    merged = {f"{on}_params": merged_weights(frozen[on], state.params, scale)}
    loss = diffusion_loss(
        frozen["controlnet"], frozen["unet"], cfg, sqrt_abar, sqrt_one_minus_abar,
        batch["x0"], batch["hint"], batch["ctx"], t, noise, **merged)
    return apply_gradients(state, loss, tp_summed)


# ------------------------------------------------------------- save / load


def save_lora(path: str, lora: Dict, alpha: float, rank: Optional[int] = None,
              on: str = "controlnet") -> str:
    """Single-file .npz: flat "/"-joined keys + a JSON metadata record (the
    JAX package's `sdeo-lora-v1`)."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(str(x) for x in prefix + (k,))] = _numpy(v)

    walk(lora, ())
    if rank is None:
        rank = next(iter(flat.values())).shape[-1] if flat else 0
    meta = json.dumps({"format": "sdeo-lora-v1", "alpha": alpha,
                       "rank": rank, "on": on})
    np.savez(path, __meta__=np.frombuffer(meta.encode(), np.uint8), **flat)
    return path


def load_lora(path: str) -> Tuple[Dict, dict]:
    """Returns (adapter tree of CPU tensors, metadata). Strict accounting:
    every stored key must parse into the tree and every site must hold
    exactly {"a", "b"}; a malformed or foreign file fails loudly naming the
    offending keys."""
    z = np.load(path)
    files = set(z.files)
    if "__meta__" not in files:
        raise ValueError(f"{path}: not an sdeo-lora file (no __meta__)")
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta.get("format") != "sdeo-lora-v1":
        raise ValueError(f"{path}: unknown lora format {meta.get('format')!r}")
    tree: Dict = {}
    for key in sorted(files - {"__meta__"}):
        parts = [int(p) if p.isdigit() else p for p in key.split("/")]
        if parts[-1] not in ("a", "b"):
            raise ValueError(f"{path}: unexpected leaf {key!r} "
                             "(sites hold exactly 'a'/'b')")
        node = tree
        for name in parts[:-1]:
            node = node.setdefault(name, {})
        node[parts[-1]] = torch.from_numpy(np.array(z[key]))
    bad = [p for p in _site_paths(tree)
           if set(_get(tree, p)) != {"a", "b"}]
    if bad:
        raise ValueError(f"{path}: incomplete adapter sites {bad}")
    return tree, meta


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def leaves(tree):
    """The tensors of a tree of dicts, tuples and lists, in its order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn, *trees):
    """fn over the leaves of dict trees of one structure, as a new tree."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def shard_lora(net, lora: Dict) -> Dict:
    """The adapter tree cut to the slices of a network that
    parallel/mesh.py:shard_params made tensor-parallel, so that `merge_lora`
    adds to each rank's weight slice its slice of the update: b's output
    columns at a column-parallel site (GEGLU ff1: the rank's part of each
    half), a's input rows at a row-parallel one; sites left whole keep
    their factors. A multi-ControlNet: the nets of `_nets`."""
    from stablediffusioneo_tpu_torch.parallel.mesh import _rows, tp_parts

    def rebuilt(tree):  # new dicts, the same tensors (autograd follows them)
        return {k: rebuilt(v) if isinstance(v, dict) else v for k, v in tree.items()}

    nets = _nets(net)
    if () not in nets and isinstance(lora, (tuple, list)):
        lora = dict(enumerate(lora))
    out = rebuilt(lora)
    for path, t, col, row in _tp_sites(nets, lora):
        site = _get(out, path)
        if col is not None:
            # an OpenCLIP q / k / v site is one third of the packed in_proj
            parts = 1 if t.rows is not None else tp_parts(t.name)
            site["b"] = _rows(torch.as_tensor(site["b"]).T, col.index, col.size, parts).T
        if row is not None:
            site["a"] = torch.as_tensor(site["a"]).chunk(row.size, dim=0)[row.index]
    return out


def _tp_sites(nets: Dict, lora: Dict):
    """(path, target, column axis, row axis) of every adapter site whose
    linear is tensor-parallel."""
    for path in _site_paths(lora):
        prefix = () if () in nets else path[:1]
        n = nets[prefix]
        t = leaf_target(net_kind(n), _ucfg(n), tuple(path[len(prefix):]) + ("w",))
        mod = n.get_submodule(t.name.rpartition(".")[0])
        col, row = getattr(mod, "tp_col", None), getattr(mod, "tp_row", None)
        if col is not None or row is not None:
            yield path, t, col, row


def _site_paths(tree: Dict, path=()) -> Iterable[Tuple]:
    if any(not isinstance(v, dict) for v in tree.values()):
        yield path
        return
    for k, v in tree.items():
        yield from _site_paths(v, path + (k,))


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree
