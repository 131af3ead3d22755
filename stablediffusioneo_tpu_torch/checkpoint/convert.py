"""JAX parameter trees -> the port's parameter names (one map, two users).

The inverse of stablediffusioneo_tpu/checkpoint/convert.py (`convert_unet`,
`convert_controlnet`, `convert_vae`, `convert_clip`, `convert_openclip_text`).
`leaf_target(kind, ucfg, path)` names, for the path of one leaf of a JAX tree
of a given kind ("unet", "controlnet", "vae", "clip", "openclip"), the
port's tensor it becomes, relative to the network's module, and how it is
laid out there: HWIO convs go back to OIHW, (in, out) linears to (out, in),
g/b norms to weight/bias, an OpenCLIP tower's q/k/v into one third each of
its packed in_proj (3d, d), its text_projection kept as stored (d, proj).

Two users, so that no second table of names exists:
  * `state_dict_from_jax` makes one state dict of a model's JAX trees, under
    the checkpoint's prefixes (`jax_trees`): model.diffusion_model. /
    control_model. / first_stage_model. / cond_stage_model.transformer. (HF
    CLIP) or cond_stage_model.model. (OpenCLIP, SD-2.x); SDXL base's sgm
    layout (conditioner.embedders.0.transformer. / .1.model.); the SDXL
    refiner's (bigG alone, at conditioner.embedders.0.model.);
  * training/lora.py merges an adapter, whose sites are named by their JAX
    paths, into the port's modules in place.
The annotators' trees (HED, DPT-L, DPT-hybrid, the OpenPose body and hand
nets) are built by name in the JAX converters rather than by a path map, so
`annotator_state_dict_from_jax` inverts each converter directly; the
depth2img model's MiDaS tower goes through it too. The nets whose JAX
converters fold BatchNorm (MLSD, UniFormer, the FID Inception, YOLOv5) come
back through `folded_state_dict_from_jax` with identity BatchNorms.
The parameters arrive as arrays (numpy, or anything numpy can read), so this
module needs no JAX. Every parameter of the port's model gets one, and no
other key is made, so its `load_checkpoint` loads the result with nothing
left over, by the same names a real checkpoint uses.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stablediffusioneo_tpu_torch.models.unet import decoder_plan

StateDict = Dict[str, torch.Tensor]


class Target(NamedTuple):
    """Where a JAX leaf lives in the port: `name`, a tensor name relative to
    the network's module; `layout`, "linear" ((in, out) stored (out, in)),
    "conv" (HWIO stored OIHW) or "raw" (as stored); `rows`, for OpenCLIP's
    q/k/v, which third (0, 1, 2) of the packed in_proj it is, else None."""

    name: str
    layout: str
    rows: Optional[int] = None


# the transformer block's linears (ldm/modules/attention.py names)
_ATTN = {"wq": "to_q", "wk": "to_k", "wv": "to_v", "wo": "to_out.0"}
_FF = {"ff1": "ff.net.0.proj", "ff2": "ff.net.2"}
# a ResBlock's layers (openaimodel.py names)
_RES = {"norm1": "in_layers.0", "conv1": "in_layers.2", "emb": "emb_layers.1",
        "norm2": "out_layers.0", "conv2": "out_layers.3", "skip": "skip_connection"}
# a CLIP text layer: HF CLIPTextModel's and OpenCLIP's names
_CLIP_LAYER = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
               "k": "self_attn.k_proj", "v": "self_attn.v_proj",
               "out": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
_OPENCLIP_LAYER = {"ln1": "ln_1", "ln2": "ln_2", "out": "attn.out_proj",
                   "fc1": "mlp.c_fc", "fc2": "mlp.c_proj"}
_QKV = ("q", "k", "v")  # OpenCLIP's in_proj order


def _transformer(rest) -> str:
    """A SpatialTransformer's node (norm / proj_in / proj_out / blocks/j/...)."""
    if rest[0] != "blocks":
        return _one(rest, rest[0])
    j, part = rest[1], rest[2]
    if part in ("attn1", "attn2"):
        return _one(rest[3:], f"transformer_blocks.{j}.{part}.{_ATTN[rest[3]]}")
    return _one(rest[3:], f"transformer_blocks.{j}." + (_FF[part] if part in _FF else part))


def _one(rest, name: str) -> str:
    """`name` if the path ends here (its node reached), else a KeyError."""
    if len(rest) > 1:
        raise KeyError("/".join(map(str, rest)))
    return name


def _unet_node(ucfg, path) -> str:
    """The port module of a UNet / ControlNet node (a dict of w / b / g)."""
    head = path[0]
    if head in ("time_embed", "label_emb"):
        pre = "time_embed." if head == "time_embed" else "label_emb.0."
        return _one(path[1:], pre + {"l1": "0", "l2": "2"}[path[1]])
    if head == "out":
        return _one(path[1:], {"norm": "out.0", "conv": "out.2"}[path[1]])
    if head == "input_hint_block":
        return _one(path[1:], f"input_hint_block.{2 * int(path[1])}")
    if head == "zero_convs":
        return _one(path[1:], f"zero_convs.{int(path[1])}.0")
    if head == "middle_block_out":
        return _one(path, "middle_block_out.0")
    if head == "middle_block":
        part = path[1]
        if part == "attn":
            return "middle_block.1." + _transformer(path[2:])
        return f"middle_block.{ {'res1': 0, 'res2': 2}[part] }." + _one(
            path[2:], _RES[path[2]])
    if head not in ("input_blocks", "output_blocks"):
        raise KeyError(head)
    i, part = int(path[1]), path[2]
    base = f"{head}.{i}."
    if part == "res":
        return base + "0." + _one(path[3:], _RES[path[3]])
    if part == "attn":
        return base + "1." + _transformer(path[3:])
    if head == "input_blocks" and part in ("conv", "down"):
        return _one(path[2:], base + ("0" if part == "conv" else "0.op"))
    if head == "output_blocks" and part == "up":
        return _one(path[2:], base + f"{2 if decoder_plan(ucfg)[i]['attn'] else 1}.conv")
    raise KeyError(part)


def _vae_node(path) -> str:
    """VAE names are the JAX keys joined, a resampler's conv one level down."""
    name = ".".join(map(str, path))
    return name + ".conv" if path[-1] in ("downsample", "upsample") else name


def leaf_target(kind: str, ucfg, path: Tuple) -> Target:
    """The port's tensor of the JAX leaf at `path` (a tuple of keys and list
    indices, ending at "w", "b", "g" or a bare array) in a tree of `kind`.
    ucfg: the UNet configuration of a "unet" / "controlnet" tree (it places
    an output block's upsampler). A path the trees do not hold raises
    KeyError."""
    if kind in ("clip", "openclip"):
        return _clip_target(kind == "openclip", path)
    node, leaf = path[:-1], path[-1]
    if not node or leaf not in ("w", "b", "g"):
        raise KeyError("/".join(map(str, path)))
    name = _unet_node(ucfg, node) if kind in ("unet", "controlnet") else _vae_node(node)
    if leaf == "w":
        conv = not (kind in ("unet", "controlnet") and node[-1] in (
            "wq", "wk", "wv", "wo", "ff1", "ff2", "emb", "l1", "l2"))
        return Target(name + ".weight", "conv" if conv else "linear")
    return Target(name + (".bias" if leaf == "b" else ".weight"), "raw")


def _clip_target(openclip: bool, path) -> Target:
    head = path[0]
    if len(path) == 1 and head in ("token_embedding", "position_embedding"):
        if openclip:
            return Target("token_embedding.weight" if head == "token_embedding"
                          else "positional_embedding", "raw")
        return Target(f"text_model.embeddings.{head}.weight", "raw")
    if head == "text_projection" and openclip and path[1:] == ("w",):
        return Target("text_projection", "raw")  # stored (d, proj), applied x @ W
    leaf = path[-1]
    if leaf not in ("w", "b", "g"):
        raise KeyError("/".join(map(str, path)))
    if head == "final_ln" and len(path) == 2:
        return Target(("ln_final" if openclip else "text_model.final_layer_norm")
                      + (".bias" if leaf == "b" else ".weight"), "raw")
    if head != "layers" or len(path) != 4:
        raise KeyError("/".join(map(str, path)))
    i, part = int(path[1]), path[2]
    if openclip and part in _QKV:
        return Target(f"transformer.resblocks.{i}.attn.in_proj_"
                      + ("weight" if leaf == "w" else "bias"),
                      "linear" if leaf == "w" else "raw", _QKV.index(part))
    sub = (_OPENCLIP_LAYER if openclip else _CLIP_LAYER)[part]
    base = f"transformer.resblocks.{i}." if openclip else f"text_model.encoder.layers.{i}."
    if leaf == "w":
        return Target(base + sub + ".weight", "linear")
    return Target(base + sub + (".bias" if leaf == "b" else ".weight"), "raw")


def linear_nodes(kind: str, net) -> Iterator[Tuple]:
    """The JAX path of every linear node (a "w" of (in, out), in the JAX
    tree's order) of the port's network `net` of `kind`: its candidates are
    enumerated over the network's blocks from the names above, and a
    candidate is kept where `leaf_target` finds its tensor in `net`."""
    names = dict(net.named_parameters())

    def block_nodes(st):  # the linears of a SpatialTransformer
        for j in range(len(st.transformer_blocks)):
            for part in ("attn1", "attn2"):
                yield from (("blocks", j, part, w) for w in sorted(_ATTN))
            yield from (("blocks", j, f) for f in sorted(_FF))

    def unet_candidates():  # a ControlNet has no output blocks
        for head in ("input_blocks", "output_blocks"):
            for i, blk in enumerate(getattr(net, head, ())):
                st = blk.transformer()
                if st is not None:
                    yield from ((head, i, "attn") + n for n in block_nodes(st))
                yield (head, i, "res", "emb")
        yield from (("middle_block", "attn") + n
                    for n in block_nodes(net.middle_block.transformer()))
        yield from (("middle_block", r, "emb") for r in ("res1", "res2"))
        yield from ((head, l) for head in ("label_emb", "time_embed") for l in ("l1", "l2"))

    def clip_candidates():
        for i in range(len(net.blocks)):
            yield from (("layers", i, part) for part in sorted(_CLIP_LAYER)
                        if part not in ("ln1", "ln2"))
        if kind == "openclip":
            yield ("text_projection",)

    if kind in ("unet", "controlnet"):
        candidates, ucfg = unet_candidates(), getattr(net.cfg, "unet", net.cfg)
    elif kind in ("clip", "openclip"):
        candidates, ucfg = clip_candidates(), None
    else:
        return  # the VAE holds no linear
    for node in candidates:
        t = leaf_target(kind, ucfg, node + ("w",))
        if t.name in names and names[t.name].dim() == 2:
            yield node


def jax_leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    """(path, leaf) of every array of a JAX tree: dict keys in sorted order
    (int keys for list positions, as an adapter file gives them), list and
    tuple items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from jax_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from jax_leaves(v, path + (i,))
    else:
        yield path, tree


def port_layout(a: np.ndarray, layout: str) -> np.ndarray:
    """A JAX array in the port's layout."""
    if layout == "linear":
        return np.transpose(a)
    if layout == "conv":
        return np.transpose(a, (3, 2, 0, 1))
    return a


def tree_state_dict(sd: StateDict, kind: str, ucfg, tree, prefix: str = "") -> None:
    """Every leaf of one JAX tree of `kind` into `sd`, fp32, under `prefix`
    (prefix "": the names within the network's own module)."""
    for path, leaf in jax_leaves(tree):
        t = leaf_target(kind, ucfg, path)
        a = port_layout(np.asarray(leaf, np.float32), t.layout)
        name = prefix + t.name
        if t.rows is None:
            sd[name] = torch.from_numpy(np.array(a))  # a writable copy
        else:  # a third of OpenCLIP's packed in_proj
            d = a.shape[0]
            packed = sd.setdefault(name, torch.zeros((3 * d,) + a.shape[1:]))
            packed[t.rows * d:(t.rows + 1) * d] = torch.from_numpy(np.array(a))


def jax_trees(cfg, params: Optional[dict] = None) -> Tuple[Tuple[str, str, str], ...]:
    """(params key, kind, prefix) of each JAX tree of a model of `cfg`: a
    PipelineConfig ({"unet", "controlnet" (absent for a ControlNet-free model;
    a tuple of N trees for a ControlLDM of N ControlNets, under
    control_model.<i>.), "vae", "clip"}, the text tower OpenCLIP's under
    cond_stage_model.model. where cfg.clip.layer is "penultimate" (SD-2.x)),
    an SDXL base configuration ({"unet", "clip_l", "clip_g", "vae"}) or an
    SDXL refiner one ({"unet", "clip_g", "vae"}), by their own layouts.
    `params` tells whether a PipelineConfig's model has a ControlNet. The
    depth2img configuration (models/cldm.py:depth_conditioned) also takes its
    MiDaS tower ({"depth"}, a JAX convert_dpt_hybrid tree) under
    depth_model.model."""
    from stablediffusioneo_tpu_torch.models.cldm import depth_conditioned
    from stablediffusioneo_tpu_torch.models.sdxl import SDXLConfig, SDXLRefinerConfig

    trees = [("unet", "unet", "model.diffusion_model."),
             ("vae", "vae", "first_stage_model.")]
    if isinstance(cfg, SDXLRefinerConfig):
        return tuple(trees) + (("clip_g", "openclip", "conditioner.embedders.0.model."),)
    if isinstance(cfg, SDXLConfig):
        return tuple(trees) + (
            ("clip_l", "clip", "conditioner.embedders.0.transformer."),
            ("clip_g", "openclip", "conditioner.embedders.1.model."))
    if params is None or params.get("controlnet") is not None:
        trees.append(("controlnet", "controlnet", "control_model."))
    if cfg.clip.layer == "penultimate":
        trees.append(("clip", "openclip", "cond_stage_model.model."))
    else:
        trees.append(("clip", "clip", "cond_stage_model.transformer."))
    if depth_conditioned(cfg):
        trees.append(("depth", "dpt_hybrid", "depth_model.model."))
    return tuple(trees)


def state_dict_from_jax(params: dict, cfg) -> StateDict:
    """JAX trees -> one fp32 state dict under the checkpoint's names (see
    `jax_trees` for the trees each configuration takes)."""
    sd: StateDict = {}
    for key, kind, prefix in jax_trees(cfg, params):
        tree = params[key]
        ucfg = cfg.controlnet.unet if kind == "controlnet" else getattr(cfg, "unet", None)
        if kind in ANNOTATOR_KINDS:
            sd.update((prefix + k, v) for k, v in annotator_state_dict_from_jax(kind, tree).items())
        elif kind == "controlnet" and isinstance(tree, (tuple, list)):  # multi-ControlNet
            for i, net in enumerate(tree):
                tree_state_dict(sd, kind, ucfg, net, f"{prefix}{i}.")
        else:
            tree_state_dict(sd, kind, ucfg, tree, prefix)
    return sd


# one tree at a time, under a prefix (the whole network's module: prefix="")


def unet_state_dict(sd: StateDict, ucfg, p, prefix="model.diffusion_model.") -> None:
    tree_state_dict(sd, "unet", ucfg, p, prefix)


def controlnet_state_dict(sd: StateDict, cfg, p, prefix="control_model.") -> None:
    tree_state_dict(sd, "controlnet", cfg.unet, p, prefix)


def vae_state_dict(sd: StateDict, p, prefix="first_stage_model.") -> None:
    tree_state_dict(sd, "vae", None, p, prefix)


def clip_state_dict(sd: StateDict, p, prefix="cond_stage_model.transformer.") -> None:
    tree_state_dict(sd, "clip", None, p, prefix)


def openclip_state_dict(sd: StateDict, p, prefix="cond_stage_model.model.") -> None:
    tree_state_dict(sd, "openclip", None, p, prefix)


# ------------------------------------------------------------- annotators

ANNOTATOR_KINDS = ("hed", "dpt_large", "dpt_hybrid", "openpose_body", "openpose_hand",
                   "mlsd_large", "uniformer")
# the nets whose JAX converters fold BatchNorm into the convs, and the eps of
# their BatchNorms; the MLSD and UniFormer files carry a num_batches_tracked
# counter a BatchNorm, pytorch_fid's Inception none, and YOLOv5's loader
# reads none
FOLDED_KINDS = ("mlsd_large", "uniformer", "inception", "yolov5")
BN_EPS = {"mlsd_large": 1e-5, "uniformer": 1e-5, "inception": 1e-3, "yolov5": 1e-3}
_TRACKED = ("mlsd_large", "uniformer")


def annotator_state_dict_from_jax(kind: str, params) -> StateDict:
    """A JAX annotator tree -> the port module's state dict under the
    upstream names (no prefix), fp32: the inverse of the JAX package's
    convert_hed, convert_dpt, convert_dpt_hybrid, convert_body and
    convert_hand (annotators/*.py) for `kind` in ANNOTATOR_KINDS, and of
    convert_mlsd_large and convert_uniformer_upernet by
    `folded_state_dict_from_jax`. HWIO convs
    go back to OIHW, (in, out) linears to (out, in), g/b norms to
    weight/bias, HED's NHWC `norm` to (1, 3, 1, 1).

    DPT-L's stage-1/2 upsamplers: the JAX package runs lax.conv_transpose
    without transpose_kernel on a kernel convert_dpt only permuted, which is
    the upstream ConvTranspose2d with its kernel mirrored in both spatial
    axes. The port's module is upstream's ConvTranspose2d, so the weight
    given here is the JAX kernel flipped back: the same tree computes the
    same function in both packages (while a checkpoint file loads into the
    port as upstream runs it)."""
    if kind not in ANNOTATOR_KINDS:
        raise KeyError(f"annotator kind {kind!r}; have {ANNOTATOR_KINDS}")
    if kind in FOLDED_KINDS:
        return folded_state_dict_from_jax(kind, params)
    sd: StateDict = {}

    def put(name, a, layout="raw"):
        sd[name] = torch.from_numpy(np.array(port_layout(np.asarray(a, np.float32), layout)))

    def node(name, p, layout):  # a {"w", "b"} or {"g", "b"} node
        for leaf, v in p.items():
            put(f"{name}.{ {'w': 'weight', 'g': 'weight', 'b': 'bias'}[leaf] }", v,
                layout if leaf == "w" else "raw")

    if kind in ("openpose_body", "openpose_hand"):
        for name, p in params.items():
            node(name, p, "conv")
        return sd
    if kind == "hed":
        put("norm", np.transpose(np.asarray(params["norm"]), (0, 3, 1, 2)))
        for bi in range(5):
            block = params[f"block{bi + 1}"]
            for j, p in enumerate(block["convs"]):
                node(f"block{bi + 1}.convs.{j}", p, "conv")
            node(f"block{bi + 1}.projection", block["projection"], "conv")
        return sd

    vm = "pretrained.model."
    vit = params["vit"] if kind == "dpt_large" else params
    put(f"{vm}cls_token", vit["cls_token"])
    put(f"{vm}pos_embed", vit["pos_embed"])
    for i, blk in enumerate(vit["blocks"]):
        for part, sub in (("norm1", "norm1"), ("qkv", "attn.qkv"), ("proj", "attn.proj"),
                          ("norm2", "norm2"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            node(f"{vm}blocks.{i}.{sub}", blk[part],
                 "raw" if part.startswith("norm") else "linear")
    if kind == "dpt_large":
        node(f"{vm}patch_embed.proj", vit["patch_embed"], "conv")
        posts, stages = params["reassemble"], (1, 2, 3, 4)
    else:
        bb = f"{vm}patch_embed.backbone."
        backbone = params["backbone"]
        node(f"{bb}stem.conv", backbone["stem"]["conv"], "conv")
        node(f"{bb}stem.norm", backbone["stem"]["norm"], "raw")
        for si, blocks in enumerate(backbone["stages"]):
            for bi, blk in enumerate(blocks):
                for part, p in blk.items():
                    name = f"{bb}stages.{si}.blocks.{bi}.{part}"
                    node(name + (".conv" if part == "downsample" else ""), p,
                         "raw" if part.startswith("norm") else "conv")
        node(f"{vm}patch_embed.proj", params["patch_proj"], "conv")
        posts, stages = params, (3, 4)
    for i in stages:
        post, base = posts[f"post{i}"], f"pretrained.act_postprocess{i}"
        node(f"{base}.0.project.0", post["project"], "linear")
        node(f"{base}.3", post["channel"], "conv")
        if "resample" in post:
            res = post["resample"]
            if kind == "dpt_large" and i in (1, 2):  # (kh, kw, in, out) mirrored
                w = np.transpose(np.asarray(res["w"], np.float32), (2, 3, 0, 1))
                put(f"{base}.4.weight", w[:, :, ::-1, ::-1])
                put(f"{base}.4.bias", res["b"])
            else:
                node(f"{base}.4", res, "conv")
    for i in range(1, 5):
        node(f"scratch.layer{i}_rn", posts[f"layer{i}_rn"], "conv")
        f = params["fusion"][f"refine{i}"]
        base = f"scratch.refinenet{i}"
        for u in (1, 2):
            for c in ("conv1", "conv2"):
                node(f"{base}.resConfUnit{u}.{c}", f[f"rcu{u}"][c], "conv")
        node(f"{base}.out_conv", f["out_conv"], "conv")
    for j, c in (("0", "conv1"), ("2", "conv2"), ("4", "conv3")):
        node(f"scratch.output_conv.{j}", params["head"][c], "conv")
    return sd


def folded_state_dict_from_jax(kind: str, params) -> StateDict:
    """The weight carry of the BatchNorm-folded nets (`kind` in FOLDED_KINDS:
    the JAX convert_mlsd_large, convert_uniformer_upernet, convert_inception
    and convert_yolov5 trees): the port module's state dict under the
    upstream names, fp32. A folded tree does not give back the upstream
    BatchNorm parameters, so each folded conv becomes its conv weight and an
    identity BatchNorm: weight 1, the folded shift as bias (no conv before a
    BatchNorm has a bias upstream), running_mean 0 and running_var 1 - eps at
    the net's own eps (BN_EPS; var + eps is then exactly 1 in fp32), and
    num_batches_tracked 0 where the net's file has one. UniFormer's CBlock
    norms (a per-channel scale and shift in the JAX tree) become BatchNorms
    of that weight and bias. Converting the result again gives the tree
    back exactly."""
    if kind not in FOLDED_KINDS:
        raise KeyError(f"folded kind {kind!r}; have {FOLDED_KINDS}")
    eps = BN_EPS[kind]
    sd: StateDict = {}

    def put(name, a, layout="raw"):
        sd[name] = torch.from_numpy(np.array(port_layout(np.asarray(a, np.float32), layout)))

    def node(name, p, layout):  # {"w", "b"} or {"g", "b"}
        for leaf, v in p.items():
            put(f"{name}.{ {'w': 'weight', 'g': 'weight', 'b': 'bias'}[leaf] }", v,
                layout if leaf == "w" else "raw")

    def bn(name, scale, shift):
        c = np.asarray(shift).shape[0]
        put(f"{name}.weight", scale)
        put(f"{name}.bias", shift)
        put(f"{name}.running_mean", np.zeros(c, np.float32))
        put(f"{name}.running_var", np.full(c, 1.0 - eps, np.float32))
        if kind in _TRACKED:
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def folded(conv, norm, p):  # a folded {"w", "b"} conv
        put(f"{conv}.weight", p["w"], "conv")
        bn(norm, np.ones(np.asarray(p["b"]).shape[0], np.float32), p["b"])

    if kind == "mlsd_large":
        fb, bb = "backbone.features", params["backbone"]
        folded(f"{fb}.0.0", f"{fb}.0.1", bb["stem"])
        for idx, p in enumerate(bb["blocks"], start=1):
            base, off = f"{fb}.{idx}.conv", int("expand" in p)
            if off:
                folded(f"{base}.0.0", f"{base}.0.1", p["expand"])
            folded(f"{base}.{off}.0", f"{base}.{off}.1", p["dw"])
            folded(f"{base}.{off + 1}", f"{base}.{off + 2}", p["project"])
        for blk in range(15, 24):
            for ci in (1, 2):
                folded(f"block{blk}.conv{ci}.0", f"block{blk}.conv{ci}.1",
                       params[f"block{blk}"][f"conv{ci}"])
        node("block23.conv3", params["block23"]["conv3"], "conv")
    elif kind == "uniformer":
        for si, stage in enumerate(params["backbone"]["stages"], start=1):
            node(f"backbone.patch_embed{si}.proj", stage["patch_embed"], "conv")
            node(f"backbone.patch_embed{si}.norm", stage["patch_norm"], "raw")
            for bi, blk in enumerate(stage["blocks"]):
                base = f"backbone.blocks{si}.{bi}"
                node(f"{base}.pos_embed", blk["pos"], "conv")
                if "mix_in" in blk:  # CBlock
                    for part, sub in (("mix_in", "conv1"), ("mix_dw", "attn"),
                                      ("mix_out", "conv2"), ("mlp1", "mlp.fc1"),
                                      ("mlp2", "mlp.fc2")):
                        node(f"{base}.{sub}", blk[part], "conv")
                    for norm in ("norm1", "norm2"):
                        bn(f"{base}.{norm}", blk[norm]["g"], blk[norm]["b"])
                else:  # SABlock
                    for part, sub in (("norm1", "norm1"), ("qkv", "attn.qkv"),
                                      ("proj", "attn.proj"), ("norm2", "norm2"),
                                      ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
                        node(f"{base}.{sub}", blk[part],
                             "raw" if part.startswith("norm") else "linear")
        head, dh = params["decode_head"], "decode_head."
        modules = ([(f"psp_modules.{i}.1", p) for i, p in enumerate(head["ppm"])]
                   + [("bottleneck", head["bottleneck"]), ("fpn_bottleneck", head["fusion"])]
                   + [(f"lateral_convs.{i}", p) for i, p in enumerate(head["laterals"])]
                   + [(f"fpn_convs.{i}", p) for i, p in enumerate(head["fpn_convs"])])
        for name, p in modules:
            folded(f"{dh}{name}.conv", f"{dh}{name}.bn", p)
        node(f"{dh}conv_seg", head["classifier"], "conv")
    elif kind == "inception":
        for top, tree in params.items():
            for leaf, p in ([("", tree)] if "w" in tree else tree.items()):
                name = f"{top}.{leaf}" if leaf else top
                folded(f"{name}.conv", f"{name}.bn", p)
    else:  # yolov5: model.{i}. Conv blocks, C3s, SPPF and the Detect convs
        def block(prefix, p):
            folded(f"{prefix}.conv", f"{prefix}.bn", p["conv"])

        for key, tree in params.items():
            m = f"model.{key}"
            if key == "24":
                for i in range(3):
                    node(f"{m}.m.{i}", tree[f"m{i}"], "conv")
            elif "conv" in tree:
                block(m, tree)
            else:
                for part in ("cv1", "cv2", "cv3"):
                    if part in tree:
                        block(f"{m}.{part}", tree[part])
                for i, b in enumerate(tree.get("m", ())):
                    block(f"{m}.m.{i}.cv1", b["cv1"])
                    block(f"{m}.m.{i}.cv2", b["cv2"])
    return sd


# -------------------------------------------------------------------- T5


def t5_state_dict_from_jax(params) -> StateDict:
    """The weight carry of a JAX T5 tree (init_t5 / convert_t5's) into HF
    T5EncoderModel's names, the port's models/t5.py:T5Encoder's, fp32:
    token_embedding -> shared.weight, rel_bias -> block 0's
    relative_attention_bias, the (in, out) linears stored (out, in), the
    RMSNorm gains as layer_norm weights."""
    sd: StateDict = {}

    def put(name, a, layout="raw"):
        sd[name] = torch.from_numpy(np.array(port_layout(np.asarray(a, np.float32), layout)))

    put("shared.weight", params["token_embedding"])
    put("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
        params["rel_bias"])
    for i, p in enumerate(params["blocks"]):
        base = f"encoder.block.{i}.layer"
        for name in ("q", "k", "v", "o"):
            put(f"{base}.0.SelfAttention.{name}.weight", p[name]["w"], "linear")
        for name in ("wi_0", "wi_1", "wo"):
            put(f"{base}.1.DenseReluDense.{name}.weight", p[name]["w"], "linear")
        put(f"{base}.0.layer_norm.weight", p["norm1"]["g"])
        put(f"{base}.1.layer_norm.weight", p["norm2"]["g"])
    put("encoder.final_layer_norm.weight", params["final_norm"]["g"])
    return sd
