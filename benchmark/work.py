"""The work a request does, counted from the configuration's shapes alone:
model FLOPs (for `mfu`) and every attention call with its least time on the
card (for `kernels.attention_roofline`).

FLOPs are 2 a multiply-add of every convolution, linear layer and attention
product (Q K^T and P V) of the published request, as the reference
(`benchmark/reference/`) computes it: the text tower(s) over the cond and
uncond rows, `steps` evaluations of the nets on the batch-2 CFG concat
(ControlNet with its hint block, then the UNet; or SDXL's UNet with its ADM
input), the VAE decode. Norms, activations and the DDIM update are not
counted (they are not products); neither are biases. The program may do
less (it computes the cross-attention K/V and the hint embedding once a
request), never more of this work. Each family counts its own request
(`benchmark/families/<family>.py`: `flops_per_image`, `attention_calls`)
from the pieces here; a family of another architecture brings its own.

The attention sites and bounds are a frozen copy of the smoke test's
`attention_sites` / `attention_work` / `bound_ms`: each call's least time is
the larger of its operations over the bf16 tensor-core peak and its bytes
(q, k, v and o read or written once) over the memory bandwidth.
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import families

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def _depth(u, level):
    td = u["transformer_depth"]
    return td[level] if isinstance(td, list) else td


def _heads(u, ch):
    return ch // u["num_head_channels"] if u.get("num_head_channels") else u["num_heads"]


def _conv(cin, cout, k, hw):
    return 2 * cin * cout * k * k * hw


def _res(cin, cout, emb, hw):
    return (_conv(cin, cout, 3, hw) + 2 * emb * cout + _conv(cout, cout, 3, hw)
            + (_conv(cin, cout, 1, hw) if cin != cout else 0))


def _transformer(ch, depth, hw, ctx_len, ctx_dim):
    """One SpatialTransformer over one row: proj_in/out, and per block
    attn1 (q, k, v, out + products), attn2 (q, out; k, v of the context +
    products), GEGLU (ch -> 8 ch) and its output (4 ch -> ch)."""
    per_block = (2 * hw * ch * ch * (4 + 2 + 8 + 4) + 2 * 2 * ctx_len * ctx_dim * ch
                 + 4 * hw * hw * ch + 4 * hw * ctx_len * ch)
    return 2 * 2 * hw * ch * ch + depth * per_block


def _encoder(u, side, ctx_len, taps=False):
    """(FLOPs of one row through the input blocks and the middle block
    [and the ControlNet's zero convs], the skip channels)."""
    mc, emb = u["model_channels"], 4 * u["model_channels"]
    hw = side * side
    fl = _conv(u["in_channels"], mc, 3, hw) + (_conv(mc, mc, 1, hw) if taps else 0)
    ch, ds, chs = mc, 1, [mc]
    for level, m in enumerate(u["channel_mult"]):
        hw = (side // ds) ** 2
        for _ in range(u["num_res_blocks"]):
            fl += _res(ch, m * mc, emb, hw)
            ch = m * mc
            if ds in u["attention_resolutions"] and _depth(u, level) > 0:
                fl += _transformer(ch, _depth(u, level), hw, ctx_len, u["context_dim"])
            fl += _conv(ch, ch, 1, hw) if taps else 0
            chs.append(ch)
        if level != len(u["channel_mult"]) - 1:
            ds *= 2
            fl += _conv(ch, ch, 3, (side // ds) ** 2) + (
                _conv(ch, ch, 1, (side // ds) ** 2) if taps else 0)
            chs.append(ch)
    hw = (side // ds) ** 2
    last = len(u["channel_mult"]) - 1
    fl += 2 * _res(ch, ch, emb, hw) + _transformer(ch, _depth(u, last), hw, ctx_len,
                                                   u["context_dim"])
    fl += _conv(ch, ch, 1, hw) if taps else 0
    return fl, chs, ch, ds


def _embed(u):
    mc = u["model_channels"]
    fl = 2 * (mc * 4 * mc + 16 * mc * mc)
    if u.get("adm_in_channels"):
        fl += 2 * (u["adm_in_channels"] * 4 * mc + 16 * mc * mc)
    return fl


def unet_flops(u, side, ctx_len):
    """One row of the UNet at latent side `side`."""
    mc, emb = u["model_channels"], 4 * u["model_channels"]
    fl, chs, ch, ds = _encoder(u, side, ctx_len)
    for level, m in reversed(list(enumerate(u["channel_mult"]))):
        for i in range(u["num_res_blocks"] + 1):
            hw = (side // ds) ** 2
            fl += _res(ch + chs.pop(), m * mc, emb, hw)
            ch = m * mc
            if ds in u["attention_resolutions"] and _depth(u, level) > 0:
                fl += _transformer(ch, _depth(u, level), hw, ctx_len, u["context_dim"])
            if level != 0 and i == u["num_res_blocks"]:
                ds //= 2
                fl += _conv(ch, ch, 3, (side // ds) ** 2)
    return fl + _embed(u) + _conv(mc, u["out_channels"], 3, side * side)


def hint_block_flops(hint_channels, mc, res):
    convs = [(hint_channels, 16, 1), (16, 16, 1), (16, 32, 2), (32, 32, 1),
             (32, 96, 2), (96, 96, 1), (96, 256, 2), (256, mc, 1)]
    fl, side = 0, res
    for cin, cout, stride in convs:
        side //= stride
        fl += _conv(cin, cout, 3, side * side)
    return fl


def controlnet_flops(u, side, ctx_len, hint_channels, res):
    """One row of the ControlNet, its hint block included."""
    return (_encoder(u, side, ctx_len, taps=True)[0] + _embed(u)
            + hint_block_flops(hint_channels, u["model_channels"], res))


def vae_decode_flops(v, side):
    ch, mult, nrb = v["ch"], v["ch_mult"], v["num_res_blocks"]
    z, hw = v["z_channels"], side * side
    c = ch * mult[-1]
    fl = _conv(v["embed_dim"], z, 1, hw) + _conv(z, c, 3, hw)
    fl += 2 * _res(c, c, 0, hw) + 2 * 4 * hw * c * c + 4 * hw * hw * c
    for i in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            fl += _res(c, ch * mult[i], 0, hw)
            c = ch * mult[i]
        if i != 0:
            side *= 2
            hw = side * side
            fl += _conv(c, c, 3, hw)
    return fl + _conv(c, v["out_channels"], 3, hw)


def text_flops(t, rows):
    """`rows` rows through the layers the tower's output needs (all for
    "last" and for a pooled tower; all but the last for "penultimate_raw"),
    with the pooled projection where the tower has one."""
    d, inner, n, length = t["hidden_size"], t["intermediate_size"], t["num_layers"], \
        t["max_length"]
    if t["layer"] == "penultimate_raw" and not t.get("projection_dim"):
        n -= 1
    per_layer = 2 * length * (4 * d * d + 2 * d * inner) + 4 * length * length * d
    fl = rows * n * per_layer
    if t.get("projection_dim"):
        fl += rows * 2 * d * t["projection_dim"]
    return fl


def latent_side(cfg):
    """The latent's side: the request's resolution over the VAE's
    downsampling."""
    return cfg["sampling"]["resolution"] // 2 ** (len(cfg["vae"]["ch_mult"]) - 1)


def ldm_flops_per_image(cfg, per_row, text):
    """FLOPs of one image of a latent-diffusion request: `per_row` FLOPs of
    the nets a row, on the cond and uncond rows of every step, the text
    towers' `text` and the VAE decode."""
    return 2 * cfg["sampling"]["steps"] * per_row + text + vae_decode_flops(
        cfg["vae"], latent_side(cfg))


def model_flops_per_image(cfg):
    """FLOPs of one image of the configuration's request (see the module's
    docstring), as its family counts them (`flops_per_image`)."""
    return families.load(cfg["family"]).flops_per_image(cfg)


# ------------------------------------------------------- attention bounds


def attention_work(batch, heads, tq, s, head_dim, itemsize=2):
    """(operations, bytes) of one attention call: 2 products of 2*Tq*S*d
    each per head; q and o of Tq rows, k and v of S rows."""
    ops = 4 * batch * heads * tq * s * head_dim
    nbytes = 2 * batch * heads * head_dim * (tq + s) * itemsize
    return ops, nbytes


def bound_s(ops, nbytes):
    """The least time of a call, seconds: the larger of ops / peak and
    bytes / bandwidth."""
    return max(ops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def _unet_sites(u, side, ctx_len, copies_enc):
    """(channels, tokens, depth) of every transformer of one evaluation:
    the encoder's and middle block's `copies_enc` times (UNet and
    ControlNet), the decoder's once."""
    sites, ds, ch = [], 1, u["model_channels"]
    for level, m in enumerate(u["channel_mult"]):
        ch = m * u["model_channels"]
        if ds in u["attention_resolutions"] and _depth(u, level) > 0:
            sites += [(ch, (side // ds) ** 2, _depth(u, level))] * (
                u["num_res_blocks"] * copies_enc)
            sites += [(ch, (side // ds) ** 2, _depth(u, level))] * (u["num_res_blocks"] + 1)
        if level != len(u["channel_mult"]) - 1:
            ds *= 2
    last = len(u["channel_mult"]) - 1
    return sites + [(ch, (side // ds) ** 2, _depth(u, last))] * copies_enc


def ldm_attention_calls(cfg, towers, copies, batch):
    """Every attention call of `batch` requests of a latent-diffusion family
    as (batch, heads, Tq, S, head_dim), once each: the text `towers`, `steps`
    evaluations of the nets on the CFG concat (self- and cross-attention of
    every transformer block; the encoder's and middle block's `copies`
    times: 2 with a ControlNet), the VAE decoder's mid-block attention."""
    s, u, v = cfg["sampling"], cfg["unet"], cfg["vae"]
    side = latent_side(cfg)
    calls = []
    for t in towers:
        n = t["num_layers"] - (1 if t["layer"] == "penultimate_raw"
                               and not t.get("projection_dim") else 0)
        hd = t["hidden_size"] // t["num_heads"]
        calls += [(2 * batch, t["num_heads"], t["max_length"], t["max_length"], hd)] * n
    ctx_len = towers[0]["max_length"]
    for ch, tokens, depth in _unet_sites(u, side, ctx_len, copies):
        h = _heads(u, ch)
        for _ in range(s["steps"] * depth):
            calls.append((2 * batch, h, tokens, tokens, ch // h))
            calls.append((2 * batch, h, tokens, ctx_len, ch // h))
    c = v["ch"] * v["ch_mult"][-1]
    calls.append((batch, 1, side * side, side * side, c))
    return calls


def attention_calls(cfg, batch=1):
    """Every attention call of `batch` requests as (batch, heads, Tq, S,
    head_dim), once each, as the configuration's family lists them
    (`attention_calls`)."""
    return families.load(cfg["family"]).attention_calls(cfg, batch)


def attention_bound_s(cfg, batch=1):
    """The least time of every attention call of `batch` requests."""
    return sum(bound_s(*attention_work(*call)) for call in attention_calls(cfg, batch))
