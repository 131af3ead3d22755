"""Textual inversion (counterpart of
stablediffusioneo_tpu/checkpoint/textual_inversion.py; An Image is Worth One
Word, arXiv:2208.01618): learned concept embeddings injected into a CLIP text
tower.

A concept is (k, d) embedding vectors for a placeholder word. Injection
appends the vectors to the tower's token-embedding table and registers the
placeholder with the tokenizer (models/tokenizer.py:add_placeholder) so that
it encodes to the k new ids; the rest of the tower is untouched, so a concept
composes with any prompt, window count and clip_skip. The grown table is a
new tensor: a captured CLIP engine holds the old one's address, so
`apply_textual_inversion` evicts exactly the runtime's CLIP engines (they are
captured again at their next use); the sampler, decoder and encoder engines
read no embedding table and stay.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn


def load_concept(path: str) -> Dict[str, np.ndarray]:
    """Read a textual-inversion file -> {placeholder: (k, d) f32}.

    Supported layouts:
      - A1111/sd-concepts .pt/.bin: {"string_to_param": {"*": (k, d)},
        "name": str}
      - diffusers .pt/.bin: {token: (d,) or (k, d)}
      - ours: .npz with one array per placeholder
    The .pt/.bin files are read with torch.load(weights_only=True): tensors,
    dicts, strings and numbers, which is all these layouts hold; a file that
    pickles other objects is refused by torch.
    """
    if path.endswith(".npz"):
        z = np.load(path)
        return {k: np.atleast_2d(np.asarray(z[k], np.float32))
                for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if "string_to_param" in obj:
        name = obj.get("name") or "<concept>"
        table = obj["string_to_param"]
        vec = table.get("*", next(iter(table.values())))
        return {name: np.atleast_2d(vec.detach().float().numpy())}
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            out[k] = np.atleast_2d(v.detach().float().numpy())
    if not out:
        raise ValueError(f"{path}: no embedding tensors found "
                         "(expected string_to_param or token->tensor)")
    return out


def token_embedding(clip: nn.Module) -> nn.Embedding:
    """The token-embedding table of a CLIPTextModel or OpenCLIPTextModel."""
    return (clip.token_embedding if hasattr(clip, "token_embedding")
            else clip.text_model.embeddings.token_embedding)


@torch.no_grad()
def add_concepts(clip: nn.Module, tokenizer, concepts: Dict) -> nn.Module:
    """Append each concept's vectors (in sorted placeholder order) to the
    tower's token-embedding table, in the table's dtype and on its device,
    and register each placeholder with the tokenizer. The table becomes a new
    tensor; everything else of the tower is untouched. Returns the tower.

    Vector width must match the tower's hidden size: a mismatched file
    (e.g. an SDXL embedding into SD-1.5) fails loudly."""
    emb = token_embedding(clip)
    table = emb.weight
    d = table.shape[1]
    rows = [table.data]
    base = table.shape[0]
    for word, vecs in sorted(concepts.items()):
        vecs = torch.as_tensor(np.asarray(vecs)).to(table.device, table.dtype)
        if vecs.dim() != 2 or vecs.shape[1] != d:
            raise ValueError(
                f"concept {word!r}: vectors {tuple(vecs.shape)} do not match the "
                f"text tower's hidden size {d}")
        tokenizer.add_placeholder(word, list(range(base, base + vecs.shape[0])))
        rows.append(vecs)
        base += vecs.shape[0]
    emb.weight = nn.Parameter(torch.cat(rows, dim=0), requires_grad=table.requires_grad)
    emb.num_embeddings = base
    return clip


def apply_textual_inversion(runtime, tokenizer, concepts: Dict) -> int:
    """Inject concepts into a LIVE runtime: grows the resident CLIP
    embedding table and evicts the runtime's CLIP engines (captured on the
    old table; they are built again at their next use). The samplers,
    decoders and encoders are untouched. Returns the number of new rows."""
    add_concepts(runtime._require_model().clip, tokenizer, concepts)
    for key in [k for k in runtime._engines if k[0] == "clip"]:
        del runtime._engines[key]
    return sum(np.atleast_2d(v).shape[0] for v in concepts.values())
