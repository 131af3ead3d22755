"""Prompt front end beyond the 77-token path (counterpart of
stablediffusioneo_tpu/models/text_encoding.py).

  - Long prompts, the reference's `hack_everything` (cldm/hack.py:32-68):
    a prompt is tokenized without truncation, cut into windows of 75 tokens,
    each wrapped [BOS] + window + [EOS] and padded to 77; the windows run as
    one batched CLIP call and their contexts are concatenated to (B, windows
    x 77, hidden) (`runtime/engine.py:encode_prompt_windowed`).
  - Emphasis (A1111 syntax, beyond the reference): "(x)" scales a fragment's
    contexts by 1.1, "[x]" by 1/1.1, "(x:1.5)" by 1.5; groups nest by
    multiplication; "\\(" and "\\[" are literals. Each row's mean is restored
    after the scaling.
clip_skip needs nothing here: models/clip.py:clip_text_apply takes it.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import torch

from stablediffusioneo_tpu_torch.models.tokenizer import CLIPTokenizer


def tokenize_windowed(
    tokenizer: CLIPTokenizer,
    texts: List[str],
    windows: int = 3,
    window_body: Optional[int] = None,
) -> np.ndarray:
    """Tokenize without truncation, split into `windows` x (window_body)
    chunks, wrap each with SOT/EOT, pad with EOT to max_length.
    Returns (B, windows, max_length) int32 (hack.py:46-61; window_body=75
    for the real 77-token CLIP)."""
    if window_body is None:
        window_body = tokenizer.max_length - 2
    out = np.full((len(texts), windows, window_body + 2), tokenizer.eot, np.int32)
    for bi, text in enumerate(texts):
        raw = tokenizer.encode(text)
        for wi in range(windows):
            chunk = raw[window_body * wi: window_body * (wi + 1)]
            row = [tokenizer.sot] + chunk + [tokenizer.eot]
            out[bi, wi, : len(row)] = row
    return out


def needed_windows(
    tokenizer: CLIPTokenizer,
    texts: List[str],
    window_body: Optional[int] = None,
    max_windows: int = 3,
) -> int:
    """The fewest windows that hold the longest of `texts`: ceil(longest /
    75), clamped to [1, max_windows]. A 78-127-token prompt thus takes the
    2-window (154-token) contexts; CLIP's position table has 77 entries, so
    no window holds more."""
    if window_body is None:
        window_body = tokenizer.max_length - 2
    longest = max(len(tokenizer.encode(t)) for t in texts)
    return int(np.clip(-(-longest // window_body), 1, max_windows))


# ------------------------------------------------------- prompt emphasis

# an escaped bracket, a bracket, a well-formed ":w)" weight close ('1', '1.5',
# '.5'; a malformed ':1..5)' falls through to the literal alternatives), text
_EMPH_TOKEN = re.compile(
    r"\\[\\()\[\]]|\(|\)|\[|\]"
    r"|:\s*([+-]?(?:\d+(?:\.\d*)?|\.\d+))\s*\)"
    r"|[^\\()\[\]:]+|:")


def parse_prompt_attention(text: str):
    """-> [(fragment, weight)] with adjacent equal-weight fragments merged.

    A scan with a multiplier stack: '(' pushes x1.1, '[' pushes x(1/1.1),
    ':w)' rewrites the enclosing '(' group's multiplier to w, ')' / ']' pop.
    Escapes: '\\(' etc. emit the literal character. Unclosed groups keep
    their provisional multiplier; an unmatched closer is literal text."""
    out = []          # [[fragment, weight]]
    stack = []        # (index into out at group start, kind)
    weight = 1.0

    def emit(s, w):
        if s:
            out.append([s, w])

    def rescale(start, factor):
        for item in out[start:]:
            item[1] *= factor

    for m in _EMPH_TOKEN.finditer(text):
        tok = m.group(0)
        if tok.startswith("\\"):
            emit(tok[1:], weight)
        elif tok == "(":
            stack.append((len(out), "("))
            weight *= 1.1
        elif tok == "[":
            stack.append((len(out), "["))
            weight /= 1.1
        elif m.group(1) is not None:  # ":w)", an explicit weight close
            if stack and stack[-1][1] == "(":
                start, _ = stack.pop()
                rescale(start, float(m.group(1)) / 1.1)  # replaces the 1.1
                weight /= 1.1
            else:
                emit(tok, weight)
        elif tok == ")":
            if stack and stack[-1][1] == "(":
                stack.pop()
                weight /= 1.1
            else:
                emit(tok, weight)
        elif tok == "]":
            if stack and stack[-1][1] == "[":
                stack.pop()
                weight *= 1.1
            else:
                emit(tok, weight)
        else:
            emit(tok, weight)
    merged = []
    for s, w in out:
        if merged and abs(merged[-1][1] - w) < 1e-9:
            merged[-1][0] += s
        else:
            merged.append([s, w])
    return [(s, w) for s, w in merged] or [("", 1.0)]


def tokenize_weighted(tokenizer: CLIPTokenizer, texts: List[str]):
    """-> (ids (B, L) int32, weights (B, L) f32): per-token emphasis
    weights aligned with the padded token grid (SOT/EOT/pad = 1.0)."""
    L = tokenizer.max_length
    ids = np.full((len(texts), L), tokenizer.eot, np.int32)
    weights = np.ones((len(texts), L), np.float32)
    for i, text in enumerate(texts):
        toks, ws = [], []
        for frag, w in parse_prompt_attention(text):
            t = tokenizer.encode(frag)
            toks.extend(t)
            ws.extend([w] * len(t))
        toks, ws = toks[: L - 2], ws[: L - 2]
        ids[i, 0] = tokenizer.sot
        ids[i, 1:1 + len(toks)] = toks
        ids[i, 1 + len(toks)] = tokenizer.eot
        weights[i, 1:1 + len(ws)] = ws
    return ids, weights


def apply_emphasis(ctx: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """Scale contexts (B, L, hidden) by per-token weights (B, L), then
    restore each row's mean (the A1111 recipe: emphasis shifts the direction,
    not the overall magnitude): in fp32, z * (orig_mean / new_mean) in that
    order, cast back to ctx's dtype. Weights that are all 1 return ctx."""
    if np.allclose(weights, 1.0):
        return ctx
    w = torch.as_tensor(np.asarray(weights, np.float32), device=ctx.device)[..., None]
    c = ctx.float()
    orig_mean = c.mean(dim=(1, 2), keepdim=True)
    z = c * w
    new_mean = z.mean(dim=(1, 2), keepdim=True)
    return (z * (orig_mean / new_mean)).to(ctx.dtype)
