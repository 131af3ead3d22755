"""Token Merging (ToMe; Bolya & Hoffman, arXiv:2303.17604), counterpart of
stablediffusioneo_tpu/ops/tome.py.

Around a transformer block's self-attention, the src tokens most similar to
a dst token (the top-left token of each sy x sx cell) are averaged into it
before the attention and copied back after: the merged sequence is shorter
by r tokens. As in the JAX package the matching is deterministic (tomesd's
use_rand=False), r is a static function of the grid (`merge_count`, which
keeps the merged length a multiple of 128), and the merge metric is the
block input before norm1.

What a captured CUDA graph needs: the static index tensors of a grid are
made once per (h, w, sx, sy, device) (`_partition_tensors`), so a replay
copies nothing from the host; the sort is stable, as JAX's is; and the mean
into the dst tokens is a one-hot product in fp32 (a matmul, whose sums run
in a fixed order), not `index_add_`, whose float atomics on CUDA could make
a replay differ from the eager call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch


class ToMe(NamedTuple):
    """The merge settings a network evaluation runs with (UNetConfig's
    tome_* fields, the ratio possibly a request's)."""

    ratio: float
    min_tokens: int
    sx: int
    sy: int


def tome_of(ucfg, ratio: float = 0.0) -> Optional[ToMe]:
    """The settings of a UNetConfig with `ratio` in place of its own when
    nonzero (the JAX runtime's `_cfg_with_tome`); None when nothing merges."""
    ratio = float(ratio) or float(ucfg.tome_ratio)
    if ratio <= 0.0:
        return None
    return ToMe(ratio, ucfg.tome_min_tokens, ucfg.tome_sx, ucfg.tome_sy)


def _dst_src_partition(h: int, w: int, sx: int, sy: int):
    """Static partition of the h*w token grid: dst = top-left token of
    each sy x sx cell, src = the rest. Returns (dst_idx, src_idx) int32
    numpy arrays (sorted ascending), with dst_idx of size ceil(h/sy) *
    ceil(w/sx)."""
    rows = np.arange(h)
    cols = np.arange(w)
    is_dst = ((rows[:, None] % sy == 0) & (cols[None, :] % sx == 0))
    flat = is_dst.reshape(-1)
    dst_idx = np.nonzero(flat)[0].astype(np.int32)
    src_idx = np.nonzero(~flat)[0].astype(np.int32)
    return dst_idx, src_idx


def merge_count(h: int, w: int, ratio: float, sx: int = 2, sy: int = 2,
                align: int = 128) -> int:
    """The static merge count r for an h x w grid: floor(N * ratio),
    capped at the src-set size, then reduced so the merged length
    (N - r) is a multiple of `align` when possible (keeps the packed
    attention kernel dispatching). Returns 0 when nothing merges."""
    n = h * w
    dst_idx, src_idx = _dst_src_partition(h, w, sx, sy)
    r = min(int(n * ratio), len(src_idx))
    if align > 1 and n > align:
        # round the MERGED length (n - r) up to the alignment (merge
        # slightly fewer tokens than requested, never more); grids at or
        # below the alignment skip this — the packed kernel doesn't
        # dispatch at those sizes anyway (ops/attention._min_tq)
        kept = -(-(n - r) // align) * align
        r = max(n - kept, 0)
    return max(r, 0)


@functools.lru_cache(maxsize=64)
def _partition_tensors(h: int, w: int, sx: int, sy: int, device: torch.device):
    """(dst_idx, src_idx, perm) as int64 tensors on `device`, made once:
    perm takes the token order of concat([src, dst]) back to 0..N-1."""
    dst, src = _dst_src_partition(h, w, sx, sy)
    perm = np.argsort(np.concatenate([src, dst]))
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (dst, src, perm))


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) at per-sample token indices idx (B, M) -> (B, M, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def build_merge(metric: torch.Tensor, h: int, w: int, r: int,
                sx: int = 2, sy: int = 2):
    """Bipartite soft matching over the 2D grid (the JAX `build_merge`).

    metric: (B, N, C), N == h * w, the features the tokens are matched on.
    Returns (merge, unmerge, n_merged): merge (B, N, C') -> (B, N - r, C'),
    the unmerged srcs then the dsts with their merged srcs averaged in (in
    fp32); unmerge (B, N - r, C') -> (B, N, C'), each merged src taking its
    dst's value. Both apply to any tensor of the same token layout."""
    b, n, _ = metric.shape
    if n != h * w:
        raise ValueError(f"{n} tokens for a {h}x{w} grid")
    dst_idx, src_idx, perm = _partition_tensors(h, w, sx, sy, metric.device)
    n_dst, n_src = dst_idx.numel(), src_idx.numel()
    if not 0 < r <= n_src:
        raise ValueError(f"merge count {r} outside (0, {n_src}]")
    n_unm = n_src - r

    mf = metric.float()
    mf = mf / torch.clamp(torch.linalg.vector_norm(mf, dim=-1, keepdim=True), min=1e-12)
    scores = torch.matmul(mf.index_select(1, src_idx),
                          mf.index_select(1, dst_idx).transpose(1, 2))  # (B, n_src, n_dst)
    node_max, node_idx = scores.max(dim=-1)
    # the most similar srcs merge: descending, ties in token order (stable)
    order = torch.argsort(-node_max, dim=-1, stable=True)
    merged_sl, unm_sl = order[:, :r], order[:, r:]
    dst_of_merged = torch.gather(node_idx, 1, merged_sl)
    src_b = src_idx.expand(b, n_src)
    glob_unm = torch.gather(src_b, 1, unm_sl)
    glob_mrg = torch.gather(src_b, 1, merged_sl)
    # (B, n_dst, r) one-hot of each merged src's dst: the sum into the dsts
    # as a product, and the counts as its row sums
    onehot = (dst_of_merged[:, None, :]
              == torch.arange(n_dst, device=metric.device)[None, :, None]).float()
    counts = onehot.sum(dim=-1, keepdim=True) + 1.0

    def merge(x: torch.Tensor) -> torch.Tensor:
        dst = x.index_select(1, dst_idx).float()
        summed = dst + torch.matmul(onehot, _take_rows(x, glob_mrg).float())
        return torch.cat([_take_rows(x, glob_unm), (summed / counts).to(x.dtype)], dim=1)

    # each src slot's row of the merged sequence: unmerged slot j -> j,
    # merged slot -> n_unm + its dst; the dsts follow the unmerged srcs
    src_pos = torch.empty((b, n_src), dtype=torch.int64, device=metric.device)
    src_pos.scatter_(1, unm_sl, torch.arange(n_unm, device=metric.device).expand(b, n_unm))
    src_pos.scatter_(1, merged_sl, n_unm + dst_of_merged)
    dst_pos = (n_unm + torch.arange(n_dst, device=metric.device)).expand(b, n_dst)
    full_pos = torch.cat([src_pos, dst_pos], dim=1)[:, perm]

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        return _take_rows(y, full_pos)

    return merge, unmerge, n - r
