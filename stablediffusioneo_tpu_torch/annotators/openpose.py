"""OpenPose body / hand annotator of the port (counterpart of
stablediffusioneo_tpu/annotators/openpose.py): the CMU nets as nn.Modules,
the JAX package's numpy decode.

  - `BodyPoseModel` (the reference's bodypose_model, model.py:24-130): a VGG
    trunk, then 6 refinement stages of two branches, PAFs (38 channels,
    "L1") and part heatmaps (19, "L2"), each stage taking concat(paf, heat,
    trunk features); `HandPoseModel` (model.py:131-219): a deeper trunk and
    6 stages of 22 heatmaps. Both are built from the JAX package's spec
    tables, under the upstream names (`model0.conv1_1`, `model2_1.
    Mconv1_stage2_L1`, ...; `model1_0.*`, `model{2..6}.*` for the hand:
    body_pose_model.pth's 184 keys, hand_pose_model.pth's 102); the 2x2
    max-pools floor, as the JAX VALID pool.
  - The decode (peak finding, PAF limb scoring, person assembly, hand boxes
    and peaks, drawing, the composed upsample matrices and `_VirtualMap`) is
    the JAX package's code as it stands (held line for line by
    tests/test_torch_imports.py).
  - `OpenposeDetector` keeps the JAX single-scale fused decode: on the
    device, the body net, the two composed cubic-upsample + gaussian
    matrices and the 4-neighbour peak mask; the host takes the net-size maps
    and the mask (as tensors: the JAX package bit-packs the mask into one
    byte blob, a transfer trick for a network-attached TPU) and samples the
    virtual full-size maps exactly. `_infer_maps` keeps the reference's
    materialised multi-scale chain.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.annotators._dtype import cast_module, default_device

# ---------------------------------------------------------------- net specs

# (name, cin, cout, kernel, pad, relu)
_BODY_TRUNK = [
    ("conv1_1", 3, 64, 3, 1, True), ("conv1_2", 64, 64, 3, 1, True), ("pool", 0, 0, 0, 0, False),
    ("conv2_1", 64, 128, 3, 1, True), ("conv2_2", 128, 128, 3, 1, True), ("pool", 0, 0, 0, 0, False),
    ("conv3_1", 128, 256, 3, 1, True), ("conv3_2", 256, 256, 3, 1, True),
    ("conv3_3", 256, 256, 3, 1, True), ("conv3_4", 256, 256, 3, 1, True), ("pool", 0, 0, 0, 0, False),
    ("conv4_1", 256, 512, 3, 1, True), ("conv4_2", 512, 512, 3, 1, True),
    ("conv4_3_CPM", 512, 256, 3, 1, True), ("conv4_4_CPM", 256, 128, 3, 1, True),
]


def _stage1_spec(branch: str, cout: int):
    return [
        (f"conv5_1_CPM_{branch}", 128, 128, 3, 1, True),
        (f"conv5_2_CPM_{branch}", 128, 128, 3, 1, True),
        (f"conv5_3_CPM_{branch}", 128, 128, 3, 1, True),
        (f"conv5_4_CPM_{branch}", 128, 512, 1, 0, True),
        (f"conv5_5_CPM_{branch}", 512, cout, 1, 0, False),
    ]


def _stageN_spec(stage: int, branch: str, cin: int, cout: int):
    return [
        (f"Mconv1_stage{stage}_{branch}", cin, 128, 7, 3, True),
        (f"Mconv2_stage{stage}_{branch}", 128, 128, 7, 3, True),
        (f"Mconv3_stage{stage}_{branch}", 128, 128, 7, 3, True),
        (f"Mconv4_stage{stage}_{branch}", 128, 128, 7, 3, True),
        (f"Mconv5_stage{stage}_{branch}", 128, 128, 7, 3, True),
        (f"Mconv6_stage{stage}_{branch}", 128, 128, 1, 0, True),
        (f"Mconv7_stage{stage}_{branch}", 128, cout, 1, 0, False),
    ]


# hand net: trunk deeper (to conv5_2), 22-channel heatmaps
_HAND_TRUNK = _BODY_TRUNK[:12] + [
    ("conv4_3", 512, 512, 3, 1, True), ("conv4_4", 512, 512, 3, 1, True),
    ("conv5_1", 512, 512, 3, 1, True), ("conv5_2", 512, 512, 3, 1, True),
    ("conv5_3_CPM", 512, 128, 3, 1, True),
]


def _hand_stage1():
    return [
        ("conv6_1_CPM", 128, 512, 1, 0, True),
        ("conv6_2_CPM", 512, 22, 1, 0, False),
    ]


def _hand_stageN(stage: int):
    return [
        (f"Mconv1_stage{stage}", 150, 128, 7, 3, True),
        (f"Mconv2_stage{stage}", 128, 128, 7, 3, True),
        (f"Mconv3_stage{stage}", 128, 128, 7, 3, True),
        (f"Mconv4_stage{stage}", 128, 128, 7, 3, True),
        (f"Mconv5_stage{stage}", 128, 128, 7, 3, True),
        (f"Mconv6_stage{stage}", 128, 128, 1, 0, True),
        (f"Mconv7_stage{stage}", 128, 22, 1, 0, False),
    ]


class SpecNet(nn.Sequential):
    """One spec table as a module: convs under their names (the upstream
    keys), a 2x2 max-pool at each "pool", ReLU where the spec says."""

    def __init__(self, spec):
        layers = OrderedDict()
        for i, (name, cin, cout, k, pad, relu) in enumerate(spec):
            if name == "pool":
                layers[f"pool{i}"] = nn.MaxPool2d(2, 2)
                continue
            layers[name] = nn.Conv2d(cin, cout, k, padding=pad)
            if relu:
                layers[f"relu_{name}"] = nn.ReLU()
        super().__init__(layers)


class BodyPoseModel(nn.Module):
    """x (N, 3, H, W) preprocessed -> (paf (N, 38, h, w), heat (N, 19, h, w))."""

    def __init__(self):
        super().__init__()
        self.model0 = SpecNet(_BODY_TRUNK)
        self.model1_1 = SpecNet(_stage1_spec("L1", 38))
        self.model1_2 = SpecNet(_stage1_spec("L2", 19))
        for s in range(2, 7):
            setattr(self, f"model{s}_1", SpecNet(_stageN_spec(s, "L1", 185, 38)))
            setattr(self, f"model{s}_2", SpecNet(_stageN_spec(s, "L2", 185, 19)))

    def forward(self, x):
        feats = self.model0(x)
        paf, heat = self.model1_1(feats), self.model1_2(feats)
        for s in range(2, 7):
            inp = torch.cat([paf, heat, feats], dim=1)
            paf = getattr(self, f"model{s}_1")(inp)
            heat = getattr(self, f"model{s}_2")(inp)
        return paf, heat


class HandPoseModel(nn.Module):
    """x (N, 3, H, W) preprocessed -> heatmaps (N, 22, h, w)."""

    def __init__(self):
        super().__init__()
        self.model1_0 = SpecNet(_HAND_TRUNK)
        self.model1_1 = SpecNet(_hand_stage1())
        for s in range(2, 7):
            setattr(self, f"model{s}", SpecNet(_hand_stageN(s)))

    def forward(self, x):
        feats = self.model1_0(x)
        heat = self.model1_1(feats)
        for s in range(2, 7):
            heat = getattr(self, f"model{s}")(torch.cat([heat, feats], dim=1))
        return heat


def _seeded(cls, generator: Optional[torch.Generator], seed: int):
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    generator = generator or torch.Generator().manual_seed(seed)
    with torch.device(generator.device):
        net = cls()
    init_weights(net, generator)
    return net


def init_body(generator: Optional[torch.Generator] = None) -> BodyPoseModel:
    """A body net with weights drawn from `generator` (default seed 0)."""
    return _seeded(BodyPoseModel, generator, 0)


def init_hand(generator: Optional[torch.Generator] = None) -> HandPoseModel:
    """A hand net with weights drawn from `generator` (default seed 1)."""
    return _seeded(HandPoseModel, generator, 1)


def _preprocess(u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> the CMU input u8 / 256 - 0.5, NCHW, in dtype."""
    return (u8.to(dtype) / 256.0 - 0.5).permute(0, 3, 1, 2)


# ------------------------------------------------------------ decode (numpy)

# COCO-18 limb pairs and their PAF channel pairs (public CMU convention)
LIMB_PAIRS = [
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9), (9, 10),
    (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
    (2, 16), (5, 17),
]
PAF_CHANNELS = [
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35),
    (32, 33), (36, 37), (18, 19), (26, 27),
]


def _cv2_cubic_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) matrix W with W @ v == cv2.resize(v, INTER_CUBIC) along
    one axis for float input: half-pixel centers, Keys kernel A=-0.75
    (cv2's bicubic), replicate-clamped borders. Linear, so chained resizes
    compose by matrix product — the device upsample path uses this to
    reproduce the reference's two-stage cv2 chain exactly (~1e-5)."""
    scale = src / dst
    A = -0.75
    W = np.zeros((dst, src), np.float32)
    for i in range(dst):
        sx = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(sx))
        f = sx - x0
        for t in (-1, 0, 1, 2):
            d = abs(f - t)
            if d <= 1.0:
                w = ((A + 2.0) * d - (A + 3.0)) * d * d + 1.0
            elif d < 2.0:
                w = (((d - 5.0) * d + 8.0) * d - 4.0) * A
            else:
                w = 0.0
            W[i, min(max(x0 + t, 0), src - 1)] += w
    return W


def _upsample_matrices(small_h: int, small_w: int, padded_h: int,
                       padded_w: int, scaled_h: int, scaled_w: int,
                       h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis matrices reproducing body.py's upsample chain: net output
    -> cv2 cubic to the padded size -> crop to the scaled size -> cv2
    cubic to the image size. All three stages are linear maps, so the
    composition is one (h, small_h) x (w, small_w) matrix pair."""
    wy = _cv2_cubic_weights(scaled_h, h) @ \
        _cv2_cubic_weights(small_h, padded_h)[:scaled_h]
    wx = _cv2_cubic_weights(scaled_w, w) @ \
        _cv2_cubic_weights(small_w, padded_w)[:scaled_w]
    return wy, wx


def _gaussian_matrix(n: int) -> np.ndarray:
    """(n, n) matrix applying the sigma=3 25-tap gaussian with cv2
    BORDER_REFLECT semantics along one axis — the linear form of
    `_gaussian_sigma3`, composable with the cubic upsample matrices so the
    device decode smooths for free inside the same matmul pair."""
    k = cv2.getGaussianKernel(25, 3).astype(np.float32)[:, 0]
    G = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(-12, 13):
            j = i + t
            while j < 0 or j >= n:  # repeated reflection for n < radius
                j = -j - 1 if j < 0 else 2 * n - j - 1
            G[i, j] += k[t + 12]
    return G


class _VirtualMap:
    """Lazily evaluates the full-res upsampled map `wy @ small @ wx.T`
    at individual (y, x, c) points — exactly the values the materialized
    cv2 resize chain would hold, without building or fetching the
    (h, w, C) array. Supports the `m[ys, xs, c]` indexing `score_limbs`
    uses (ys/xs int arrays or scalars, c a channel index)."""

    def __init__(self, small: np.ndarray, wy: np.ndarray, wx: np.ndarray):
        self.small = np.asarray(small, np.float32)  # (sh, sw, C)
        self.wy = wy    # (h, sh)
        self.wx = wx    # (w, sw)

    def __getitem__(self, idx):
        ys, xs, c = idx
        ys = np.atleast_1d(np.asarray(ys, np.int64))
        xs = np.atleast_1d(np.asarray(xs, np.int64))
        m = self.small[:, :, c]                       # (sh, sw)
        # val_k = wy[ys[k]] @ m @ wx[xs[k]]
        return np.einsum("ks,sw,kw->k", self.wy[ys], m, self.wx[xs],
                         optimize=True)


def peaks_from_mask(mask: np.ndarray, heat_small: np.ndarray,
                    wy: np.ndarray, wx: np.ndarray) -> List[List[Tuple]]:
    """find_peaks from a device-computed peak mask (h, w, 18) plus the
    net-resolution heatmaps: peak coords come from the mask, peak scores
    from the virtual raw upsampled map at those coords (identical values
    to indexing the materialized full-res map)."""
    all_peaks: List[List[Tuple]] = []
    peak_id = 0
    for part in range(18):
        ys, xs = np.nonzero(mask[:, :, part])
        if len(ys):
            vm = _VirtualMap(heat_small, wy, wx)
            scores = vm[ys, xs, part]
        peaks = []
        for k, (x, y) in enumerate(zip(xs, ys)):
            peaks.append((int(x), int(y), float(scores[k]), peak_id))
            peak_id += 1
        all_peaks.append(peaks)
    return all_peaks


def _gaussian_sigma3(stack: np.ndarray) -> np.ndarray:
    """sigma=3 gaussian over the leading two axes of (h, w, c) f32.

    Numerically identical to scipy.ndimage.gaussian_filter(sigma=3) per
    channel (reflect border, truncate=4 -> radius 12 -> 25-tap kernel;
    verified max |diff| 2.4e-7 on random 512^2 maps) but ~7x faster on one
    host core — the decode used to spend ~200 ms/frame here at 512^2.
    """
    k = cv2.getGaussianKernel(25, 3).astype(np.float32)
    return cv2.sepFilter2D(stack, -1, k, k, borderType=cv2.BORDER_REFLECT)


def find_peaks(heatmap: np.ndarray, thresh: float = 0.1) -> List[List[Tuple]]:
    """Per-part peak lists [(x, y, score, id), ...] from (h, w, 19) maps."""
    m = _gaussian_sigma3(np.ascontiguousarray(heatmap[:, :, :18], np.float32))
    # 4-neighbour local-max with zero padding at the borders, expressed as
    # sliced in-place ANDs (no shifted full-map temporaries). Border rows
    # compare against implicit 0, which `m > thresh` already subsumes for
    # the positive thresholds this decoder uses.
    is_peak = m > thresh
    is_peak[1:, :] &= m[1:, :] >= m[:-1, :]
    is_peak[:-1, :] &= m[:-1, :] >= m[1:, :]
    is_peak[:, 1:] &= m[:, 1:] >= m[:, :-1]
    is_peak[:, :-1] &= m[:, :-1] >= m[:, 1:]
    all_peaks = []
    peak_id = 0
    for part in range(18):
        ys, xs = np.nonzero(is_peak[:, :, part])
        peaks = []
        for x, y in zip(xs, ys):
            peaks.append((int(x), int(y), float(heatmap[y, x, part]), peak_id))
            peak_id += 1
        all_peaks.append(peaks)
    return all_peaks


def score_limbs(
    paf: np.ndarray,
    all_peaks: List[List[Tuple]],
    img_h: int,
    n_samples: int = 10,
    paf_thresh: float = 0.05,
) -> List[np.ndarray]:
    """Greedy limb matching via PAF line integrals. Returns per-limb arrays
    of (peak_id_a, peak_id_b, score, idx_a, idx_b)."""
    connections = []
    for limb_idx, (pa, pb) in enumerate(LIMB_PAIRS):
        ca, cb = PAF_CHANNELS[limb_idx]
        cand_a = all_peaks[pa]
        cand_b = all_peaks[pb]
        if not cand_a or not cand_b:
            connections.append(np.zeros((0, 5)))
            continue
        scored = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                vec = np.asarray([b[0] - a[0], b[1] - a[1]], np.float64)
                norm = max(np.linalg.norm(vec), 1e-6)
                u = vec / norm
                xs = np.linspace(a[0], b[0], n_samples)
                ys = np.linspace(a[1], b[1], n_samples)
                px = paf[ys.round().astype(int), xs.round().astype(int), ca]
                py = paf[ys.round().astype(int), xs.round().astype(int), cb]
                align = px * u[0] + py * u[1]
                # distance prior: penalize limbs longer than half the image
                prior = min(0.5 * img_h / norm - 1.0, 0.0)
                score = float(align.mean() + prior)
                ok = (align > paf_thresh).sum() > 0.8 * n_samples and score > 0
                if ok:
                    scored.append((i, j, score))
        scored.sort(key=lambda t: -t[2])
        used_a, used_b = set(), set()
        conn = []
        for i, j, s in scored:
            if i in used_a or j in used_b:
                continue
            used_a.add(i)
            used_b.add(j)
            conn.append([cand_a[i][3], cand_b[j][3], s, i, j])
        connections.append(np.asarray(conn).reshape(-1, 5))
    return connections


def assemble_people(
    all_peaks: List[List[Tuple]],
    connections: List[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge limbs into person `subset` rows (20 cols: 18 part peak-ids,
    total score, part count) + flat `candidate` (x, y, score, id) array."""
    candidate = np.asarray(
        [p for peaks in all_peaks for p in peaks], np.float64
    ).reshape(-1, 4)
    subset = np.empty((0, 20))
    for limb_idx, (pa, pb) in enumerate(LIMB_PAIRS):
        conn = connections[limb_idx]
        for row in conn:
            ida, idb, score = row[0], row[1], row[2]
            found = []
            for si, s in enumerate(subset):
                if s[pa] == ida or s[pb] == idb:
                    found.append(si)
            if len(found) == 1:
                s = subset[found[0]]
                if s[pb] != idb:
                    s[pb] = idb
                    s[19] += 1
                    s[18] += candidate[int(idb), 2] + score
                elif s[pa] != ida:
                    s[pa] = ida
                    s[19] += 1
                    s[18] += candidate[int(ida), 2] + score
            elif len(found) == 2:
                s1, s2 = subset[found[0]], subset[found[1]]
                overlap = ((s1[:18] >= 0) & (s2[:18] >= 0)).sum()
                if overlap == 0:  # disjoint people: merge
                    s1[:18] = np.where(s2[:18] >= 0, s2[:18], s1[:18])
                    s1[18:] += s2[18:]
                    s1[18] += score
                    subset = np.delete(subset, found[1], axis=0)
                else:
                    s1[pb] = idb
                    s1[19] += 1
                    s1[18] += candidate[int(idb), 2] + score
            elif limb_idx < 17:
                row20 = -1 * np.ones(20)
                row20[pa] = ida
                row20[pb] = idb
                row20[19] = 2
                row20[18] = candidate[int(ida), 2] + candidate[int(idb), 2] + score
                subset = np.vstack([subset, row20])
    # prune weak/small people
    keep = [
        i for i, s in enumerate(subset)
        if s[19] >= 4 and s[18] / max(s[19], 1) >= 0.4
    ]
    return candidate, subset[keep]


# -------------------------------------------------------------- hand decode

# hand skeleton edges (public CMU 21-keypoint convention)
HAND_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
    (15, 16), (0, 17), (17, 18), (18, 19), (19, 20),
]


def hand_detect(
    candidate: np.ndarray, subset: np.ndarray, img_h: int, img_w: int
) -> List[Tuple[int, int, int, bool]]:
    """Derive square hand boxes from body keypoints (the openpose
    handDetector.cpp recipe, mirrored by annotator/openpose/util.py
    handDetect:94-156): box center = wrist + 0.33*(wrist - elbow), box
    width = 1.5 * max(|wrist-elbow|, 0.9*|elbow-shoulder|), clipped to the
    image; boxes under 20 px are dropped. Returns (x, y, w, is_left) with
    (x, y) the top-left corner.

    Keypoint trios: right arm = parts (2, 3, 4), left arm = (5, 6, 7)."""
    ratio_wrist_elbow = 0.33
    boxes = []
    for person in subset.astype(int):
        arms = []
        if not np.any(person[[5, 6, 7]] == -1):  # left: shoulder/elbow/wrist
            arms.append((person[5], person[6], person[7], True))
        if not np.any(person[[2, 3, 4]] == -1):  # right
            arms.append((person[2], person[3], person[4], False))
        for sh, el, wr, is_left in arms:
            x1, y1 = candidate[sh][:2]
            x2, y2 = candidate[el][:2]
            x3, y3 = candidate[wr][:2]
            x = x3 + ratio_wrist_elbow * (x3 - x2)
            y = y3 + ratio_wrist_elbow * (y3 - y2)
            d_we = math.hypot(x3 - x2, y3 - y2)
            d_es = math.hypot(x2 - x1, y2 - y1)
            width = 1.5 * max(d_we, 0.9 * d_es)
            x -= width / 2
            y -= width / 2
            x, y = max(x, 0.0), max(y, 0.0)
            width = min(
                width,
                img_w - x if x + width > img_w else width,
                img_h - y if y + width > img_h else width,
            )
            if width >= 20:
                boxes.append((int(x), int(y), int(width), is_left))
    return boxes


def decode_hand_peaks(heatmap: np.ndarray, thresh: float = 0.05) -> np.ndarray:
    """(h, w, 22) averaged hand heatmaps -> (21, 2) int [x, y] peaks in crop
    coordinates; [0, 0] for parts below threshold. Mirrors hand.py:58-73:
    smooth, keep the connected component with the largest total activation,
    take its argmax."""
    from scipy.ndimage import label as cc_label

    all_smoothed = _gaussian_sigma3(
        np.ascontiguousarray(heatmap[:, :, :21], np.float32))
    peaks = np.zeros((21, 2), np.int64)
    eight = np.ones((3, 3), np.int32)  # 8-connectivity (skimage ndim default)
    for part in range(21):
        m = heatmap[:, :, part].copy()
        smoothed = all_smoothed[:, :, part]
        binary = smoothed > thresh
        if not binary.any():
            continue
        labels, n = cc_label(binary, structure=eight)
        sums = [m[labels == i].sum() for i in range(1, n + 1)]
        best = int(np.argmax(sums)) + 1
        m[labels != best] = 0
        y, x = np.unravel_index(np.argmax(m), m.shape)
        peaks[part] = (x, y)
    return peaks


# ------------------------------------------------------------------ drawing

_BODY_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
]


def draw_bodypose(canvas: np.ndarray, candidate: np.ndarray, subset: np.ndarray
                  ) -> np.ndarray:
    """Skeleton rendering (annotator/openpose/util.py draw_bodypose)."""
    for limb_idx in range(17):
        pa, pb = LIMB_PAIRS[limb_idx]
        for s in subset:
            ia, ib = int(s[pa]), int(s[pb])
            if ia < 0 or ib < 0:
                continue
            xa, ya = candidate[ia, :2]
            xb, yb = candidate[ib, :2]
            mx, my = (xa + xb) / 2, (ya + yb) / 2
            length = math.hypot(xa - xb, ya - yb)
            angle = math.degrees(math.atan2(yb - ya, xb - xa))
            poly = cv2.ellipse2Poly(
                (int(mx), int(my)), (int(length / 2), 4), int(angle), 0, 360, 1
            )
            cv2.fillConvexPoly(canvas, poly, _BODY_COLORS[limb_idx % 18])
    canvas = (canvas * 0.6).astype(np.uint8)
    for part in range(18):
        for s in subset:
            idx = int(s[part])
            if idx < 0:
                continue
            x, y = candidate[idx, :2]
            cv2.circle(canvas, (int(x), int(y)), 4, _BODY_COLORS[part], thickness=-1)
    return canvas


def draw_handpose(canvas: np.ndarray, all_hand_peaks: Sequence[np.ndarray]
                  ) -> np.ndarray:
    """Hand skeleton rendering (util.py draw_handpose:74-90): each of the 20
    edges gets an HSV hue by edge index; every keypoint (including the [0,0]
    sentinels — a reference quirk kept for parity) gets a red dot."""
    import colorsys

    for peaks in all_hand_peaks:
        peaks = np.asarray(peaks)
        for ie, (a, b) in enumerate(HAND_EDGES):
            # skip if either endpoint is the [0, 0] "not found" sentinel
            if np.all(peaks[a] == 0) or np.all(peaks[b] == 0):
                continue
            rgb = colorsys.hsv_to_rgb(ie / len(HAND_EDGES), 1.0, 1.0)
            color = tuple(int(c * 255) for c in rgb)
            cv2.line(canvas, (int(peaks[a][0]), int(peaks[a][1])),
                     (int(peaks[b][0]), int(peaks[b][1])), color, thickness=2)
        for x, y in peaks:
            cv2.circle(canvas, (int(x), int(y)), 4, (0, 0, 255), thickness=-1)
    return canvas


class OpenposeDetector:
    """Drop-in OpenposeDetector (annotator/openpose/__init__.py:21-50):
    uint8 HWC RGB image -> (pose canvas uint8, {candidate, subset}).
    body_params / hand_params: state dicts under the upstream names
    (checkpoint/convert.py:annotator_state_dict_from_jax); body_ckpt /
    hand_ckpt: body_pose_model.pth / hand_pose_model.pth, read by
    checkpoint/torch_reader.py; neither: seeded weights (seeds 0 and 1).
    device: the card unless the caller names another."""

    BOX_SIZE = 368
    STRIDE = 8
    PEAK_THRESH = 0.1  # find_peaks default (body.py threshold)

    # hand-net multi-scale search (hand.py:27): the crop is square, so scaled
    # inputs are exactly scale * 368 px
    HAND_SCALES = (0.5, 1.0, 1.5, 2.0)

    def __init__(
        self,
        body_params: Optional[Mapping] = None,
        body_ckpt: Optional[str] = None,
        hand_params: Optional[Mapping] = None,
        hand_ckpt: Optional[str] = None,
        device=None,
    ):
        from stablediffusioneo_tpu_torch.checkpoint.accounting import load_strict
        from stablediffusioneo_tpu_torch.checkpoint.torch_reader import load_torch_state_dict

        self.device = default_device(device)

        def net(params, ckpt, cls, init, tag):
            if params is None and ckpt is not None:
                params = load_torch_state_dict(ckpt)
            if params is None:
                return cast_module(init(), self.device)
            m = cls()
            load_strict(m, params, tag)
            return cast_module(m, self.device)

        # paf / heat come back fp32: the host peak / limb decode stays exact
        self.body = net(body_params, body_ckpt, BodyPoseModel, init_body, "openpose_body")
        self.hand = net(hand_params, hand_ckpt, HandPoseModel, init_hand, "openpose_hand")
        self.dtype = self.body.model0.conv1_1.weight.dtype
        self._mat_cache: Dict[Tuple, Tuple] = {}

    def _body_maps(self, padded: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 -> the body net's (h, w, 57) fp32 maps, paf then
        heat, on the device."""
        u8 = torch.from_numpy(np.ascontiguousarray(padded[None])).to(self.device)
        paf, heat = self.body(_preprocess(u8, self.dtype))
        return torch.cat([paf, heat], dim=1).float()[0].permute(1, 2, 0)

    @torch.no_grad()
    def _infer_maps(self, img: np.ndarray, scales=(0.5,)) -> Tuple[np.ndarray, np.ndarray]:
        h, w = img.shape[:2]
        heat_avg = np.zeros((h, w, 19), np.float32)
        paf_avg = np.zeros((h, w, 38), np.float32)
        for scale in scales:
            s = scale * self.BOX_SIZE / h
            scaled = cv2.resize(img, (0, 0), fx=s, fy=s, interpolation=cv2.INTER_CUBIC)
            pad_h = (self.STRIDE - scaled.shape[0] % self.STRIDE) % self.STRIDE
            pad_w = (self.STRIDE - scaled.shape[1] % self.STRIDE) % self.STRIDE
            padded = np.pad(scaled, ((0, pad_h), (0, pad_w), (0, 0)), constant_values=128)
            both = np.ascontiguousarray(self._body_maps(padded).cpu().numpy())
            paf, heat = both[:, :, :38], both[:, :, 38:]
            up = lambda m: cv2.resize(
                m, (w, h), interpolation=cv2.INTER_CUBIC
            )
            heat_full = cv2.resize(
                heat, (padded.shape[1], padded.shape[0]), interpolation=cv2.INTER_CUBIC
            )[: scaled.shape[0], : scaled.shape[1]]
            paf_full = cv2.resize(
                paf, (padded.shape[1], padded.shape[0]), interpolation=cv2.INTER_CUBIC
            )[: scaled.shape[0], : scaled.shape[1]]
            heat_avg += up(heat_full) / len(scales)
            paf_avg += up(paf_full) / len(scales)
        return paf_avg, heat_avg

    def _decode_matrices(self, h: int, w: int, scale: float):
        """Cached per (h, w, scale): the raw upsample matrices (host virtual
        sampling) and their gaussian-composed copies on the device (the peak
        mask)."""
        key = (h, w, scale)
        if key not in self._mat_cache:
            s = scale * self.BOX_SIZE / h
            sh, sw = int(round(h * s)), int(round(w * s))
            ph = sh + (self.STRIDE - sh % self.STRIDE) % self.STRIDE
            pw = sw + (self.STRIDE - sw % self.STRIDE) % self.STRIDE
            wy, wx = _upsample_matrices(ph // self.STRIDE, pw // self.STRIDE,
                                        ph, pw, sh, sw, h, w)
            wyg = torch.from_numpy(_gaussian_matrix(h) @ wy).to(self.device)
            wxg = torch.from_numpy(_gaussian_matrix(w) @ wx).to(self.device)
            self._mat_cache[key] = (wy, wx, wyg, wxg, (sh, sw), (ph, pw))
        return self._mat_cache[key]

    def _peak_mask(self, both: torch.Tensor, wyg: torch.Tensor,
                   wxg: torch.Tensor) -> torch.Tensor:
        """The 18 part heatmaps of the (sh, sw, 57) maps, upsampled and
        smoothed by the composed matrices, -> the (h, w, 18) 4-neighbour
        local-maximum mask above PEAK_THRESH (borders against nothing), as
        the JAX _fused_decode."""
        m = torch.einsum("hs,swc->hwc", wyg, both[:, :, 38:56])
        m = torch.einsum("wt,htc->hwc", wxg, m)
        pk = m > self.PEAK_THRESH
        pk[1:] &= m[1:] >= m[:-1]
        pk[:-1] &= m[:-1] >= m[1:]
        pk[:, 1:] &= m[:, 1:] >= m[:, :-1]
        pk[:, :-1] &= m[:, :-1] >= m[:, 1:]
        return pk

    @torch.no_grad()
    def _infer_fast(self, img: np.ndarray, scale: float = 0.5):
        """Single-scale device decode: (raw net maps (sh, sw, 57), peak mask
        (h, w, 18) uint8, wy, wx)."""
        h, w = img.shape[:2]
        wy, wx, wyg, wxg, (sh, sw), (ph, pw) = self._decode_matrices(h, w, scale)
        scaled = cv2.resize(img, (sw, sh), interpolation=cv2.INTER_CUBIC)
        padded = np.pad(scaled, ((0, ph - sh), (0, pw - sw), (0, 0)),
                        constant_values=128)
        both = self._body_maps(padded)
        mask = self._peak_mask(both, wyg, wxg)
        return (both.cpu().numpy(), mask.to(torch.uint8).cpu().numpy(), wy, wx)

    @torch.no_grad()
    def _infer_hand_peaks(self, crop: np.ndarray, scales=None) -> np.ndarray:
        """The hand net at each scale on one square crop, then 21 peaks
        (hand.py:25-74). Each scale resizes the crop to scale * 368 px, a
        multiple of the stride: no padding."""
        scales = self.HAND_SCALES if scales is None else scales
        w = crop.shape[0]
        heat_avg = np.zeros((w, w, 22), np.float32)
        pending = []  # every scale launched before any is fetched
        for scale in scales:
            size = int(round(scale * self.BOX_SIZE))
            size -= size % self.STRIDE  # keep multiples of the net stride
            scaled = cv2.resize(crop, (size, size), interpolation=cv2.INTER_CUBIC)
            u8 = torch.from_numpy(np.ascontiguousarray(scaled[None])).to(self.device)
            pending.append((size, self.hand(_preprocess(u8, self.dtype)).float()))
        for size, dev_heat in pending:
            heat = np.ascontiguousarray(dev_heat[0].permute(1, 2, 0).cpu().numpy())
            heat = cv2.resize(heat, (size, size), interpolation=cv2.INTER_CUBIC)
            heat_avg += cv2.resize(heat, (w, w), interpolation=cv2.INTER_CUBIC
                                   ) / len(scales)
        return decode_hand_peaks(heat_avg)

    def __call__(self, img: np.ndarray, hand: bool = False,
                 hand_scales=None):
        # the CMU nets are BGR-trained; the reference flips at entry
        # (annotator/openpose/__init__.py:35) and draws on the flipped frame
        img = img[:, :, ::-1].copy()
        small, mask, wy, wx = self._infer_fast(img)
        peaks = peaks_from_mask(mask, small[:, :, 38:], wy, wx)
        paf_v = _VirtualMap(small[:, :, :38], wy, wx)
        connections = score_limbs(paf_v, peaks, img.shape[0])
        candidate, subset = assemble_people(peaks, connections)
        canvas = np.zeros_like(img)
        canvas = draw_bodypose(canvas, candidate, subset)
        if hand:
            boxes = hand_detect(candidate, subset, img.shape[0], img.shape[1])
            all_hand_peaks = []
            for x, y, w, _is_left in boxes:
                pk = self._infer_hand_peaks(img[y:y + w, x:x + w, :],
                                            scales=hand_scales)
                # offset into image coords; [0,0] sentinels stay put
                pk[:, 0] = np.where(pk[:, 0] == 0, 0, pk[:, 0] + x)
                pk[:, 1] = np.where(pk[:, 1] == 0, 0, pk[:, 1] + y)
                all_hand_peaks.append(pk)
            canvas = draw_handpose(canvas, all_hand_peaks)
        return canvas, dict(candidate=candidate.tolist(), subset=subset.tolist())
