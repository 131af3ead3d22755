"""Deterministic benchmark fixture images (counterpart of
stablediffusioneo_tpu/testing/fixtures.py, whose code this is, held to the
original by tests/test_torch_imports.py).

The reference ships 20 cropped bird photos (`pictures_croped/bird_*.jpg`)
and their goldens; the repository ships no photos, so the fixtures are
seeded synthetic scenes (shapes and texture) with enough structure for Canny
to give a meaningful hint.
"""

import os
import sys

import cv2
import numpy as np


def make_scene(seed: int, size: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 160, np.uint8)
    # textured background
    noise = rng.normal(0, 12, (size // 8, size // 8, 3))
    img = np.clip(
        img + cv2.resize(noise, (size, size)).astype(np.int32), 0, 255
    ).astype(np.uint8)
    # a "bird"-ish blob: body ellipse + head circle + beak triangle + wing arc
    cx, cy = rng.integers(size // 3, 2 * size // 3, 2)
    body = (int(cx), int(cy))
    color = tuple(int(c) for c in rng.integers(40, 200, 3))
    cv2.ellipse(img, body, (size // 5, size // 8), int(rng.integers(0, 180)),
                0, 360, color, -1)
    head = (int(cx + size // 6), int(cy - size // 10))
    cv2.circle(img, head, size // 12, color, -1)
    beak = np.array([
        [head[0] + size // 12, head[1] - size // 40],
        [head[0] + size // 12, head[1] + size // 40],
        [head[0] + size // 6, head[1]],
    ])
    cv2.fillConvexPoly(img, beak, (30, 30, 30))
    cv2.ellipse(img, body, (size // 8, size // 16), int(rng.integers(0, 180)),
                0, 300, tuple(int(c * 0.7) for c in color), 3)
    # branch
    y0 = int(cy + size // 7)
    cv2.line(img, (0, y0), (size, y0 + int(rng.integers(-20, 20))), (70, 50, 30), 5)
    return img


def main(out_dir: str = "fixtures", n: int = 20, size: int = 256):
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(out_dir, f"bird_{i}.jpg"), make_scene(1000 + i, size))
    print(f"wrote {n} fixtures to {out_dir}/")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
