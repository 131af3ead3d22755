"""The port's token merging (ops/tome.py and its hook in the transformer
blocks) against the JAX package's ops/tome.py: the static partition and
merge count equal, the merge's indices equal and its values within 1e-6
(fp32 on the CPU), and process(tome_ratio=0.5) against the JAX pipeline's
with tome_min_tokens lowered in both packages' configurations (a 64x64 image
has 64 latent tokens at level 0)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.ops import tome as jax_tome
from stablediffusioneo_tpu_torch.ops import tome

from torch_port_util import CFG, PORT_CFG, port_model, tiny_params

GRIDS = [(8, 8), (4, 4), (16, 16), (32, 32), (64, 64), (128, 128), (4, 12), (7, 9),
         (64, 96), (1, 1)]


@pytest.mark.parametrize("h,w", GRIDS, ids=[f"{h}x{w}" for h, w in GRIDS])
def test_partition_and_merge_count_equal_the_jax_packages(h, w):
    for sx, sy in ((2, 2), (3, 2), (1, 4)):
        for got, want in zip(tome._dst_src_partition(h, w, sx, sy),
                             jax_tome._dst_src_partition(h, w, sx, sy)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        for ratio in (0.0, 0.1, 0.25, 0.4, 0.5, 0.75, 2.0):
            for align in (128, 1):
                assert tome.merge_count(h, w, ratio, sx, sy, align) == \
                    jax_tome.merge_count(h, w, ratio, sx, sy, align), (ratio, sx, sy, align)


def test_merge_count_at_the_sd15_level0_site():
    """512x512: the 64x64 level-0 sites keep 2048 of 4096 tokens at ratio
    0.5, and those still reach the packed attention kernel (at least 1024
    queries, not the streaming entry)."""
    from stablediffusioneo_tpu_torch.ops.attention import stream_attention
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ

    kept = 4096 - tome.merge_count(64, 64, 0.5)
    assert kept == 2048 and kept >= ATTN_MIN_TQ
    assert not stream_attention(kept, kept, 320, torch.bfloat16)


CASES = [  # (batch, h, w, channels, ratio, sx, sy, align, metric)
    (2, 8, 8, 6, 0.4, 2, 2, 1, "normal"),
    (1, 4, 12, 4, 0.3, 3, 2, 1, "normal"),
    (2, 16, 16, 8, 0.5, 2, 2, 1, "repeated"),
    (2, 64, 64, 32, 0.5, 2, 2, 128, "exact"),
]


def _metric(rng, b, n, c, kind):
    """normal: standard normal rows. repeated: rows drawn from n/8 of them,
    so that similarities tie. exact: rows of four +-1/2 entries, of norm 1
    exactly, so that every similarity is a sum of quarters, exact in any
    summation order (at 4096 tokens, random rows give similarities closer
    than the last bit, which the two packages' matrix products order
    differently), with ties everywhere."""
    if kind == "exact":
        m = np.zeros((b, n, c), np.float32)
        for row in m.reshape(-1, c):
            row[rng.choice(c, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
        return m
    m = rng.standard_normal((b, n, c), dtype=np.float32)
    return m[:, rng.integers(0, n // 8, n)] if kind == "repeated" else m


@pytest.mark.parametrize("case", CASES, ids=[f"{c[1]}x{c[2]}" for c in CASES])
def test_merge_and_unmerge_match_jax(case):
    """The same metric and payload through both packages' build_merge: the
    unmerged tokens' ids and every token's row in the merged sequence equal
    exactly (the matching, the stable order, the dst of each merged src),
    the merged and unmerged values within 1e-6. Where similarities tie, the
    first dst wins and tied srcs keep their token order (a stable sort)."""
    b, h, w, c, ratio, sx, sy, align, kind = case
    n = h * w
    rng = np.random.default_rng(n)
    metric = _metric(rng, b, n, c, kind)
    payload = rng.standard_normal((b, n, 5), dtype=np.float32)
    r = tome.merge_count(h, w, ratio, sx, sy, align)
    ref_merge, ref_unmerge, ref_n = jax_tome.build_merge(jnp.asarray(metric), h, w, r, sx, sy)
    merge, unmerge, n_m = tome.build_merge(torch.from_numpy(metric), h, w, r, sx, sy)
    assert n_m == ref_n == n - r
    n_unm = len(tome._dst_src_partition(h, w, sx, sy)[1]) - r
    ids = np.broadcast_to(np.arange(n, dtype=np.float32)[None, :, None], (b, n, 1)).copy()
    assert np.array_equal(merge(torch.from_numpy(ids)).numpy()[:, :n_unm],
                          np.asarray(ref_merge(jnp.asarray(ids)))[:, :n_unm])
    rows = np.broadcast_to(np.arange(n - r, dtype=np.float32)[None, :, None],
                           (b, n - r, 1)).copy()
    assert np.array_equal(unmerge(torch.from_numpy(rows)).numpy(),
                          np.asarray(ref_unmerge(jnp.asarray(rows))))
    merged = merge(torch.from_numpy(payload))
    want = np.asarray(ref_merge(jnp.asarray(payload)))
    assert merged.shape == want.shape == (b, n - r, 5)
    assert np.abs(merged.numpy() - want).max() <= 1e-6
    back = unmerge(merged).numpy()
    assert np.abs(back - np.asarray(ref_unmerge(jnp.asarray(want)))).max() <= 1e-6
    # the tokens that were not merged come back as they were
    untouched = np.abs(back - payload).max(axis=-1) == 0
    assert untouched.sum(axis=1).min() >= n_unm


def test_merge_count_out_of_range_raises():
    with pytest.raises(ValueError, match="merge count"):
        tome.build_merge(torch.zeros((1, 64, 4)), 8, 8, 49)
    with pytest.raises(ValueError, match="tokens for a"):
        tome.build_merge(torch.zeros((1, 60, 4)), 8, 8, 8)


def test_tome_of_reads_the_config_and_the_request():
    ucfg = PORT_CFG.controlnet.unet
    assert tome.tome_of(ucfg) is None and tome.tome_of(ucfg, 0.0) is None
    assert tome.tome_of(ucfg, 0.5) == tome.ToMe(0.5, 4096, 2, 2)
    on = dataclasses.replace(ucfg, tome_ratio=0.3, tome_min_tokens=64)
    assert tome.tome_of(on) == tome.ToMe(0.3, 64, 2, 2)
    assert tome.tome_of(on, 0.5).ratio == 0.5


def _lowered(cfg, min_tokens=64):
    """The pipeline configuration with ToMe's site threshold lowered in the
    UNet's and the ControlNet's UNet configuration."""
    unet = dataclasses.replace(cfg.unet, tome_min_tokens=min_tokens)
    return dataclasses.replace(cfg, unet=unet,
                               controlnet=dataclasses.replace(cfg.controlnet, unet=unet))


@pytest.fixture(scope="module")
def tome_pipes():
    from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer
    from stablediffusioneo_tpu.pipeline.canny2image import (
        Canny2ImagePipeline as JaxPipeline,
    )
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    params = tiny_params()
    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    return (JaxPipeline(params, tok, _lowered(CFG), persistent_cache=False),
            Canny2ImagePipeline(port_model(params), tok, _lowered(PORT_CFG), device="cpu"),
            Canny2ImagePipeline(port_model(params), tok, PORT_CFG, device="cpu"))


@pytest.fixture(scope="module")
def request_inputs():
    rng = np.random.default_rng(3)
    return {"image": (rng.random((64, 64, 3)) * 255).astype(np.uint8),
            "x_T": rng.standard_normal((1, 8, 8, 4), dtype=np.float32)}


def test_process_with_tome_matches_jax(tome_pipes, request_inputs):
    """tome_ratio=0.5, 2 DDIM steps, both nets merging at their 8x8 sites
    (32 of 64 tokens): the port's image within 1 of the JAX package's, and
    another image than the port's without merging."""
    jax_pipe, port_pipe, _ = tome_pipes
    kw = dict(num_samples=1, image_resolution=64, ddim_steps=2, seed=7,
              x_T=request_inputs["x_T"], tome_ratio=0.5)
    ref = jax_pipe.process(request_inputs["image"], "a bird", **kw)
    out = port_pipe.process(request_inputs["image"], "a bird", **kw)
    assert out[1].shape == ref[1].shape == (64, 64, 3)
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1
    plain = port_pipe.process(request_inputs["image"], "a bird", **dict(kw, tome_ratio=0.0))
    assert np.abs(plain[1].astype(int) - out[1].astype(int)).max() > 1


def test_tome_below_the_site_threshold_changes_nothing(tome_pipes, request_inputs):
    """At the default threshold (4096 tokens) a 64x64 image has no site to
    merge: tome_ratio=0.5 gives the plain image in bytes, through its own
    engine."""
    pipe = tome_pipes[2]
    kw = dict(image_resolution=64, ddim_steps=2, seed=7, x_T=request_inputs["x_T"])
    plain = pipe.process(request_inputs["image"], "a bird", **kw)[1]
    merged = pipe.process(request_inputs["image"], "a bird", tome_ratio=0.5, **kw)[1]
    assert np.array_equal(plain, merged)
    assert {k[13] for k in pipe.runtime._engines if k[0] == "sample_decode"} == {0.0, 0.5}
