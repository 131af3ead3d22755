"""The port's scoring harness (stablediffusioneo_tpu_torch/scoring/: the
score formula, the perceptual distance, the pixel and FID Inception feature
extractors, ScoreHarness) against the JAX package's, on the CPU.

The Inception tower takes seeded numpy weights at the names and shapes of
the repository's `pt_inception` universe (470 keys; BatchNorm statistics
away from the identity): the port loads the upstream-named state dict, the
JAX package its converter's folded tree, and the port's pool3 features of
one 299x299 image are within 1e-4 of max |JAX|; the carry back from the
folded tree is exact. The formula, the distance and the pixel extractor are
the JAX package's code and give its values exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.scoring import inception as jinc
from stablediffusioneo_tpu.scoring import score as jscore
from stablediffusioneo_tpu.testing import fixtures as jfixtures
from stablediffusioneo_tpu_torch import scoring as port_scoring
from stablediffusioneo_tpu_torch.checkpoint.accounting import ConversionAccountingError
from stablediffusioneo_tpu_torch.checkpoint.convert import folded_state_dict_from_jax
from stablediffusioneo_tpu_torch.scoring import inception as pinc
from stablediffusioneo_tpu_torch.scoring import score as pscore
from stablediffusioneo_tpu_torch.testing import fixtures as pfixtures

from torch_port_util import PORT_CFG, assert_close_scaled, universe_sd

NET_TOL = 1e-4


def _torch(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _image(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def inception_sd():
    return universe_sd("inception", 51)


@pytest.fixture(scope="module")
def inception_tree(inception_sd):
    return jinc.convert_inception({k: np.asarray(v) for k, v in inception_sd.items()})


# ---------------------------------------------------------- formula, distance


def test_get_score_is_the_jax_formula():
    for t_ms in (350.0, 1000.0, 7000.0, 12345.6):
        for p in np.concatenate([np.linspace(-1, 14, 61), [0, 4, 8, 12, 3.999, 12.0001]]):
            assert pscore.get_score(t_ms, float(p)) == jscore.get_score(t_ms, float(p))


@pytest.mark.parametrize("shape", [(64, 64, 3), (97, 131, 3), (8, 8, 3)])
def test_pixel_extractor_and_distance_are_exact(shape):
    a, b = _image(shape, 52), _image(shape, 53)
    got, want = pscore.PixelFeatureExtractor()(a), jscore.PixelFeatureExtractor()(a)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for x, y in ((a, b), (a, a)):
        assert pscore.perceptual_distance(x, y) == jscore.perceptual_distance(x, y)
    assert pscore.perceptual_distance(a, a) == 0.0 < pscore.perceptual_distance(a, b)
    ext = pscore.PixelFeatureExtractor(levels=2, grid=4)
    assert pscore.perceptual_distance(a, b, ext) == jscore.perceptual_distance(
        a, b, jscore.PixelFeatureExtractor(levels=2, grid=4))


def test_exports():
    assert port_scoring.InceptionFeatureExtractor is pinc.InceptionFeatureExtractor
    assert port_scoring.ScoreHarness is pscore.ScoreHarness
    from stablediffusioneo_tpu import scoring as jax_scoring

    assert set(jax_scoring.__all__) <= set(port_scoring.__all__)
    assert all(hasattr(port_scoring, name) for name in port_scoring.__all__)


@pytest.mark.parametrize("seed,size", [(1000, 256), (1003, 64), (7, 128)])
def test_fixture_scenes_are_the_jax_packages(seed, size):
    got, want = pfixtures.make_scene(seed, size), jfixtures.make_scene(seed, size)
    assert got.shape == (size, size, 3) and got.tobytes() == want.tobytes()


# ------------------------------------------------------------------ Inception


def test_inception_features_match_jax(inception_sd, inception_tree):
    """The extractor on the upstream state dict against the JAX tower on the
    folded tree, one 200x240 image through pytorch_fid's preprocessing; then
    the carried tree gives the same features."""
    import cv2

    img = _image((200, 240, 3), 54)
    ext = pinc.InceptionFeatureExtractor(params=_torch(inception_sd), device="cpu")
    assert ext.net.Conv2d_1a_3x3.conv.weight.dtype == torch.float32
    got = ext(img)
    x = cv2.resize(img, (299, 299), interpolation=cv2.INTER_LINEAR).astype(np.float32)
    x = x / 127.5 - 1.0
    want = np.asarray(jinc.inception_features(inception_tree, jnp.asarray(x[None])))[0]
    assert got.shape == (2048,) and got.dtype == np.float32
    assert_close_scaled(got, want, NET_TOL)
    carried = pinc.InceptionFeatureExtractor(
        params=folded_state_dict_from_jax("inception", inception_tree), device="cpu")
    assert_close_scaled(carried(img), want, NET_TOL)
    assert pscore.perceptual_distance(img, img, ext) == 0.0


def test_inception_pools_keep_the_fid_variants():
    """count_include_pad=False in the average pools (a corner of a constant
    map stays constant), a max pool in Mixed_7c's branch pool, eps 1e-3."""
    x = torch.ones((1, 4, 5, 5))
    assert torch.equal(pinc._avg_pool_nocount(x), x)
    net = pinc.FIDInceptionV3()
    assert (net.Mixed_7b.pool, net.Mixed_7c.pool) == ("avg", "max")
    assert net.Mixed_6e.branch_pool.bn.eps == pinc.BN_EPS == 1e-3


def test_no_tf32_restores_the_flags():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with pinc.no_tf32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_inception_carry_round_trip_is_exact(inception_tree):
    back = folded_state_dict_from_jax("inception", inception_tree)
    assert len(back) == 470 and not any("num_batches" in k for k in back)
    again = jinc.convert_inception({k: v.numpy() for k, v in back.items()})
    leaves, ref = jax.tree.leaves_with_path(again), jax.tree.leaves_with_path(inception_tree)
    assert [p for p, _ in leaves] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(leaves, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.parametrize("fault", [None, "missing", "shape", "extra", "leftovers"])
def test_inception_loader_takes_exactly_its_universe(inception_sd, fault):
    """The strict load takes all 470 keys; a missing key, a wrong shape or a
    foreign key raises; a torchvision file's leftovers (BatchNorm counters,
    AuxLogits, fc) are ignored."""
    sd = _torch(inception_sd)
    victim = "Mixed_6c.branch7x7dbl_3.conv.weight"
    if fault == "missing":
        del sd[victim]
    elif fault == "shape":
        sd[victim] = torch.zeros((160, 160, 7, 1))
    elif fault == "extra":
        sd["Mixed_8a.conv.weight"] = torch.zeros(1)
    elif fault == "leftovers":
        sd.update({"Mixed_5b.branch1x1.bn.num_batches_tracked": torch.tensor(0),
                   "AuxLogits.fc.weight": torch.zeros((1000, 768)),
                   "fc.weight": torch.zeros((1000, 2048)), "fc.bias": torch.zeros(1000)})
    if fault in ("missing", "shape", "extra"):
        with pytest.raises(ConversionAccountingError, match="inception"):
            pinc.InceptionFeatureExtractor(params=sd, device="cpu")
        return
    ext = pinc.InceptionFeatureExtractor(params=sd, device="cpu")
    assert len(ext.report.consumed) == 470
    assert len(ext.report.ignored) == (4 if fault else 0)
    with pytest.raises(ValueError, match="params or ckpt_path"):
        pinc.InceptionFeatureExtractor(device="cpu")


def test_inception_reads_a_file(tmp_path, inception_sd):
    sd = _torch(inception_sd)
    path = tmp_path / "pt_inception-2015-12-05.pth"
    torch.save(sd, path)
    ext = pinc.InceptionFeatureExtractor(ckpt_path=str(path), device="cpu")
    state = ext.net.state_dict()
    assert set(state) == set(sd) and all(torch.equal(state[k], sd[k]) for k in sd)


# --------------------------------------------------------------- the harness


def _tiny_pipeline():
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights
    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    model = ControlLDM(PORT_CFG)
    init_weights(model, torch.Generator().manual_seed(55))
    tok = toy_tokenizer(vocab_size=PORT_CFG.clip.vocab_size,
                        max_length=PORT_CFG.clip.max_length)
    return Canny2ImagePipeline(model, tok, PORT_CFG, device="cpu")


def test_score_harness_over_a_tiny_process():
    """ScoreHarness.run over the port's tiny process(): the JAX harness's
    record keys; PD exactly 0 against self-consistency goldens (a first pass
    of the same requests), and above 0 against another seed's images."""
    pipe = _tiny_pipeline()
    images = [pfixtures.make_scene(1000 + i, 64) for i in range(2)]
    kw = dict(ddim_steps=2, image_resolution=64, seed=11)
    goldens = [pipe.process(img, "a bird", num_samples=1, **kw)[-1] for img in images]
    result = pscore.ScoreHarness(pipe.process).run(images, goldens, prompt="a bird", **kw)
    calls = []

    def fake(img, *a, **k):
        calls.append(k)
        return [img]

    want = jscore.ScoreHarness(fake).run(images, images, ddim_steps=2, image_resolution=64)
    assert set(result) == set(want) and len(result["records"]) == 2
    assert all(set(r) == set(w) for r, w in zip(result["records"], want["records"]))
    assert set(calls[0]) == {"num_samples", "image_resolution", "ddim_steps", "strength",
                             "scale", "seed"}
    assert result["mean_pd"] == 0.0 and all(r["pd"] == 0.0 for r in result["records"])
    assert result["mean_score"] == pytest.approx(
        np.mean([7000.0 / r["t_ms"] for r in result["records"]]))
    other = pscore.ScoreHarness(pipe.process).run(images, goldens, prompt="a bird",
                                                 **{**kw, "seed": 12})
    assert other["mean_pd"] > 0.0
