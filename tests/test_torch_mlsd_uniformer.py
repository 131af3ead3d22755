"""The port's MLSD and UniFormer annotators (stablediffusioneo_tpu_torch/
annotators/{mlsd,mlsd_net,uniformer}.py) against the JAX package's, fp32 on
the CPU, on seeded numpy weights at the names and shapes of the repository's
key universes (stablediffusioneo_tpu/checkpoint/universes/mlsd_large.txt.gz,
344 keys, and uniformer.txt.gz, 398 keys; BatchNorm statistics drawn away
from the identity).

Both nets are held twice: the port loading the upstream-named state dict
itself (its BatchNorms as upstream runs them) against the JAX package on
its converter's folded tree, and the port loading that folded tree back
through the carry (checkpoint/convert.py:annotator_state_dict_from_jax:
identity BatchNorms). Tolerances, relative to max |reference|: the MLSD
tpMap (128x128 input) and the UniFormer logits (224x224) 1e-4; the decodes
exact on the same map; UniFormer's label map on at least 99.5% of the
pixels (argmax ties of a seeded net); the carry exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from stablediffusioneo_tpu.annotators import mlsd as jmlsd
from stablediffusioneo_tpu.annotators import mlsd_net as jmlsd_net
from stablediffusioneo_tpu.annotators import uniformer as juni
from stablediffusioneo_tpu_torch import annotators as port_annotators
from stablediffusioneo_tpu_torch.annotators import mlsd as pmlsd
from stablediffusioneo_tpu_torch.annotators import mlsd_net as pmlsd_net
from stablediffusioneo_tpu_torch.annotators import uniformer as puni
from stablediffusioneo_tpu_torch.checkpoint.accounting import (
    ConversionAccountingError,
    load_strict,
)
from stablediffusioneo_tpu_torch.checkpoint.convert import annotator_state_dict_from_jax
from stablediffusioneo_tpu_torch.ops.kernels import attention as ka

from torch_port_util import assert_close_scaled, universe_sd

NET_TOL = 1e-4
LABEL_SHARE = 0.995
CONVERT = {"mlsd_large": jmlsd_net.convert_mlsd_large,
           "uniformer": juni.convert_uniformer_upernet}
NETS = {"mlsd_large": pmlsd_net.MobileV2MLSDLarge, "uniformer": puni.UniformerSegmentor}
COUNTS = {"mlsd_large": 344, "uniformer": 398}


def _numpy(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def _torch(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _port(kind, sd):
    net = NETS[kind]()
    load_strict(net, _torch(sd), kind)
    return net.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _image(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def mlsd_sd():
    return universe_sd("mlsd_large", 31)


@pytest.fixture(scope="module")
def mlsd_tree(mlsd_sd):
    return CONVERT["mlsd_large"](_numpy(mlsd_sd))


@pytest.fixture(scope="module")
def uni_sd():
    return universe_sd("uniformer", 32)


@pytest.fixture(scope="module")
def uni_tree(uni_sd):
    return CONVERT["uniformer"](_numpy(uni_sd))


def _jax_uniformer(tree, x):
    feats = juni.uniformer_apply(tree["backbone"], jnp.asarray(x))
    return np.asarray(juni.upernet_apply(tree["decode_head"], feats))


# ----------------------------------------------------------------------- MLSD


@pytest.mark.parametrize("source", ["file", "carry"])
def test_mlsd_tpmap_matches_jax(mlsd_sd, mlsd_tree, source):
    """The 16-channel tpMap of a 128x128 input: the port on the upstream
    state dict (its BatchNorms) or on the carried folded tree, against the
    JAX net on the folded tree."""
    x = np.random.default_rng(33).uniform(-1, 1, (1, 128, 128, 4)).astype(np.float32)
    want = np.asarray(jmlsd_net.mlsd_large_apply(mlsd_tree, jnp.asarray(x)))
    sd = mlsd_sd if source == "file" else annotator_state_dict_from_jax("mlsd_large",
                                                                         mlsd_tree)
    with torch.no_grad():
        got = _nhwc(_port("mlsd_large", sd)(_nchw(x)))
    assert got.shape == (1, 64, 64, 16)
    assert_close_scaled(got, want, NET_TOL)


def _synthetic_tp_map(seed, h=32, w=40):
    """A tpMap with a few strong centres and long displacements."""
    rng = np.random.default_rng(seed)
    tp = rng.standard_normal((1, h, w, 16)).astype(np.float32) - 3.0
    tp[0, :, :, 1:5] = rng.uniform(-12, 12, (h, w, 4)).astype(np.float32)
    for y, x in ((5, 6), (12, 30), (25, 17), (20, 8)):
        tp[0, y, x, 0] = 4.0
    return tp


@pytest.mark.parametrize("seed", [34, 35])
def test_mlsd_decode_exact_on_the_same_map(seed):
    tp = _synthetic_tp_map(seed)
    for got, want in zip(pmlsd.decode_center_and_displacement(tp),
                         jmlsd.decode_center_and_displacement(tp)):
        assert np.array_equal(got, want)
    image = _image((64, 80, 3), seed)
    for thr_v, thr_d in ((0.1, 5.0), (0.5, 20.0), (0.99, 0.0)):
        got = pmlsd.pred_lines(image, lambda x: tp, (64, 80), thr_v, thr_d)
        want = jmlsd.pred_lines(image, lambda x: tp, (64, 80), thr_v, thr_d)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    assert len(pmlsd.pred_lines(image, lambda x: tp, (64, 80), 0.1, 5.0)) >= 3


def test_mlsd_detector_decodes_its_net_map_as_jax(mlsd_sd, mlsd_tree):
    """The detector on the upstream state dict: its net's map of the image
    within NET_TOL of the JAX net's; its line map exactly the JAX decode and
    drawing on that same map (an image with no line over the thresholds
    gives the black map, no exception)."""
    img = _image((96, 128, 3), 36)
    det = pmlsd.MLSDdetector(params=_torch(mlsd_sd), device="cpu")
    assert det.net.block23.conv3.weight.dtype == torch.float32
    x = np.concatenate([img, np.ones((96, 128, 1))], axis=-1)[None].astype(np.float32)
    x = x / 127.5 - 1.0
    tp = det.model_fn(x)
    assert_close_scaled(tp, np.asarray(jmlsd_net.mlsd_large_apply(mlsd_tree, jnp.asarray(x))),
                        NET_TOL)
    jdet = jmlsd.MLSDdetector(model_fn=lambda _x: tp)
    for thr_v, thr_d in ((0.0, 0.0), (0.1, 0.1), (1.1, 0.0)):
        got = det(img, thr_v, thr_d)
        assert got.shape == (96, 128) and got.dtype == np.uint8
        assert np.array_equal(got, jdet(img, thr_v, thr_d))
    assert det(img, 0.0, 0.0).any() and not det(img, 1.1, 0.0).any()


def test_mlsd_tiny_net_matches_jax():
    """The contract net on the JAX init_tiny_mlsd weights (HWIO to OIHW)."""
    tree = jmlsd.init_tiny_mlsd(jax.random.PRNGKey(37))
    net = pmlsd.TinyMLSD()
    net.load_state_dict({f"{name}.{'weight' if leaf == 'w' else 'bias'}":
                         torch.from_numpy(np.array(
                             np.transpose(np.asarray(v), (3, 2, 0, 1)) if leaf == "w"
                             else np.asarray(v)))
                         for name, p in tree.items() for leaf, v in p.items()})
    x = np.random.default_rng(38).uniform(-1, 1, (1, 48, 40, 4)).astype(np.float32)
    want = np.asarray(jmlsd.tiny_mlsd_apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert got.shape == (1, 24, 20, 16)
    assert_close_scaled(got, want, NET_TOL)


def test_mlsd_detector_default_is_the_seeded_tiny_net():
    det = pmlsd.MLSDdetector(device="cpu")
    assert isinstance(det.net, pmlsd.TinyMLSD)
    again = pmlsd.MLSDdetector(device="cpu")
    img = _image((64, 64, 3), 39)
    assert np.array_equal(det(img, 0.0, 0.0), again(img, 0.0, 0.0))
    given = pmlsd.MLSDdetector(model_fn=lambda x: _synthetic_tp_map(40, 32, 32))
    assert given.net is None and given(img, 0.1, 5.0).any()


# ------------------------------------------------------------------ UniFormer


@pytest.mark.parametrize("source", ["file", "carry"])
def test_uniformer_logits_match_jax(uni_sd, uni_tree, source):
    """The 150 class logits of a 224x224 input at 1/4, full width."""
    x = np.random.default_rng(41).standard_normal((1, 224, 224, 3)).astype(np.float32)
    want = _jax_uniformer(uni_tree, x)
    sd = uni_sd if source == "file" else annotator_state_dict_from_jax("uniformer", uni_tree)
    with torch.no_grad():
        got = _nhwc(_port("uniformer", sd)(_nchw(x)))
    assert got.shape == (1, 56, 56, 150)
    assert_close_scaled(got, want, NET_TOL)


def test_uniformer_label_map_matches_jax(uni_sd, uni_tree):
    """The detector's coloured map of a 200x232 image (resized to 192x224):
    the same palette colour on at least LABEL_SHARE of the pixels."""
    img = _image((200, 232, 3), 42)
    want = juni.UniformerDetector(params=uni_tree)(img)
    det = puni.UniformerDetector(params=_torch(uni_sd), device="cpu")
    got = det(img)
    assert got.shape == want.shape == (200, 232, 3) and got.dtype == np.uint8
    same = (got == want).all(axis=-1).mean()
    assert same >= LABEL_SHARE, same
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 1


@pytest.mark.parametrize("hw", [(7, 7), (5, 9), (16, 16), (12, 7)])
def test_adaptive_avg_pool_matches_jax(hw):
    """The PPM's pool (torch's AdaptiveAvgPool2d) against the JAX package's
    copy of its semantics, sizes the bins do not divide included."""
    x = np.random.default_rng(43).standard_normal((1, *hw, 8)).astype(np.float32)
    for bins in puni.PPM_BINS:
        want = np.asarray(juni._adaptive_avg_pool(jnp.asarray(x), bins))
        got = _nhwc(F.adaptive_avg_pool2d(_nchw(x), bins))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_resizes_match_jax_where_they_upsample():
    """UperNet's resizes from the PPM bins to h/32 and up the pyramid equal
    jax.image.resize at every input of at least 192 pixels (they only
    upsample); a shrink, where JAX antialiases, differs."""
    x = np.random.default_rng(44).standard_normal((1, 6, 6, 8)).astype(np.float32)
    for side in (6, 7, 16, 32):
        want = np.asarray(juni._resize_to(jnp.asarray(x), side, side))
        got = _nhwc(puni._resize_to(_nchw(x), side, side))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    shrink = _nhwc(puni._resize_to(_nchw(x), 4, 4))
    assert np.abs(shrink - np.asarray(juni._resize_to(jnp.asarray(x), 4, 4))).max() > 1e-3


@pytest.mark.parametrize("side,launches", [(32, 1), (16, 0)])
def test_sablock_attention_goes_to_the_split_entry(monkeypatch, side, launches):
    """A stage-3 SABlock (width 320, 5 heads of 64) at 32x32 tokens sends its
    attention to the split kernel entry at (1, 5, 1024, 64), q / k / v views
    of the one qkv projection with token stride 3C; at 16x16 (256 tokens)
    it stays on plain math, as the JAX gate."""
    calls = []
    real = ka._split_forward

    def spy(q, k, v, scale):
        calls.append((tuple(q.shape), q.stride(), k.data_ptr() - q.data_ptr()))
        return real(q, k, v, scale)

    monkeypatch.setattr(ka, "_split_forward", spy)
    blk = puni.SABlock(320)
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    init_weights(blk, torch.Generator().manual_seed(45))
    with torch.no_grad():
        out = blk.eval()(torch.randn((1, 320, side, side),
                                     generator=torch.Generator().manual_seed(46)))
    assert out.shape == (1, 320, side, side) and torch.isfinite(out).all()
    assert len(calls) == launches
    if launches:
        shape, stride, k_offset = calls[0]
        assert shape == (1, 5, 1024, 64)
        assert stride == (1024 * 960, 64, 960, 1) and k_offset == 320 * 4


def test_ade20k_palette_is_the_jax_packages():
    assert np.array_equal(puni.ade20k_palette(), juni.ade20k_palette())
    assert puni.ade20k_palette().shape == (150, 3)


# ------------------------------------------------------- carry and loaders


@pytest.mark.parametrize("kind", sorted(CONVERT))
def test_carry_round_trip_is_exact(kind):
    """convert(carry(convert(sd))) == convert(sd), leaf for leaf: the
    identity BatchNorms (variance 1 - eps) fold back to the same tree."""
    sd = universe_sd(kind, 47)
    tree = CONVERT[kind](_numpy(sd))
    back = annotator_state_dict_from_jax(kind, tree)
    assert set(back) == set(sd)
    again = CONVERT[kind](_numpy(back))
    leaves, ref = jax.tree.leaves_with_path(again), jax.tree.leaves_with_path(tree)
    assert [p for p, _ in leaves] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(leaves, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _detector_net(kind, sd):
    if kind == "mlsd_large":
        return pmlsd.MLSDdetector(params=sd, device="cpu").net
    return puni.UniformerDetector(params=sd, device="cpu").net


@pytest.mark.parametrize("kind", sorted(CONVERT))
@pytest.mark.parametrize("fault", [None, "missing", "shape", "extra"])
def test_loader_takes_exactly_its_universe(kind, fault):
    """Each detector's strict load from a state dict of exactly its
    universe's names and shapes: every key taken (the BatchNorm counters
    too); one missing key, one wrong shape or one foreign key raises."""
    sd = _torch(universe_sd(kind, 48))
    n = COUNTS[kind]
    assert len(sd) == n
    victim = sorted(k for k in sd if k.endswith(".weight"))[n // 4]
    if fault == "missing":
        del sd[victim]
    elif fault == "shape":
        sd[victim] = torch.zeros(tuple(sd[victim].shape) + (1,))
    elif fault == "extra":
        sd["auxiliary_head.conv_seg.weight"] = torch.zeros(1)
    if fault:
        with pytest.raises(ConversionAccountingError, match=kind):
            _detector_net(kind, sd)
        return
    state = _detector_net(kind, sd).state_dict()
    assert set(state) == set(sd)
    assert all(torch.equal(state[k], sd[k].to(state[k].dtype)) for k in sd)


@pytest.mark.parametrize("kind", sorted(CONVERT))
def test_detector_reads_a_file(tmp_path, kind):
    """ckpt_path goes through checkpoint/torch_reader.py, a nested
    state_dict (mmseg's checkpoint layout) unwrapped."""
    sd = _torch(universe_sd(kind, 49))
    path = tmp_path / f"{kind}.pth"
    torch.save({"state_dict": sd} if kind == "uniformer" else sd, path)
    det = (pmlsd.MLSDdetector(ckpt_path=str(path), device="cpu") if kind == "mlsd_large"
           else puni.UniformerDetector(ckpt_path=str(path), device="cpu"))
    state = det.net.state_dict()
    assert all(torch.equal(state[k], sd[k]) for k in sd)


def test_detectors_default_to_the_card():
    from stablediffusioneo_tpu_torch.annotators._dtype import default_device

    assert default_device() == torch.device("cuda")
    assert port_annotators.MLSDdetector is pmlsd.MLSDdetector
    assert port_annotators.UniformerDetector is puni.UniformerDetector
    assert {"MLSDdetector", "UniformerDetector"} <= set(port_annotators.__all__)


# ------------------------------------------- the native preprocessing library


@pytest.fixture(scope="module")
def native():
    """The port's wrappers, the library built by utils/native.py (g++ into
    stablediffusioneo_tpu_torch/csrc/build/, never `make -C native`)."""
    from stablediffusioneo_tpu_torch.annotators import native as pnative
    from stablediffusioneo_tpu_torch.utils import native as loader

    assert pnative.native_available()
    path = loader.library_path("sdeo_preproc")
    assert path.parent == loader.BUILD_DIR and path.exists()
    return pnative


def test_native_hwc3_and_gray(native):
    from stablediffusioneo_tpu_torch.annotators.util import HWC3

    rng = np.random.default_rng(71)
    for shape in ((16, 16), (16, 16, 1), (16, 16, 3)):
        x = (rng.random(shape) * 255).astype(np.uint8)
        assert np.array_equal(native.hwc3(x), HWC3(x))
    rgba = (rng.random((16, 16, 4)) * 255).astype(np.uint8)
    assert np.abs(native.hwc3(rgba).astype(int) - HWC3(rgba).astype(int)).max() <= 1
    import cv2

    rgb = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    assert np.abs(native.rgb2gray(rgb).astype(int) - gray.astype(int)).max() <= 1


@pytest.mark.parametrize("shape,out", [((20, 30, 3), (37, 53)), ((64, 48), (32, 24))])
def test_native_resize_against_cv2(native, shape, out):
    import cv2

    x = (np.random.default_rng(72).random(shape) * 255).astype(np.uint8)
    a = native.resize_bilinear(x, *out)
    b = cv2.resize(x, out[::-1], interpolation=cv2.INTER_LINEAR)
    assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_native_canny_against_cv2(native):
    """tests/test_native.py's bounds: exact on a blurred box, IoU > 0.8 on
    noise-like texture; an RGB input goes through rgb2gray."""
    import cv2

    img = np.zeros((64, 64), np.uint8)
    img[16:48, 16:48] = 200
    img = cv2.GaussianBlur(img, (5, 5), 1.2)
    a, b = native.canny(img, 100, 200), cv2.Canny(img, 100, 200)
    assert a.any() and np.array_equal(a > 0, b > 0)
    nat = cv2.GaussianBlur((np.random.default_rng(73).random((128, 128)) * 255)
                           .astype(np.uint8), (7, 7), 2.0)
    a, b = native.canny(nat, 60, 150), cv2.Canny(nat, 60, 150)
    assert ((a > 0) & (b > 0)).sum() / max(((a > 0) | (b > 0)).sum(), 1) > 0.8
    rgb = np.repeat(img[:, :, None], 3, axis=2)
    assert np.array_equal(native.canny(rgb, 100, 200), native.canny(img, 100, 200))


def test_native_wrappers_give_the_jax_wrappers_bytes(native, monkeypatch):
    """The JAX package's wrappers, pointed at the library the port built (its
    own candidate, native/build/, is another build), give the same bytes."""
    from stablediffusioneo_tpu.annotators import native as jnative
    from stablediffusioneo_tpu_torch.utils import native as loader

    monkeypatch.setattr(jnative, "_LIB_CANDIDATES",
                        (str(loader.library_path("sdeo_preproc")),))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_attempted", False)
    assert jnative.native_available()
    rng = np.random.default_rng(74)
    rgb = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    rgba = (rng.random((40, 56, 4)) * 255).astype(np.uint8)
    for name, args in (("hwc3", (rgba,)), ("hwc3", (rgb[:, :, 0],)),
                       ("resize_bilinear", (rgb, 33, 71)), ("rgb2gray", (rgb,)),
                       ("canny", (rgb, 50, 120))):
        got, want = getattr(native, name)(*args), getattr(jnative, name)(*args)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), name


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No cv2 fallback: where the library cannot be built, the wrappers
    raise and native_available() says so."""
    from stablediffusioneo_tpu_torch.annotators import native as pnative
    from stablediffusioneo_tpu_torch.utils import native as loader

    monkeypatch.setattr(loader, "_cache", {})
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(loader, "library_path", lambda name: tmp_path / f"lib{name}-x.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="libsdeo_preproc.so"):
        pnative.canny(np.zeros((8, 8), np.uint8), 100, 200)
    assert not pnative.native_available()
