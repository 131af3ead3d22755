"""The port's annotators (stablediffusioneo_tpu_torch/annotators/: HED,
MiDaS DPT-L and DPT-hybrid, OpenPose body and hand) against the JAX
package's, fp32 on the CPU, on the same seeded numpy weights: an upstream-
named state dict goes through the JAX converter (convert_hed, convert_dpt,
convert_dpt_hybrid, convert_body, convert_hand), and the JAX tree comes to
the port through checkpoint/convert.py:annotator_state_dict_from_jax.

Widths: HED, the body and hand nets and the DPT-hybrid at the widths of the
repository's key universes (stablediffusioneo_tpu/checkpoint/universes/
{hed,openpose_body,openpose_hand,dpt_hybrid}.txt.gz: 37, 184, 102 and 358
keys, each with its shape) on small images; DPT-L narrow (24 blocks of width
64, as tests/test_pose_depth_mlsd.py builds one): no universe of it is in the
repository.

Tolerances, relative to max |reference|: HED's side maps 1e-5; raw depth and
the body / hand maps 1e-4; the detectors' uint8 maps within 1 level; the
decode (peaks, limbs, people, the device peak mask) exact on synthetic maps.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from stablediffusioneo_tpu.annotators import hed as jhed
from stablediffusioneo_tpu.annotators import midas as jmidas
from stablediffusioneo_tpu.annotators import midas_hybrid as jhybrid
from stablediffusioneo_tpu.annotators import openpose as jpose
from stablediffusioneo_tpu_torch import annotators as port_annotators
from stablediffusioneo_tpu_torch.annotators import _dtype
from stablediffusioneo_tpu_torch.annotators import hed as phed
from stablediffusioneo_tpu_torch.annotators import midas as pmidas
from stablediffusioneo_tpu_torch.annotators import midas_hybrid as phybrid
from stablediffusioneo_tpu_torch.annotators import openpose as ppose
from stablediffusioneo_tpu_torch.checkpoint.accounting import (
    ConversionAccountingError,
    load_strict,
)
from stablediffusioneo_tpu_torch.checkpoint.convert import annotator_state_dict_from_jax

from torch_port_util import assert_close_scaled, draw_upstream, universe_sd

SIDE_TOL, NET_TOL = 1e-5, 1e-4
# the universes of this file's nets (tests/test_torch_mlsd_uniformer.py and
# tests/test_torch_scoring.py hold the BatchNorm-folded ones)
KINDS = ("dpt_hybrid", "hed", "openpose_body", "openpose_hand")
CONVERT = {"hed": jhed.convert_hed, "dpt_large": jmidas.convert_dpt,
           "dpt_hybrid": jhybrid.convert_dpt_hybrid, "openpose_body": jpose.convert_body,
           "openpose_hand": jpose.convert_hand}


def narrow_dpt_sd(seed=0, dim=64):
    """An upstream-named DPT-L state dict at width `dim`, 24 blocks (the
    hooks need them), a 4x4 position grid, stage channels (16, 32, 64, 64),
    fusion width 32 and head widths 16 / 8."""
    rng = np.random.default_rng(seed)
    ic, feat, sd = (16, 32, 64, 64), 32, {}

    def put(name, *shape):
        sd[name] = draw_upstream(rng, name, shape)

    def conv(name, cin, cout, k, bias=True):
        put(f"{name}.weight", cout, cin, k, k)
        if bias:
            put(f"{name}.bias", cout)

    def lin(name, cin, cout):
        put(f"{name}.weight", cout, cin)
        put(f"{name}.bias", cout)

    vm = "pretrained.model."
    conv(f"{vm}patch_embed.proj", 3, dim, 16)
    put(f"{vm}cls_token", 1, 1, dim)
    put(f"{vm}pos_embed", 1, 1 + 16, dim)
    for i in range(24):
        for n in ("norm1", "norm2"):
            put(f"{vm}blocks.{i}.{n}.weight", dim)
            put(f"{vm}blocks.{i}.{n}.bias", dim)
        lin(f"{vm}blocks.{i}.attn.qkv", dim, 3 * dim)
        lin(f"{vm}blocks.{i}.attn.proj", dim, dim)
        lin(f"{vm}blocks.{i}.mlp.fc1", dim, 2 * dim)
        lin(f"{vm}blocks.{i}.mlp.fc2", 2 * dim, dim)
    for i in range(1, 5):
        base = f"pretrained.act_postprocess{i}"
        lin(f"{base}.0.project.0", 2 * dim, dim)
        conv(f"{base}.3", dim, ic[i - 1], 1)
        if i in (1, 2):  # ConvTranspose2d: (in, out, k, k)
            k = 4 if i == 1 else 2
            put(f"{base}.4.weight", ic[i - 1], ic[i - 1], k, k)
            put(f"{base}.4.bias", ic[i - 1])
        if i == 4:
            conv(f"{base}.4", ic[3], ic[3], 3)
        conv(f"scratch.layer{i}_rn", ic[i - 1], feat, 3, bias=False)
        for u in (1, 2):
            for c in ("conv1", "conv2"):
                conv(f"scratch.refinenet{i}.resConfUnit{u}.{c}", feat, feat, 3)
        conv(f"scratch.refinenet{i}.out_conv", feat, feat, 1)
    conv("scratch.output_conv.0", feat, 16, 3)
    conv("scratch.output_conv.2", 16, 8, 3)
    conv("scratch.output_conv.4", 8, 1, 1)
    return sd


def _jax_tree(kind, sd):
    return CONVERT[kind]({k: np.asarray(v) for k, v in sd.items()})


def _port(cls, kind, tree, **kw):
    net = cls(**kw)
    load_strict(net, annotator_state_dict_from_jax(kind, tree), kind)
    return net.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _image(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def _within_one_level(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.fixture(scope="module")
def hed_tree():
    sd = universe_sd("hed", 1)
    sd["norm"] = sd["norm"] * 1000.0  # mean pixel values of the order of 100
    return _jax_tree("hed", sd)


@pytest.fixture(scope="module")
def dpt_sd():
    return narrow_dpt_sd(2)


@pytest.fixture(scope="module")
def hybrid_tree():
    return _jax_tree("dpt_hybrid", universe_sd("dpt_hybrid", 3))


@pytest.fixture(scope="module")
def body_tree():
    return _jax_tree("openpose_body", universe_sd("openpose_body", 4))


@pytest.fixture(scope="module")
def hand_tree():
    return _jax_tree("openpose_hand", universe_sd("openpose_hand", 5))


# ---------------------------------------------------------------- dtype policy


def test_dtype_policy(monkeypatch):
    monkeypatch.delenv("SDEO_ANNOTATOR_DTYPE", raising=False)
    assert _dtype.annotator_dtype("cpu") == torch.float32
    assert _dtype.annotator_dtype("cuda") == torch.bfloat16
    assert _dtype.default_device() == torch.device("cuda")
    monkeypatch.setenv("SDEO_ANNOTATOR_DTYPE", "bfloat16")
    assert _dtype.annotator_dtype("cpu") == torch.bfloat16
    monkeypatch.setenv("SDEO_ANNOTATOR_DTYPE", "float16")
    with pytest.raises(ValueError, match="SDEO_ANNOTATOR_DTYPE"):
        _dtype.annotator_dtype("cpu")


def test_detector_exports():
    from stablediffusioneo_tpu_torch.annotators import mlsd as pmlsd
    from stablediffusioneo_tpu_torch.annotators import uniformer as puni

    assert port_annotators.HEDdetector is phed.HEDdetector
    assert port_annotators.MidasDetector is pmidas.MidasDetector
    assert port_annotators.OpenposeDetector is ppose.OpenposeDetector
    assert port_annotators.MLSDdetector is pmlsd.MLSDdetector
    assert port_annotators.UniformerDetector is puni.UniformerDetector
    with pytest.raises(AttributeError):
        getattr(port_annotators, "SegmentAnythingDetector")


# ------------------------------------------------------------------------ HED


@pytest.mark.parametrize("hw", [(48, 40), (37, 45)])
def test_hed_side_maps_match_jax(hed_tree, hw):
    """Full width; an odd size takes the floor of every 2x2 pool."""
    x = np.random.default_rng(6).random((1, *hw, 3)).astype(np.float32) * 255
    want = jhed.hed_apply(hed_tree, jnp.asarray(x))
    net = _port(phed.ControlNetHED, "hed", hed_tree)
    with torch.no_grad():
        got = net(_nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_close_scaled(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), SIDE_TOL)


def test_hed_detector_matches_jax(hed_tree):
    img = _image((64, 56, 3), 7)
    want = jhed.HEDdetector(params=hed_tree)(img)
    det = phed.HEDdetector(params=annotator_state_dict_from_jax("hed", hed_tree),
                           device="cpu")
    assert det.net.norm.dtype == torch.float32
    got = det(img)
    _within_one_level(got, want)
    assert got.shape == (64, 56) and len(np.unique(got)) > 4


# --------------------------------------------------------------------- DPT-L


def test_dpt_large_depth_matches_jax(dpt_sd):
    """The narrow DPT-L at a 64x64 input: the 24x24 -> 4x4 position table
    shrinks (antialiased in both), and the stage-1/2 upsamplers take the
    carried (flipped) kernels."""
    tree = _jax_tree("dpt_large", dpt_sd)
    x = np.random.default_rng(8).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmidas.dpt_apply(tree, jnp.asarray(x)))
    sd = annotator_state_dict_from_jax("dpt_large", tree)
    net = _port(pmidas.DPT, "dpt_large", tree, **pmidas.dpt_shape(sd))
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
    assert got.shape == (1, 64, 64)
    assert_close_scaled(got, want, NET_TOL)


def test_position_table_resize_matches_jax():
    """24x24 -> 4x4 (shrink: jax.image.resize antialiases), -> 32x32 (grow)
    and -> 24x24 (kept)."""
    import jax

    pos = np.random.default_rng(9).standard_normal((1, 1 + 576, 8)).astype(np.float32)
    for side in (4, 32, 24):
        want = np.asarray(jmidas._resize_pos_embed(jnp.asarray(pos), side, side))
        got = pmidas.resize_pos_embed(torch.from_numpy(pos), side, side).numpy()
        assert_close_scaled(got, want, 1e-5)
    plain = F.interpolate(torch.from_numpy(pos[:, 1:]).reshape(1, 24, 24, 8)
                          .permute(0, 3, 1, 2), size=(4, 4), mode="bilinear")
    want = np.asarray(jax.image.resize(jnp.asarray(pos[:, 1:]).reshape(1, 24, 24, 8),
                                       (1, 4, 4, 8), "bilinear"))
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 0.1


def test_dpt_resample_is_upstream_conv_transpose(dpt_sd):
    """The port's stage-1 / stage-2 resampler on the upstream weight is
    F.conv_transpose2d with that weight; the JAX package's is the kernel
    mirrored in both spatial axes (its lax.conv_transpose lacks
    transpose_kernel), so the carry flips it and a file loads unflipped."""
    net = pmidas.DPT(**pmidas.dpt_shape(dpt_sd))
    load_strict(net, {k: torch.from_numpy(v) for k, v in dpt_sd.items()}, "dpt_large")
    tree = _jax_tree("dpt_large", dpt_sd)
    for i, stride in ((1, 4), (2, 2)):
        w = dpt_sd[f"pretrained.act_postprocess{i}.4.weight"]
        b = dpt_sd[f"pretrained.act_postprocess{i}.4.bias"]
        y = np.random.default_rng(10 + i).standard_normal((1, w.shape[0], 3, 5)).astype(
            np.float32)
        resample = getattr(getattr(net.pretrained, f"act_postprocess{i}"), "4")
        with torch.no_grad():
            got = resample(torch.from_numpy(y)).numpy()
        want = F.conv_transpose2d(torch.from_numpy(y), torch.from_numpy(w),
                                  torch.from_numpy(b), stride=stride).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        jax_out = np.asarray(jmidas._conv_transpose2d(
            jnp.asarray(np.transpose(y, (0, 2, 3, 1))), tree["reassemble"][f"post{i}"]["resample"],
            stride))
        jax_out = np.transpose(jax_out, (0, 3, 1, 2))
        assert np.abs(jax_out - want).max() > 0.1  # the JAX package mirrors it
        flipped = F.conv_transpose2d(torch.from_numpy(y),
                                     torch.from_numpy(np.ascontiguousarray(w[:, :, ::-1, ::-1])),
                                     torch.from_numpy(b), stride=stride).numpy()
        np.testing.assert_allclose(jax_out, flipped, rtol=1e-4, atol=1e-5)


def test_midas_detector_dpt_large_matches_jax(dpt_sd):
    tree = _jax_tree("dpt_large", dpt_sd)
    img = _image((70, 90, 3), 11)
    want = jmidas.MidasDetector(params=tree)(img)
    det = pmidas.MidasDetector(params=annotator_state_dict_from_jax("dpt_large", tree),
                               device="cpu")
    got = det(img)
    for g, w in zip(got, want):
        _within_one_level(g, w)
    assert got[0].shape == (70, 90) and got[1].shape == (70, 90, 3)


# ---------------------------------------------------------------- DPT-hybrid


def test_dpt_hybrid_depth_matches_jax(hybrid_tree):
    """The full-topology hybrid (the universe's shapes) at a 64x64 input."""
    x = np.random.default_rng(12).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jhybrid.dpt_hybrid_apply(hybrid_tree, jnp.asarray(x)))
    sd = annotator_state_dict_from_jax("dpt_hybrid", hybrid_tree)
    net = _port(phybrid.DPTHybrid, "dpt_hybrid", hybrid_tree, **phybrid.hybrid_shape(sd))
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
    assert got.shape == (1, 64, 64)
    assert_close_scaled(got, want, NET_TOL)


def test_midas_detector_dpt_hybrid_matches_jax(hybrid_tree):
    img = _image((64, 64, 3), 13)
    want = jmidas.MidasDetector(params=hybrid_tree, model_type="dpt_hybrid")(img)
    det = pmidas.MidasDetector(
        params=annotator_state_dict_from_jax("dpt_hybrid", hybrid_tree),
        model_type="dpt_hybrid", device="cpu")
    for g, w in zip(det(img), want):
        _within_one_level(g, w)


# ------------------------------------------------------------------ OpenPose


def test_body_net_matches_jax(body_tree):
    x = np.random.default_rng(14).standard_normal((1, 48, 40, 3)).astype(np.float32) * 0.3
    paf, heat = jpose.body_apply(body_tree, jnp.asarray(x))
    net = _port(ppose.BodyPoseModel, "openpose_body", body_tree)
    with torch.no_grad():
        gp, gh = net(_nchw(x))
    assert gp.shape == (1, 38, 6, 5) and gh.shape == (1, 19, 6, 5)
    assert_close_scaled(gp.permute(0, 2, 3, 1).numpy(), np.asarray(paf), NET_TOL)
    assert_close_scaled(gh.permute(0, 2, 3, 1).numpy(), np.asarray(heat), NET_TOL)


def test_hand_net_matches_jax(hand_tree):
    x = np.random.default_rng(15).standard_normal((1, 40, 40, 3)).astype(np.float32) * 0.3
    want = np.asarray(jpose.hand_apply(hand_tree, jnp.asarray(x)))
    net = _port(ppose.HandPoseModel, "openpose_hand", hand_tree)
    with torch.no_grad():
        got = net(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (1, 5, 5, 22)
    assert_close_scaled(got, want, NET_TOL)


def _synthetic_person(h=64, w=64):
    """Heat blobs at parts 1, 2, 5 and 8 and the PAFs between them."""
    heat = np.zeros((h, w, 19), np.float32)
    paf = np.zeros((h, w, 38), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    parts = {1: (20, 30), 2: (20, 16), 5: (20, 44), 8: (44, 24)}
    for part, (y, x) in parts.items():
        heat[:, :, part] = np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 18.0)
    paf[18:23, 16:31, 12] = -1.0   # 1 -> 2 (limb 0: channels 12, 13), leftwards
    paf[18:23, 30:45, 20] = 1.0    # 1 -> 5 (limb 1: channels 20, 21)
    for t in np.linspace(0, 1, 60):  # 1 -> 8 (limb 6: channels 0, 1)
        y, x = int(round(20 + 24 * t)), int(round(30 - 6 * t))
        paf[y - 1:y + 2, x - 1:x + 2, 0] = -6 / np.hypot(24, 6)
        paf[y - 1:y + 2, x - 1:x + 2, 1] = 24 / np.hypot(24, 6)
    return heat, paf


def test_pose_decode_exact_on_synthetic_maps():
    heat, paf = _synthetic_person()
    peaks = ppose.find_peaks(heat)
    assert peaks == jpose.find_peaks(heat)
    conns = ppose.score_limbs(paf, peaks, 64)
    want = jpose.score_limbs(paf, peaks, 64)
    assert len(conns) == len(want) and all(np.array_equal(a, b) for a, b in zip(conns, want))
    cand, subset = ppose.assemble_people(peaks, conns)
    jc, js = jpose.assemble_people(peaks, want)
    assert np.array_equal(cand, jc) and np.array_equal(subset, js)
    assert subset.shape == (1, 20) and subset[0, 19] == 4  # one person, 4 parts
    canvas = ppose.draw_bodypose(np.zeros((64, 64, 3), np.uint8), cand, subset)
    assert np.array_equal(canvas, jpose.draw_bodypose(np.zeros((64, 64, 3), np.uint8),
                                                      jc, js))
    assert canvas.sum() > 0


def test_device_peak_mask_exact_on_synthetic_maps():
    """The detector's composed upsample + gaussian and 4-neighbour mask on
    given net-size maps equals the JAX package's host chain (its
    test_virtual_decode reference), and the peaks it gives equal
    find_peaks on the materialised maps."""
    import cv2

    h = w = 128
    small = np.zeros((23, 23, 57), np.float32)
    yy, xx = np.mgrid[0:23, 0:23]
    small[:, :, 39] = np.exp(-((yy - 8) ** 2 + (xx - 6) ** 2) / 4.0)
    small[:, :, 40] = np.exp(-((yy - 14) ** 2 + (xx - 17) ** 2) / 4.0)
    small += np.random.default_rng(16).standard_normal(small.shape).astype(np.float32) * 0.01
    det = object.__new__(ppose.OpenposeDetector)
    det.device, det._mat_cache = torch.device("cpu"), {}
    # scale 0.5 of the 368 box: 184, a multiple of the stride -> 23 net rows
    wy, wx, wyg, wxg, (sh, sw), (ph, pw) = det._decode_matrices(h, w, 0.5)
    assert (sh, ph, ph // 8) == (184, 184, 23)
    mask = det._peak_mask(torch.from_numpy(small), wyg, wxg).numpy()
    m = np.einsum("hs,swc->hwc", jpose._gaussian_matrix(h) @ wy, small[:, :, 38:56])
    m = np.einsum("wt,htc->hwc", jpose._gaussian_matrix(w) @ wx, m)
    ref = m > 0.1
    ref[1:] &= m[1:] >= m[:-1]
    ref[:-1] &= m[:-1] >= m[1:]
    ref[:, 1:] &= m[:, 1:] >= m[:, :-1]
    ref[:, :-1] &= m[:, :-1] >= m[:, 1:]
    assert np.array_equal(mask, ref) and mask.sum() >= 2
    heat = small[:, :, 38:]
    full = cv2.resize(cv2.resize(heat, (pw, ph), interpolation=cv2.INTER_CUBIC)[:sh, :sw],
                      (w, h), interpolation=cv2.INTER_CUBIC)
    got = ppose.peaks_from_mask(mask.astype(np.uint8), heat, wy, wx)
    want = jpose.find_peaks(full)
    assert [[p[:2] for p in part] for part in got] == [[p[:2] for p in part] for part in want]


def test_openpose_detector_matches_jax(body_tree, hand_tree):
    """The whole detector on a 64x64 image: the net-size maps within
    NET_TOL, then the same mask, candidates, people and canvas."""
    img = _image((64, 64, 3), 17)
    jdet = jpose.OpenposeDetector(body_params=body_tree, hand_params=hand_tree)
    det = ppose.OpenposeDetector(
        body_params=annotator_state_dict_from_jax("openpose_body", body_tree),
        hand_params=annotator_state_dict_from_jax("openpose_hand", hand_tree), device="cpu")
    bgr = img[:, :, ::-1].copy()
    j_small, j_mask, _, _ = jdet._infer_fast(bgr)
    small, mask, _, _ = det._infer_fast(bgr)
    assert_close_scaled(small, j_small, NET_TOL)
    assert np.array_equal(mask, j_mask)
    canvas, meta = det(img)
    j_canvas, j_meta = jdet(img)
    assert np.array_equal(canvas, j_canvas)
    _same_people(meta, j_meta)


def _same_people(meta, want):
    """Candidates at the same pixels with the same ids and people of the
    same parts; the scores (sampled from the net's maps) within NET_TOL."""
    for key, exact in (("candidate", [0, 1, 3]), ("subset", list(range(18)) + [19])):
        got, ref = np.asarray(meta[key]), np.asarray(want[key])
        assert got.shape == ref.shape
        if got.size:
            assert np.array_equal(got[:, exact], ref[:, exact])
            score = 2 if key == "candidate" else 18
            np.testing.assert_allclose(got[:, score], ref[:, score], rtol=NET_TOL)


def test_hand_flow_matches_jax(hand_tree, monkeypatch):
    """hand=True with a person stubbed in (random body weights find none):
    the hand box, the hand net at one scale and the drawing, as the JAX
    detector (tests/test_pose_depth_mlsd.py's stub, in both packages)."""
    candidate = np.array([[30.0, 30.0, 0.9, 0], [60.0, 30.0, 0.9, 1], [90.0, 30.0, 0.9, 2]])
    subset = -1 * np.ones((1, 20))
    subset[0, 5], subset[0, 6], subset[0, 7] = 0, 1, 2
    subset[0, 18], subset[0, 19] = 2.7, 3
    for mod in (jpose, ppose):
        monkeypatch.setattr(mod, "assemble_people", lambda *_a, **_k: (candidate, subset))
    img = _image((128, 128, 3), 18)
    small_body = _jax_tree("openpose_body", universe_sd("openpose_body", 19))
    jdet = jpose.OpenposeDetector(body_params=small_body, hand_params=hand_tree)
    det = ppose.OpenposeDetector(
        body_params=annotator_state_dict_from_jax("openpose_body", small_body),
        hand_params=annotator_state_dict_from_jax("openpose_hand", hand_tree), device="cpu")
    got, meta = det(img, hand=True, hand_scales=(0.25,))
    want, j_meta = jdet(img, hand=True, hand_scales=(0.25,))
    assert np.array_equal(got, want)
    _same_people(meta, j_meta)
    base, _ = det(img, hand=False)
    assert not np.array_equal(base, got)


# ------------------------------------------------------- carry and loaders


@pytest.mark.parametrize("kind", KINDS)
def test_carry_inverts_the_jax_converter(kind):
    """universe state dict -> JAX converter -> annotator_state_dict_from_jax
    gives the state dict back, every key and value."""
    sd = universe_sd(kind, 20)
    back = annotator_state_dict_from_jax(kind, _jax_tree(kind, sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert np.array_equal(back[k].numpy(), v), k


def test_carry_flips_only_the_dpt_upsamplers(dpt_sd):
    back = annotator_state_dict_from_jax("dpt_large", _jax_tree("dpt_large", dpt_sd))
    assert set(back) == set(dpt_sd)
    flipped = {f"pretrained.act_postprocess{i}.4.weight" for i in (1, 2)}
    for k, v in dpt_sd.items():
        want = v[:, :, ::-1, ::-1] if k in flipped else v
        assert np.array_equal(back[k].numpy(), want), k
    with pytest.raises(KeyError, match="annotator kind"):
        annotator_state_dict_from_jax("mlsd", {})


def _detector(kind, sd):
    """The detector of `kind` on the CPU from a state dict of the upstream
    names."""
    if kind == "hed":
        return phed.HEDdetector(params=sd, device="cpu").net
    if kind == "dpt_hybrid":
        return pmidas.MidasDetector(params=sd, model_type="dpt_hybrid", device="cpu").net
    det = ppose.OpenposeDetector(**{("body" if kind.endswith("body") else "hand")
                                    + "_params": sd}, device="cpu")
    return det.body if kind.endswith("body") else det.hand


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fault", [None, "missing", "extra"])
def test_loader_takes_exactly_its_universe(kind, fault):
    """Each detector's strict load at full width from a state dict of exactly
    its universe's names and shapes: every key is taken; one missing key or
    one foreign key raises."""
    sd = {k: torch.from_numpy(v) for k, v in universe_sd(kind, 21).items()}
    n = {"hed": 37, "dpt_hybrid": 358, "openpose_body": 184, "openpose_hand": 102}[kind]
    assert len(sd) == n
    if fault == "missing":
        del sd[sorted(sd)[n // 2]]
    elif fault == "extra":
        sd["lora_unet.alpha"] = torch.zeros(1)
    if fault:
        with pytest.raises(ConversionAccountingError, match=kind):
            _detector(kind, sd)
        return
    net = _detector(kind, sd)
    state = net.state_dict()
    assert set(state) == set(sd)
    assert all(torch.equal(state[k], sd[k]) for k in sd)


def test_loader_reads_a_file(tmp_path):
    """ckpt_path goes through checkpoint/torch_reader.py (a nested
    state_dict unwrapped), and a DPT file's timm head and final norm are
    documented leftovers."""
    sd = {k: torch.from_numpy(v) for k, v in universe_sd("hed", 22).items()}
    path = tmp_path / "ControlNetHED.pth"
    torch.save(sd, path)
    net = phed.HEDdetector(ckpt_path=str(path), device="cpu").net
    assert all(torch.equal(net.state_dict()[k], sd[k]) for k in sd)
    dpt = {k: torch.from_numpy(v) for k, v in narrow_dpt_sd(23).items()}
    extra = {"pretrained.model.norm.weight": torch.ones(64),
             "pretrained.model.norm.bias": torch.zeros(64),
             "pretrained.model.head.weight": torch.zeros(1000, 64),
             "pretrained.model.head.bias": torch.zeros(1000)}
    path = tmp_path / "dpt_large-midas-2f21e586.pt"
    torch.save({"state_dict": {**dpt, **extra}}, path)
    net = pmidas.MidasDetector(ckpt_path=str(path), device="cpu").net
    assert set(net.state_dict()) == set(dpt)
