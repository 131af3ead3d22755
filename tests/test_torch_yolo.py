"""The port's YOLOv5 (stablediffusioneo_tpu_torch/yolo/: the detector, the
letterbox pre-processing, the NMS post-processing) against the JAX
package's, fp32 on the CPU.

No key universe of YOLOv5 is in the repository: the key set is the one the
JAX convert_yolov5 reads (held here by recording its reads), and the
weights are drawn with numpy at the port module's names and shapes
(BatchNorm statistics away from the identity). The port loads that state
dict; the JAX package runs its converter's folded tree. Tolerances: the
decoded predictions of a 160x160 image within 1e-4 of max |JAX|; the
pre- and post-processing exact on the same inputs (the post-processing on
the port's own prediction tensor); the carry exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.yolo import model as jmodel
from stablediffusioneo_tpu.yolo import pipeline as jpipe
from stablediffusioneo_tpu_torch import yolo as port_yolo
from stablediffusioneo_tpu_torch.checkpoint.accounting import ConversionAccountingError
from stablediffusioneo_tpu_torch.checkpoint.convert import folded_state_dict_from_jax
from stablediffusioneo_tpu_torch.yolo import model as pmodel
from stablediffusioneo_tpu_torch.yolo import pipeline as ppipe

from torch_port_util import assert_close_scaled, draw_upstream, with_batch_norms

NET_TOL = 1e-4


class _Reads(dict):
    """A dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def yolo_sd(seed):
    """{name: float32 array} at the port YOLOv5's names and shapes."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in pmodel.YOLOv5().state_dict().items()}
    return with_batch_norms({k: draw_upstream(rng, k, s) for k, s in sorted(shapes.items())},
                            rng)


def _torch(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def sd():
    return yolo_sd(61)


@pytest.fixture(scope="module")
def tree(sd):
    return jmodel.convert_yolov5(sd)


@pytest.fixture(scope="module")
def net(sd):
    return port_yolo.load_yolov5(_torch(sd), device="cpu")


def test_key_set_is_what_convert_yolov5_reads(sd):
    reads = _Reads(sd)
    jmodel.convert_yolov5(reads)
    assert reads.read == set(sd)
    assert len(sd) == 291 and not any("num_batches" in k for k in sd)


def test_predictions_match_jax(net, tree):
    """(1, 3 x (400 + 100 + 25), 85) decoded rows of a 160x160 image in
    [0, 1]: boxes in pixels, objectness and class scores."""
    x = np.random.default_rng(62).random((1, 160, 160, 3)).astype(np.float32)
    want = np.asarray(jmodel.yolov5_apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = pmodel.yolov5_apply(net, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (1, 3 * (400 + 100 + 25), 85) and got.dtype == np.float32
    assert_close_scaled(got[..., :4], want[..., :4], NET_TOL)
    assert_close_scaled(got[..., 4:], want[..., 4:], NET_TOL)


def test_detect_is_the_top_k_of_the_predictions(net):
    """yolov5_detect on the uint8 image: the rows of yolov5_apply(x / 255)
    with the k largest objectness scores, in descending order."""
    img = (np.random.default_rng(63).random((1, 128, 160, 3)) * 255).astype(np.uint8)
    u8 = torch.from_numpy(img)
    with torch.no_grad():
        full = pmodel.yolov5_apply(net, (u8.float() / 255.0).permute(0, 3, 1, 2))[0]
    order = torch.argsort(full[:, 4], descending=True, stable=True)
    for k in (300, 17):
        top = pmodel.yolov5_detect(net, u8, k=k)
        assert top.shape == (1, k, 85) and top.dtype == torch.float32
        assert torch.equal(top[0, :, 4], full[order[:k], 4])
        assert torch.equal(top[0], full[top_rows(full, top[0])])


def top_rows(full, top):
    """The row index of each of `top`'s rows in `full` (rows are distinct)."""
    return torch.tensor([int(torch.nonzero((full == row).all(dim=1))[0]) for row in top])


@pytest.mark.parametrize("shape", [(720, 1280, 3), (300, 200, 3), (64, 64, 3)])
def test_preprocessor_is_exact(shape):
    img = (np.random.default_rng(64).random(shape) * 255).astype(np.uint8)
    got, want = ppipe.PreProcessor(160, 160)(img), jpipe.PreProcessor(160, 160)(img)
    assert got[0].shape == (160, 160, 3) and np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("conf,iou", [(0.2, 0.45), (0.3, 0.3), (0.99, 0.45)])
def test_postprocessor_and_nms_exact_on_the_same_predictions(net, conf, iou):
    img = (np.random.default_rng(65).random((1, 160, 160, 3)) * 255).astype(np.uint8)
    pred = pmodel.yolov5_detect(net, torch.from_numpy(img), k=300).numpy()
    args = (conf, iou, 0, 0, 1280 / 160, 720 / 160)
    got, want = ppipe.PostProcessor(*args)(pred), jpipe.PostProcessor(*args)(pred)
    assert len(got) == len(want) == 1
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    if conf < 0.99:
        assert len(got[0]) > 0
    det = got[0]
    if len(det):
        assert np.array_equal(ppipe.nms(det[:, :4], det[:, 4], 0.1),
                              jpipe.nms(det[:, :4], det[:, 4], 0.1))
        canvas = np.zeros((720, 1280, 3), np.uint8)
        assert np.array_equal(ppipe.draw_boxes(canvas, det), jpipe.draw_boxes(canvas, det))


def test_carry_round_trip_is_exact(tree):
    back = folded_state_dict_from_jax("yolov5", tree)
    assert set(back) == set(pmodel.YOLOv5().state_dict())
    again = jmodel.convert_yolov5({k: v.numpy() for k, v in back.items()})
    leaves, ref = jax.tree.leaves_with_path(again), jax.tree.leaves_with_path(tree)
    assert [p for p, _ in leaves] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(leaves, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.parametrize("fault", [None, "missing", "shape", "extra", "leftovers"])
def test_loader_takes_exactly_its_key_set(sd, fault):
    """load_yolov5 takes every key; a missing key, a wrong shape or a
    foreign key raises; an upstream file's BatchNorm counters and Detect
    anchors are ignored."""
    sd = _torch(sd)
    victim = "model.8.m.0.cv2.conv.weight"
    if fault == "missing":
        del sd[victim]
    elif fault == "shape":
        sd[victim] = torch.zeros((256, 256, 1, 1))
    elif fault == "extra":
        sd["model.25.conv.weight"] = torch.zeros(1)
    elif fault == "leftovers":
        sd["model.0.bn.num_batches_tracked"] = torch.tensor(0)
        sd["model.24.anchors"] = torch.zeros((3, 3, 2))
    if fault in ("missing", "shape", "extra"):
        with pytest.raises(ConversionAccountingError, match="yolov5"):
            port_yolo.load_yolov5(sd, device="cpu")
        return
    net = port_yolo.load_yolov5(sd, device="cpu")
    state = net.state_dict()
    assert all(torch.equal(state[k], sd[k]) for k in state)
    with pytest.raises(ValueError, match="params or ckpt_path"):
        port_yolo.load_yolov5()


def test_loader_reads_a_file_and_init_is_seeded(tmp_path, sd):
    path = tmp_path / "yolov5s_state_dict.pt"
    torch.save(_torch(sd), path)
    net = port_yolo.load_yolov5(ckpt_path=str(path), device="cpu")
    assert all(torch.equal(net.state_dict()[k], torch.from_numpy(sd[k])) for k in sd)
    a, b, c = (port_yolo.init_yolov5(s, device="cpu").state_dict() for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.0.conv.weight"], c["model.0.conv.weight"])
    assert not a["model.24.m.0.weight"].requires_grad


def test_entries_default_to_the_card_in_bf16(sd, monkeypatch):
    """load_yolov5 and init_yolov5 put the net on the card unless the caller
    names another device, in the annotators' dtype policy: bf16 on the card,
    fp32 on the CPU."""
    from stablediffusioneo_tpu_torch.annotators._dtype import annotator_dtype

    monkeypatch.delenv("SDEO_ANNOTATOR_DTYPE", raising=False)
    seen = []

    def cast(net, device, dtype=None):
        seen.append((device, annotator_dtype(device) if dtype is None else dtype))
        return net

    monkeypatch.setattr(pmodel, "cast_module", cast)
    port_yolo.load_yolov5(_torch(sd))
    port_yolo.init_yolov5(0)
    assert seen == [(torch.device("cuda"), torch.bfloat16)] * 2
    monkeypatch.undo()
    for net in (port_yolo.load_yolov5(_torch(sd), device="cpu"),
                port_yolo.init_yolov5(0, device="cpu")):
        assert {(p.device.type, p.dtype) for p in net.parameters()} == {("cpu", torch.float32)}


def test_exports_cover_the_jax_packages():
    from stablediffusioneo_tpu import yolo as jax_yolo

    assert set(jax_yolo.__all__) <= set(port_yolo.__all__)
    assert port_yolo.yolov5_detect is pmodel.yolov5_detect
