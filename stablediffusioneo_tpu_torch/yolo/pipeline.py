"""YOLOv5 pre- and post-processing of the port (counterpart of
stablediffusioneo_tpu/yolo/pipeline.py, whose code this is: numpy and cv2
only, held to the original by tests/test_torch_imports.py).

  - `PreProcessor` letterbox: aspect-preserving INTER_AREA resize, 114-gray
    centre padding, /255 (practice_yolov5/misc.py:95-144), NHWC float32;
  - `PostProcessor` (misc.py:149-243): objectness filter, conf = obj * cls,
    xywh -> xyxy with the ratio, class filter, then `nms`: greedy IoU
    suppression with torchvision.ops.nms's semantics, in numpy;
  - `draw_boxes` (misc.py:247-283).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np


class PreProcessor:
    """Letterbox to (inpHeight, inpWidth): resize keeping aspect, center-pad
    with 114 gray, scale to [0,1] float32 NHWC."""

    def __init__(self, inp_height: int, inp_width: int):
        self.inp_height = inp_height
        self.inp_width = inp_width

    def __call__(self, image: np.ndarray) -> Tuple[np.ndarray, float, int, int]:
        src_h, src_w = image.shape[:2]
        hw_scale = src_h / src_w
        left = top = 0
        if hw_scale > 1:
            new_h = self.inp_height
            new_w = int(self.inp_width / hw_scale)
            resized = cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_AREA)
            left = int((self.inp_width - new_w) * 0.5)
            padded = cv2.copyMakeBorder(
                resized, 0, 0, left, self.inp_width - new_w - left,
                cv2.BORDER_CONSTANT, value=(114, 114, 114),
            )
        else:
            new_h = int(self.inp_height * hw_scale)
            new_w = self.inp_width
            resized = cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_AREA)
            top = int((self.inp_height - new_h) * 0.5)
            padded = cv2.copyMakeBorder(
                resized, top, self.inp_height - new_h - top, 0, 0,
                cv2.BORDER_CONSTANT, value=(114, 114, 114),
            )
        out = np.ascontiguousarray(padded, dtype=np.float32) / 255.0
        return out, hw_scale, left, top


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU for xyxy boxes: (Na, 4) x (Nb, 4) -> (Na, Nb)."""
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    area_b = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    lt = np.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = np.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float) -> np.ndarray:
    """Greedy NMS with torchvision.ops.nms semantics: input must be sorted
    or not — returns kept indices in descending-score order."""
    order = np.argsort(-scores, kind="stable")
    keep: List[int] = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        ious = iou_matrix(boxes[i : i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= iou_thresh]
    return np.asarray(keep, np.int64)


class PostProcessor:
    """YOLOv5 head decode + NMS (misc.py:149-243)."""

    def __init__(
        self,
        conf_thresh: float,
        nms_thresh: float,
        left: int,
        top: int,
        ratio_w: float,
        ratio_h: float,
    ):
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.left = left
        self.top = top
        self.ratio_w = ratio_w
        self.ratio_h = ratio_h

    def xywh2xyxy(self, x: np.ndarray) -> np.ndarray:
        y = np.copy(x)
        y[:, 0] = (x[:, 0] - x[:, 2] / 2) * self.ratio_w
        y[:, 1] = (x[:, 1] - x[:, 3] / 2) * self.ratio_h
        y[:, 2] = (x[:, 0] + x[:, 2] / 2) * self.ratio_w
        y[:, 3] = (x[:, 1] + x[:, 3] / 2) * self.ratio_h
        return y

    def __call__(
        self,
        prediction: np.ndarray,
        classes: Optional[Sequence[int]] = None,
    ) -> List[np.ndarray]:
        """prediction: (B, anchors, 4+1+C) -> per-image (n, 6) arrays of
        (x1, y1, x2, y2, cls_conf, cls)."""
        prediction = np.asarray(prediction, np.float32)
        bs = prediction.shape[0]
        nc = prediction.shape[2] - 5
        obj_mask = prediction[..., 4] > self.conf_thresh
        output = [np.zeros((0, 6), np.float32)] * bs
        for xi in range(bs):
            x = prediction[xi][obj_mask[xi]]
            if x.shape[0] == 0:
                continue
            x[:, 5:] *= x[:, 4:5]  # conf = obj_conf * cls_conf
            box = self.xywh2xyxy(x[:, :4])
            j = np.argmax(x[:, 5 : 5 + nc], axis=1)
            cls_conf = x[np.arange(len(x)), 5 + j]
            det = np.concatenate(
                [box, cls_conf[:, None], j[:, None].astype(np.float32)], axis=1
            )
            det = det[cls_conf > self.conf_thresh]
            if classes is not None:
                det = det[np.isin(det[:, 5].astype(int), np.asarray(classes))]
            if det.shape[0] == 0:
                continue
            det = det[np.argsort(-det[:, 4], kind="stable")]
            keep = nms(det[:, :4], det[:, 4], self.nms_thresh)
            output[xi] = det[keep]
        return output


def draw_boxes(
    image: np.ndarray,
    detections: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Render (n, 6) detections onto a copy of the image (misc.py:247-283)."""
    img = image.copy()
    for x1, y1, x2, y2, conf, cls in detections:
        p1, p2 = (int(x1), int(y1)), (int(x2), int(y2))
        cv2.rectangle(img, p1, p2, (0, 255, 0), 2)
        name = (
            class_names[int(cls)]
            if class_names and int(cls) < len(class_names)
            else str(int(cls))
        )
        label = f"{name} {conf:.2f}"
        cv2.putText(
            img, label, (p1[0], max(p1[1] - 4, 10)),
            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1,
        )
    return img
