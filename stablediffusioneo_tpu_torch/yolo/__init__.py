"""YOLOv5 of the port (counterpart of stablediffusioneo_tpu/yolo/; the
reference's practice_yolov5/): the letterbox pre-processing, the detector
(yolo/model.py) and the NMS post-processing."""

from stablediffusioneo_tpu_torch.yolo.model import init_yolov5, load_yolov5, yolov5_detect
from stablediffusioneo_tpu_torch.yolo.pipeline import (
    PostProcessor,
    PreProcessor,
    draw_boxes,
    nms,
)

__all__ = ["PreProcessor", "PostProcessor", "nms", "draw_boxes", "init_yolov5",
           "load_yolov5", "yolov5_detect"]
