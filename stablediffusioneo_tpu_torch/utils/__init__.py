"""Shared utilities (counterpart of stablediffusioneo_tpu/utils/: the
reference's ldm/util.py and scattered helpers), plus the native libraries'
loader (utils/native.py)."""

from stablediffusioneo_tpu_torch.utils.misc import (
    seed_everything,
    log_txt_as_img,
    count_params,
)
from stablediffusioneo_tpu_torch.utils.debug import assert_finite, nan_report

__all__ = [
    "seed_everything",
    "log_txt_as_img",
    "count_params",
    "assert_finite",
    "nan_report",
]
