"""Checkpoints: reading a file, accounting for its keys, loading the model.

`load_controlnet_pipeline(path)` is the counterpart of the JAX package's
checkpoint/convert.py:load_controlnet_pipeline: a `control_sd15_*.pth` (or
.ckpt, .safetensors) becomes a `ControlLDM` holding the file's weights. The
port keeps the checkpoint's key names, so nothing is converted; every key is
accounted for (checkpoint/accounting.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from stablediffusioneo_tpu_torch.checkpoint.accounting import account_checkpoint
from stablediffusioneo_tpu_torch.checkpoint.torch_reader import load_torch_state_dict
from stablediffusioneo_tpu_torch.config import PipelineConfig, sd15_pipeline


def load_controlnet_pipeline(path: str, cfg: Optional[PipelineConfig] = None,
                             device="cuda", strict: bool = True):
    """The ControlLDM of `cfg` (default SD-1.5) holding the weights of the
    checkpoint at `path`, in fp32 on `device`. The model is built on the
    meta device and materialised on `device` only, so the full width never
    passes through host memory twice. strict=True raises
    ConversionAccountingError on any key the model does not consume and that
    SD_KNOWN_UNUSED does not document; missing keys and wrong shapes raise
    either way. The accounting is kept as `model.load_report`."""
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM

    cfg = cfg or sd15_pipeline()
    sd = load_torch_state_dict(path)
    with torch.device("meta"):
        model = ControlLDM(cfg)
    report = account_checkpoint(model, sd).assert_complete(
        "controlnet_pipeline", orphans=strict)
    model.to_empty(device=device)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(sd[name])
    model.load_report = report
    return model.eval().requires_grad_(False)
