"""Model families: how the program builds and serves a configuration.

A configuration file names its `family`; `benchmark/families/<family>.py`
gives `build(cfg, seed, device) -> (model, program config)`, `ENTRIES` (the
entries a traffic file may name, each a class with `warm`, `run(request) ->
Output`, `engines`, `counters`, `reset`, `close` and `clients_max`: None
where it takes any number of callers at once), `reference_module(cfg)` (the
float32 reference networks under the checkpoint's names, whose state dict
the benchmark draws from the seed for both sides), `reference_request(net,
cfg, request) -> (latents, image)`, and the work it counts from the
configuration's shapes: `flops_per_image(cfg)` (for `mfu`) and
`attention_calls(cfg, batch)` (for `kernels.attention_roofline`; see
`benchmark/work.py`). A new configuration of a known family adds only its
configuration file; a new family adds its module and its configuration
file.
"""

from __future__ import annotations

import importlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from benchmark.weights import draw_state_dict

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Output(NamedTuple):
    image: np.ndarray                # uint8 (H, W, 3) on the host
    latents: Optional[torch.Tensor]  # fp32 x_0 latents NHWC, where the entry gives them
    spans: Dict[str, float]          # the request's own spans, by metric name


def load(family: str):
    return importlib.import_module(f"benchmark.families.{family}")


def program_model(make, reference_layout, seed, device, dtype):
    """The program's model from `make()` (built on the meta device, then
    given storage in `dtype` on `device`), loaded through its checkpoint
    loader with the state dict drawn from `seed` under the checkpoint's
    names (the layout of the module `reference_layout()` builds)."""
    with torch.device("meta"):
        model = make()
        layout = reference_layout()
    model = model.to(DTYPES[dtype]).to_empty(device=device)
    sd = draw_state_dict(layout, seed, device, DTYPES[dtype])
    model.load_checkpoint(sd)
    del sd
    return model.eval().requires_grad_(False)
