"""Serving layer: cross-request batching over the captured engines
(counterpart of stablediffusioneo_tpu/serving/). Concurrent requests whose
engine matches (resolution, steps, sampler, guess mode, context length, hint
variant, ...) are gathered into one batched `sample_decode` call, with
per-request prompts, seeds, guidance scales and control strengths inside the
batch."""

from stablediffusioneo_tpu_torch.serving.scheduler import (  # noqa: F401
    decide_cut,
    next_deadline_ms,
    pick_group,
)
from stablediffusioneo_tpu_torch.serving.server import (  # noqa: F401
    DiffusionServer,
    GenRequest,
)


def make_http_server(*args, **kwargs):  # noqa: D103 — lazy re-export
    from stablediffusioneo_tpu_torch.serving.http_api import make_http_server as f

    return f(*args, **kwargs)
