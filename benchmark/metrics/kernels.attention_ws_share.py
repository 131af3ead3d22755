"""kernels.attention_ws_share: the attention launches on the card that ran
the warp-specialised variant (`wgmma_ws`), as a share of all attention
launches on the card, over the process, percent. It reads the program's
counter `stablediffusioneo_tpu_torch.ops.kernels.attention.variant_launches`,
launches by variant name; a captured engine adds its launches at every
replay. None where the program has no such variant (its `VARIANTS` lacks
`wgmma_ws`) or launched no attention kernel."""

import importlib


def read(run):
    try:
        attention = importlib.import_module("stablediffusioneo_tpu_torch.ops.kernels.attention")
    except ImportError:
        return None
    if "wgmma_ws" not in getattr(attention, "VARIANTS", {}):
        return None
    counts = getattr(attention, "variant_launches", None)
    total = sum(counts.values()) if counts else 0
    if total <= 0:
        return None
    return 100.0 * counts["wgmma_ws"] / total
