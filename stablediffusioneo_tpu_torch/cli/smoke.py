"""Smoke test, the trt_check.py analog (trt_check.py:1-14), of the port
(counterpart of stablediffusioneo_tpu/cli/smoke.py): bring up the CLIP
engine (runtime/engine.py:CNSDRuntime.clip_engine, a captured CUDA graph on
the card) over seeded weights, encode random token ids and print the
output's stats and the engine's info.

Usage: sdeo-smoke-torch [--tiny] [--cpu]   (--tiny: the seeded tiny
configuration instead of the SD-1.5 widths; --cpu: the CPU instead of the
card).
"""

import argparse
import sys

import numpy as np


def bring_up(tiny: bool = False, device="cuda"):
    """(the CLIP engine's output for one row of seeded random ids, the
    engine's get_engine_infor()) of a runtime over a seeded ControlLDM."""
    import torch

    from stablediffusioneo_tpu_torch.config import sd15_pipeline, tiny_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, seeded
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime

    cfg = tiny_pipeline() if tiny else sd15_pipeline()
    model = seeded(lambda: ControlLDM(cfg), torch.Generator(device=device).manual_seed(0), device)
    rt = CNSDRuntime(model, cfg, device=device)
    ids = np.random.default_rng(0).integers(
        0, cfg.clip.vocab_size, (1, cfg.clip.max_length)).astype(np.int32)
    out = rt.encode_prompt(ids)
    return out, rt.clip_engine(1).get_engine_infor()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    out, info = bring_up(args.tiny, "cpu" if args.cpu else "cuda")
    print("clip engine OK:", tuple(out.shape), out.dtype,
          "mean|x|=", float(out.float().abs().mean()))
    print(info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
