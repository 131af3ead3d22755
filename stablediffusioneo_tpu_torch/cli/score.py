"""End-to-end scoring entry of the port, the compute_score.py equivalent
(counterpart of stablediffusioneo_tpu/cli/score.py).

Runs the port's canny2image pipeline over fixture images, compares each
output with its golden by the perceptual distance and prints the hackathon
score (compute_score.py:40-73; the fixtures are the seeded synthetic scenes
of testing/fixtures.py unless --fixtures names a directory of bird_{i}.jpg).

  sdeo-score-torch --ckpt control_sd15_canny.pth --tokenizer DIR [--golden-dir DIR]
      [--steps 20] [--res 256] [--n 5]
  sdeo-score-torch --cpu          # seeded tiny weights, 64x64, 2 steps

With no --golden-dir the goldens are a first pass of the same pipeline
(self-consistency: the distance then measures run-to-run determinism, which
must be 0). Without --ckpt the weights are seeded tiny ones. The pipeline
runs on the card unless --cpu. The distance uses the harness's default
extractor (pixel statistics), as the JAX CLI.
"""

import argparse
import os
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fixtures", default=None)
    ap.add_argument("--golden-dir", default=None)
    ap.add_argument("--ckpt", default=os.environ.get("SDEO_CKPT"))
    ap.add_argument("--tokenizer", default=os.environ.get("SDEO_TOKENIZER"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2946901)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if args.ckpt and not args.tokenizer:
        ap.error("--ckpt needs --tokenizer (a CLIP tokenizer directory)")
    return args


def build_pipeline(args, device):
    """(pipeline, steps, resolution): the loaded checkpoint's, or seeded tiny
    weights at 64x64 and 2 steps at most."""
    import torch

    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    if args.ckpt:
        from stablediffusioneo_tpu_torch.checkpoint import load_controlnet_pipeline
        from stablediffusioneo_tpu_torch.config import sd15_pipeline
        from stablediffusioneo_tpu_torch.models.tokenizer import CLIPTokenizer

        cfg = sd15_pipeline()
        model = load_controlnet_pipeline(args.ckpt, cfg, device=device)
        pipe = Canny2ImagePipeline(model, CLIPTokenizer.from_pretrained(args.tokenizer), cfg,
                                   device=device)
        return pipe, args.steps, args.res
    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights
    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer

    cfg = tiny_pipeline()
    model = ControlLDM(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    tok = toy_tokenizer(vocab_size=cfg.clip.vocab_size, max_length=cfg.clip.max_length)
    pipe = Canny2ImagePipeline(model, tok, cfg, device=device)
    return pipe, min(args.steps, 2), min(args.res, 64)


def score(args) -> dict:
    """The scoring run of parsed `args`: the harness's result dict (mean
    latency, distance and score, one record a fixture)."""
    import cv2

    from stablediffusioneo_tpu_torch.scoring import ScoreHarness

    device = "cpu" if args.cpu else "cuda"
    pipe, steps, res = build_pipeline(args, device)
    if args.fixtures:
        images = [cv2.imread(os.path.join(args.fixtures, f"bird_{i}.jpg"))[:, :, ::-1]
                  for i in range(args.n)]
    else:
        from stablediffusioneo_tpu_torch.testing.fixtures import make_scene

        # drawn at --res, as the JAX CLI draws them: process() resizes them
        # to the tiny path's clamped resolution
        images = [make_scene(1000 + i, args.res) for i in range(args.n)]
    kwargs = dict(prompt="a bird", ddim_steps=steps, image_resolution=res, seed=args.seed)
    if args.golden_dir:
        goldens = [cv2.imread(os.path.join(args.golden_dir, f"bird_{i}.jpg"))[:, :, ::-1]
                   for i in range(args.n)]
    else:
        print("generating self-consistency goldens (first pass)...", flush=True)
        goldens = [pipe.process(img, num_samples=1, **kwargs)[-1] for img in images]
    result = ScoreHarness(pipe.process).run(images, goldens, **kwargs)
    print(f"mean latency: {result['mean_t_ms']:.0f} ms")
    print(f"mean perceptual distance: {result['mean_pd']:.3f}")
    print(f"mean score: {result['mean_score']:.3f}")
    return result


def main(argv=None) -> int:
    """The console entry: the exit code, 0 once the run has scored every
    fixture (a failing run raises). `score(parse_args(argv))` returns the
    result itself."""
    score(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
