"""Real-checkpoint readiness of the port: one command from weights to a
parity verdict (counterpart of stablediffusioneo_tpu/cli/readiness.py).

The day `control_sd15_canny.pth` (+ CLIP vocab/merges) is available, this
runs the full-scale parity check: the port on the card (bf16, captured
engines, the CUDA kernels) against an independent run of the port built
from the SAME file, in fp32 on the CPU, where every kernel takes its plain
PyTorch version (the path the CPU tests hold against the JAX package),
scored with the hackathon perceptual-distance formula (the
`compute_score_torch` analog, reference compute_score.py:40-73).

    sdeo-readiness-torch --ckpt control_sd15_canny.pth \\
        --vocab vocab.json --merges merges.txt [--res 512 --steps 20 --n 3]

Stages:
  1. strict key accounting of the checkpoint (every key consumed, or one
     that SD_KNOWN_UNUSED documents) and a load onto the card;
  2. the reference: the same file loaded in fp32 on the CPU; its images of
     the fixtures are the goldens (slow at 512x512: cache them with
     --save-goldens, reuse them with --golden-dir);
  3. the card's run on the same fixtures and the same x_T;
  4. per-image PD + hackathon score; exit 1 if the mean PD exceeds
     --pd-limit (default 10, the score formula's zero-penalty knee).

`--dry-run` takes the identical flow end to end on seeded tiny-config
weights, written to a temporary file first (no files needed). `--cpu` runs
the "card" side on the CPU too. `--verify-manifest` / `--pin-manifest` check
files against the packaged manifest (checkpoint/manifest.py);
`--offline-drill` runs testing/offline_drill.py.
"""

import argparse
import os
import sys
import time

import numpy as np

PROMPT = "a bird"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt")
    ap.add_argument("--vocab")
    ap.add_argument("--merges")
    ap.add_argument("--golden-dir", help="reuse cached reference goldens")
    ap.add_argument("--save-goldens", help="write the reference goldens here")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2946901)
    ap.add_argument("--pd-limit", type=float, default=10.0)
    ap.add_argument("--dry-run", action="store_true",
                    help="seeded tiny-config weights, no files needed")
    ap.add_argument("--verify-manifest", nargs="*", metavar="FILE",
                    help="verify downloaded weight files against the "
                         "packaged manifest (integrity + required key "
                         "universe) and exit; with no FILEs, verifies "
                         "--ckpt/--vocab/--merges before the parity check")
    ap.add_argument("--pin-manifest", nargs="+", metavar="FILE",
                    help="first trusted contact: structure-check FILEs, "
                         "then record sha256+size into the manifest")
    ap.add_argument("--manifest", default=None,
                    help="manifest json path (default: the packaged one)")
    ap.add_argument("--offline-drill", nargs="*", metavar="FAMILY",
                    help="real-weight drill without network: synthesize "
                         "FULL-WIDTH state dicts from the packaged key "
                         "universes, write real .pth/.safetensors files, "
                         "then run manifest verify -> strict load -> one "
                         "inference per family. No FAMILYs = all (sd15 sdxl "
                         "hed openpose mlsd dpt_hybrid uniformer inception)")
    ap.add_argument("--drill-res", type=int, default=256,
                    help="sample resolution for the drill's sd15/sdxl legs")
    ap.add_argument("--drill-steps", type=int, default=1,
                    help="sampler steps for the drill's sd15/sdxl legs")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    weights = args.ckpt and args.vocab and args.merges
    if args.offline_drill is None:
        if args.pin_manifest is None and args.verify_manifest is not None \
                and not (args.verify_manifest or args.ckpt or args.vocab or args.merges):
            ap.error("--verify-manifest needs FILEs (or --ckpt/--vocab/--merges)")
        if not (args.pin_manifest or args.verify_manifest is not None or args.dry_run
                or weights):
            ap.error("--ckpt/--vocab/--merges required (or --dry-run)")
    return args


def check_manifest(args) -> bool:
    """--verify-manifest / --pin-manifest: one OK / PINNED / REJECTED line a
    file. Returns whether every file passed."""
    from stablediffusioneo_tpu_torch.checkpoint.manifest import (
        ManifestError,
        pin_file,
        verify_file,
    )

    files = (args.pin_manifest or args.verify_manifest
             or [f for f in (args.ckpt, args.vocab, args.merges) if f])
    failed = False
    for f in files:
        try:
            if args.pin_manifest:
                e = pin_file(f, manifest_path=args.manifest)
                print(f"PINNED {f}: sha256={e['sha256'][:16]}… ({e['size_bytes']} B)")
            else:
                rep = verify_file(f, manifest_path=args.manifest)
                print(f"OK {f}: {rep}")
        except ManifestError as e:
            print(f"REJECTED {f}:\n{e}")
            failed = True
    return not failed


def _dry_run_files(args, directory):
    """--dry-run: the tiny configuration's seeded ControlLDM written to a
    .pth in `directory` (every key under its checkpoint name, as a real file
    holds them) and the toy tokenizer; res 64, 2 steps, 2 images."""
    import torch

    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights
    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer

    cfg = tiny_pipeline()
    args.res, args.steps, args.n = 64, 2, 2
    model = ControlLDM(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    args.ckpt = os.path.join(directory, "tiny_seeded.pth")
    torch.save(model.state_dict(), args.ckpt)
    return cfg, toy_tokenizer(vocab_size=cfg.clip.vocab_size, max_length=cfg.clip.max_length)


def _pipeline(path, cfg, tok, device):
    from stablediffusioneo_tpu_torch.checkpoint import load_controlnet_pipeline
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline
    from stablediffusioneo_tpu_torch.runtime.engine import DTYPES

    model = load_controlnet_pipeline(path, cfg, device=device, dtype=DTYPES[cfg.dtype])
    return model.load_report, Canny2ImagePipeline(model, tok, cfg, device=device)


def parity(args) -> dict:
    """Stages 1-4 (--dry-run, or --ckpt / --vocab / --merges); returns {"pds",
    "mean_pd", "times_ms", "scores", "pass", "consumed", "ignored",
    "latent_errs", "ref_latents", "pipeline", "kwargs", "images"}.
    latent_errs[i] is max |z - z_ref| / max |z_ref| of image i's final
    latents (None with --golden-dir, which keeps no latents): seeded or
    untrained weights decode to near-flat images whose PD moves little, and
    the latents still show what the nets did. The verdict stays the PD's."""
    import dataclasses
    import tempfile

    import cv2

    from stablediffusioneo_tpu_torch.annotators.util import HWC3, resize_image
    from stablediffusioneo_tpu_torch.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.scoring.score import get_score, perceptual_distance
    from stablediffusioneo_tpu_torch.testing.fixtures import make_scene

    device = "cpu" if args.cpu else "cuda"
    with tempfile.TemporaryDirectory() as directory:
        if args.dry_run:
            cfg, tok = _dry_run_files(args, directory)
        else:
            from stablediffusioneo_tpu_torch.models.tokenizer import CLIPTokenizer

            cfg = sd15_pipeline(dtype="bfloat16" if device == "cuda" else "float32")
            tok = CLIPTokenizer.from_hf_files(args.vocab, args.merges,
                                              max_length=cfg.clip.max_length)
        # stage 1: strict accounting, then the card's pipeline: a real
        # checkpoint either maps 100% (modulo the documented SD_KNOWN_UNUSED
        # buffers) or this raises naming the orphan keys
        rep, pipe = _pipeline(args.ckpt, cfg, tok, device)
        print(f"[accounting] {len(rep.consumed)} keys consumed, "
              f"{len(rep.ignored)} known-unused"
              + (f" ({sorted(rep.ignored)[:4]}...)" if rep.ignored else ""), flush=True)

        images = [make_scene(1000 + i, args.res) for i in range(args.n)]
        h, w = resize_image(HWC3(images[0]), args.res).shape[:2]
        f = cfg.vae.downsample_factor
        x_T = np.random.default_rng(args.seed).standard_normal(
            (1, h // f, w // f, 4)).astype(np.float32)
        kwargs = dict(num_samples=1, image_resolution=args.res, ddim_steps=args.steps,
                      seed=args.seed, x_T=x_T)

        ref_latents = None
        if args.golden_dir:
            goldens = [cv2.imread(os.path.join(args.golden_dir, f"golden_{i}.png"))[:, :, ::-1]
                       for i in range(args.n)]
        else:
            print(f"[reference] {args.n} goldens at {args.res}px/{args.steps} steps "
                  "(the port in fp32 on the CPU, plain versions; slow at full scale)...",
                  flush=True)
            ref_cfg = dataclasses.replace(cfg, dtype="float32")
            _, ref = _pipeline(args.ckpt, ref_cfg, tok, "cpu")
            goldens, ref_latents = [], []
            for img in images:
                goldens.append(ref.process(img, PROMPT, **kwargs)[-1])
                ref_latents.append(ref.last_latents.float().cpu())
            del ref
            if args.save_goldens:
                os.makedirs(args.save_goldens, exist_ok=True)
                for i, g in enumerate(goldens):
                    cv2.imwrite(os.path.join(args.save_goldens, f"golden_{i}.png"),
                                g[:, :, ::-1])

    pds, times, scores, latent_errs = [], [], [], []
    for i, (img, gold) in enumerate(zip(images, goldens)):
        t0 = time.perf_counter()
        out = pipe.process(img, PROMPT, **kwargs)[-1]
        dt = (time.perf_counter() - t0) * 1e3
        pd = perceptual_distance(out, gold)
        pds.append(pd)
        times.append(dt)
        scores.append(get_score(dt, pd))
        line = f"image {i}: t={dt:.0f} ms  PD={pd:.3f}  score={scores[-1]:.1f}"
        if ref_latents is not None:
            z, z_ref = pipe.last_latents.float().cpu(), ref_latents[i]
            latent_errs.append(float((z - z_ref).abs().max() / z_ref.abs().max()))
            line += f"  latents max|dz|/max|z_ref|={latent_errs[-1]:.3g}"
        print(line, flush=True)

    mean_pd = float(np.mean(pds))
    print(f"\nmean PD = {mean_pd:.3f} (limit {args.pd_limit}), "
          f"median t = {np.median(times):.0f} ms")
    ok = mean_pd <= args.pd_limit
    print("READINESS: PASS" if ok else
          "READINESS: FAIL — the card's output diverges from the fp32 CPU reference")
    return {"pds": pds, "mean_pd": mean_pd, "times_ms": times, "scores": scores,
            "pass": ok, "consumed": len(rep.consumed), "ignored": len(rep.ignored),
            "latent_errs": latent_errs if ref_latents is not None else None,
            "ref_latents": ref_latents, "pipeline": pipe, "kwargs": kwargs,
            "images": images}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.offline_drill is not None:
        from stablediffusioneo_tpu_torch.testing.offline_drill import ALL_FAMILIES, run_drill

        fams = tuple(args.offline_drill) or ALL_FAMILIES
        reports = run_drill(fams, res=args.drill_res, steps=args.drill_steps,
                            device="cpu" if args.cpu else "cuda")
        print(f"OFFLINE DRILL: PASS ({len(reports)} families: "
              f"{[r['family'] for r in reports]})")
        return 0
    if args.pin_manifest or args.verify_manifest is not None:
        ok = check_manifest(args)
        if args.pin_manifest or not ok or not (args.ckpt and args.vocab and args.merges):
            return 0 if ok else 1
        print("[manifest] all files verified; continuing to the parity check")
    return 0 if parity(args)["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
