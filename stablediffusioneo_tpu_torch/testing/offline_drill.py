"""Offline real-weight drill (counterpart of
stablediffusioneo_tpu/testing/offline_drill.py): exercise the ENTIRE
weight-acquisition path of the port against full-width files on disk, so
the only untested step left without network access is the download itself.

The reference's value proof runs real downloaded checkpoints
(canny2image_TRT.py:27 loads control_sd15_canny.pth;
annotator/hed/__init__.py:88-93 self-fetches annotator weights;
compute_score.py:8-17 loads pt_inception). The drill synthesizes
full-width state dicts FROM THE PACKAGED KEY UNIVERSES
(checkpoint/universes/), writes them to REAL ``.pth`` / ``.safetensors``
files under their real filenames, and then runs the path a user with real
downloads would take, per weight family:

    manifest verify (checkpoint/manifest.py: keys + shapes)
      -> strict load through the port's loaders (key accounting)
      -> one inference on the device (bf16 on the card, fp32 on the CPU)
      -> a finite uint8 output

Values are random (N(0, 0.02); BatchNorm running_var made positive), which
is sufficient: the drill proves file parsing, key mapping, shape plumbing
and numerical plumbing (finite outputs), not output quality, which the
parity tests hold.

CLI: ``sdeo-readiness-torch --offline-drill [family ...]``; families default
to all of: sd15 sdxl hed openpose mlsd dpt_hybrid uniformer inception. The
two diffusion families are full width (1.4 B / 3.5 B parameters: a ~6 GB
.pth and a ~14 GB .safetensors file); bound the run with a family list when
iterating.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from stablediffusioneo_tpu_torch.checkpoint import torch_reader
from stablediffusioneo_tpu_torch.checkpoint.manifest import (
    load_manifest,
    load_universe,
    verify_file,
)
from stablediffusioneo_tpu_torch.utils.debug import assert_finite

ALL_FAMILIES = ("sd15", "sdxl", "hed", "openpose", "mlsd", "dpt_hybrid",
                "uniformer", "inception")

# universe-name -> manifest filename is read from the manifest itself
_FAMILY_ARTIFACTS = {
    "sd15": ("control_sd15_canny",),
    "sdxl": ("sdxl_base",),
    "hed": ("hed",),
    "openpose": ("openpose_body", "openpose_hand"),
    "mlsd": ("mlsd_large",),
    "dpt_hybrid": ("dpt_hybrid",),
    "uniformer": ("uniformer",),
    "inception": ("pt_inception",),
}


def synth_state_dict(universe: Dict[str, str], seed: int = 0,
                     scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Full-width state dict with the universe's exact keys + shapes.

    N(0, scale) f32 except the structurally-constrained leaves:
    ``*running_var`` must be positive (BN rsqrt), ``*num_batches_tracked``
    is an int64 counter, ``*position_ids`` is an int64 arange row.
    """
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for k, shape_str in universe.items():
        shape = tuple(int(d) for d in shape_str.split("x")) if shape_str \
            else ()
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros(shape, np.int64)
        elif k.endswith("position_ids"):
            sd[k] = np.arange(int(np.prod(shape) or 1),
                              dtype=np.int64).reshape(shape or (1,))
        elif k.endswith("running_var"):
            sd[k] = np.abs(rng.standard_normal(shape).astype(np.float32)
                           ) * scale + 1.0
        else:
            sd[k] = rng.standard_normal(shape).astype(np.float32) * scale
    return sd


def write_pth(sd: Dict[str, np.ndarray], path: str) -> str:
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def write_safetensors(sd: Dict[str, np.ndarray], path: str) -> str:
    """The port's own safetensors writer (checkpoint/torch_reader.py), which
    also writes the I64 counters and index rows."""
    return torch_reader.write_safetensors(sd, path)


def _synth_artifact(name: str, out_dir: str, fmt: Optional[str] = None,
                    seed: int = 0) -> str:
    """Synthesize one manifest artifact to disk under its REAL filename
    (verify_file matches on the basename)."""
    entry = load_manifest()["artifacts"][name]
    uni = load_universe(entry["universe"])
    sd = synth_state_dict(uni, seed=seed)
    path = os.path.join(out_dir, entry["filename"])
    if (fmt or os.path.splitext(entry["filename"])[1]) in (
            ".safetensors", "safetensors"):
        return write_safetensors(sd, path)
    return write_pth(sd, path)


def _verify(path: str, name: str) -> Dict:
    return verify_file(path, name=name)


def _finite_u8(img: np.ndarray, what: str):
    assert img.dtype == np.uint8, f"{what}: dtype {img.dtype}"
    assert img.size, what
    assert_finite(img, what)


def _dtype(device) -> torch.dtype:
    """The inference dtype of a drill: bf16 on the card, fp32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def drill_sd15(out_dir: str, res: int, steps: int, log, device="cuda") -> Dict:
    """control_sd15_canny.pth: verify -> the port's readers give back what
    was written -> strict load -> full-width canny2image process() -> uint8
    image."""
    from stablediffusioneo_tpu_torch.checkpoint import load_controlnet_pipeline
    from stablediffusioneo_tpu_torch.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    t0 = time.perf_counter()
    entry = load_manifest()["artifacts"]["control_sd15_canny"]
    uni = load_universe(entry["universe"])
    sd = synth_state_dict(uni, seed=1)
    # a real checkpoint also carries the DDPM schedule buffers the loaders
    # deliberately ignore (SD_KNOWN_UNUSED): include a few so the drill
    # exercises the known-unused path, not just the happy set
    sd["betas"] = np.linspace(8.5e-4, 1.2e-2, 1000).astype(np.float32)
    sd["alphas_cumprod"] = np.cumprod(1.0 - sd["betas"]).astype(np.float32)
    sd["logvar"] = np.zeros(1000, np.float32)
    log(f"[sd15] synthesized {len(sd)} keys: {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    path = write_pth(sd, os.path.join(out_dir, entry["filename"]))
    log(f"[sd15] wrote {path} ({os.path.getsize(path)/1e9:.2f} GB): "
        f"{time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    rep = _verify(path, "control_sd15_canny")
    log(f"[sd15] manifest verify OK: {rep['key_count']} keys: {time.perf_counter()-t0:.1f}s")

    # both of the port's readers give back the arrays they were handed: the
    # .pth on a probe of keys, and a .safetensors of the probe and of the
    # int64 rows through the port's own writer
    probe = sorted(sd)[::max(1, len(sd) // 16)]
    probe += [k for k in sorted(sd) if sd[k].dtype == np.int64 and k not in probe]
    raw = torch_reader.load_torch_state_dict(path)
    assert set(raw) == set(sd)
    st = write_safetensors({k: sd[k] for k in probe},
                           os.path.join(out_dir, "sd15_probe.safetensors"))
    back = torch_reader.load_torch_state_dict(st)
    assert set(back) == set(probe)
    for k in probe:
        for got in (raw[k], back[k]):
            assert got.numpy().dtype == sd[k].dtype and got.numpy().tobytes() == sd[k].tobytes(), k
    del raw, back

    dtype = _dtype(device)
    cfg = sd15_pipeline(dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    t0 = time.perf_counter()
    model = load_controlnet_pipeline(path, cfg=cfg, device=device, dtype=dtype)
    log(f"[sd15] strict load: {time.perf_counter()-t0:.1f}s")
    tok = toy_tokenizer(vocab_size=cfg.clip.vocab_size,
                        max_length=cfg.clip.max_length)
    pipe = Canny2ImagePipeline(model, tok, cfg, device=device)
    src = np.zeros((res, res, 3), np.uint8)
    src[res // 4: -res // 4, res // 4: -res // 4] = 220
    t0 = time.perf_counter()
    out = pipe.process(src, "a bird", num_samples=1, image_resolution=res,
                       ddim_steps=steps, seed=7)[-1]
    log(f"[sd15] full-width process() ({res}px/{steps} step): "
        f"{time.perf_counter()-t0:.1f}s")
    _finite_u8(np.asarray(out), "sd15 sample")
    return {"family": "sd15", "keys": rep["key_count"], "image": np.asarray(out).shape}


def drill_sdxl(out_dir: str, res: int, steps: int, log, device="cuda") -> Dict:
    """sd_xl_base_1.0.safetensors: verify -> strict load -> one txt2img
    sample+decode at full width."""
    from stablediffusioneo_tpu_torch.checkpoint import load_sdxl_pipeline
    from stablediffusioneo_tpu_torch.models.sdxl import (
        SDXLConfig,
        sdxl_conditioning,
        sdxl_txt2img,
    )
    from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
    from stablediffusioneo_tpu_torch.runtime.engine import decode_u8

    t0 = time.perf_counter()
    path = _synth_artifact("sdxl_base", out_dir, seed=2)
    log(f"[sdxl] synthesized and wrote {path} ({os.path.getsize(path)/1e9:.2f} GB): "
        f"{time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    rep = _verify(path, "sdxl_base")
    log(f"[sdxl] manifest verify OK: {rep['key_count']} keys: {time.perf_counter()-t0:.1f}s")
    dtype = _dtype(device)
    cfg = SDXLConfig(dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    t0 = time.perf_counter()
    model = load_sdxl_pipeline(path, cfg, device=device, dtype=dtype)
    log(f"[sdxl] strict load: {time.perf_counter()-t0:.1f}s")
    ids = torch.zeros((1, cfg.clip_l.max_length), dtype=torch.long, device=device)
    ids[0, 1] = 42
    sched = DiffusionSchedule().ddim(steps)
    h = res // 8
    x_T = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, h, h, 4)).astype(np.float32)).to(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        ctx, y = sdxl_conditioning(model, ids, ids, (res, res))
        z = sdxl_txt2img(model.unet, sched, x_T, ctx, ctx, y, y, 5.0,
                         generator=torch.Generator(device=device).manual_seed(3))
        img = decode_u8(model.vae, z, dtype)[0].cpu().numpy()
    log(f"[sdxl] full-width sample+decode ({res}px/{steps} step): "
        f"{time.perf_counter()-t0:.1f}s")
    _finite_u8(img, "sdxl sample")
    return {"family": "sdxl", "keys": rep["key_count"], "image": img.shape}


def _frame(res: int = 256) -> np.ndarray:
    rng = np.random.default_rng(11)
    img = (rng.random((res, res, 3)) * 255).astype(np.uint8)
    img[res // 4: -res // 4, res // 4: -res // 4] = 230
    return img


def drill_hed(out_dir: str, log, device="cuda") -> Dict:
    from stablediffusioneo_tpu_torch.annotators.hed import HEDdetector

    path = _synth_artifact("hed", out_dir, seed=3)
    rep = _verify(path, "hed")
    det = HEDdetector(ckpt_path=path, device=device)
    out = det(_frame())
    _finite_u8(out, "hed map")
    return {"family": "hed", "keys": rep["key_count"], "map": out.shape}


def drill_openpose(out_dir: str, log, device="cuda") -> Dict:
    from stablediffusioneo_tpu_torch.annotators.openpose import OpenposeDetector

    body = _synth_artifact("openpose_body", out_dir, seed=4)
    hand = _synth_artifact("openpose_hand", out_dir, seed=5)
    keys = _verify(body, "openpose_body")["key_count"] + \
        _verify(hand, "openpose_hand")["key_count"]
    det = OpenposeDetector(body_ckpt=body, hand_ckpt=hand, device=device)
    out, _ = det(_frame(), hand=True)
    _finite_u8(out, "openpose canvas")
    return {"family": "openpose", "keys": keys, "map": out.shape}


def drill_mlsd(out_dir: str, log, device="cuda") -> Dict:
    from stablediffusioneo_tpu_torch.annotators.mlsd import MLSDdetector

    path = _synth_artifact("mlsd_large", out_dir, seed=6)
    rep = _verify(path, "mlsd_large")
    det = MLSDdetector(ckpt_path=path, device=device)
    out = det(_frame(), thr_v=0.1, thr_d=0.1)
    _finite_u8(out, "mlsd map")
    return {"family": "mlsd", "keys": rep["key_count"], "map": out.shape}


def drill_dpt_hybrid(out_dir: str, log, device="cuda") -> Dict:
    from stablediffusioneo_tpu_torch.annotators.midas import MidasDetector

    path = _synth_artifact("dpt_hybrid", out_dir, seed=7)
    rep = _verify(path, "dpt_hybrid")
    det = MidasDetector(ckpt_path=path, model_type="dpt_hybrid", device=device)
    depth, normal = det(_frame())
    _finite_u8(depth, "dpt depth")
    _finite_u8(normal, "dpt normal")
    return {"family": "dpt_hybrid", "keys": rep["key_count"], "map": depth.shape}


def drill_uniformer(out_dir: str, log, device="cuda") -> Dict:
    from stablediffusioneo_tpu_torch.annotators.uniformer import UniformerDetector

    path = _synth_artifact("uniformer", out_dir, seed=8)
    rep = _verify(path, "uniformer")
    det = UniformerDetector(ckpt_path=path, device=device)
    out = det(_frame())
    _finite_u8(out, "uniformer seg")
    return {"family": "uniformer", "keys": rep["key_count"], "map": out.shape}


def drill_inception(out_dir: str, log, device="cuda") -> Dict:
    from stablediffusioneo_tpu_torch.scoring.inception import InceptionFeatureExtractor

    path = _synth_artifact("pt_inception", out_dir, seed=9)
    rep = _verify(path, "pt_inception")
    ex = InceptionFeatureExtractor(ckpt_path=path, device=device)
    feats = ex(_frame())
    assert feats.shape[-1] == 2048
    assert_finite(feats, "inception features")
    return {"family": "inception", "keys": rep["key_count"], "features": feats.shape}


_RUNNERS = {
    "hed": drill_hed,
    "openpose": drill_openpose,
    "mlsd": drill_mlsd,
    "dpt_hybrid": drill_dpt_hybrid,
    "uniformer": drill_uniformer,
    "inception": drill_inception,
}


def run_drill(families=ALL_FAMILIES, out_dir: Optional[str] = None,
              res: int = 256, steps: int = 1, keep_files: bool = False,
              log=print, device="cuda") -> List[Dict]:
    """Run the drill for the given families on `device` (the card unless
    the caller names another); returns per-family reports, each with its
    seconds, the bytes of the files it wrote and the kernel launches it made
    (ops/dispatch.py:launches, non-zero entries). Files are written under
    out_dir (a fresh temp dir by default) and deleted after each family
    unless keep_files (sd15 + sdxl alone are ~20 GB)."""
    import shutil
    import tempfile

    from stablediffusioneo_tpu_torch.ops import dispatch

    own_dir = out_dir is None
    out_dir = out_dir or tempfile.mkdtemp(prefix="sdeo_drill_")
    reports = []
    try:
        for fam in families:
            if fam not in ALL_FAMILIES:
                raise ValueError(f"unknown drill family {fam!r}; have "
                                 f"{ALL_FAMILIES}")
            t0 = time.perf_counter()
            before = dispatch.counts()
            had = set(os.listdir(out_dir))
            log(f"[drill] {fam}: start")
            if fam == "sd15":
                rep = drill_sd15(out_dir, res, steps, log, device)
            elif fam == "sdxl":
                rep = drill_sdxl(out_dir, res, steps, log, device)
            else:
                rep = _RUNNERS[fam](out_dir, log, device)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            rep["seconds"] = round(time.perf_counter() - t0, 1)
            new = sorted(set(os.listdir(out_dir)) - had)
            rep["bytes"] = sum(os.path.getsize(os.path.join(out_dir, f)) for f in new)
            rep["launches"] = dispatch.counts_since(before)[0]
            log(f"[drill] {fam}: OK {rep}")
            reports.append(rep)
            if not keep_files:
                for f in new:
                    os.unlink(os.path.join(out_dir, f))
    finally:
        if own_dir and not keep_files:
            shutil.rmtree(out_dir, ignore_errors=True)
    return reports
