"""How far a served row's bytes move with the batch it runs in, on one NVIDIA
card, at the full SD-1.5 + ControlNet width in bf16 with seeded weights.

    python3 scripts/torch_batch_variance.py
    CUBLAS_WORKSPACE_CONFIG=:0:0 python3 scripts/torch_batch_variance.py

For each of four settings of PyTorch's reduction knobs (default;
`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False`;
`torch.backends.cudnn.deterministic = True`; both):
  * the CLIP contexts of one prompt pair at batch 2 and at batch 8;
  * one controlled-UNet evaluation (t = 801) of the same row at CFG batch 2
    and at CFG batch 8, with a forward hook on every module: the maximum
    difference of the row's output and the first module outputs that
    differ; and the row at position 0 and at position 3 of the batch of 4;
  * whole 20-step eager requests (scale 9, packed Canny-like hints): each of
    four rows at batch 4 against the same request at batch 1, row 0 at
    position 0 and at position 3, and, as the control, the batch-1 request
    against itself with one of x_T's 16,384 values scaled by 1.01 (the share
    of pixels off by more than 1, and the mean |d| of 255).
The card's name and power limit lead the output.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from stablediffusioneo_tpu_torch.config import sd15_pipeline  # noqa: E402
from stablediffusioneo_tpu_torch.models.controlnet import controlled_unet_apply  # noqa: E402
from stablediffusioneo_tpu_torch.ops.kernels import (  # noqa: E402
    attention,
    build,
    groupnorm,
    layernorm,
    quant,
)
from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime  # noqa: E402

TEXTS = ["a bird", "a dog on grass", "an oil painting of a ship", "a red sports car"]
NEG = "lowres, bad anatomy"
SETTINGS = {"default": {}, "bf16 reduced-precision reduction off": {"bf16red": False},
            "cudnn deterministic": {"det": True},
            "both": {"bf16red": False, "det": True}}


def eval_rows(model, x, hint, ctx8, rows, record=None):
    """One controlled-UNet evaluation of `rows` on the CFG batch; `record`
    collects (module name, the first row of its output)."""
    xb, hb = torch.cat([x[rows], x[rows]]), torch.cat([hint[rows], hint[rows]])
    ctx = torch.cat([ctx8[rows], ctx8[[4 + r for r in rows]]])
    tb = torch.full((xb.shape[0],), 801.0, device="cuda")
    handles = []
    if record is not None:
        def hook(name):
            def keep(module, inputs, out):
                ok = isinstance(out, torch.Tensor) and out.dim() and out.shape[0] == xb.shape[0]
                record.append((name, out[:1].float().clone() if ok else None))
            return keep

        handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    with torch.no_grad():
        out = controlled_unet_apply(model.unet, model.control, xb, hb, tb, ctx,
                                    control_scales=[1.0] * 13)
    for h in handles:
        h.remove()
    return out


def one_eval(label, rt, model, x, hint):
    c2 = rt.encode_prompt(cs.stand_in_tokenizer([TEXTS[0], NEG]))
    c8 = rt.encode_prompt(cs.stand_in_tokenizer(TEXTS + [NEG] * 4))
    print(f"[{label}] CLIP batch 2 vs 8: cond row equal {torch.equal(c2[0], c8[0])}, "
          f"uncond row equal {torch.equal(c2[1], c8[4])}", flush=True)
    r2, r8 = [], []
    o2 = eval_rows(model, x, hint, c8, [0], r2)
    o8 = eval_rows(model, x, hint, c8, [0, 1, 2, 3], r8)
    differ = [(n, round((a - b).abs().max().item(), 6)) for (n, a), (_, b) in zip(r2, r8)
              if a is not None and b is not None and not torch.equal(a, b)]
    print(f"[{label}] one evaluation, row 0 at CFG batch 2 vs 8: max|d| "
          f"{(o2[0].float() - o8[0].float()).abs().max().item():.3e} (max|out| "
          f"{o2[0].float().abs().max().item():.3e}); {len(differ)} of {len(r2)} module "
          f"outputs differ, the first: {differ[:8]}", flush=True)
    o8p = eval_rows(model, x, hint, c8, [1, 2, 3, 0])
    print(f"[{label}] one evaluation, row 0 at position 0 vs 3 of batch 4: equal "
          f"{torch.equal(o8[0], o8p[3])}", flush=True)


def share(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return round(float((d > 1).mean()), 4), round(float(d.mean()), 3)


def requests(label, rt, hint):
    ctx = rt.encode_prompt(cs.stand_in_tokenizer(TEXTS + [NEG] * 4))
    xs = torch.randn((4, 64, 64, 4), generator=torch.Generator(device="cuda").manual_seed(1),
                     device="cuda")
    bits = hint[..., 0].float().cpu().numpy() > 0
    packed = torch.from_numpy(np.packbits(bits, axis=-1)).cuda()

    def run(x_T, rows):
        return rt.sample_decode(20, x_T, packed[rows], ctx[:4][rows], ctx[4:][rows],
                                guidance_scale=9.0).cpu().numpy()

    four = run(xs, [0, 1, 2, 3])
    moved = run(xs[[1, 2, 3, 0]], [1, 2, 3, 0])
    ones = [run(xs[i:i + 1], [i])[0] for i in range(4)]
    nudged = xs[:1].clone()
    nudged[0, 32, 32, 0] *= 1.01
    control = run(nudged, [0])[0]
    print(f"[{label}] 20-step requests (share of pixels off by more than 1, mean |d|): "
          f"batch-4 rows vs batch 1 {[share(ones[i], four[i]) for i in range(4)]}; row 0 at "
          f"position 0 vs 3 {share(four[0], moved[3])}; control, batch 1 vs itself with one "
          f"x_T value scaled by 1.01 {share(ones[0], control)}", flush=True)


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}", flush=True)
    build.load_libraries({"attention": attention.SOURCES, "groupnorm": groupnorm.SOURCES,
                          "layernorm": layernorm.SOURCES, "quant": quant.SOURCES})
    cfg = sd15_pipeline(dtype="bfloat16")
    model = cs.build_model(cfg, seed=0)
    rt = CNSDRuntime(model, cfg, device="cuda", graphs=False)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((4, 64, 64, 4), generator=g, device="cuda").to(torch.bfloat16)
    hint = (torch.rand((4, 512, 512, 3), generator=g, device="cuda") > 0.8).to(torch.bfloat16)
    for label, s in SETTINGS.items():
        matmul = torch.backends.cuda.matmul
        matmul.allow_bf16_reduced_precision_reduction = s.get("bf16red", True)
        torch.backends.cudnn.deterministic = s.get("det", False)
        t0 = time.perf_counter()
        one_eval(label, rt, model, x, hint)
        requests(label, rt, hint)
        print(f"[{label}] {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
