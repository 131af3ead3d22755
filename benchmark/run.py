"""The benchmark of the PyTorch + CUDA port (`stablediffusioneo_tpu_torch`).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Runs one cell of BENCHMARK.json on the first
CUDA device and prints, as the last line of its standard output, one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), `device`, with --trace 1
`breakdown`, and last `checks`, each compared number beside its limit (also
the last lines of standard error). Without a CUDA device, or with fewer than
the cell asks for, it exits with code 2 and prints no result; it never falls
back to the CPU. Build and kernel caches stay inside the checkout, under
`.bench_cache/` (the port's own kernel builds under
`stablediffusioneo_tpu_torch/csrc/build/`).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    bench, wl, cfg, traffic = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(bench, wl, cfg, traffic, args.seed, args.seconds,
                              bool(args.trace), device, T_PROCESS)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
