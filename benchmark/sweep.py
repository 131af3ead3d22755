"""Find the knee of an open-loop cell: the highest arrival rate its system
sustains. One process sets the cell up once, then offers each rate of
`--rates` for `--seconds` through the cell's own entry and loop (the
schedule from its `arrivals_seed`, the requests and weights from `--seed`),
and prints one JSON line a rate and last the knee:

    python3 benchmark/sweep.py --workload <open-loop cell> --seed <n> --seconds 51 \\
        --rates 4.0,4.4,4.8,5.2,5.6,6.0,6.4

A rate is sustained where the completed rate (images / the window, which
ends at the last completion, as the cell's `images_per_s`) is at least 0.97
of the offered rate and the median latency of the last third of the
arrivals is within 1.1x of the first third's: a queue that grows through
the window fails the second. The knee is the highest sustained rate. The
benchmark's runs never call this; a cell's rate is fixed in its traffic
file, at about 0.8 of the knee found here.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

COMPLETED_SHARE = 0.97
THIRDS_RATIO = 1.1


def sustained(row):
    return (row["completed_per_s"] >= COMPLETED_SHARE * row["offered_per_s"]
            and row["failed"] == 0
            and row["p50_last_third_s"] <= THIRDS_RATIO * row["p50_first_third_s"])


def reading(records, t0, t1, rate, counters):
    """The numbers of one rate's window."""
    from benchmark.harness import percentile

    done = sorted((r for r in records if r.out is not None), key=lambda r: r.t0)
    third = max(len(done) // 3, 1)
    lat = [r.t1 - r.t0 for r in done]
    server = counters.get("server", {})
    return {"offered_per_s": rate, "sent": len(records), "failed": len(records) - len(done),
            "completed_per_s": len(done) / (t1 - t0),
            "p50_s": percentile(lat, 50), "p90_s": percentile(lat, 90),
            "p50_first_third_s": percentile(lat[:third], 50),
            "p50_last_third_s": percentile(lat[-third:], 50),
            "late_max_ms": 1e3 * max(r.late_s for r in records),
            "mean_batch": server.get("mean_batch"), "cuts": server.get("cuts")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True, help="comma-separated arrivals a second")
    p.add_argument("--out", help="also write the lines to this file")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import CACHES

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)

    import numpy as np
    import torch

    from benchmark import families, harness
    from benchmark import traffic as traffic_mod

    _, wl, cfg, traffic = harness.load_cell(ROOT, args.workload)
    if traffic["loop"] != "open":
        raise SystemExit(f"{args.workload} is not an open-loop cell")
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    fam = families.load(cfg["family"])
    Entry = fam.ENTRIES[traffic["entry"]]
    harness.check_loop(traffic, Entry)
    weight_seed = int(np.random.default_rng([args.seed, 0]).integers(0, 2 ** 62))
    model, pcfg = fam.build(cfg, weight_seed, device)
    entry = Entry(model, pcfg, cfg, traffic, device)
    reqs = traffic_mod.requests(traffic, cfg, args.seed)
    entry.warm(reqs[:traffic["warm"]])
    torch.cuda.synchronize(device)
    harness.say(f"set-up {time.perf_counter() - T_PROCESS:.1f} s; "
                f"{torch.cuda.get_device_name(device)}, power limit {harness.power_limit()}")
    rows = []
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            entry.reset()
            records, t0, t1 = harness.drive(entry, reqs, dict(traffic, rate_per_s=rate),
                                            seconds=args.seconds)
            row = reading(records, t0, t1, rate, entry.counters())
            row["sustained"] = sustained(row)
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        entry.close()
    knee = max((r["offered_per_s"] for r in rows if r["sustained"]), default=None)
    print(json.dumps({"knee_per_s": knee}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows + [{"knee_per_s": knee}]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
