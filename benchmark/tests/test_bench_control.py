"""The control of the output check, on the card, at the cells' own sizes:
the reference computed one precision below the configurations' bf16 (every
product's operands in float8 e4m3, `benchmark/reference/lowp.py`), put in the
program's place, must come out not correct through the harness's own
`judge` on the numbers the cell compares, where the program as configured
comes out correct.

    python3 -m pytest benchmark/tests/test_bench_control.py -m cuda -s

`BENCH_CONTROL_SEEDS` (comma-separated) picks the seeds, `BENCH_CONTROL_CELLS`
the cells; `readings()` and `control_readings()` are what the limits were set
from.
"""

from __future__ import annotations

import gc
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def readings(cell, seed, device):
    """(the compared numbers, requests sent, requests failed, the entry's
    counters) of a cell's traffic through its entry, as a run computes them:
    `clients` x `check_requests` requests sent by a closed loop's clients, so
    that a served cell's batches fill its largest bucket, or an open loop's
    arrivals at its rate, as many as its largest bucket x `check_requests`;
    `check_requests` of them sampled from the seed."""
    from benchmark import families, harness
    from benchmark import traffic as traffic_mod

    _, _, cfg, traffic = harness.load_cell(ROOT, cell)
    fam = families.load(cfg["family"])
    weight_seed = int(np.random.default_rng([seed, 0]).integers(0, 2 ** 62))
    model, pcfg = fam.build(cfg, weight_seed, device)
    entry = fam.ENTRIES[traffic["entry"]](model, pcfg, cfg, traffic, device)
    reqs = traffic_mod.requests(traffic, cfg, seed)
    entry.warm(reqs[:traffic["warm"]])
    entry.reset()
    width = (traffic["clients"] if traffic["loop"] == "closed"
             else max(traffic["server"]["batch_buckets"]))
    records, _, _ = harness.drive(entry, reqs, traffic, count=width * cfg["check_requests"])
    counters = entry.counters()
    sent, failed = len(records), sum(r.out is None for r in records)
    picked = harness.sample_records(records, cfg["check_requests"], seed)
    entry.close()
    del entry, model, records
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return harness.compare(fam, cfg, picked, weight_seed, device), sent, failed, counters


def control_readings(cell, seed, n_requests, device):
    """The compared numbers of the control (the fp32 reference run with its
    products rounded to e4m3) against the fp32 reference, over the first
    `n_requests` requests of the seed's traffic."""
    from benchmark import families, harness
    from benchmark import traffic as traffic_mod
    from benchmark.reference.lowp import RoundedProducts

    _, _, cfg, traffic = harness.load_cell(ROOT, cell)
    fam = families.load(cfg["family"])
    weight_seed = int(np.random.default_rng([seed, 0]).integers(0, 2 ** 62))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        net = harness.reference_net(cfg, weight_seed, device)
        out = {}
        for req in traffic_mod.requests(traffic, cfg, seed)[:n_requests]:
            z_ref, img_ref = fam.reference_request(net, cfg, req)
            with RoundedProducts():
                z_c, img_c = fam.reference_request(net, cfg, req)
            out = harness.worst(out, harness.gaps(img_c[0].cpu().numpy(), z_c, img_ref, z_ref))
        del net
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cells' own sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_control_fails_and_program_passes(card):
    seeds = [int(s) for s in os.environ.get(
        "BENCH_CONTROL_SEEDS", "3000000001,3000000002,3000000003").split(",")]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = os.environ.get("BENCH_CONTROL_CELLS",
                           ",".join(w["name"] for w in bench["workloads"])).split(",")
    from benchmark import harness

    for cell in cells:
        _, _, cfg, traffic = harness.load_cell(ROOT, cell)
        limits = cfg["limits"]
        for seed in seeds:
            sound, sent, failed, counters = readings(cell, seed, card)
            control = control_readings(cell, seed, cfg["check_requests"], card)
            hist = counters.get("server", {}).get("batch_hist")
            print(f"control {cell} seed {seed}: program {sound} (sent {sent}, batches "
                  f"{hist}) e4m3 reference {control} limits {limits}", flush=True)
            if hist is not None and traffic["loop"] == "closed":
                # the served rows came from the largest bucket's engine
                assert max(hist) == max(traffic["server"]["batch_buckets"]), (cell, seed, hist)
            ok, checks = harness.judge(sound, limits, sent, failed)
            assert ok, (cell, seed, checks)
            ok, checks = harness.judge({k: control[k] for k in sound}, limits, sent, 0)
            assert not ok, (cell, seed, checks)
