"""One run of one cell: set-up, the measured window, the traced segment
(with --trace 1), the output check against the reference, the result line.

A cell (`workloads` in BENCHMARK.json) names a configuration
(`benchmark/configs/<name>.json`, found through `configs`) and a traffic
file (`benchmark/traffic/<name>.json`); the per-layer metrics are readers in
`benchmark/metrics/<name>.py`, each `read(run) -> number or None`. Nothing
here names a cell, a configuration, a family or a metric.

A traffic file's `loop` says how requests are sent: "closed", `clients`
callers each sending its next request when its last one completes; or
"open", arrivals on a schedule drawn before the window from the traffic
file's `arrivals_seed` (`traffic.arrivals`: the same schedule in every run,
the run's seed choosing the requests), each request started at its time on
a worker thread whether or not earlier ones have completed, at most
`max_outstanding` at a time. An open-loop request's latency runs from its
scheduled arrival, so a harness that falls behind its schedule shows as
latency.
"""

from __future__ import annotations

import gc
import importlib.util
import itertools
import json
import math
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import families, traffic as traffic_mod, work
from benchmark.trace import Trace, traced

FORBIDDEN = ("jax", "jaxlib", "flax", "stablediffusioneo_tpu")


@dataclass
class Record:
    req: traffic_mod.Request
    t0: float                       # sent; in an open loop, its scheduled arrival
    t1: float
    out: Optional[families.Output]  # None: the request failed
    late_s: float = 0.0             # open loop: scheduled arrival -> the call's start


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    cfg: dict
    traffic: dict
    setup_s: float
    window_s: float
    records: List[Record]
    failed: int
    engines: Dict[str, dict]
    counters: Dict[str, dict]
    peak_reserved: int
    trace: Optional[Trace] = None
    trace_images: int = 0
    flops_per_image: float = 0.0
    peaks: dict = field(default_factory=lambda: work.PEAKS)

    def span(self, name):
        """The values of a per-request span over the window's requests."""
        return [r.out.spans[name] for r in self.records
                if r.out is not None and name in r.out.spans]

    @property
    def images(self):
        return sum(r.out is not None for r in self.records)


def say(line):
    """A progress line on standard error (before the checks, which end it)."""
    print(f"bench: {line}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (the port's name begins with the latter's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(root: Path, workload: str):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    return bench, wl, cfg, traffic_mod.load(wl["traffic"])


def load_metric(name: str):
    path = Path(__file__).parent / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def percentile(values, q):
    """Linear interpolation between order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def call(entry, req, i, annotate):
    """One request through the entry; None where it raised (counted as
    failed, reported)."""
    try:
        if annotate:
            with torch.profiler.record_function("bench.request"):
                return entry.run(req)
        return entry.run(req)
    except Exception as e:  # noqa: BLE001 - counted as failed, reported
        print(f"request {i} failed: {e!r}", file=sys.stderr, flush=True)
        return None


def closed_loop(entry, reqs, clients, seconds=None, count=None, annotate=False):
    """`clients` callers, each sending its next request when its last one
    completes, until `seconds` have passed since the start (a request is not
    started after that) or `count` requests have been started. Returns the
    records, failures included, and (start, end of the last completion).
    annotate: each request inside a `bench.request` span (for the trace)."""
    records, lock = [], threading.Lock()
    ticket = itertools.count()
    t_start = time.perf_counter()
    deadline = None if seconds is None else t_start + seconds

    def client():
        while True:
            i = next(ticket)
            if (deadline is not None and time.perf_counter() >= deadline) or (
                    count is not None and i >= count):
                return
            req = reqs[i % len(reqs)]
            t0 = time.perf_counter()
            out = call(entry, req, i, annotate)
            with lock:
                records.append(Record(req, t0, time.perf_counter(), out))

    if clients == 1:
        client()
    else:
        threads = [threading.Thread(target=client, name=f"bench-client-{k}")
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    t_end = max((r.t1 for r in records), default=time.perf_counter())
    return records, t_start, t_end


def open_loop(entry, reqs, offsets, max_outstanding, annotate=False):
    """Request i arrives `offsets[i]` seconds after the start and is started
    then on one of `max_outstanding` worker threads, whatever earlier
    requests are doing. Its record's t0 is its scheduled arrival, so a late
    start counts as latency; an arrival that finds `max_outstanding`
    requests outstanding is not sent and is recorded as failed. Returns the
    records and (start, end of the last completion), as `closed_loop`."""
    records, lock = [], threading.Lock()
    work_q = queue.SimpleQueue()
    outstanding = 0

    def worker():
        nonlocal outstanding
        while (item := work_q.get()) is not None:
            i, t0 = item
            late = time.perf_counter() - t0
            out = call(entry, reqs[i % len(reqs)], i, annotate)
            t1 = time.perf_counter()
            with lock:
                records.append(Record(reqs[i % len(reqs)], t0, t1, out, late))
                outstanding -= 1

    threads = [threading.Thread(target=worker, name=f"bench-arrival-{k}")
               for k in range(max_outstanding)]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    try:
        for i, offset in enumerate(offsets):
            t0 = t_start + offset
            wait = t0 - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            with lock:
                refused = outstanding >= max_outstanding
                if refused:
                    records.append(Record(reqs[i % len(reqs)], t0, t0, None))
                else:
                    outstanding += 1
            if refused:
                print(f"request {i} failed: {max_outstanding} requests outstanding",
                      file=sys.stderr, flush=True)
            else:
                work_q.put((i, t0))
    finally:
        for _ in threads:
            work_q.put(None)
        for t in threads:
            t.join()
    t_end = max((r.t1 for r in records), default=time.perf_counter())
    return records, t_start, t_end


def drive(entry, reqs, traffic, seconds=None, count=None, annotate=False):
    """The traffic's loop over `reqs` for `seconds` (no request sent after
    them) or for `count` requests. An open loop sends floor(rate x seconds)
    arrivals in the window, or `count`, on the schedule of its
    `arrivals_seed`."""
    if traffic["loop"] == "closed":
        return closed_loop(entry, reqs, traffic["clients"], seconds=seconds, count=count,
                           annotate=annotate)
    rate = traffic["rate_per_s"]
    n = count if count is not None else math.floor(rate * seconds)
    return open_loop(entry, reqs, traffic_mod.arrivals(rate, n, traffic["arrivals_seed"]),
                     traffic["max_outstanding"], annotate=annotate)


def check_loop(traffic, Entry):
    """Refuse a traffic file the entry cannot take."""
    loop = traffic["loop"]
    if loop == "closed":
        if Entry.clients_max is not None and traffic["clients"] > Entry.clients_max:
            raise ValueError(f"entry {traffic['entry']} takes {Entry.clients_max} client(s)")
    elif loop == "open":
        if Entry.clients_max is not None:
            raise ValueError(f"an open loop sends requests while earlier ones are running; "
                             f"entry {traffic['entry']} takes {Entry.clients_max} caller(s) "
                             f"at a time, so it takes closed loops only")
    else:
        raise ValueError(f"traffic loop {loop!r}: the generator drives closed and open loops")


def end_to_end(run: Run, names) -> Dict[str, dict]:
    lat = [r.t1 - r.t0 for r in run.records if r.out is not None]
    values = {"images_per_s": (run.images / run.window_s, "images/s"),
              "setup_s": (run.setup_s, "s")}
    if lat:
        values["latency_p50_s"] = (percentile(lat, 50), "s")
        values["latency_p90_s"] = (percentile(lat, 90), "s")
    return {n: {"value": values[n][0], "unit": values[n][1]} for n in names if n in values}


def per_layer(run: Run, specs) -> Dict[str, dict]:
    out = {}
    for m in specs:
        v = load_metric(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def cell_metrics(bench, workload, kind):
    """The cell's metrics of a kind ("end_to_end" or "per_layer"): those
    without a `workloads` key and those that list the cell."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def power_limit():
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader", "-i", "0"], capture_output=True,
                              text=True, timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


# ------------------------------------------------------------- the check


def sample_records(records, k, seed):
    """k records of distinct requests drawn from the seed, the one with the
    longest prompt among them."""
    done = {}
    for r in records:
        if r.out is not None:
            done.setdefault(r.req.index, r)
    pool = sorted(done.values(), key=lambda r: r.req.index)
    if not pool:
        return []
    longest = max(pool, key=lambda r: (len(r.req.prompt.split()), -r.req.index))
    rest = [r for r in pool if r is not longest]
    rng = np.random.default_rng([seed, 1])
    picks = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in picks]


def reference_net(cfg, weight_seed, device):
    """The reference's networks in float32 on `device`, with the weights the
    program got (the same draw from the same seed, widened)."""
    from benchmark.weights import draw_state_dict

    with torch.device("meta"):
        net = families.load(cfg["family"]).reference_module(cfg)
    net = net.to_empty(device=device)
    sd = draw_state_dict(net, weight_seed, device, families.DTYPES[cfg["dtype"]])
    net.load_state_dict(sd)
    del sd
    return net.eval().requires_grad_(False)


def gaps(image, latents, img_ref, z_ref):
    """The compared numbers of one request: the image's mean |pixel -
    reference pixel| (uint8 levels) and, where the entry gives latents, the
    x_0 latents' relative gap ||z - z_ref|| / ||z_ref||."""
    img_ref = img_ref[0].cpu().numpy() if torch.is_tensor(img_ref) else img_ref
    out = {"pixel_mad": float(np.abs(np.asarray(image, np.float64) - img_ref).mean())}
    if latents is not None:
        z = latents.to(z_ref.device, torch.float32).reshape(z_ref.shape)
        rel = float((z - z_ref).norm() / z_ref.norm())
        out["latent_rel"] = rel if math.isfinite(rel) else math.inf
    return out


def worst(readings, more):
    """The larger of each number over requests."""
    return {k: max(readings.get(k, 0.0), v) for k, v in more.items()}


def compare(fam, cfg, picked, weight_seed, device):
    """The compared numbers of the sampled requests, each the largest over
    them (`gaps`), against the reference run on the same inputs, float32
    with TF32 off."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        net = reference_net(cfg, weight_seed, device)
        readings = {}
        for rec in picked:
            z_ref, img_ref = fam.reference_request(net, cfg, rec.req)
            readings = worst(readings, gaps(rec.out.image, rec.out.latents, img_ref, z_ref))
        del net
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return readings


def judge(readings, limits, attempted, failed):
    """(correct, the checks: each number with its limit)."""
    checks = {name: {"value": v, "limit": limits[name]} for name, v in readings.items()}
    checks["requests_failed"] = {"value": failed, "limit": 0}
    ok = (attempted > 0 and bool(readings) and failed == 0
          and all(c["value"] <= c["limit"] for c in checks.values()))
    return ok, checks


# ------------------------------------------------------------------ a run


def run_cell(bench, wl, cfg, traffic, seed, seconds, trace, device, t_process):
    """One run of a cell on `device`; returns the result dict (the last line
    of the benchmark's output). The chip check is the caller's."""
    fam = families.load(cfg["family"])
    Entry = fam.ENTRIES[traffic["entry"]]
    check_loop(traffic, Entry)
    weight_seed = int(np.random.default_rng([seed, 0]).integers(0, 2 ** 62))
    say(f"imports done at {time.perf_counter() - t_process:.1f} s")
    model, pcfg = fam.build(cfg, weight_seed, device)
    say(f"model built at {time.perf_counter() - t_process:.1f} s")
    entry = Entry(model, pcfg, cfg, traffic, device)
    reqs = traffic_mod.requests(traffic, cfg, seed)
    say(f"entry built at {time.perf_counter() - t_process:.1f} s")
    entry.warm(reqs[:traffic["warm"]])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process
    engines = entry.engines()
    say(f"set-up {setup_s:.1f} s; engines {engines}")

    entry.reset()
    records, t0, t1 = drive(entry, reqs[traffic["warm"]:] + reqs[:traffic["warm"]], traffic,
                            seconds=seconds)
    counters = entry.counters()
    failed = sum(r.out is None for r in records)
    lat = sorted(r.t1 - r.t0 for r in records if r.out is not None)
    late = [r.late_s for r in records]
    say(f"window: {len(records)} requests ({failed} failed) in {t1 - t0:.3f} s; latency "
        f"min/p10/p50/p90/max {[round(percentile(lat, q), 4) for q in (0, 10, 50, 90, 100)]}"
        + (f"; start late by mean {1e3 * sum(late) / max(len(late), 1):.2f} ms, max "
           f"{1e3 * max(late, default=0.0):.2f} ms" if traffic["loop"] == "open" else "")
        + f"; {counters}")
    run = Run(cfg=cfg, traffic=traffic, setup_s=setup_s, window_s=t1 - t0, records=records,
              failed=failed, engines=engines, counters=counters, peak_reserved=0,
              flops_per_image=work.model_flops_per_image(cfg))
    if trace:
        n = traffic["trace_requests"]
        run.trace = traced(lambda: drive(entry, reqs, traffic, count=n, annotate=True))
        say(f"traced segment: {n} requests, "
            f"{'no device events' if run.trace is None else f'{run.trace.window_s:.3f} s'}")
        run.trace_images = n
    if device.type == "cuda":
        run.peak_reserved = torch.cuda.max_memory_reserved(device)

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of the JAX stack or the JAX package are loaded: {found}")

    picked = sample_records(records, cfg["check_requests"], seed)
    for rec in picked:  # keep what is judged, on the host; free the rest
        rec.out = rec.out._replace(latents=None if rec.out.latents is None
                                   else rec.out.latents.float().cpu())
    kind = "per_layer" if trace else "end_to_end"
    specs = cell_metrics(bench, wl["name"], kind)
    metrics = per_layer(run, specs) if trace else end_to_end(run, [m["name"] for m in specs])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": wl["chips"], "memory_peak_bytes": run.peak_reserved,
           "power_limit": power_limit() if device.type == "cuda" else None}
    result = {"correct": False, "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        if run.trace is None:
            raise RuntimeError("the profiler gave no device events in any attempt")
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    entry.close()
    run.records = []
    del entry, model, records
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    readings = compare(fam, cfg, picked, weight_seed, device)
    say(f"reference: {len(picked)} requests (pool indices "
        f"{[r.req.index for r in picked]}) in {time.perf_counter() - t_ref:.1f} s; run "
        f"{time.perf_counter() - t_process:.1f} s")
    result["correct"], result["checks"] = judge(readings, cfg["limits"],
                                                result["attempted"], failed)
    return result
