"""The yardstick's arithmetic: the analytic FLOP count against
`torch.utils.flop_counter.FlopCounterMode` over the reference on tiny
presets of both configurations and against a published count at full width;
the attention bounds; the trace reduction; the metric readers."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from benchmark import work  # noqa: E402
from benchmark.harness import Run, load_metric  # noqa: E402
from benchmark.trace import Trace, reduce_events  # noqa: E402
from tiny import tiny  # noqa: E402


def counted(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["sd15-controlnet-canny", "sdxl-base"])
def test_flops_match_flop_counter_on_tiny_presets(name):
    """One request of the reference, every product counted by torch's flop
    counter, equals the analytic count."""
    from benchmark import families
    from benchmark.reference import sample
    from benchmark.weights import draw_state_dict

    cfg = tiny(name)
    torch.manual_seed(0)
    net = families.load(cfg["family"]).reference_module(cfg)
    net.load_state_dict(draw_state_dict(net, 1, "cpu", torch.float32))
    if cfg["family"] == "controlnet_sd":
        import numpy as np

        from benchmark.traffic import stand_in_tokenizer

        img = (np.random.default_rng(0).random((64, 64, 3)) * 255).astype(np.uint8)
        ids = stand_in_tokenizer(["a house", ""])
        flops = counted(lambda: sample.sd_request(net, cfg, img, ids, 3))
    else:
        from benchmark.families.sdxl import token_ids
        from benchmark.traffic import Request

        ids_l, ids_g = token_ids(Request(0, 3, "a red car", None))
        flops = counted(lambda: sample.sdxl_request(net, cfg, ids_l, ids_g, 3))
    assert flops == work.model_flops_per_image(cfg)


def test_unet_count_against_published_macs():
    """SD-1.5's UNet at 512x512 is 339 GMAC without the attention products
    (BK-SDM, arXiv:2305.15798, Table 1): the analytic count less its Q K^T
    and P V products lands there."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "sd15-controlnet-canny.json").read_text())
    u = cfg["unet"]
    products = sum(depth * 4 * tokens * s * c for c, tokens, depth in
                   work._unet_sites(u, 64, 77, 1) for s in (tokens, 77))
    macs = (work.unet_flops(u, 64, 77) - products) / 2
    assert abs(macs / 339e9 - 1) < 0.01, macs


def test_full_width_counts():
    """Per image: sd15 ~46.0 TFLOP (20 CFG evaluations of UNet 402 GMAC +
    ControlNet 142 GMAC a row, the decode 1.26 TMAC); SDXL ~281 TFLOP."""
    load = lambda n: json.loads((ROOT / "benchmark" / "configs" / f"{n}.json").read_text())  # noqa: E731
    sd, xl = load("sd15-controlnet-canny"), load("sdxl-base")
    assert work.unet_flops(sd["unet"], 64, 77) / 2 == pytest.approx(401.64e9, rel=1e-3)
    assert work.vae_decode_flops(sd["vae"], 64) / 2 == pytest.approx(1.2573e12, rel=1e-3)
    assert work.model_flops_per_image(sd) == pytest.approx(46.004e12, rel=1e-3)
    assert work.model_flops_per_image(xl) == pytest.approx(281.14e12, rel=1e-3)


def test_attention_bound_arithmetic():
    ops, nbytes = work.attention_work(2, 8, 4096, 4096, 40)
    assert ops == 4 * 2 * 8 * 4096 * 4096 * 40
    assert nbytes == 2 * 2 * 8 * 40 * (4096 + 4096) * 2
    assert work.bound_s(ops, nbytes) == pytest.approx(max(ops / 989e12, nbytes / 3.35e12))
    assert work.bound_s(ops, 10 ** 12) == pytest.approx(10 ** 12 / 3.35e12)
    cfg = json.loads((ROOT / "benchmark" / "configs" / "sd15-controlnet-canny.json").read_text())
    calls = work.attention_calls(cfg)
    # 20 steps x (7 blocks at 4096, 7 at 1024, 7 at 256, 2 at 64) x (self, cross),
    # 12 CLIP layers, one VAE mid-block call
    assert len(calls) == 20 * 23 * 2 + 12 + 1
    assert work.attention_bound_s(cfg, 4) == pytest.approx(4 * work.attention_bound_s(cfg))


def test_trace_reduction():
    device = [("k1", 0, 10), ("k2", 5, 20), ("k1", 40, 50), ("copy", 90, 95)]
    host = [("bench.segment", 0, 100), ("aten::x", 20, 45), ("cudaStreamSynchronize", 60, 89)]
    t = reduce_events(device, host, (0, 100))
    assert t.busy_s == pytest.approx(35e-6) and t.window_s == pytest.approx(100e-6)
    assert t.by_name == pytest.approx({"k1": 20e-6, "k2": 15e-6, "copy": 5e-6})
    assert [g[0] for g in t.gaps] == ["cudaStreamSynchronize", "aten::x", "bench.segment"]
    assert t.gaps[0][1] == pytest.approx(40e-6)
    assert t.family_s(["k"]) == pytest.approx(35e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(20e-6)] and len(bd["idle_gaps"]) == 3


def _run(**kw):
    cfg = json.loads((ROOT / "benchmark" / "configs" / "sd15-controlnet-canny.json").read_text())
    base = dict(cfg=cfg, traffic={}, setup_s=20.0, window_s=10.0, records=[], failed=0,
                engines={}, counters={}, peak_reserved=0)
    base.update(kw)
    return Run(**base)


def test_metric_readers_read_or_return_nothing():
    from benchmark.families import Output
    from benchmark.harness import Record

    empty = _run()
    for name in ("serving.mean_batch", "serving.queue_ms", "serving.latency_p90_s",
                 "pipeline.preprocess_ms",
                 "pipeline.text_ms", "runtime.capture_s", "mfu", "kernels.attention_roofline",
                 "device.idle_share", "device.peak_reserved_gib"):
        assert load_metric(name).read(empty) is None, name
    recs = [Record(None, 0.0, 0.4 + i / 10, Output(None, None, {"pipeline.preprocess_ms": v}))
            for i, v in enumerate([1.0, 3.0] * 5)]
    trace = Trace(window_s=1.0, busy_s=0.9, by_name={"attention_wgmma_kernel": 0.02,
                                                     "gemm": 0.5})
    run = _run(records=recs, trace=trace, trace_images=1, peak_reserved=2 ** 33,
               engines={"a": {"compiled": True, "compile_seconds": 2.5}},
               counters={"server": {"batches": 2, "mean_batch": 3.5, "mean_queue_ms": 900.0}},
               flops_per_image=work.model_flops_per_image(_run().cfg))
    read = lambda n: load_metric(n).read(run)  # noqa: E731
    assert read("pipeline.preprocess_ms") == 2.0
    assert read("serving.mean_batch") == 3.5 and read("serving.queue_ms") == 900.0
    assert read("serving.latency_p90_s") == pytest.approx(1.21)
    assert read("runtime.capture_s") == 2.5 and read("device.peak_reserved_gib") == 8.0
    assert read("device.idle_share") == pytest.approx(10.0)
    assert read("mfu") == pytest.approx(100 * 46.004e12 * 10 / 10.0 / 989e12, rel=1e-3)
    assert read("kernels.attention_roofline") == pytest.approx(
        100 * work.attention_bound_s(run.cfg) / 0.02)
