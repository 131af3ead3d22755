"""The `sd3` family (`benchmark/families/sd3.py`) and `sd35-medium`: the work
counts pinned to the hand count in PERF.md and held to torch's flop counter
over the reference on a tiny preset; the weight rules cover every leaf of
the reference; the frozen reference (`benchmark/reference/sd3.py`) and the
port's (`stablediffusioneo_tpu_torch/testing/torch_ref_sd3.py`) agree; the
configuration is the program's preset; a tiny cell runs through the harness
on the CPU and comes out correct, and not correct with a fault planted; the
configurations pinned before this family read as they did."""

from __future__ import annotations

import copy
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from benchmark import families, harness, work  # noqa: E402
from benchmark.families import sd3 as fam  # noqa: E402
from benchmark.traffic import Request  # noqa: E402
from benchmark.weights import draw_state_dict, leaf_rules  # noqa: E402

import test_bench_pinned  # noqa: E402

CFG = json.loads((ROOT / "benchmark" / "configs" / "sd35-medium.json").read_text())

# the hand count (PERF.md section 4): FLOPs of one image, and its parts
FLOPS = 915_453_609_713_664
MMDIT_ROW = 11_249_573_707_776
ATTENTION_CALLS = 1_481     # 40 x (24 joint + 13 image-only) + the decode's mid-block
CALLS_SHA256 = "fad14c4ed2390d8e29c65aae1abbbf4bb0efa99e9b1bf925ff87b43a5b70daf9"
LEAVES = 1_841


def tiny_cfg():
    """sd35-medium's layout at tiny widths: 4 blocks (the first 2 dual, the
    last context stream pre-only), towers of 77 CLIP tokens with CLIP's
    49,408 ids (the stand-in tokenizer's) and 20 T5 tokens, a 64x64 request
    of 2 steps, fp32."""
    cfg = copy.deepcopy(CFG)
    cfg["transformer"].update(sample_size=8, num_layers=4, attention_head_dim=8,
                              num_attention_heads=2, joint_attention_dim=24,
                              caption_projection_dim=16, pooled_projection_dim=28,
                              pos_embed_max_size=12, dual_attention_layers=[0, 1])
    tower = {"intermediate_size": 32, "num_layers": 2, "num_heads": 2}
    cfg["clip_l"].update(tower, hidden_size=8, projection_dim=12)
    cfg["clip_g"].update(tower, hidden_size=12, projection_dim=16)
    cfg["t5"].update(vocab_size=32128, d_model=24, d_kv=6, d_ff=40, num_layers=2, num_heads=4,
                     max_length=20)
    cfg["vae"].update(ch=16, ch_mult=[1, 1, 1, 1], num_res_blocks=1, groups=8)
    cfg["sampling"].update(resolution=64, steps=2)
    cfg["dtype"] = "float32"
    return cfg


def counted(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def drawn_reference(cfg, module, seed=1):
    torch.manual_seed(0)
    net = module.SD3(cfg)
    net.load_state_dict(draw_state_dict(net, seed, "cpu", torch.float32))
    return net.eval()


def test_flops_match_flop_counter_on_the_tiny_preset():
    """Every product of one reference request, counted by torch's flop
    counter, equals the analytic count."""
    from benchmark.reference import sd3 as ref

    cfg = tiny_cfg()
    net = drawn_reference(cfg, ref)
    ids = fam.token_ids(Request(0, 3, "a red car on a hill", None), cfg)
    assert counted(lambda: ref.sd3_request(net, cfg, *ids, 3)) == fam.flops_per_image(cfg)


def test_counts_pinned_to_the_hand_count():
    assert fam.flops_per_image(CFG) == work.model_flops_per_image(CFG) == FLOPS
    assert fam.mmdit_flops(CFG["transformer"], 128, 333) == MMDIT_ROW
    # the joint and image-only products, 2.89 and 1.34 TFLOP a row
    assert 24 * 4 * 4429 ** 2 * 1536 == 2_892_502_941_696
    assert 13 * 4 * 4096 ** 2 * 1536 == 1_340_029_796_352
    calls = work.attention_calls(CFG)
    assert len(calls) == ATTENTION_CALLS
    assert calls[0] == (2, 24, 4429, 4429, 64) and calls[1] == (2, 24, 4096, 4096, 64)
    assert calls[-1] == (1, 1, 16384, 16384, 512)
    assert hashlib.sha256(repr(calls).encode()).hexdigest() == CALLS_SHA256


def test_leaf_rules_cover_the_reference():
    with torch.device("meta"):
        net = fam.reference_module(CFG)
    rules = leaf_rules(net)
    assert len(rules) == LEAVES == len(list(net.parameters()))
    kinds = {k: kind for k, kind, _ in rules}
    assert kinds["model.diffusion_model.joint_blocks.0.x_block.attn2.ln_q.weight"] == "one"
    assert kinds["text_encoders.t5xxl.transformer.encoder.final_layer_norm.weight"] == "one"
    assert kinds["text_encoders.clip_l.transformer.text_projection.weight"] == "uniform"
    assert not any("pos_embed" in k for k in kinds)


def test_frozen_reference_agrees_with_the_ports():
    from benchmark.reference import sd3 as frozen
    from stablediffusioneo_tpu_torch.testing import torch_ref_sd3 as port_ref

    cfg = tiny_cfg()
    a, b = drawn_reference(cfg, frozen, 7), drawn_reference(cfg, port_ref, 7)
    assert list(a.state_dict()) == list(b.state_dict())
    ids = fam.token_ids(Request(0, 5, "two boats at dusk", None), cfg)
    za, ia = frozen.sd3_request(a, cfg, *ids, 11)
    zb, ib = port_ref.sd3_request(b, cfg, *ids, 11)
    assert torch.equal(za, zb) and torch.equal(ia, ib)


def test_config_is_the_programs_preset():
    from stablediffusioneo_tpu_torch.models.sd3 import SD3Config

    assert fam.program_config(CFG) == SD3Config()


def test_t5_stand_in_ids():
    ids = fam.t5_ids(["a house, by the sea", ""], 256)
    assert ids.shape == (2, 256) and ids.dtype == np.int64
    assert list(ids[0, 5:7]) == [1, 0] and ids[1, 0] == 1 and (ids[1, 1:] == 0).all()
    assert ((ids[0, :5] >= 3) & (ids[0, :5] < 32000)).all()


def step_skipped(monkeypatch):
    """Every stage's loop leaves out its first Euler step."""
    from stablediffusioneo_tpu_torch.pipeline import flow_match

    real = flow_match.flow_match_sample
    monkeypatch.setattr(flow_match, "flow_match_sample",
                        lambda velocity, steps, *a, **kw: real(velocity, steps[1:], *a, **kw))


def answer_altered(monkeypatch):
    """A quarter of the image blanked where the engine makes it."""
    from stablediffusioneo_tpu_torch.runtime import engine

    real = engine.decode_u8

    def decode(*a, **kw):
        img = real(*a, **kw).clone()
        h, w = img.shape[1:3]
        img[:, : h // 2, : w // 2] = 0
        return img

    monkeypatch.setattr(engine, "decode_u8", decode)


@pytest.mark.parametrize("fault", [None, step_skipped, answer_altered],
                         ids=["sound", "step_skipped", "answer_altered"])
def test_check_sees_fault_in_the_tiny_cell(fault, monkeypatch):
    """The family's entry (conditioning, the engine eagerly on the CPU,
    fetch) against its reference, judged by the cell's own limits as a run
    judges it: sound it is correct, with a fault planted in the timed path it
    is not (`test_bench_faults.py`'s cases, for the flow-matching family)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == "sd35-medium.single")
    traffic = dict(json.loads((ROOT / "benchmark" / "traffic" / "single.json").read_text()),
                   pool=3, warm=1)
    if fault:
        fault(monkeypatch)
    res = harness.run_cell(bench, wl, tiny_cfg(), traffic, 2 ** 31 + 9, 0.5, False,
                           torch.device("cpu"), time.perf_counter())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is (fault is None), res["checks"]
    assert set(res["checks"]) == {"latent_rel", "pixel_mad", "requests_failed"}
    assert set(res["metrics"]) == {"images_per_s", "latency_p50_s", "setup_s"}


@pytest.mark.parametrize("name", sorted(test_bench_pinned.PINNED))
def test_pinned_configurations_unchanged(name):
    test_bench_pinned.test_counts(name)
    test_bench_pinned.test_reference_layout(name)
    test_bench_pinned.test_tiny_draw(name)
    assert families.load(test_bench_pinned.load(name)["family"]) is not fam
