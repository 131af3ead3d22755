"""The readings of the configurations the benchmark measured before the
families brought their own counts and reference: the FLOPs of an image, the
attention bounds, the number of attention calls, and the reference's
state-dict layout (keys, shapes, order: what `draw_state_dict` draws from a
seed) are the values the harness gave when `benchmark/work.py` and
`benchmark/reference/sample.py` still branched on the family. Compared
exactly: a changed count moves `mfu` and `kernels.attention_roofline`, a
changed layout the weights of every run."""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from benchmark import families, work  # noqa: E402
from benchmark.weights import draw_state_dict  # noqa: E402
from tiny import tiny  # noqa: E402

PINNED = {
    "sd15-controlnet-canny": {
        "flops": 46003732619264,
        "bound_s": {1: 0.007954472274850459, 2: 0.015908944549700918,
                    8: 0.06363577819880367},
        "calls": 933,
        "calls_sha256": "4ce81359cb0f856bdd866501908b6dc8b8eb9876ad028fc1f1f3b8c11cb1c870",
        "leaves": 1470,
        "layout_sha256": "15a2095b95afc8e94e3779ed68ee08dd6b9f8e64abe05c2d239f47902d348078",
        "tiny_leaves": 652,
        "tiny_draw_sha256": "f2effee017ca780bf0072732d4f010b746a2a3340d36417bf4e2ccec83f2f608",
    },
    "sdxl-base": {
        "flops": 281139955320832,
        "bound_s": {1: 0.036287304078145816, 2: 0.07257460815629163,
                    8: 0.2902984326251665},
        "calls": 2844,
        "calls_sha256": "a48185c65127272bf7b0fa6b644729b911b840e10120368911ef21d1f8c3419c",
        "leaves": 2513,
        "layout_sha256": "e786e18b2fcc5cc2a23c0895348c0669a0fd25814b4915b4ffb38f9943866b7c",
        "tiny_leaves": 651,
        "tiny_draw_sha256": "1223c52f66349ea77d05de61eeab2e7bc541ffc92cd6d4fe986c8c672379fc46",
    },
}


def load(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def layout(cfg):
    with torch.device("meta"):
        net = families.load(cfg["family"]).reference_module(cfg)
    return net, [f"{k}:{tuple(p.shape)}" for k, p in net.state_dict().items()]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_counts(name):
    cfg, pin = load(name), PINNED[name]
    flops = work.model_flops_per_image(cfg)
    assert type(flops) is int and flops == pin["flops"]
    assert {n: work.attention_bound_s(cfg, n) for n in (1, 2, 8)} == pin["bound_s"]
    calls = work.attention_calls(cfg)
    assert len(calls) == pin["calls"]
    assert hashlib.sha256(repr(calls).encode()).hexdigest() == pin["calls_sha256"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_reference_layout(name):
    _, lines = layout(load(name))
    assert len(lines) == PINNED[name]["leaves"]
    assert hashlib.sha256("\n".join(lines).encode()).hexdigest() == PINNED[name]["layout_sha256"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_tiny_draw(name):
    """The values drawn from one seed at the tiny preset, in order."""
    net, _ = layout(tiny(name))
    sd = draw_state_dict(net, 2 ** 40 + 5, "cpu", torch.float32)
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert len(sd) == PINNED[name]["tiny_leaves"]
    assert h.hexdigest() == PINNED[name]["tiny_draw_sha256"]
