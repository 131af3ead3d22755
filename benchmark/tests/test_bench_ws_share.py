"""The reader of kernels.attention_ws_share against the program's counter,
and against a program that keeps none or lacks the variant."""

import collections

from benchmark.harness import load_metric
from stablediffusioneo_tpu_torch.ops.kernels import attention


def test_share_of_launches_on_the_warp_specialised_variant(monkeypatch):
    read = load_metric("kernels.attention_ws_share").read
    monkeypatch.setattr(attention, "variant_launches", collections.Counter(
        {"wgmma_ws": 1480, "wgmma_split": 1}))
    assert read(None) == 100.0 * 1480 / 1481
    monkeypatch.setattr(attention, "variant_launches", collections.Counter(
        {"wgmma": 1400, "wgmma_ws": 1400, "wgmma_split": 1}))
    assert read(None) == 100.0 * 1400 / 2801
    monkeypatch.setattr(attention, "variant_launches", collections.Counter({"wgmma": 12}))
    assert read(None) == 0.0


def test_nothing_to_read(monkeypatch):
    read = load_metric("kernels.attention_ws_share").read
    monkeypatch.setattr(attention, "variant_launches", collections.Counter())
    assert read(None) is None
    monkeypatch.setattr(attention, "variant_launches", collections.Counter({"wgmma": 3}))
    monkeypatch.setattr(attention, "VARIANTS", {"cuda_core": 0, "wgmma": 1})
    assert read(None) is None  # the program before the variant
    monkeypatch.delattr(attention, "variant_launches")
    assert read(None) is None
