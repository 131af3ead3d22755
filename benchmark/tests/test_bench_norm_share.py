"""The reader of kernels.norm_kernel_share against the program's counter,
and against a program that keeps none."""

import collections

from benchmark.harness import load_metric
from stablediffusioneo_tpu_torch.ops import norms


def test_share_of_card_calls_that_reached_a_kernel(monkeypatch):
    read = load_metric("kernels.norm_kernel_share").read
    counts = collections.Counter({("group_norm", "one_pass"): 6, ("group_norm", "pair"): 2,
                                  ("layer_norm", "kernel"): 8, ("layer_norm", "plain_refused"): 3,
                                  ("group_norm", "plain_grad"): 1,
                                  ("group_norm", "plain_cpu"): 50,
                                  ("layer_norm", "flag_cpu"): 7})
    monkeypatch.setattr(norms, "route_counts", counts)
    assert read(None) == 100.0 * 16 / 20
    monkeypatch.setattr(norms, "route_counts", collections.Counter(
        {("layer_norm", "kernel"): 4, ("group_norm", "pair"): 1}))
    assert read(None) == 100.0


def test_nothing_to_read(monkeypatch):
    read = load_metric("kernels.norm_kernel_share").read
    monkeypatch.setattr(norms, "route_counts", collections.Counter())
    assert read(None) is None
    monkeypatch.setattr(norms, "route_counts",
                        collections.Counter({("group_norm", "plain_cpu"): 3,
                                             ("layer_norm", "flag_cpu"): 2}))
    assert read(None) is None
    monkeypatch.delattr(norms, "route_counts")  # the program before the counter
    assert read(None) is None
