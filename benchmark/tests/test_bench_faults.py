"""The output check sees faults planted in the timed path. Each case drives
a whole run of a cell (`harness.run_cell`) on the CPU at a tiny preset, in
float32, past the look for a card, with the cell's own limits: a sound run
comes out `correct`, a run with a fault underneath does not. The faults a
cell of one card's inference can have: a DDIM step that returns its state
unchanged; an image altered where it is produced (a quarter of it blanked
in the decode to uint8); in the served cells, the rows of a batch answered
with each other's images (the open loop's tiny traffic fills every batch)."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from benchmark import harness  # noqa: E402
from benchmark import traffic as traffic_mod  # noqa: E402
from tiny import tiny, tiny_traffic  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def step_unchanged(monkeypatch):
    from stablediffusioneo_tpu_torch.pipeline import ddim

    real = ddim.ddim_update

    def update(x, e_t, schedule, i, *a, **kw):
        return x if i == 0 else real(x, e_t, schedule, i, *a, **kw)

    monkeypatch.setattr(ddim, "ddim_update", update)


def answer_altered(monkeypatch):
    from stablediffusioneo_tpu_torch.runtime import engine

    real = engine.decode_u8

    def decode(*a, **kw):
        img = real(*a, **kw).clone()
        h, w = img.shape[1:3]
        img[:, : h // 2, : w // 2] = 0
        return img

    monkeypatch.setattr(engine, "decode_u8", decode)


def rows_rolled(monkeypatch):
    from stablediffusioneo_tpu_torch.runtime import engine

    real = engine.decode_u8
    monkeypatch.setattr(engine, "decode_u8",
                        lambda *a, **kw: torch.roll(real(*a, **kw), 1, dims=0))


FAULTS = {"step_unchanged": step_unchanged, "answer_altered": answer_altered,
          "rows_rolled": rows_rolled}
CASES = [(c, f) for c in CELLS for f in [None, "step_unchanged", "answer_altered"]
         + (["rows_rolled"] if traffic_mod.load(CELLS[c]["traffic"])["entry"] == "server"
            else [])]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_check_sees_fault(cell, fault, monkeypatch):
    wl = CELLS[cell]
    cfg = tiny(wl["config"])
    full = json.loads((ROOT / next(c["file"] for c in BENCH["configs"]
                                   if c["name"] == wl["config"])).read_text())
    assert cfg["limits"] == full["limits"]
    traffic = tiny_traffic(traffic_mod.load(wl["traffic"]))
    if fault:
        FAULTS[fault](monkeypatch)
    result = harness.run_cell(BENCH, wl, cfg, traffic, 2 ** 31 + 77, 1.0, False,
                              torch.device("cpu"), time.perf_counter())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
