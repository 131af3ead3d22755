"""The general generator of requests: a traffic file
(`benchmark/traffic/<name>.json`) gives the loop, the clients, the entry
and the mix's parameters; the seed gives the requests. Every seed gets the
same sizes (the configuration's resolution, prompts within one 77-token
window); the images, prompts and per-request seeds differ.

Traffic keys: `loop` ("closed": each client sends its next request when
the last one completes; "open": requests arrive on a schedule, whether or
not earlier ones have completed), `clients` (closed loop), `rate_per_s`
(open loop: the mean arrival rate of a Poisson process, `arrivals`),
`arrivals_seed` (open loop: the seed of its schedule, the same in every run:
drawn from the run's seed, each realization's bursts moved the median
latency of SD-1.5 + ControlNet served at 4.6 arrivals a second on an H100
by 10% from seed to seed, where the run's seed is to change the requests
and not the load),
`max_outstanding` (open loop: requests sent and not yet completed, at most;
an arrival beyond them is not sent and counts as failed), `entry` (the
family's entry: "pipeline" or "server"; an open loop needs one that takes
any number of callers), `server` (the server's settings, for that entry),
`pool` (distinct requests made in set-up, sent in turn), `warm` (requests
sent in set-up), `trace_requests` (requests in the traced segment),
`prompt_words` [min, max], `vocabulary` (a word file beside the traffic
file), `image` {`shapes` [min, max], `noise`} (a synthetic image with edges:
a colour gradient, rectangles and discs, uniform noise).
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

TRAFFIC_DIR = Path(__file__).parent / "traffic"


def stand_in_tokenizer(texts, max_length=77):
    """Deterministic stand-in for the CLIP BPE tokenizer (its vocabulary is
    not in the repository; a copy of the smoke test's): BOS 49406, one hashed
    id below 49406 per word, EOS and padding 49407."""
    rows = []
    for t in texts:
        ids = [49406] + [zlib.crc32(w.encode()) % 49406
                         for w in t.replace(",", " ").split()][:max_length - 2]
        rows.append(ids + [49407] * (max_length - len(ids)))
    return np.asarray(rows, np.int64)


@dataclass
class Request:
    index: int
    seed: int           # the request's own seed: its initial latents
    prompt: str
    image: np.ndarray   # uint8 (res, res, 3), or None for text-only families


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def synthetic_image(rng, res: int, shapes, noise: int) -> np.ndarray:
    yy, xx = np.mgrid[0:res, 0:res] / res
    c0, c1 = rng.uniform(0, 200, 3), rng.uniform(0, 200, 3)
    img = c0 * xx[..., None] + c1 * yy[..., None]
    for _ in range(int(rng.integers(shapes[0], shapes[1] + 1))):
        colour = rng.uniform(0, 230, 3)
        cx, cy, r = rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9), rng.uniform(0.05, 0.25)
        if rng.random() < 0.5:
            img[(np.abs(xx - cx) < r) & (np.abs(yy - cy) < 0.7 * r)] = colour
        else:
            img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = colour
    img = img + rng.integers(0, noise + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def arrivals(rate: float, n: int, seed: int) -> List[float]:
    """The arrival times, seconds from the start, of `n` requests of a
    Poisson process of `rate` a second, drawn from `seed`: exponential gaps
    of mean 1 / rate, scaled so that the (n+1)-th arrival falls at n / rate.
    That is the process given n arrivals in [0, n / rate): the same number
    of requests over the same span whatever the seed."""
    gaps = np.random.default_rng([seed, 2]).exponential(1.0 / rate, n + 1)
    t = np.cumsum(gaps)
    return (t[:n] * (n / rate / t[n])).tolist()


def requests(traffic: dict, cfg: dict, seed: int) -> List[Request]:
    """The pool of distinct requests of a run, from its seed."""
    rng = np.random.default_rng(seed)
    words = (TRAFFIC_DIR / traffic["vocabulary"]).read_text().split()
    res = cfg["sampling"]["resolution"]
    lo, hi = traffic["prompt_words"]
    out = []
    for i in range(traffic["pool"]):
        n = int(rng.integers(lo, hi + 1))
        prompt = " ".join(rng.choice(words, n))
        image = (synthetic_image(rng, res, traffic["image"]["shapes"], traffic["image"]["noise"])
                 if cfg.get("conditioning") == "canny" else None)
        out.append(Request(i, int(rng.integers(0, 2 ** 31 - 1)), prompt, image))
    return out
