"""Kernel families: `benchmark/kernels/<family>/*.json`, each file a list of
`marks` (substrings of device kernel names) with its `why`. A family's
kernels are those whose names hold a mark of any of its files, so a new
kernel adds a file and edits none."""

import json
from pathlib import Path


def marks(family: str):
    files = sorted((Path(__file__).parent / family).glob("*.json"))
    return sorted({m for f in files for m in json.loads(f.read_text())["marks"]})
