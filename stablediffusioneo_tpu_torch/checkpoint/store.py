"""Native pipeline snapshots: a fast-reload deployment format (counterpart
of stablediffusioneo_tpu/checkpoint/store.py, which uses orbax).

`save_pipeline` persists the networks of a pipeline one file a component
(`<path>/<component>.safetensors`, written by checkpoint/torch_reader.py:
write_safetensors, in the tensors' own dtypes), and `load_pipeline` reads
them back with strict key accounting into the caller's modules, on their
devices. The port reads the upstream single files natively (no conversion;
PERF.md has their load times), so what a snapshot saves is the split by
network and, for a bf16 copy, half the bytes, rather than a parse.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Union

import torch
import torch.nn as nn

from stablediffusioneo_tpu_torch.checkpoint.accounting import load_strict
from stablediffusioneo_tpu_torch.checkpoint.torch_reader import (
    read_safetensors,
    write_safetensors,
)

__all__ = ["load_pipeline", "save_pipeline"]

Tree = Union[nn.Module, Mapping[str, torch.Tensor]]


def _file(path: str, component: str) -> str:
    return os.path.join(path, f"{component}.safetensors")


def save_pipeline(path: str, trees: Dict[str, Tree]) -> str:
    """{component: state dict (or module)} -> one safetensors file each under
    the directory `path` (made if missing). Returns `path`."""
    os.makedirs(path, exist_ok=True)
    for component, tree in trees.items():
        sd = tree.state_dict() if isinstance(tree, nn.Module) else tree
        write_safetensors(sd, _file(path, component))
    return path


def load_pipeline(path: str, like: Dict[str, nn.Module]) -> Dict[str, nn.Module]:
    """Restore a snapshot into `like`'s modules ({component: module}, their
    structure and devices): every key of each file accounted for
    (ConversionAccountingError on an orphan, missing or misshapen key), the
    tensors copied onto the module's device in its dtype. Returns `like`."""
    for component, module in like.items():
        load_strict(module, read_safetensors(_file(path, component)), component)
    return like
