"""State-dict readers (counterpart of stablediffusioneo_tpu/checkpoint/torch_reader.py).

`load_torch_state_dict(path)` returns {name: torch.Tensor} on the CPU, as the
reference's `load_state_dict` (cldm/model.py:8-21) reads a checkpoint:
  - `.pth` / `.ckpt`: torch.load(map_location="cpu", weights_only=True,
    mmap=True), so the tensors page in from the file as they are read;
  - `.safetensors`: this module's own reader of the format (an 8-byte
    little-endian header length, a JSON header of {name: {dtype, shape,
    data_offsets}}, then the data; offsets count from the end of the header),
    with the tensors made by torch.frombuffer over a private mapping of the
    file. It takes F32, F16 and BF16, the dtypes of SD checkpoints.
A nested {"state_dict": {...}} is unwrapped; entries that are not tensors
(a training step, a config) are dropped.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict

import torch

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        # a private (copy-on-write) mapping: writable for torch.frombuffer,
        # and the file is never written; the tensors keep it alive
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + hlen
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise TypeError(f"{path}: {name} has dtype {meta['dtype']}; this "
                            f"reader takes {sorted(_SAFETENSORS_DTYPES)}")
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        count = (end - start) // dtype.itemsize
        if count != int(torch.Size(shape).numel()) or base + end > len(data):
            raise ValueError(f"{path}: {name} data_offsets {start}..{end} do not "
                             f"hold a {meta['dtype']} tensor of shape {shape}")
        flat = (torch.frombuffer(data, dtype=dtype, count=count, offset=base + start)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(shape)
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pth / .ckpt / .safetensors state dict as {name: CPU tensor}."""
    if str(path).endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    # unwrap nested {'state_dict': ...} (cldm/model.py:15-17)
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
