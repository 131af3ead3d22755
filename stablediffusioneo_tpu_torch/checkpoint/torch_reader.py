"""State-dict readers (counterpart of stablediffusioneo_tpu/checkpoint/torch_reader.py).

`load_torch_state_dict(path)` returns {name: torch.Tensor} on the CPU, as the
reference's `load_state_dict` (cldm/model.py:8-21) reads a checkpoint:
  - `.pth` / `.ckpt`: torch.load(map_location="cpu", weights_only=True,
    mmap=True), so the tensors page in from the file as they are read;
  - `.safetensors`: this module's own reader of the format (an 8-byte
    little-endian header length, a JSON header of {name: {dtype, shape,
    data_offsets}}, then the data; offsets count from the end of the header),
    with the tensors made by torch.frombuffer over a private mapping of the
    file. It takes the float dtypes of SD checkpoints (F32, F16, BF16, F64)
    and the integer ones of their counters and index rows (I64 for a
    BatchNorm's num_batches_tracked and a CLIP tower's position_ids, I32,
    I16, I8, U8, BOOL).
A nested {"state_dict": {...}} is unwrapped; entries that are not tensors
(a training step, a config) are dropped.

`write_safetensors(sd, path)` writes the same format (the counterpart of the
`safetensors` package's save_file, which the port does not use): tensors
ordered by element size, largest first, then by name; the header padded
with spaces to a multiple of 8 bytes, so every tensor's data is aligned.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "F64": torch.float64,
                       "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
                       "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_SAFETENSORS_NAMES = {v: k for k, v in _SAFETENSORS_DTYPES.items()}


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


def _as_tensor(v) -> torch.Tensor:
    """A host tensor sharing v's memory where it can (a numpy array, or a
    tensor on any device, copied to the host)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().contiguous()
    a = np.asarray(v)
    return torch.from_numpy(a if a.flags.c_contiguous else a.copy())


def write_safetensors(sd: Mapping, path: str,
                      metadata: Optional[Dict[str, str]] = None) -> str:
    """{name: tensor or numpy array} -> a .safetensors file at `path`."""
    tensors = {k: _as_tensor(v) for k, v in sd.items()}
    for k, t in tensors.items():
        if t.dtype not in _SAFETENSORS_NAMES:
            raise TypeError(f"{k}: dtype {t.dtype} has no safetensors name")
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for k in order:
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in order:
            t = tensors[k]
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
    return path


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
