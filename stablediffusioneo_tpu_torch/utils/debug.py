"""Numerical sanitizers (counterpart of stablediffusioneo_tpu/utils/debug.py).

- nan_report / assert_finite: explicit scans of a nested structure of
  tensors (dicts, lists, tuples, nn.Modules) for tests, the offline drill
  and the readiness check;
- enable_debug_nans(): torch's anomaly mode, the runtime sanitizer of
  autograd (dev-only: it slows every backward down).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch
import torch.nn as nn


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) in the order and with the path strings of
    jax.tree_util.tree_flatten_with_path + keystr: dict keys sorted and
    written ['key'], list and tuple positions [i]; an nn.Module is the dict
    of its state_dict(); None is an empty subtree."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bool or not (leaf.is_floating_point() or leaf.is_complex()):
            return True
        return bool(torch.isfinite(leaf).all())
    if leaf.dtype == np.bool_:
        return True
    return bool(np.isfinite(np.asarray(leaf, np.float32)).all())


def nan_report(tree, max_entries: int = 10) -> List[str]:
    """Paths of non-finite leaves (empty == all finite). Leaves without a
    dtype (Python numbers, strings) and boolean ones are not checked."""
    bad = []
    for path, leaf in _leaves(tree):
        if not hasattr(leaf, "dtype"):
            continue
        if not _finite(leaf):
            bad.append(path)
            if len(bad) >= max_entries:
                break
    return bad


def assert_finite(tree, what: str = "tree") -> None:
    bad = nan_report(tree)
    assert not bad, f"non-finite values in {what}: {bad}"


def enable_debug_nans(enable: bool = True) -> None:
    """torch.autograd.set_detect_anomaly(enable). Unlike the JAX package's
    jax_debug_nans, which checks every compiled op's output and re-runs the
    failing op eagerly, anomaly mode checks the backward pass only: a
    backward function that returns NaN raises, naming the forward op that
    made it. Forward NaNs are found with nan_report / assert_finite."""
    torch.autograd.set_detect_anomaly(enable)
