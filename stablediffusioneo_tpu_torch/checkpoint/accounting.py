"""Checkpoint key accounting (counterpart of
stablediffusioneo_tpu/checkpoint/accounting.py).

The port keeps the checkpoint's key names, so loading converts nothing: the
one job left is to account for every key. `account_checkpoint(model, sd)`
sorts the file's keys into those the model consumes, those a documented
pattern says nothing reads (`SD_KNOWN_UNUSED`, an own copy of the JAX
package's list) and orphans; and the model's own keys into those present
with the right shape, missing, or of another shape. A strict load raises
`ConversionAccountingError` naming the first orphans, missing keys and
mismatches, as the JAX package's `ConversionReport.assert_complete` does.

Two rules beyond names and shapes, both the JAX converters':
  * a SpatialTransformer's proj_in / proj_out, held as a 1x1 conv (C, C, 1,
    1), also takes the Linear weight (C, C) that SD-2.x and SDXL files store
    (`_proj_conv`, convert.py); nothing else changes shape on load;
  * a loader of several trees names each tree's documented leftovers by
    pattern under its prefix (`tree_ignores`: `.*position_ids` for an HF
    CLIP tower, `.*attn_mask` and `.*logit_scale` for an OpenCLIP one).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import torch

import torch.nn as nn

# Keys a full ControlNet/SD checkpoint carries that the rebuild derives or
# has no use for. Each entry documents why it is safe to leave behind.
SD_KNOWN_UNUSED: Tuple[str, ...] = (
    # DDPM schedule buffers registered by LatentDiffusion — pure functions of
    # (timesteps, linear_start, linear_end); ops/schedule.py recomputes them
    # from the config, so the serialized copies are redundant.
    r"betas",
    r"alphas_cumprod",
    r"alphas_cumprod_prev",
    r"sqrt_alphas_cumprod",
    r"sqrt_one_minus_alphas_cumprod",
    r"log_one_minus_alphas_cumprod",
    r"sqrt_recip_alphas_cumprod",
    r"sqrt_recipm1_alphas_cumprod",
    r"posterior_variance",
    r"posterior_log_variance_clipped",
    r"posterior_mean_coef1",
    r"posterior_mean_coef2",
    # per-timestep loss log-variances (training-only; reference never reads
    # them at inference either)
    r"logvar",
    # EMA shadow params (training artifact; the live weights are canonical)
    r"model_ema\..*",
    # HF CLIPTextModel registers position_ids as a persistent int buffer;
    # the rebuild uses a static arange.
    r"cond_stage_model\.transformer\.text_model\.embeddings\.position_ids",
    # OpenCLIP towers (SD-2.x) serialize the causal mask and, for the full
    # model, vision/logit towers the text pipeline never touches.
    r"cond_stage_model\.model\.attn_mask",
    r"cond_stage_model\.model\.text_projection",
    r"cond_stage_model\.model\.logit_scale",
)
_UNUSED = [re.compile(p) for p in SD_KNOWN_UNUSED]


# a SpatialTransformer's projections: block .1 of an input, middle or output
# block (the VAE's attn_1.proj_out is not one)
_PROJ = re.compile(r"(.*\.)?(input_blocks\.\d+|middle_block|output_blocks\.\d+)"
                   r"\.1\.proj_(in|out)\.weight")

# per-tree leftovers of the JAX loaders' jobs (convert.py:405-410, 609-615)
HF_CLIP_IGNORES: Tuple[str, ...] = (r".*position_ids",)
OPENCLIP_IGNORES: Tuple[str, ...] = (r".*attn_mask", r".*logit_scale")


class ConversionAccountingError(RuntimeError):
    pass


def known_unused(key: str) -> bool:
    return any(p.fullmatch(key) for p in _UNUSED)


def tree_ignores(trees: Iterable[Tuple[str, Sequence[str]]]) -> Tuple[str, ...]:
    """(prefix, patterns) per tree -> patterns over the full keys."""
    return tuple(re.escape(prefix) + pat for prefix, pats in trees for pat in pats)


def proj_weight_fits(key: str, file_shape, model_shape) -> bool:
    """Whether a file tensor of file_shape loads into the model's key: the
    same shape, or a Linear-stored (C, C) projection into its 1x1 conv."""
    file_shape, model_shape = tuple(file_shape), tuple(model_shape)
    if file_shape == model_shape:
        return True
    return (len(file_shape) == 2 and model_shape == file_shape + (1, 1)
            and _PROJ.fullmatch(key) is not None)


def _head(keys, n: int) -> str:
    keys = sorted(keys)
    more = f" (+{len(keys) - n} more)" if len(keys) > n else ""
    return ", ".join(keys[:n]) + more


@dataclass
class CheckpointReport:
    """Where each key went. consumed: file keys the model holds, with the
    model's shape; ignored: file keys matching SD_KNOWN_UNUSED; orphans: the
    other file keys; missing: model keys the file lacks; mismatched: {key:
    (file shape, model shape)}."""

    consumed: set
    ignored: set
    orphans: set
    missing: set
    mismatched: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]

    @property
    def complete(self) -> bool:
        return not (self.orphans or self.missing or self.mismatched)

    def problems(self, orphans: bool = True) -> List[str]:
        out = []
        if orphans and self.orphans:
            out.append(f"{len(self.orphans)} checkpoint keys never consumed: "
                       f"{_head(self.orphans, 15)}")
        if self.missing:
            out.append(f"{len(self.missing)} model keys missing from the "
                       f"checkpoint: {_head(self.missing, 10)}")
        if self.mismatched:
            shown = sorted(self.mismatched)[:10]
            more = (f" (+{len(self.mismatched) - 10} more)"
                    if len(self.mismatched) > 10 else "")
            out.append(f"{len(self.mismatched)} shape mismatches: " + ", ".join(
                f"{k} {self.mismatched[k][0]} vs model {self.mismatched[k][1]}"
                for k in shown) + more)
        return out

    def assert_complete(self, name: str = "checkpoint",
                        orphans: bool = True) -> "CheckpointReport":
        """Raise naming what is wrong; orphans=False tolerates orphan keys
        (a non-strict load), never missing or misshapen ones."""
        problems = self.problems(orphans)
        if problems:
            raise ConversionAccountingError(
                f"[{name}] incomplete load:\n  " + "\n  ".join(problems))
        return self


def account_checkpoint(model: nn.Module, sd: Mapping,
                       ignore: Sequence[str] = ()) -> CheckpointReport:
    """Account every key of `sd` (name -> tensor) against model.state_dict()
    (shapes only: a model on the meta device will do). A key the model does
    not hold is ignored if SD_KNOWN_UNUSED or one of the `ignore` patterns
    (fullmatch against the whole key) names it, else it is an orphan."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    have = set(sd)
    unread = have - set(want)
    extra = [re.compile(p) for p in ignore]
    ignored = {k for k in unread
               if known_unused(k) or any(p.fullmatch(k) for p in extra)}
    present = have & set(want)
    mismatched = {k: (tuple(sd[k].shape), want[k]) for k in present
                  if not proj_weight_fits(k, sd[k].shape, want[k])}
    return CheckpointReport(consumed=present - set(mismatched), ignored=ignored,
                            orphans=unread - ignored, missing=set(want) - have,
                            mismatched=mismatched)


@torch.no_grad()
def copy_checkpoint_(model: nn.Module, sd: Mapping) -> None:
    """Copy every parameter and buffer of the model from `sd` (accounted for
    first), in the model's dtype, a Linear-stored projection as its 1x1
    conv."""
    for name, t in model.state_dict().items():
        t.copy_(sd[name].reshape(t.shape))


def load_strict(module: nn.Module, sd: Mapping, tag: str,
                ignore: Sequence[str] = ()) -> CheckpointReport:
    """An annotator's state dict (its own names, no prefix) into `module`:
    every key accounted for first (`ignore`: the patterns of documented
    leftovers; any other extra key, a missing key or a wrong shape raises
    ConversionAccountingError), then load_state_dict(strict=True) of the
    consumed keys."""
    report = account_checkpoint(module, sd, ignore).assert_complete(tag)
    module.load_state_dict({k: sd[k] for k in report.consumed}, strict=True)
    return report
