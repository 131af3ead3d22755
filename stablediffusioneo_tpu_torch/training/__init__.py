"""Training subsystem of the port (counterpart of
stablediffusioneo_tpu/training/): ControlNet fine-tuning on one card.

The reference's (vendored, upstream-ControlNet) training hooks:
`ControlLDM.configure_optimizers` (AdamW over the ControlNet's parameters,
cldm/cldm.py:416-423), the DDPM eps-prediction loss of the missing
ldm.models.diffusion.ddpm, `LitEma` (ldm/modules/ema.py:5-76) and the
`ImageLogger` callback (cldm/logger.py:11-77); the LoRA adapters
(lora.py), the data loader (data.py) and the loop (loop.py). The exports
are the JAX package's.
"""

from stablediffusioneo_tpu_torch.training.trainer import (
    TrainState,
    create_train_state,
    train_step,
    diffusion_loss,
)
from stablediffusioneo_tpu_torch.training.ema import ema_init, ema_update
from stablediffusioneo_tpu_torch.training.lora import (
    init_lora,
    load_lora,
    lora_sites,
    lora_train_step,
    merge_lora,
    save_lora,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "train_step",
    "diffusion_loss",
    "ema_init",
    "ema_update",
    "init_lora",
    "lora_sites",
    "lora_train_step",
    "merge_lora",
    "save_lora",
    "load_lora",
]
