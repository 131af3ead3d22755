"""The parallel layer (counterpart of stablediffusioneo_tpu/parallel/): the
mesh over torch.distributed with its collectives and sharding rules
(mesh.py: dp, tp, sp, FSDP) and the GPipe schedule over a pp axis
(pipeline.py). The JAX package lets GSPMD insert the collectives of a
one-controller program; the port is one process a rank and writes every
collective out (mesh.py's docstring). pp serves the conditioner towers
(models/clip.py:clip_text_apply_pp, models/t5.py:t5_encode_pp), never the
UNet, as in the JAX package.
"""

from stablediffusioneo_tpu_torch.parallel.mesh import (
    data_sharding,
    fsdp_param_sharding_rules,
    fsdp_shard_params,
    latent_sharding,
    make_mesh,
    replicate,
    shard_params,
    unet_param_sharding_rules,
)
from stablediffusioneo_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pp_shard_params,
    pp_stage_sharding,
    stack_layer_params,
    unstack_layer_params,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "latent_sharding",
    "replicate",
    "unet_param_sharding_rules",
    "shard_params",
    "fsdp_param_sharding_rules",
    "fsdp_shard_params",
    "pipeline_apply",
    "pp_shard_params",
    "pp_stage_sharding",
    "stack_layer_params",
    "unstack_layer_params",
]
