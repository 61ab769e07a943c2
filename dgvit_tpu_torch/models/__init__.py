from dgvit_tpu_torch.models.got import GoT, patchify_2d, patchify_channels
from dgvit_tpu_torch.models.jax_io import params_from_jax, params_to_jax
from dgvit_tpu_torch.models.policies import (GoTPolicy, GoTQNetwork,
                                             build_actor, build_critic)
from dgvit_tpu_torch.models.simple_vit import SimpleViT

__all__ = ["GoT", "GoTPolicy", "GoTQNetwork", "SimpleViT", "build_actor",
           "build_critic", "params_from_jax", "params_to_jax",
           "patchify_2d", "patchify_channels"]
