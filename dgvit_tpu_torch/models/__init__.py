from dgvit_tpu_torch.models.got import GoT, patchify_2d, patchify_channels
from dgvit_tpu_torch.models.jax_io import params_from_jax
from dgvit_tpu_torch.models.policies import GoTPolicy, build_actor

__all__ = ["GoT", "GoTPolicy", "build_actor", "params_from_jax",
           "patchify_2d", "patchify_channels"]
