"""The deterministic deployment map act(obs, goal) -> action.

Counterpart of `dgvit_tpu/serve/export.py::make_action_fn` in its live
serving form: the GoT actor's trunk runs as the whole-trunk CUDA kernel,
parameters are kept in fp32 and the compute dtype is bf16 by default.

    act(obs[b, ...], goal[b, 2]) -> action[b, 2]

returns tanh(mean) (the evaluate=True branch of the Gaussian actor) and,
with env_units=True, clips it and scales it to robot commands
a_in = [(a0 + 1) * L_SCALE, a1 * A_SCALE]. The StableHLO artifact export
of the JAX package has no counterpart here yet.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.models.jax_io import params_from_jax
from dgvit_tpu_torch.models.policies import build_actor


def make_action_fn(cfg, params: Mapping[str, Any], env_units: bool = False,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[Union[str, torch.device]] = None):
    """Numpy-out act(obs, goal), closed over `params` (the JAX package's
    actor parameter tree, nested or flat as `load_params_npz` returns it).
    obs and goal are numpy arrays, or tensors (states that
    `preprocess_depth_auto` left on the card go in without a round trip
    through the host). Runs on CUDA unless device='cpu'; the returned
    action is fp32. The built actor is `act.policy`."""
    dev = resolve_device(device)
    policy = build_actor(cfg, dtype=dtype)
    policy.load_state_dict(params_from_jax(params))
    policy = policy.to(dev).eval()
    e = cfg.env

    @torch.no_grad()
    def act(obs, goal) -> np.ndarray:
        o, g = (x.to(dev, torch.float32) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x, np.float32), device=dev)
                for x in (obs, goal))
        a = torch.tanh(policy(o, g, inference=True)[0])
        if env_units:
            a = torch.clamp(a, -e.max_action, e.max_action)
            a = torch.stack([(a[..., 0] + 1.0) * e.linear_cmd_scale,
                             a[..., 1] * e.angular_cmd_scale], dim=-1)
        return a.float().cpu().numpy()

    act.policy = policy
    return act
