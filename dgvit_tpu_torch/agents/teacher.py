"""A frozen trained actor as an action source: the reference's
SAC_teacher (main.py:27-53), counterpart of `dgvit_tpu/agents/teacher.py`.

  * `choose_action(obs, goal)`: single or batched deterministic actions
    in policy units (tanh of the mean), one whole-trunk kernel launch
    (K1) a call on the card;
  * `as_pilot()`: an `(obs, goal, t) -> [policy action]` source and the
    deployment command map, for `train/demo_record.record_episodes`:
    demonstrations of a trained policy (teacher corpora for BC and for
    the expert-guided trainer; `tools/record_teacher_demos.py`).

The teacher acts in the config's compute dtype, as the JAX teacher does
(its `make_action_fn` with no dtype): fp32 under `Config()`.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.serve.export import make_action_fn


class SACTeacher:
    """Load `<directory>/<filename>_actor.npz` (the save_params_npz layout
    of either package) and act with the deterministic deployment policy.
    dtype: None for the config's compute dtype, else a torch dtype or its
    name. Runs on the card unless device='cpu'."""

    def __init__(self, cfg, filename: str, directory: str = ".",
                 dtype: Optional[Union[str, torch.dtype]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        if dtype is None:
            dtype = cfg.model.compute_dtype
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self.params = ckpt.load_params_npz(
            os.path.join(directory, f"{filename}_actor.npz"))
        self._act = make_action_fn(cfg, self.params, dtype=dtype,
                                   device=device)

    def choose_action(self, obs, goal) -> np.ndarray:
        """Deterministic policy-unit action; obs (H, W) or (B, H, W)."""
        obs = np.asarray(obs, np.float32)
        goal = np.asarray(goal, np.float32)
        single = goal.ndim == 1
        if single:
            obs, goal = obs[None], goal[None]
        a = self._act(obs, goal[:, :2])
        return a[0] if single else a

    def as_pilot(self):
        """(action_source, action_to_env) pair for record_episodes: the
        teacher records policy-unit actions while the env receives command
        units (main.py:320,370 map)."""
        e = self.cfg.env

        def source(obs, goal, t):
            o = obs[..., 0] if obs.ndim == 3 and obs.shape[-1] == 1 else obs
            a = self.choose_action(o, np.asarray(goal)[:2])
            return np.clip(a, -e.max_action, e.max_action)

        def to_env(a):
            return [(a[0] + 1.0) * e.linear_cmd_scale,
                    a[1] * e.angular_cmd_scale]

        return source, to_env
