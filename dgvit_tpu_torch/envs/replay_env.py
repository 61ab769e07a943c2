"""Recorded demonstrations: the npz corpus layout of the reference
(obs (N, 128, 160[, 4]), act (N, 2), goal (N, 4), reward, next_obs,
next_goal, done; demonstration.py:237-245), and the env over them.

Counterpart of `dgvit_tpu/envs/replay_env.py`: `load_demo_npz`, which the
trainer's expert buffer and the offline trainer read, and `ReplayEnv`,
which steps through logged transitions (`--env replay`): the caller's
action is recorded (`divergence`, the largest |taken - logged| of each
step) but does not move the trajectory. It is the Gazebo-free backbone of
the integration tests and the offline loop.
"""

from __future__ import annotations

import glob
from typing import List, Optional, Sequence

import numpy as np

from dgvit_tpu_torch.envs.base import ResetResult, StepResult

DEMO_FIELDS = ("obs", "act", "goal", "reward", "next_obs", "next_goal",
               "done")


def load_demo_npz(paths: Sequence[str]) -> dict:
    """Concatenate demo npz files in the order given (main.py:232-256).
    Some recordings carry a field shorter than their obs (truncated reward
    arrays): it is np.resize'd to the obs count, as the consumer would
    broadcast it."""
    out = {k: [] for k in DEMO_FIELDS}
    for p in paths:
        d = np.load(p)
        n = d["obs"].shape[0]
        for k in DEMO_FIELDS:
            a = np.asarray(d[k])
            if a.shape[0] != n:
                a = np.resize(a, (n,) + a.shape[1:])
            out[k].append(a)
    return {k: np.concatenate(v, axis=0) for k, v in out.items()}


class ReplayEnv:
    """The Env protocol over logged transitions; episodes end where `done`
    is set, and `reset` past the last transition starts the data again.

    data: a dict of the demo fields (or `glob_pattern`: the files matching
    it, sorted, through `load_demo_npz`). channel: the channel a (H, W, C)
    frame keeps (None keeps them all); states come back (H, W, 1) or
    (H, W, C) in fp32. A reward array shorter than the data reads 0.0 past
    its end; `target` is done with a positive reward; `collision` stays 0
    (the attribute the drivers read)."""

    def __init__(self, data: Optional[dict] = None,
                 glob_pattern: Optional[str] = None,
                 channel: Optional[int] = 0):
        if data is None:
            if glob_pattern is None:
                raise ValueError("ReplayEnv needs data or a glob_pattern")
            files = sorted(glob.glob(glob_pattern))
            if not files:
                raise FileNotFoundError(glob_pattern)
            data = load_demo_npz(files)
        self.data = data
        self.n = data["obs"].shape[0]
        self.channel = channel
        self._t = 0
        self.divergence: List[float] = []
        self.collision = 0

    def _obs(self, i: int, key: str) -> np.ndarray:
        o = self.data[key][i]
        if o.ndim == 3 and self.channel is not None:
            o = o[..., self.channel]
        if o.ndim == 2:
            o = o[..., None]
        return o.astype(np.float32)

    def reset(self) -> ResetResult:
        if self._t >= self.n:
            self._t = 0
        return ResetResult(state=self._obs(self._t, "obs"), xR=0.0, yR=0.0,
                           to_goal=self.data["goal"][self._t].astype(
                               np.float32))

    def step(self, action, t: int) -> StepResult:
        i = min(self._t, self.n - 1)
        self.divergence.append(float(np.abs(
            np.asarray(action) - self.data["act"][i]).max()))
        rew = self.data["reward"]
        reward = float(rew[i]) if i < len(rew) else 0.0
        done = bool(self.data["done"][i])
        self._t += 1
        return StepResult(state=self._obs(i, "next_obs"), reward=reward,
                          done=done,
                          to_goal=self.data["next_goal"][i].astype(
                              np.float32),
                          target=done and reward > 0)

    def stop(self) -> None:
        pass
