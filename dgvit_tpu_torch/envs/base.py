"""Env protocol — the reset/step contract of the reference GazeboEnv
(env_lab.py:190,303) as a typed interface.

reset() -> (state, xR, yR, toGoal)
step(action, t) -> (state, reward, done, toGoal, target)

state: (H, W, 1) float in [0, 1] (resized, scaled observation)
toGoal: np.array([dist_norm, heading_norm, act0, act1]) (env_lab.py:298)

An Env is host code: the training and evaluation loops move states and
actions across the host boundary.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, Sequence, Tuple

import numpy as np


class ResetResult(NamedTuple):
    state: np.ndarray
    xR: float
    yR: float
    to_goal: np.ndarray


class StepResult(NamedTuple):
    state: np.ndarray
    reward: float
    done: bool
    to_goal: np.ndarray
    target: bool


class Env(Protocol):
    def reset(self) -> ResetResult: ...

    def step(self, action: Sequence[float], t: int) -> StepResult: ...

    def stop(self) -> None: ...
