"""Recorded demonstrations: the npz corpus layout of the reference
(obs (N, 128, 160[, 4]), act (N, 2), goal (N, 4), reward, next_obs,
next_goal, done; demonstration.py:237-245).

Counterpart of `dgvit_tpu/envs/replay_env.py`'s `load_demo_npz`, which
the trainer's expert buffer reads. The env over logged transitions
(`ReplayEnv`, `--env replay`) is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

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
