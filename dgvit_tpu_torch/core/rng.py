"""RNG discipline: one root seed, folded per step.

Counterpart of `dgvit_tpu/core/rng.py`. The JAX package threads
`jax.random` keys; the port draws from `torch.Generator`s, so a key here
is a seed (a non-negative int below 2**63) and deriving one is a hash of
integers on the host: `step_key(base, step)` is the counterpart of
`jax.random.fold_in`. A generator for a seed on a device is
`generator(seed, device)`. Runs are reproducible from the root seed, and
a loop that derives each step's seed from its step counter
(`step_key(seed, round)` in `train_fused`, `step_key(seed, chunk)` in
`train_vec`) draws the same stream after a restart. The JAX module's
`RngStream` (a split stream and named folds) has one role in the port:
the fleet trainer's collection noise, a generator seeded
`step_key(train.seed, FLEET_STREAM)` that only the server thread draws
from (`train/train_fleet.py`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers that spreads
    every input bit over the output."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def step_key(base: int, step: int) -> int:
    """The seed for `step` of the stream rooted at seed `base` (the
    counterpart of `jax.random.fold_in(base, step)`)."""
    x = _mix((int(base) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64)
    return _mix(x ^ 0xD1B54A32D192ED03) >> 1


def generator(seed: int,
              device: Optional[Union[str, torch.device]] = None
              ) -> torch.Generator:
    """A `torch.Generator` on `device` (the CPU by default) seeded with
    `seed`."""
    return torch.Generator(device or "cpu").manual_seed(int(seed))
