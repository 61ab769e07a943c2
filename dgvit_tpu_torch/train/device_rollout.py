"""One evaluation episode with the policy on the card and the env on the
host behind a callback.

Counterpart of `dgvit_tpu/train/device_rollout.py`. JAX runs the whole
episode as one jitted `lax.scan` whose body calls the env through an
ordered `io_callback`. The port runs one step on the card and then one
host callback, and repeats: each step the observation, the goal and the
ended flag go up through pinned staging buffers (`HostStager`), the
actor's action is taken through the whole-trunk kernel (K1, via
`SACAgent.act_batch`), then clipped to [-1, 1], scaled to the command
a_in = [(a0 + 1) * l_scale, a1 * a_scale] and frozen to zero once the
episode has ended, all on the card; the host waits once a step, for a_in
(and the action beside it), and steps the env with it.

JAX's scan semantics are kept, quirks included:
  * the env is stepped on every one of `max_steps` steps, with zero
    commands after the episode is done (a fixed-length scan);
  * every `env.step` gets t = 0;
  * reward and target are zeroed after the end; `dones` is 1 from the
    first done on;
  * steps = sum(dones == 0) + min(sum(dones > 0), 1).
So an env that counts collisions on its own (`KinematicNavEnv.collision`)
keeps counting while a collided robot sits through the frozen steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dgvit_tpu_torch.core.rng import generator
from dgvit_tpu_torch.envs.base import Env
from dgvit_tpu_torch.replay.staging import HostStager


class RolloutResult(NamedTuple):
    """One episode, as host (CPU) tensors."""

    rewards: torch.Tensor   # (T,)
    dones: torch.Tensor     # (T,) 1.0 from the episode's end on
    actions: torch.Tensor   # (T, A) the clipped policy actions (pre-scaling)
    steps: torch.Tensor     # scalar int32: the valid step count
    targets: torch.Tensor   # (T,) 1.0 on the step the goal was reached


def _frame(state: np.ndarray) -> np.ndarray:
    return state[..., 0] if state.ndim == 3 else state


def device_rollout(agent, state, env: Env, max_steps: int,
                   l_scale: float, a_scale: float, seed: int = 0,
                   evaluate: bool = True,
                   stager: Optional[HostStager] = None) -> RolloutResult:
    """Run one episode of `state.actor` on `env` (see the module
    docstring). A stochastic action (evaluate=False) draws its noise
    from a generator seeded `seed` on the agent's device. `stager`: the
    staging buffers to reuse across episodes (one is made when None)."""
    dev = agent.device
    gen = generator(seed, dev)
    stager = stager or HostStager(dev)
    r = env.reset()
    obs = _frame(r.state).astype(np.float32)
    goal = np.asarray(r.to_goal, np.float32)
    ended = np.zeros(1, np.float32)
    rews, dones, targets, acts = [], [], [], []
    for _ in range(max_steps):
        d, _ = stager.put({"obs": obs[None], "goal": goal[None],
                           "ended": ended})
        a = agent.act_batch(state.actor, d["obs"], d["goal"][:, :2], gen,
                            evaluate)[0].float()
        a = torch.clamp(a, -1.0, 1.0)
        a_in = torch.stack([(a[0] + 1.0) * l_scale, a[1] * a_scale])
        # freeze commands once the episode has ended
        a_in = torch.where(d["ended"] > 0, torch.zeros_like(a_in), a_in)
        host = torch.cat([a_in, a]).cpu().numpy()   # the step's host wait
        s = env.step([float(host[0]), float(host[1])], 0)
        done = np.float32(1.0 if s.done else 0.0)
        gone = ended[0] > 0
        rews.append(np.float32(0.0) if gone else np.float32(s.reward))
        targets.append(np.float32(0.0) if gone
                       else np.float32(1.0 if s.target else 0.0))
        ended = np.maximum(ended, done)
        dones.append(ended[0])
        acts.append(host[2:])
        obs = _frame(s.state).astype(np.float32)
        goal = np.asarray(s.to_goal, np.float32)
    dones_t = torch.tensor(np.asarray(dones, np.float32))
    steps = (int((dones_t == 0).sum())
             + min(int((dones_t > 0).sum()), 1))
    return RolloutResult(
        rewards=torch.tensor(np.asarray(rews, np.float32)),
        dones=dones_t,
        actions=torch.tensor(np.stack(acts)),
        steps=torch.tensor(steps, dtype=torch.int32),
        targets=torch.tensor(np.asarray(targets, np.float32)))
