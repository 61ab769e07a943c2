"""Offline SAC from logged transitions: the Gazebo-free end-to-end train
loop (BASELINE.json's fifth config: replay sample -> augment -> SAC update
on logged demo trajectories).

Counterpart of `dgvit_tpu/train/train_offline.py`. The demos fill the C++
sum-tree buffer (`fill_buffer_from_demos`); a `BatchPrefetcher` thread
samples the next batches and stages them on the device while the update
runs; every update is the agent's `learn` (K4 for the no-grad forwards,
K2/K3 for the gradient passes on the card), or `learn_per` with
`sac.prioritized_replay`, each followed by `update_priorities(|td| +
1e-6)`.

`augment_sigma` > 0 adds sigma / 255 x N(0, 1) to the batch's obs (not
next_obs) and clips to [0, 1] before a plain update (PER is off then, as
in the JAX loop). The noise comes from a generator of its own on the
device, reseeded every step from the step (`augment_key`, as JAX folds
the step into its key), so the update's dropout masks and action noise
are those of the same run without it, and a resumed run draws the noise
of the run without the break.

`checkpointer`: any object with `resume(state) -> (state, step)` and
`maybe_save(step, state)` (`core/elastic.ElasticCheckpointer`, the JAX
package's contract): the loop starts at the step `resume` returns and
offers the state after every update.

    python -m dgvit_tpu_torch.train.train_offline --data-glob 'demos/*.npz' \
        [--steps 1000] [--augment-sigma 0] [--out results] [--save] \
        [--config cfg.yaml] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import time
from typing import Optional, Union

import numpy as np
import torch

from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.rng import generator, step_key
from dgvit_tpu_torch.envs.replay_env import load_demo_npz
from dgvit_tpu_torch.replay import (BatchPrefetcher, PrioritizedReplayBuffer,
                                    reference_schema)
from dgvit_tpu_torch.utils import MetricsLogger

AUGMENT_STREAM = 7777   # step_key tag of the obs noise's stream


def augment_key(seed: int, step: int) -> int:
    """The seed of the obs noise at update `step` of a run seeded `seed`."""
    return step_key(step_key(seed, AUGMENT_STREAM), step)


def fill_buffer_from_demos(pattern_or_data, cfg: Config
                           ) -> PrioritizedReplayBuffer:
    """A sum-tree buffer of max(sac.buffer_size, N) rows, seeded
    train.seed, holding the N transitions of a demo dict or of the npz
    files matching a glob (sorted): channel 0 of (N, H, W, C) frames, the
    goal's first two values as pobs, the reward np.resize'd to N, engage
    0."""
    s = cfg.sac
    if isinstance(pattern_or_data, dict):
        data = pattern_or_data
    else:
        files = sorted(glob.glob(pattern_or_data))
        if not files:
            raise FileNotFoundError(pattern_or_data)
        data = load_demo_npz(files)
    frames = lambda a: a[..., 0] if a.ndim == 4 else a
    obs, nxt = frames(data["obs"]), frames(data["next_obs"])
    n = obs.shape[0]
    buf = PrioritizedReplayBuffer(
        max(s.buffer_size, n),
        reference_schema(tuple(cfg.model.image_size), s.action_dim,
                         s.pstate_dim),
        seed=cfg.train.seed)
    buf.add(obs=obs, act=data["act"], pobs=data["goal"][:, :2],
            next_pobs=data["next_goal"][:, :2],
            rew=np.resize(data["reward"], (n,)), next_obs=nxt,
            engage=np.zeros(n, np.float32),
            done=data["done"].astype(np.float32))
    return buf


def augment_obs(batch: dict, sigma: float, gen: torch.Generator) -> dict:
    """The batch with sigma / 255 x N(0, 1) added to obs (drawn from
    `gen`) and clipped to [0, 1]."""
    obs = batch["obs"]
    noise = torch.randn(obs.shape, generator=gen, device=obs.device,
                        dtype=torch.float32)
    return dict(batch, obs=torch.clamp(obs + sigma / 255.0 * noise,
                                       0.0, 1.0))


def train_offline(cfg: Config, buf, steps: int = 1000,
                  out_dir: str = "results", augment_sigma: float = 0.0,
                  prefetch_depth: int = 2, log_every: int = 100,
                  checkpointer=None,
                  device: Optional[Union[str, torch.device]] = None):
    """`steps` updates on batches of `buf`, on the card unless
    device='cpu'. Returns (state, {'steps_per_sec': updates run here over
    their wall time, 'final': the last update's metrics as floats}).
    Every `log_every` updates the metrics and the rate so far go to
    out_dir/offline.jsonl."""
    t = cfg.train
    agent = SACAgent(cfg, device=device, seed=t.seed)
    state = agent.init_state(t.seed)
    start_step = 0
    if checkpointer is not None:
        state, start_step = checkpointer.resume(state)
    logger = MetricsLogger(out_dir, "offline")
    b = cfg.sac.batch_size
    aug_gen = (generator(0, agent.device) if augment_sigma > 0.0
               else None)
    use_per = bool(cfg.sac.prioritized_replay) and buf.prioritized \
        and augment_sigma == 0.0
    pf = BatchPrefetcher(lambda: buf.sample(b), depth=prefetch_depth,
                         device=agent.device)
    t0 = time.time()
    metrics = {}
    try:
        for step in range(start_step, steps):
            batch = next(pf)
            if use_per:
                idx = batch.pop("indexes").cpu().numpy()
                w = batch.pop("weights")
                state, metrics, td = agent.learn_per(state, batch, w)
                buf.update_priorities(
                    idx, np.abs(td.float().cpu().numpy()) + 1e-6)
            else:
                batch.pop("weights", None)
                batch.pop("indexes", None)
                if aug_gen is not None:
                    aug_gen.manual_seed(augment_key(t.seed, step))
                    batch = augment_obs(batch, augment_sigma, aug_gen)
                state, metrics = agent.learn(state, batch)
            if checkpointer is not None:
                checkpointer.maybe_save(step + 1, state)
            if (step + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = (step + 1 - start_step) / (
                    time.time() - t0)
                logger.log(step + 1, **m)
    finally:
        pf.close()
    final = {k: float(v) for k, v in metrics.items()}   # waits for the card
    wall = time.time() - t0
    return state, {"steps_per_sec": (steps - start_step) / wall,
                   "final": final}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="offline SAC from logged demos (PyTorch/CUDA)")
    p.add_argument("--data-glob", required=True)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--augment-sigma", type=float, default=0.0)
    p.add_argument("--out", default="results")
    p.add_argument("--save", action="store_true",
                   help="write the final train state to OUT/checkpoints")
    p.add_argument("--config", default=None, help="structured YAML config")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)

    cfg = Config.from_yaml(args.config) if args.config else Config()
    buf = fill_buffer_from_demos(args.data_glob, cfg)
    state, stats = train_offline(cfg, buf, args.steps, args.out,
                                 args.augment_sigma, device=args.device)
    if args.save:
        ckpt.save_train_state(f"{args.out}/checkpoints", args.steps, state)
    print(f"{stats['steps_per_sec']:.1f} updates/s; final metrics "
          f"{stats['final']}")
    return stats


if __name__ == "__main__":
    main()
