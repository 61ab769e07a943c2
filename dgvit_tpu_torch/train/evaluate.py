"""Evaluation entry point: testing.py:40-158 of the reference. Load a trained
actor, run N deterministic episodes, report success rate, collisions and
durations, append results/testing_data.txt.

Counterpart of `dgvit_tpu/train/evaluate.py::run_eval`, the host loop: a
reference-shaped Python loop with one actor forward per step (the
whole-trunk kernel on the card). The vectorized, fleet and on-device
rollout loops of the JAX package are not ported yet.

Goal-reach durations are reported in simulated seconds (steps * env.DT),
not wall-clock.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Mapping, Optional, Union

import torch

from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.envs import Env, KinematicNavEnv
from dgvit_tpu_torch.models.jax_io import params_to_jax
from dgvit_tpu_torch.serve import make_action_fn
from dgvit_tpu_torch.train.train_rl import FrameStacker, _squeeze_obs
from dgvit_tpu_torch.utils import MetricsLogger


def _maybe_stacker(cfg: Config) -> Optional[FrameStacker]:
    """Channels-mode actors consume (C, H, W) observations; single-frame
    envs feed them through an online FrameStacker."""
    if cfg.model.patch_mode == "channels":
        return FrameStacker(cfg.env.frame_stack)
    return None


def run_eval(cfg: Config, env: Env, actor_params: Mapping[str, Any],
             max_episodes: int = 100, out_dir: str = "results",
             name: str = "model",
             device: Optional[Union[str, torch.device]] = None) -> dict:
    """The evaluation protocol on `env` with the actor of `actor_params`
    (the JAX package's parameter tree, nested or flat as `load_params_npz`
    returns it), in the config's compute dtype. Runs on the card unless
    device='cpu'."""
    e = cfg.env
    dt = float(getattr(env, "DT", 0.1))  # sim-time per step (env_lab.py:204)
    # a reused env carries its previous run's collision count
    if hasattr(env, "collision"):
        env.collision = 0
    dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
             else torch.float32)
    act = make_action_fn(cfg, actor_params, dtype=dtype, device=device)
    stacker = _maybe_stacker(cfg)

    cntr2 = 0
    total_rel = max_episodes
    durations = []
    for ep in range(max_episodes):
        r = env.reset()
        obs = _squeeze_obs(r.state)
        if stacker:
            obs = stacker.reset(obs)
        goal = r.to_goal
        for timestep in range(e.max_steps):
            a = act(obs[None], goal[None, :2])[0]
            a = a.clip(-e.max_action, e.max_action)
            a_in = [(a[0] + 1) * e.linear_cmd_scale,
                    a[1] * e.angular_cmd_scale]
            s = env.step(a_in, timestep)
            obs = _squeeze_obs(s.state)
            if stacker:
                obs = stacker.push(obs)
            goal = s.to_goal
            if timestep == 0 and s.done:
                total_rel -= 1  # Bad initialization (testing.py:117-121)
                break
            if s.target:
                cntr2 += 1
                durations.append((timestep + 1) * dt)
            if s.done or timestep == e.max_steps - 1:
                break

    return _report(cfg, env, cntr2, total_rel, durations, out_dir, name)


def _report(cfg: Config, env: Env, cntr2: int, total_rel: int, durations,
            out_dir: str, name: str) -> dict:
    s_r = cntr2 / max(total_rel, 1)
    logger = MetricsLogger(out_dir, "testing")
    logger.append_txt(
        "testing_data.txt",
        "\n" + "-" * 40 + "/*/*/*/*/*/*/" + "-" * 40 + "\n"
        f"Model = {name} Sensor = {cfg.env.vis_sensor}\n"
        f"Number total of success : {cntr2} with percentage : "
        f"{s_r * 100:.1f} %\n")
    return {"successes": cntr2, "success_rate": s_r,
            "collisions": getattr(env, "collision", 0),
            "durations": durations}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="dgvit_tpu_torch evaluation (PyTorch/CUDA)")
    p.add_argument("--actor", default=None,
                   help="actor params npz (save_params_npz output of either "
                        "package)")
    p.add_argument("--checkpoint", default=None,
                   help="full train-state checkpoint of the port's trainer: "
                        "a step_N directory or a checkpoints/ dir (the "
                        "newest step is used)")
    p.add_argument("--config", default=None)
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--out", default="results")
    p.add_argument("--world", default="rrc",
                   help="kinematic world preset (rrc | hospital); "
                        "'hospital' is the unseen-layout generalization "
                        "eval")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)
    if bool(args.actor) == bool(args.checkpoint):
        p.error("exactly one of --actor / --checkpoint is required")

    cfg = Config.from_yaml(args.config) if args.config else Config()
    env = KinematicNavEnv(seed=cfg.train.seed,
                          image_hw=tuple(cfg.model.image_size),
                          world=args.world)
    if args.checkpoint:
        path = args.checkpoint
        if not os.path.basename(os.path.normpath(path)).startswith("step_"):
            path = ckpt.latest_checkpoint(path)
            if path is None:
                p.error(f"no step_* checkpoints under {args.checkpoint}")
        state = ckpt.restore_train_state(
            path, SACAgent(cfg, device="cpu").init_state(cfg.train.seed))
        params = params_to_jax(state.actor.state_dict())
        name = os.path.basename(path)
    else:
        params = ckpt.load_params_npz(args.actor)
        name = os.path.basename(args.actor)
    out = run_eval(cfg, env, params, args.episodes, args.out, name,
                   device=args.device)
    print(f"success rate: {out['success_rate'] * 100:.1f}% "
          f"({out['successes']} goals), collisions: {out['collisions']}")


if __name__ == "__main__":
    main()
