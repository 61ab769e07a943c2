"""Demonstration recorder: demonstration.py:122-291 of the reference.

Counterpart of `dgvit_tpu/train/demo_record.py`. Collects teleop (or
scripted-pilot) transitions per episode and saves npz files with the
reference's key layout obs/act/goal/reward/next_obs/next_goal/done
(demonstration.py:237-245), with its filtering quirks: zero-action frames
skipped (:269-270), (H, W, 1) -> (H, W) squeeze (:271-274), and the
shape-mismatch guard (:279-283). The trainer's expert buffer
(`train_rl.train(..., expert_glob=...)`) reads them.

    python -m dgvit_tpu_torch.train.demo_record --out Data --episodes 5
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

import numpy as np

from dgvit_tpu_torch.envs import Env, KinematicNavEnv


def record_episodes(env: Env, action_source: Callable[
        [np.ndarray, np.ndarray, int], Sequence[float]],
                    out_dir: str, env_name: str = "RRC",
                    driver: str = "torch", episodes: int = 5,
                    max_steps: int = 800, start_index: int = 0,
                    action_to_env: Optional[Callable] = None) -> list:
    """Record `episodes` episodes of `action_source(obs, goal, t) ->
    [linear, angular]` into out_dir/env_name/driver/demo_<env_name>_<i>.npz
    and return the paths written (an episode with no kept frame writes
    none).

    `action_to_env` maps the recorded action to the env command. The
    reference records raw teleop commands while its RL driver stores
    pre-scaling policy actions and deploys a_in = [(a0 + 1) L_SCALE,
    a1 A_SCALE]: pass that mapping to record deployment-consistent
    (policy-unit) actions."""
    dest = os.path.join(out_dir, env_name, driver)
    os.makedirs(dest, exist_ok=True)
    written = []
    for ep in range(episodes):
        obs_l, act_l, goal_l, rew_l, nobs_l, ngoal_l, done_l = (
            [] for _ in range(7))
        r = env.reset()
        obs, goal = r.state, r.to_goal
        for t in range(max_steps):
            action = np.asarray(action_source(obs, goal, t), np.float32)
            cmd = action if action_to_env is None else \
                np.asarray(action_to_env(action), np.float32)
            s = env.step(cmd, t)
            # zero actions are not recorded (demonstration.py:269-270)
            if not np.allclose(action, 0.0):
                o = obs.squeeze(-1) if obs.ndim == 3 and obs.shape[-1] == 1 \
                    else obs
                no = (s.state.squeeze(-1) if s.state.ndim == 3
                      and s.state.shape[-1] == 1 else s.state)
                if o.shape == no.shape:  # mismatch guard (:279-283)
                    obs_l.append(o)
                    act_l.append(action)
                    goal_l.append(goal)
                    rew_l.append(s.reward)
                    nobs_l.append(no)
                    ngoal_l.append(s.to_goal)
                    done_l.append(s.done)
            obs, goal = s.state, s.to_goal
            if s.done:
                break
        if not obs_l:
            continue
        path = os.path.join(dest, f"demo_{env_name}_{start_index + ep}.npz")
        np.savez_compressed(
            path,
            obs=np.stack(obs_l).astype(np.float32),
            act=np.stack(act_l).astype(np.float32),
            goal=np.stack(goal_l).astype(np.float32),
            reward=np.asarray(rew_l, np.float32),
            next_obs=np.stack(nobs_l).astype(np.float32),
            next_goal=np.stack(ngoal_l).astype(np.float32),
            done=np.asarray(done_l, bool),
        )
        written.append(path)
    return written


def scripted_pilot(obs, goal, t):
    """A goal-seeking pilot for synthetic demos: steer toward the goal
    bearing, slow down when misaligned."""
    heading = float(goal[1])  # normalised bearing
    w = np.clip(2.0 * heading, -0.6, 0.6)
    v = float(np.clip(0.5 * (1.0 - abs(heading)), 0.05, 0.5))
    return [v, w]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="dgvit_tpu_torch demonstration recorder")
    p.add_argument("--out", default="Data")
    p.add_argument("--env-name", default="RRC")
    p.add_argument("--driver", default="torch")
    p.add_argument("--episodes", type=int, default=5)
    p.add_argument("--teleop", action="store_true",
                   help="read actions from the keyboard (not ported yet)")
    args = p.parse_args(argv)
    if args.teleop:
        raise NotImplementedError(
            "--teleop: the keyboard teleop (train/keyboard_control.py) is "
            "not ported yet; the scripted pilot records without it")
    paths = record_episodes(KinematicNavEnv(), scripted_pilot, args.out,
                            args.env_name, args.driver, args.episodes)
    print(f"wrote {len(paths)} episodes -> {paths}")


if __name__ == "__main__":
    main()
