"""RL training entry point: main.py:130-424 of the reference, on PyTorch and CUDA.

Counterpart of `dgvit_tpu/train/train_rl.py`; the behavioral contract is
the reference's, quirk for quirk:
  * action mapping a_in = [(a0+1)*L_SCALE, a1*A_SCALE] (main.py:320,370)
  * first-step special case + "Bad Initialization" skip (main.py:310-334)
  * rolling-20 mean; evaluation when mean >= reward_threshold and
    ep_real > eval_threshold; save when avg_reward > save_threshold or
    collisions < 6, with metric-encoded names (main.py:345-356)
  * learning starts once the buffer holds batch_size transitions
  * expert demos preloaded into the expert buffer (main.py:223-268); with
    them (train.pre_buffer and an expert glob) every update is the guided
    one (`learn_guidence`), and a human-intervention source stores its
    command in policy units with engage = 1
  * reward curve npy/png every plot_interval (main.py:364-365)
  * final summary appended to results/training_data.txt (main.py:410-417)

The env and the replay buffer are host code; the agent acts and learns on
the card (or on the CPU with device="cpu"): one frame up and one action
down per env step, one batch up per update, through pinned staging
buffers that are reused. Full train-state checkpoints, keyed by the
update counter, let a run resume.

Ported: the plain `learn` flavour with and without `sac.prefetch_batches`,
the guided flavour (`learn_guidence`: the expert buffer and human
intervention), `sac.prioritized_replay` (the C++ buffer's sum-tree PER:
`learn_per`, or `learn_guidence_per` on the guided path, each followed by
`update_priorities(|td| + 1e-6)`; it takes precedence over
`prefetch_batches`, as in the JAX loop), `resume`, `save_replay`,
`if_test`, `pre_train`, the online frame stack, every actor and critic
of the zoo but the `Deterministic` actor (below), head-only fine-tuning
(`train.policy_attention_fix` / `critic_attention_fix`), and
`--reference-config` (the reference's flat config.yaml, translated by
`config.load_reference_yaml`; with it `--config` is not read, as in the
JAX command line). Not ported yet, and raising NotImplementedError by
name rather than running something else: `--env replay|ros2`,
`train_elastic`, the keyboard teleop that `main` starts for
`train.human_intervention` on a terminal, and the `Deterministic`
(4-channel CNN) actor, which `SACAgent` refuses: its (H, W, 4) frame
stacks no env loop builds, and the JAX package's update fails on it.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import time
from typing import Optional, Union

import numpy as np
import torch

from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config, load_reference_yaml
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.envs import Env, KinematicNavEnv
from dgvit_tpu_torch.envs.replay_env import load_demo_npz
from dgvit_tpu_torch.models.jax_io import params_to_jax
from dgvit_tpu_torch.replay import (BatchPrefetcher,
                                    PrioritizedReplayBuffer, ReplayBuffer,
                                    reference_schema)
from dgvit_tpu_torch.replay.staging import HostStager
from dgvit_tpu_torch.utils import MetricsLogger, RewardCurve

LOGGED_METRICS = ("alpha", "alpha_loss", "policy_loss", "qf1_loss",
                  "qf2_loss", "entropy", "skipped_nonfinite")


def natural_key(name: str):
    """Sort key that compares digit runs as numbers ('2.npz' before
    '10.npz'), as natsort orders the reference's demo files."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def load_expert_dataset(pattern: str):
    """main.py:223-268: the demo npz files matching `pattern`, in natural
    order, concatenated (`load_demo_npz`); None when none match."""
    files = sorted(glob.glob(pattern), key=natural_key)
    if not files:
        return None
    return load_demo_npz(files)


def expert_buffer(cfg: Config, pattern: str, obs_shape, stacked: bool):
    """The expert replay buffer of the demos matching `pattern` and the
    number of transitions it holds, or (None, 0). Demo frames are (N, H,
    W) or (N, H, W, C): with the frame stack, C-channel demos go to (N, C,
    H, W) and single-frame demos are repeated to the stack depth; without
    it, channel 0 of C-channel demos is kept."""
    data = load_expert_dataset(pattern)
    if data is None:
        return None, 0
    s = cfg.sac

    def frames(a):
        if stacked:
            if a.ndim == 4:
                return a.transpose(0, 3, 1, 2)
            return np.repeat(a[:, None], cfg.env.frame_stack, axis=1)
        return a[..., 0] if a.ndim == 4 else a

    obs, nxt = frames(data["obs"]), frames(data["next_obs"])
    n = obs.shape[0]
    # expert demos are sampled uniformly in the reference
    buf = ReplayBuffer(n + 1, reference_schema(
        obs_shape, s.action_dim, s.pstate_dim, expert=True),
        seed=cfg.train.seed)
    buf.add(obs=obs, act_exp=data["act"], pobs=data["goal"][:, :2],
            next_pobs=data["next_goal"][:, :2],
            rew=np.resize(data["reward"], (n,)), next_obs=nxt,
            done=data["done"].astype(np.float32))
    return buf, n


class FrameStacker:
    """Online (C, H, W) frame stacking for model.patch_mode='channels'.
    The reference records 4-channel demos but comments the live
    concatenation out (main.py:66-69,323); env.use_frame_stack=True
    enables it here."""

    def __init__(self, depth: int):
        self.depth = int(depth)
        self._frames = None

    def reset(self, frame: np.ndarray) -> np.ndarray:
        self._frames = [frame] * self.depth
        return np.stack(self._frames)

    def push(self, frame: np.ndarray) -> np.ndarray:
        self._frames = self._frames[1:] + [frame]
        return np.stack(self._frames)


def _maybe_stacker(cfg: Config) -> Optional[FrameStacker]:
    if cfg.env.use_frame_stack:
        if cfg.model.patch_mode != "channels":
            raise ValueError(
                "env.use_frame_stack=True needs model.patch_mode='channels'")
        return FrameStacker(cfg.env.frame_stack)
    return None


def _squeeze_obs(state: np.ndarray) -> np.ndarray:
    return np.squeeze(state, -1) if state.ndim == 3 else state


def evaluate(env: Env, agent: SACAgent, state, max_steps: int,
             l_scale: float, a_scale: float, max_action: float = 1.0,
             eval_episodes: int = 10,
             logger: Optional[MetricsLogger] = None, epoch: int = 0,
             stacker: Optional[FrameStacker] = None):
    """main.py:55-114: N deterministic episodes, mean reward + collisions."""
    env.collision = 0
    ep = 0
    rewards = []
    while ep < eval_episodes:
        count = 0
        r = env.reset()
        state_obs = _squeeze_obs(r.state)
        if stacker:
            state_obs = stacker.reset(state_obs)
        goal = r.to_goal
        avg_reward = 0.0
        done = False
        while not done and count < max_steps:
            a = agent.choose_action_host(state, state_obs, goal[:2],
                                         evaluate=True)
            a = a.clip(-max_action, max_action)
            a_in = [(a[0] + 1) * l_scale, a[1] * a_scale]
            s = env.step(a_in, count)
            if count == 0 and s.done:
                # Bad initialization, skip episode (main.py:329-334)
                ep -= 1
                if not s.target:
                    env.collision -= 1
                break
            avg_reward += s.reward if count > 0 else 0.0
            state_obs = _squeeze_obs(s.state)
            if stacker:
                state_obs = stacker.push(state_obs)
            goal = s.to_goal
            done = s.done
            count += 1
        ep += 1
        rewards.append(avg_reward)
    mean_r = float(np.mean(rewards)) if rewards else 0.0
    col = env.collision
    if logger:
        logger.log(epoch, eval_reward=mean_r, eval_collisions=col)
    return mean_r, col


def train(cfg: Config, env: Env, out_dir: str = "results",
          expert_glob: Optional[str] = None,
          max_episodes: Optional[int] = None, resume: bool = False,
          intervention=None,
          device: Optional[Union[str, torch.device]] = None,
          timings: Optional[dict] = None) -> dict:
    """Train the SAC agent on `env`. Runs on the card unless device='cpu'.

    `expert_glob`, with train.pre_buffer: demo npz files
    (`train/demo_record.py`) loaded into an expert buffer; every update is
    then the guided one. `intervention`: a human-in-the-loop source with
    `.engaged` and `.read_action() -> [linear, angular]`; while engaged
    its command overrides the policy's and is stored in policy units with
    engage = 1, and with train.human_intervention the updates are guided
    (an all-masked expert batch when there is no expert buffer).
    With sac.prioritized_replay the agent's buffer is the sum-tree one:
    each update takes its importance weights, and its |TD error| + 1e-6
    goes back as the sampled rows' priorities.
    `timings`, when given, collects the host-clock seconds (synchronised)
    of each part of the loop under 'env', 'act', 'sample' (sampling and
    the copy to the device) and 'learn', with 'env_steps' and 'updates'
    counted beside them."""
    t = cfg.train
    e = cfg.env
    s = cfg.sac
    agent = SACAgent(cfg, device=device, seed=t.seed)
    state = agent.init_state(t.seed)
    on_card = agent.device.type == "cuda"

    # PRE_TRAIN: warm-start the actor from an IL checkpoint (main.py:272-274)
    if t.pre_train and not t.if_test and t.pre_train_model:
        d, f = os.path.split(t.pre_train_model)
        state = agent.load(state, f, d or ".", actor_only=True)
    # IF_TEST: load actor+critic and hard-refresh the target (main.py:275-278)
    if t.if_test and t.test_model:
        d, f = os.path.split(t.test_model)
        state = agent.load(state, f, d or ".")
        state = agent.load_target(state)

    ckpt_dir = os.path.join(out_dir, t.checkpoint_dir)
    resumed_replay = None
    if resume:
        latest = ckpt.latest_checkpoint(ckpt_dir)
        if latest:
            state = ckpt.restore_train_state(latest, state)
            # warm-buffer restart: a replay snapshot saved alongside this
            # step (t.save_replay) is reloaded once the buffer exists below
            snap = os.path.join(
                ckpt_dir, f"replay_{os.path.basename(latest)}.npz")
            if os.path.exists(snap):
                resumed_replay = snap

    logger = MetricsLogger(out_dir, f"train_{cfg.model.name}_{t.desc}")
    curve = RewardCurve()

    ih, iw = cfg.model.image_size
    stacker = _maybe_stacker(cfg)
    obs_shape = (e.frame_stack, ih, iw) if stacker else (ih, iw)
    buf_cls = PrioritizedReplayBuffer if s.prioritized_replay else ReplayBuffer
    buf = buf_cls(
        s.buffer_size, reference_schema(obs_shape, s.action_dim, s.pstate_dim),
        seed=t.seed)
    if resumed_replay:
        # with PER the rows come back through add(), at the max priority
        # (cpprb's load_transitions)
        buf.load_transitions(resumed_replay)
    expert_buf, expert_size = (
        expert_buffer(cfg, expert_glob, obs_shape, stacker is not None)
        if t.pre_buffer and expert_glob else (None, 0))
    guided = expert_buf is not None or (t.human_intervention
                                        and intervention is not None)

    max_eps = max_episodes if max_episodes is not None else e.max_episodes
    max_action = e.max_action
    reward_threshold = t.reward_threshold
    save_threshold = t.save_threshold
    cntr2 = 0   # successes
    ep_real = 0
    metrics = {}   # last learn metrics (rides along in the episode log)
    start_time = time.time()
    prefetcher = None
    stager = HostStager(agent.device)
    expert_stager = HostStager(agent.device)
    if timings is not None:
        timings.update({k: 0.0 for k in ("env", "act", "sample", "learn")},
                       env_steps=0, updates=0)

    def clock(key: str, t0: float, sync: bool = False) -> None:
        if timings is not None:
            if sync and on_card:
                torch.cuda.synchronize(agent.device)
            timings[key] += time.perf_counter() - t0

    def _plain_sample():
        d = buf.sample(s.batch_size)
        d.pop("engage", None)
        return d

    def _guided_sample():
        """(agent batch, expert batch with its actions as 'act', valid
        expert rows, PER's importance weights and indexes or None); without
        an expert buffer (intervention only) an all-masked expert batch of
        zeros."""
        ab = buf.sample(s.batch_size)
        w, idx = ab.pop("weights", None), ab.pop("indexes", None)
        if expert_buf is not None:
            k = agent.expert_batch_size(expert_size, buf.get_stored_size(),
                                        s.batch_size)
            eb = expert_buf.sample(s.batch_size)
            eb["act"] = eb.pop("act_exp")
        else:
            k = 0
            eb = {key: np.zeros_like(v) for key, v in ab.items()
                  if key != "engage"}
        return ab, eb, k, w, idx

    def actor_params():
        return params_to_jax(state.actor.state_dict())

    for ep in range(max_eps):
        episode_reward = 0.0
        r = env.reset()
        obs = _squeeze_obs(r.state)
        if stacker:
            obs = stacker.reset(obs)
        goal = r.to_goal
        done = False
        bad_init = False
        for timestep in range(e.max_steps):
            t0 = time.perf_counter()
            a = agent.choose_action_host(state, obs, goal[:2],
                                         evaluate=t.if_test)
            clock("act", t0)
            a = a.clip(-max_action, max_action)
            engage = 0.0
            if intervention is not None and getattr(intervention, "engaged",
                                                    False):
                # human override: run the teleop command and store it in
                # policy units (the inverse of a_in below) with engage = 1
                cmd = intervention.read_action()
                a = np.asarray([cmd[0] / e.linear_cmd_scale - 1.0,
                                cmd[1] / e.angular_cmd_scale],
                               np.float32).clip(-max_action, max_action)
                engage = 1.0
            a_in = [(a[0] + 1) * e.linear_cmd_scale,
                    a[1] * e.angular_cmd_scale]
            last_goal = goal
            t0 = time.perf_counter()
            sres = env.step(a_in, timestep)
            clock("env", t0)
            if timings is not None:
                timings["env_steps"] += 1
            next_obs = _squeeze_obs(sres.state)
            if stacker:
                next_obs = stacker.push(next_obs)
            goal = sres.to_goal
            done = sres.done

            if timestep == 0:
                if done:  # Bad initialization (main.py:329-334)
                    bad_init = True
                    break
                obs = next_obs
                continue

            episode_reward += sres.reward
            if not t.if_test:
                buf.add(obs=obs, act=a, pobs=last_goal[:2],
                        next_pobs=goal[:2], rew=sres.reward,
                        next_obs=next_obs, engage=engage, done=float(done))
                if buf.get_stored_size() >= s.batch_size and guided:
                    t0 = time.perf_counter()
                    ab, eb, k, w, idx = _guided_sample()
                    ab, _ = stager.put(ab)
                    eb, _ = expert_stager.put(eb)
                    clock("sample", t0, sync=True)
                    t0 = time.perf_counter()
                    if s.prioritized_replay:
                        state, metrics, td = agent.learn_guidence_per(
                            state, ab, eb, k, w)
                        buf.update_priorities(
                            idx, np.abs(td.float().cpu().numpy()) + 1e-6)
                    else:
                        state, metrics = agent.learn_guidence(state, ab, eb,
                                                              k)
                    clock("learn", t0, sync=True)
                    if timings is not None:
                        timings["updates"] += 1
                elif buf.get_stored_size() >= s.batch_size:
                    t0 = time.perf_counter()
                    if s.prioritized_replay:
                        d = _plain_sample()
                        w, idx = d.pop("weights"), d.pop("indexes")
                        batch, _ = stager.put(d)
                    elif s.prefetch_batches:
                        # a background thread samples the NEXT batch and
                        # copies it to the device while this step runs
                        if prefetcher is None:
                            prefetcher = BatchPrefetcher(
                                _plain_sample, depth=2, device=agent.device)
                        batch = next(prefetcher)
                    else:
                        batch, _ = stager.put(_plain_sample())
                    clock("sample", t0, sync=True)
                    t0 = time.perf_counter()
                    if s.prioritized_replay:
                        state, metrics, td = agent.learn_per(state, batch, w)
                        # |TD error| + eps as the sampled rows' priorities
                        # (standard PER; the reference stubs it out)
                        buf.update_priorities(
                            idx, np.abs(td.float().cpu().numpy()) + 1e-6)
                    else:
                        state, metrics = agent.learn(state, batch)
                    clock("learn", t0, sync=True)
                    if timings is not None:
                        timings["updates"] += 1
            obs = next_obs
            if sres.target:
                cntr2 += 1
            if done or timestep == e.max_steps - 1:
                break

        if bad_init:
            continue
        ep_real += 1
        mean_r = curve.append(episode_reward)
        # SAC internals ride along so temperature/loss trajectories are
        # diagnosable from the JSONL
        sac_m = {k: float(v) for k, v in (metrics or {}).items()
                 if k in LOGGED_METRICS}
        logger.log(ep_real, episode_reward=episode_reward, mean_reward=mean_r,
                   **sac_m)

        # periodic full-train-state checkpoint, keyed by the update counter
        # (state.itera), which survives restore and stays monotonic across
        # restarts; episode-keyed names would restart at 1 and lose to the
        # stale maximum in latest_checkpoint()
        if (t.save and not t.if_test and t.save_interval
                and ep_real % t.save_interval == 0):
            ckpt.save_train_state(ckpt_dir, int(state.itera), state)
            if t.save_replay and buf.get_stored_size() > 0:
                buf.save_transitions(os.path.join(
                    ckpt_dir, f"replay_step_{int(state.itera)}"))
            # retention: keep only the newest few periodic checkpoints
            ckpt.prune_checkpoints(ckpt_dir, keep=3)
            ckpt.prune_step_files(ckpt_dir, "replay_step", keep=3)

        # evaluation + checkpoint trigger (main.py:345-356)
        if (mean_r >= reward_threshold and ep_real > t.eval_threshold
                and not t.if_test):
            reward_threshold = mean_r
            avg_reward, nb_col = evaluate(
                env, agent, state, e.max_steps, e.linear_cmd_scale,
                e.angular_cmd_scale, max_action, t.eval_epoch, logger,
                ep_real, stacker=_maybe_stacker(cfg))
            if avg_reward > save_threshold or nb_col < 6:
                name = ckpt.reference_name(
                    f"eval_{t.desc}_{cntr2}", int(avg_reward), t.seed, nb_col)
                ckpt.save_params_npz(os.path.join(out_dir, "models"), name,
                                     actor_params())
                ckpt.save_train_state(ckpt_dir, int(state.itera), state)
                curve.save_npy(os.path.join(out_dir, "curves",
                                            f"eval_reward_mean_{t.desc}.npy"))
                save_threshold = avg_reward

        if ep_real % t.plot_interval == 0:
            curve.save_png(os.path.join(
                out_dir, f"plot_{cfg.model.name}{cfg.model.block}"
                f"{cfg.model.head}_{t.desc}.png"),
                title=f"desc: {t.desc} block={cfg.model.block} "
                      f"head={cfg.model.head}")

    if prefetcher is not None:
        prefetcher.close()
    # final save + summary (main.py:404-417)
    if t.save and not t.if_test:
        ckpt.save_train_state(ckpt_dir, int(state.itera), state)
        name = ckpt.reference_name(t.desc, int(curve.means[-1]) if curve.means
                                   else 0, t.seed)
        ckpt.save_params_npz(os.path.join(out_dir, "models"), name,
                             actor_params())
    duration = time.time() - start_time
    s_r = cntr2 / max(ep_real, 1)
    logger.append_txt(
        "training_data.txt",
        "\n" + "-" * 80 + "\n"
        f"Id = {t.desc} \t Sensor = {e.vis_sensor} Auto-tune: {s.auto_tune_alpha}\n"
        f"seed = {t.seed} critic_type: {cfg.model.critic_type} \t "
        f"actor_type: {cfg.model.actor_type} \t lfs = {cfg.model.latent_size} "
        f"blocks = {cfg.model.block} heads = {cfg.model.head}\n"
        f"Successes: {cntr2} ({s_r * 100:.1f} %), max mean reward = "
        f"{curve.max_mean:.2f} \t Duration = {duration:.1f} (s)\n")
    return {"successes": cntr2, "episodes": ep_real,
            "max_mean_reward": curve.max_mean, "state": state}


def train_elastic(*args, **kwargs):
    """Training under a restart supervisor: not ported yet."""
    raise NotImplementedError(
        "train_elastic: the restart supervisor (core/elastic.py) is not "
        "ported yet; restart with train(..., resume=True)")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="dgvit_tpu_torch RL training (PyTorch/CUDA)")
    p.add_argument("--config", help="structured YAML config")
    p.add_argument("--reference-config",
                   help="reference-format config.yaml to translate")
    p.add_argument("--env", default="kinematic",
                   choices=["kinematic", "replay", "ros2"])
    p.add_argument("--world", default="rrc",
                   help="kinematic world preset (rrc | hospital)")
    p.add_argument("--expert-glob", default=None)
    p.add_argument("--out", default="results")
    p.add_argument("--episodes", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)

    if args.reference_config:
        cfg = load_reference_yaml(args.reference_config)
    elif args.config:
        cfg = Config.from_yaml(args.config)
    else:
        cfg = Config()
    if args.env != "kinematic":
        raise NotImplementedError(
            f"--env {args.env}: only the kinematic env is ported yet")
    if cfg.train.human_intervention and sys.stdin.isatty():
        raise NotImplementedError(
            "train.human_intervention on a terminal: the keyboard teleop "
            "is not ported (pass an intervention source to train())")
    m = cfg.model
    print(f"training critic_type: {m.critic_type} \t actor_type: "
          f"{m.actor_type} ({m.backbone}, {m.compute_dtype})", flush=True)
    env = KinematicNavEnv(seed=cfg.train.seed,
                          image_hw=tuple(cfg.model.image_size),
                          world=args.world)
    out = train(cfg, env, args.out, args.expert_glob, args.episodes,
                args.resume, device=args.device)
    print(f"done: {out['successes']} successes over {out['episodes']} episodes,"
          f" max mean reward {out['max_mean_reward']:.2f}")


if __name__ == "__main__":
    main()
