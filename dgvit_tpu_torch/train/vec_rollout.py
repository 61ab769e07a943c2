"""Batched collection on the card, and the `train_vec` training loop.

Counterpart of `dgvit_tpu/train/vec_rollout.py`. `make_collect_fn` steps
B lanes of the batched kinematic env (`envs/vec_kinematic.py`) for T
steps, each step one action of the whole batch through the whole-trunk
kernel K1 (`SACAgent.act_batch`), and returns the (T, B, ...)
transitions; nothing in it waits on the card. `train_vec` feeds them to
the host C++ replay buffer and `SACAgent.learn` (with
`sac.prioritized_replay`, the sum-tree buffer and `learn_per`).

The reference's per-lane quirks are kept: actions are stored in policy
units and the env is stepped in command units (a_in = [(a0+1)*L_SCALE,
a1*A_SCALE]); the first step of each episode is marked not to store
(`store`), and a first-step done (a bad initialization) resets the lane
and is masked out with it.

With `fault_knobs` the actor acts on frames perturbed by
`envs/fault_aug.perturb_obs`, and those are the frames stored.

With a `grad_axis='data'` agent, under an active mesh
(`parallel/shard.shardmap_collect`), the carry holds the rank's lanes
and each rank steps only those: a lane's action noise is its row of the
global draw (`SACAgent._rows`), so the union of the ranks' lanes is the
unsharded collector's, and each rank draws its own fault realisations
(`rank_fault_generator`).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.rng import generator, step_key
from dgvit_tpu_torch.envs.fault_aug import (any_on, draw_faults,
                                            knobs_array, perturb_obs)
from dgvit_tpu_torch.envs.vec_kinematic import (EnvConsts, make_consts,
                                                vec_reset, vec_step)
from dgvit_tpu_torch.replay import (PrioritizedReplayBuffer, ReplayBuffer,
                                    reference_schema)
from dgvit_tpu_torch.utils import MetricsLogger


def stack_init(obs: torch.Tensor, depth: int) -> torch.Tensor:
    """(B, H, W) first frames -> (B, C, H, W) stacks of C copies
    (`train_rl.FrameStacker.reset`)."""
    return obs[:, None].repeat(1, depth, 1, 1)


def stack_push(stack: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """Drop the oldest frame, append `frame` (`FrameStacker.push`)."""
    return torch.cat([stack[:, 1:], frame[:, None]], dim=1)


def rank_fault_generator(gen: Optional[torch.Generator], rank: int,
                         device) -> torch.Generator:
    """The rank's fault generator under the data axis: seeded
    step_key(gen's seed, rank + 1), as JAX folds axis_index + 1 into the
    aug key (`vec_rollout.py:98-104`), so the ranks' fault draws differ
    and the action noise does not move. A call starts the rank's stream
    from `gen`'s seed: pass a freshly seeded `gen` to each call, as the
    fused round does."""
    if gen is None:
        raise ValueError("sensor-fault augmentation under the data axis "
                         "needs a seeded fault generator (fault_gen)")
    return generator(step_key(gen.initial_seed(), rank + 1), device)


def make_collect_fn(agent: SACAgent, consts: EnvConsts, chunk: int,
                    l_scale: float, a_scale: float, max_action: float = 1.0,
                    evaluate: bool = False, stride: Optional[int] = None,
                    frame_stack: int = 0,
                    fault_knobs: Optional[Dict[str, float]] = None,
                    aug_prob: float = 1.0):
    """`collect(actor, carry, generator, noise=None, fault_gen=None,
    faults=None) -> (carry', traj)`: `chunk` steps of every lane of
    `carry` = (VecState, obs, to_goal), acting through `actor` (K1, no
    dropout). traj holds (T, B, ...) tensors: obs, act (policy units,
    fp32), pobs, next_pobs, rew, next_obs, done, episode_end (done or the
    max_steps cap), and the masks store (not an episode's first step),
    target and collided (both masked by store). Action noise comes from
    `generator`, or is `noise` (T, B, A) of standard normal draws.

    `frame_stack` > 0 carries (B, C, H, W) stacks for a channels-mode
    actor; transitions store stacks, and a lane that resets refills its
    stack with the new episode's first frame.

    `fault_knobs` ({knob: value}, `envs/fault_aug.KNOB_KEYS`): sensor-
    fault augmentation. The actor acts on a perturbed frame and that
    frame is the stored `obs`; the carry stays clean (the faults are
    independent from step to step); `next_obs` gets a realization of its
    own; the env always sees the true world. `aug_prob` < 1 applies the
    whole knob set to a lane at a step with that probability (a uniform
    draw a lane below it), else the lane's frame stays clean. The fault
    draws come from `fault_gen`, a generator apart from the action
    noise's, so setting knobs leaves the action noise as it was: at each
    step, for obs then for next_obs, the gate's uniforms (B,) when
    `aug_prob` < 1, then `fault_aug.draw_faults`. `faults` replaces them:
    one (obs, next_obs) pair a step, each (gate or None, noise,
    occlusion, y0, x0). No knob set, or none above 0, is the unaugmented
    collection.

    Under the data axis (a `grad_axis` agent; the carry holds the rank's
    b lanes) `noise` is the global (T, B, A) draw, of which the rank's
    lanes take their rows, the generator draws the global (B, A) each
    step, and the fault draws come from `rank_fault_generator(fault_gen,
    rank)` (`faults`, when given, are the rank's own)."""
    knobs = knobs_array(fault_knobs)
    augment = any_on(knobs)

    def aug(o, gen, d):
        if d is None:
            gate_u = (torch.rand((o.shape[0],), generator=gen,
                                 device=o.device)
                      if aug_prob < 1.0 else None)
            d = (gate_u,) + draw_faults(o.shape, gen, o.device)
        pert = perturb_obs(o, knobs, draws=d[1:])
        if aug_prob >= 1.0:
            return pert
        gate = (d[0] < aug_prob).reshape((-1,) + (1,) * (o.ndim - 1))
        return torch.where(gate, pert, o)

    @torch.no_grad()
    def collect(actor, carry, gen: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                fault_gen: Optional[torch.Generator] = None,
                faults=None):
        state, obs, goal = carry
        rows = None
        if agent.grad_axis is not None:
            mesh = agent._mesh()
            rows = agent._rows(obs.shape[0])
            if augment and faults is None:
                fault_gen = rank_fault_generator(fault_gen, mesh.rank,
                                                 obs.device)
        steps = []
        for t in range(chunk):
            d_obs, d_next = (None, None) if faults is None else faults[t]
            # the actor's input and the stored obs; the carry stays clean
            obs_in = aug(obs, fault_gen, d_obs) if augment else obs
            a = agent.act_batch(actor, obs_in, goal[:, :2], gen, evaluate,
                                noise=None if noise is None else noise[t],
                                rows=rows)
            a = torch.clamp(a.float(), -max_action, max_action)
            a_in = torch.stack([(a[:, 0] + 1.0) * l_scale,
                                a[:, 1] * a_scale], dim=1)
            first = state.steps == 0
            out = vec_step(consts, state, a_in, stride=stride)
            if frame_stack:
                next_obs = stack_push(obs, out.next_obs)
                restart = (out.done | out.truncated)[:, None, None, None]
                carry_obs = torch.where(
                    restart, stack_init(out.obs, frame_stack), next_obs)
            else:
                next_obs, carry_obs = out.next_obs, out.obs
            if augment:
                next_obs = aug(next_obs, fault_gen, d_next)
            steps.append({
                "obs": obs_in, "act": a, "pobs": goal[:, :2],
                "next_pobs": out.next_to_goal[:, :2],
                "rew": out.reward, "next_obs": next_obs,
                "done": out.done.float(),
                # an episode ends at done or at the max_steps cap
                "episode_end": (out.done | out.truncated).float(),
                "store": ~first,
                "target": out.target & ~first,
                "collided": out.collided & ~first,
            })
            state, obs, goal = out.state, carry_obs, out.to_goal
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        return (state, obs, goal), traj

    return collect


def _flatten_traj(traj: Dict[str, torch.Tensor]):
    """(T, B, ...) transitions -> host (N_kept, ...) replay fields (the
    store mask applied) and the chunk's stats."""
    host = {k: v.cpu().numpy() for k, v in traj.items()}
    keep = host.pop("store").reshape(-1)
    stats = {"goals": int(host.pop("target").sum()),
             "collisions": int(host.pop("collided").sum())}
    host.pop("episode_end")
    flat = {k: v.reshape((-1,) + v.shape[2:])[keep] for k, v in host.items()}
    stats.update(stored=int(keep.sum()), reward_sum=float(flat["rew"].sum()),
                 episodes_done=int(flat["done"].sum()))
    return flat, stats


def frame_stack_depth(cfg: Config, where: str) -> int:
    """The frame-stack depth a config asks of the batched loops: C in
    channels mode (which needs env.use_frame_stack), else 0."""
    e = cfg.env
    if cfg.model.patch_mode == "channels":
        if not e.use_frame_stack:
            raise ValueError("patch_mode='channels' needs "
                             f"env.use_frame_stack=True in {where}")
        return int(e.frame_stack)
    if e.use_frame_stack:
        raise ValueError("env.use_frame_stack=True needs "
                         "model.patch_mode='channels'")
    return 0


def train_vec(cfg: Config, out_dir: str = "results", n_envs: int = 16,
              chunk: int = 64, total_env_steps: int = 100_000,
              updates_per_chunk: Optional[int] = None,
              world: Optional[str] = None, resume: bool = False,
              save_interval_chunks: int = 50,
              device: Optional[Union[str, torch.device]] = None) -> dict:
    """SAC on the batched env: each chunk of B x T steps is collected on
    the card (K1), its stored transitions go to the host replay buffer,
    then `updates_per_chunk` updates (by default one per stored step, the
    reference's cadence) run through `SACAgent.learn`, or with
    sac.prioritized_replay through `learn_per` on the sum-tree buffer,
    whose sampled rows then take |td| + 1e-6 as priorities. Channels-mode
    actors take the frame stack (env.use_frame_stack). Runs on the card
    unless device='cpu'.

    Chunk n draws its action noise from a generator seeded
    `step_key(seed, n)`, as `train_fused`'s rounds do. `resume` restores
    the newest checkpoint and the chunk, env-step, goal, collision and
    episode counters from the run's JSONL, so a resumed run draws on where
    it stopped and `total_env_steps` counts the whole run; the host
    replay buffer starts empty and lanes restart."""
    t, e, s = cfg.train, cfg.env, cfg.sac
    fs = frame_stack_depth(cfg, "train_vec")
    agent = SACAgent(cfg, device=device, seed=t.seed)
    state = agent.init_state(t.seed)
    if t.pre_train and t.pre_train_model:
        d, f = os.path.split(t.pre_train_model)
        state = agent.load(state, f, d or ".", actor_only=True)
    ckpt_dir = os.path.join(out_dir, t.checkpoint_dir)
    logger = MetricsLogger(out_dir, f"train_vec_{cfg.model.name}_{t.desc}")
    last: Dict = {}
    if resume:
        latest = ckpt.latest_checkpoint(ckpt_dir)
        if latest:
            state = ckpt.restore_train_state(latest, state)
        last = logger.last()

    ih, iw = cfg.model.image_size
    consts = make_consts(world=world or "rrc", image_hw=(ih, iw),
                         max_steps=e.max_steps, seed=t.seed,
                         device=agent.device)
    collect = make_collect_fn(agent, consts, chunk, e.linear_cmd_scale,
                              e.angular_cmd_scale, max_action=e.max_action,
                              frame_stack=fs)
    lanes, obs, goal = vec_reset(consts, n_envs)
    carry = (lanes, stack_init(obs, fs) if fs else obs, goal)
    obs_shape = (fs, ih, iw) if fs else (ih, iw)
    buf_cls = PrioritizedReplayBuffer if s.prioritized_replay else ReplayBuffer
    buf = buf_cls(s.buffer_size, reference_schema(
        obs_shape, s.action_dim, s.pstate_dim), seed=t.seed)

    n_chunk, env_steps, goals, collisions, episodes = (
        int(last.get(k, 0)) for k in
        ("step", "env_steps", "goals", "collisions", "episodes"))
    metrics: Dict = {}
    while env_steps < total_env_steps:
        carry, traj = collect(state.actor, carry,
                              generator(step_key(t.seed, n_chunk),
                                        agent.device))
        flat, st = _flatten_traj(traj)
        env_steps += n_envs * chunk
        goals += st["goals"]
        collisions += st["collisions"]
        episodes += st["episodes_done"]
        if st["stored"]:
            buf.add(**flat, engage=np.zeros((st["stored"],), np.float32))
        n_upd = st["stored"] if updates_per_chunk is None else \
            updates_per_chunk
        if buf.get_stored_size() >= s.batch_size:
            for _ in range(n_upd):
                d = buf.sample(s.batch_size)
                d.pop("engage", None)
                if s.prioritized_replay:
                    w, idx = d.pop("weights"), d.pop("indexes")
                    state, metrics, td = agent.learn_per(state, d, w)
                    buf.update_priorities(
                        idx, np.abs(td.float().cpu().numpy()) + 1e-6)
                else:
                    state, metrics = agent.learn(state, d)
        n_chunk += 1
        sac_m = {k: float(v) for k, v in metrics.items()
                 if k in ("alpha", "policy_loss", "qf1_loss", "qf2_loss",
                          "entropy", "skipped_nonfinite")}
        logger.log(n_chunk, env_steps=env_steps, goals=goals,
                   collisions=collisions, episodes=episodes,
                   chunk_reward=st["reward_sum"],
                   buffer=buf.get_stored_size(), **sac_m)
        if (t.save and save_interval_chunks
                and n_chunk % save_interval_chunks == 0):
            ckpt.save_train_state(ckpt_dir, int(state.itera), state)
            ckpt.prune_checkpoints(ckpt_dir, keep=3)
    if t.save:
        ckpt.save_train_state(ckpt_dir, int(state.itera), state)
        ckpt.prune_checkpoints(ckpt_dir, keep=3)
    return {"env_steps": env_steps, "goals": goals, "collisions": collisions,
            "episodes": episodes, "updates": int(state.itera),
            "state": state}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="dgvit_tpu_torch batched-env RL training (PyTorch/CUDA)")
    p.add_argument("--config", default=None)
    p.add_argument("--out", default="results")
    p.add_argument("--n-envs", type=int, default=16)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--env-steps", type=int, default=100_000)
    p.add_argument("--updates-per-chunk", type=int, default=None)
    p.add_argument("--world", default="rrc")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)
    cfg = Config.from_yaml(args.config) if args.config else Config()
    out = train_vec(cfg, out_dir=args.out, n_envs=args.n_envs,
                    chunk=args.chunk, total_env_steps=args.env_steps,
                    updates_per_chunk=args.updates_per_chunk,
                    world=args.world, resume=args.resume, device=args.device)
    print(f"env steps: {out['env_steps']}  episodes: {out['episodes']}  "
          f"goals: {out['goals']}  collisions: {out['collisions']}  "
          f"updates: {out['updates']}")


if __name__ == "__main__":
    main()
