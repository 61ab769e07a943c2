"""Evaluation entry point: testing.py:40-158 of the reference. Load a trained
actor, run N deterministic episodes, report success rate, collisions and
durations, append results/testing_data.txt.

Counterpart of `dgvit_tpu/train/evaluate.py`, with four episode loops:
  * `run_eval`, the host loop (default): a reference-shaped Python loop
    with one actor forward per step, the whole-trunk kernel (K1) on the
    card;
  * `run_eval(..., device_rollout_loop=True)` (`--device-rollout`): each
    episode through `train/device_rollout.py`, the policy, the clip and
    the command scaling on the card and the env behind a host callback,
    one host wait a step (JAX: one `lax.scan` with an `io_callback`);
  * `run_eval_vec` (`--vec-eval`): every episode a lane of the batched
    env on the card, which also runs the robustness sweep (`sweep=`,
    `tools/robustness_sweep.py`);
  * `run_eval_fleet` (`--fleet N`): the episodes split across N
    concurrent robots (kinematic lanes, or with `--fleet-env ros2`
    namespaced ROS 2 adapters) sharing one batching actor server
    (`serve/fleet.py`), one K1 launch a coalesced dispatch.

Goal-reach durations are reported in simulated seconds (steps * env.DT),
not wall-clock.
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.rng import generator
from dgvit_tpu_torch.envs import Env, KinematicNavEnv
from dgvit_tpu_torch.envs.fault_aug import KNOB_KEYS, knobs_array, perturb_obs
from dgvit_tpu_torch.envs.vec_kinematic import (make_consts, vec_reset,
                                                vec_step)
from dgvit_tpu_torch.models.jax_io import params_to_jax
from dgvit_tpu_torch.replay.staging import HostStager
from dgvit_tpu_torch.serve import make_action_fn
from dgvit_tpu_torch.train.train_rl import FrameStacker, _squeeze_obs
from dgvit_tpu_torch.train.vec_rollout import stack_init, stack_push
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
             device: Optional[Union[str, torch.device]] = None,
             device_rollout_loop: bool = False) -> dict:
    """The evaluation protocol on `env` with the actor of `actor_params`
    (the JAX package's parameter tree, nested or flat as `load_params_npz`
    returns it), in the config's compute dtype. Runs on the card unless
    device='cpu'. `device_rollout_loop`: each episode through
    `device_rollout` (JAX's io_callback scan), whose quirks it keeps."""
    e = cfg.env
    dt = float(getattr(env, "DT", 0.1))  # sim-time per step (env_lab.py:204)
    # a reused env carries its previous run's collision count
    if hasattr(env, "collision"):
        env.collision = 0
    if device_rollout_loop:
        return _run_eval_device(cfg, env, actor_params, max_episodes,
                                out_dir, name, dt, device)
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


def _run_eval_device(cfg: Config, env: Env, actor_params, max_episodes: int,
                     out_dir: str, name: str, dt: float,
                     device: Optional[Union[str, torch.device]]) -> dict:
    """The episode loop through `device_rollout`: a bad initialization
    (done on the first step) is excluded, a success is the first step
    with the target flag, its duration (step + 1) * dt. A failure on the
    card raises: there is no fall back to the host loop."""
    from dgvit_tpu_torch.train.device_rollout import device_rollout

    if cfg.model.patch_mode == "channels":
        raise ValueError("--device-rollout does not support frame-stacked "
                         "(channels-mode) actors yet; use the host loop")
    e = cfg.env
    agent = SACAgent(cfg, device=device)
    actor = make_action_fn(cfg, actor_params,
                           dtype=agent.dtype or torch.float32,
                           device=agent.device).policy
    state = SimpleNamespace(actor=actor)
    stager = HostStager(agent.device)
    cntr2 = 0
    total_rel = max_episodes
    durations = []
    for ep in range(max_episodes):
        out = device_rollout(agent, state, env, e.max_steps,
                             e.linear_cmd_scale, e.angular_cmd_scale,
                             seed=cfg.train.seed + ep, evaluate=True,
                             stager=stager)
        dones, targets = out.dones.numpy(), out.targets.numpy()
        if dones[0] > 0:
            total_rel -= 1  # Bad initialization (testing.py:117-121)
            continue
        hit = np.flatnonzero(targets > 0)
        if hit.size:
            cntr2 += 1
            durations.append(float(hit[0] + 1) * dt)
    return _report(cfg, env, cntr2, total_rel, durations, out_dir, name)


def run_eval_vec(cfg: Config, actor_params: Mapping[str, Any],
                 max_episodes: int = 100, world: str = "rrc",
                 out_dir: str = "results", name: str = "model",
                 obs_noise: float = 0.0, occlusion: float = 0.0,
                 greying: float = 0.0, sweep=None,
                 world_seed: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 draws: Optional[Sequence] = None):
    """The evaluation protocol with every episode a lane of the batched
    env on the card: `env.max_steps` steps of all lanes, one K1 launch a
    step, and one read of the results at the end.

    Per lane as `run_eval`: deterministic actions, a bad initialization
    (done on the first step) excluded, success and collision latched at
    the lane's first episode end, durations in simulated seconds; lane i
    runs record i. A `rand<K>` world is drawn from a held-out seed
    (cfg.train.seed + 1000003) unless `world_seed` pins one, so the
    evaluation layouts are not the training ones.

    Sensor faults (`envs/fault_aug.perturb_obs`) perturb what the actor
    sees, not the carried frames: `obs_noise` adds N(0, sigma) and clips
    to [0, 1], `occlusion` zeroes that fraction of pixels, `greying`
    blends toward 0.5. `sweep`, a list of {knob: value} dicts over
    `fault_aug.KNOB_KEYS` (`blur` and `patch_occlusion` too), runs the
    whole grid with one policy, one set of consts and one reset, and
    returns one report a point, its knob values folded in and its tag in
    testing_data.txt `name` + " k=v,...". Every point restarts the fault
    draws from a generator seeded cfg.train.seed, so at each step every
    point sees the same realization: the points are paired, and a point
    equals the run of its knobs without the sweep. `draws` (tests): the
    fault draws of each step (`fault_aug.draw_faults`' four arrays), the
    same for every point. Runs on the card unless device='cpu'."""
    e = cfg.env
    fs = (int(e.frame_stack) if cfg.model.patch_mode == "channels" else 0)
    agent = SACAgent(cfg, device=device)
    dev = agent.device
    actor = make_action_fn(cfg, actor_params,
                           dtype=agent.dtype or torch.float32,
                           device=dev).policy
    seed = world_seed
    if seed is None:
        seed = cfg.train.seed
        if isinstance(world, str) and world.startswith("rand"):
            seed = cfg.train.seed + 1_000_003
    consts = make_consts(world=world, image_hw=tuple(cfg.model.image_size),
                         max_steps=e.max_steps, seed=seed, device=dev)
    dt = float(consts.dt)
    points = sweep if sweep is not None else [
        {"obs_noise": obs_noise, "occlusion": occlusion, "greying": greying}]
    b = max_episodes
    reports = []
    with torch.no_grad():
        state0, obs0, goal0 = vec_reset(consts, b)
        if fs:
            obs0 = stack_init(obs0, fs)
        for pt in points:
            knobs = knobs_array(pt)
            gen = generator(cfg.train.seed, dev)
            state, obs, goal = state0, obs0, goal0
            ended = torch.zeros(b, dtype=torch.bool, device=dev)
            succ, coll, bad = ended.clone(), ended.clone(), ended.clone()
            dur = torch.zeros(b, device=dev)
            for t in range(e.max_steps):
                obs_in = perturb_obs(obs, knobs, gen,
                                     None if draws is None else draws[t])
                a = agent.act_batch(actor, obs_in, goal[:, :2],
                                    evaluate=True)
                a = torch.clamp(a.float(), -e.max_action, e.max_action)
                a_in = torch.stack([(a[:, 0] + 1.0) * e.linear_cmd_scale,
                                    a[:, 1] * e.angular_cmd_scale], dim=1)
                a_in = torch.where(ended[:, None], 0.0, a_in)
                out = vec_step(consts, state, a_in)
                if t == 0:
                    bad = out.done.clone()
                live = ~ended & ~bad
                hit = out.target & live
                succ |= hit
                # simulated seconds in fp32, as the JAX loop takes them
                dur = torch.where(hit, float(np.float32(t + 1.0)
                                             * np.float32(dt)), dur)
                coll |= out.collided & live
                ended = ended | out.done | out.truncated | bad
                if fs:
                    restart = (out.done | out.truncated)[:, None, None, None]
                    obs = torch.where(restart, stack_init(out.obs, fs),
                                      stack_push(obs, out.next_obs))
                else:
                    obs = out.obs
                state, goal = out.state, out.to_goal
            # the point's one read of the card
            host = torch.stack([succ.float(), coll.float(), dur,
                                bad.float()]).cpu().numpy()
            p_succ, p_bad = host[0] > 0, host[3] > 0
            tag = name if sweep is None else (
                name + " " + ",".join(f"{k}={v}" for k, v in
                                      sorted(pt.items()) if v))

            class _Count:   # the collision count `_report` reads
                collision = int(host[1].sum())

            rep = _report(cfg, _Count(), int(p_succ.sum()),
                          int(b - p_bad.sum()),
                          [float(d) for d in host[2][p_succ]], out_dir, tag)
            rep.update({k: float(pt.get(k, 0.0)) for k in KNOB_KEYS})
            rep.update(world=world, world_seed=int(seed))
            reports.append(rep)
    return reports if sweep is not None else reports[0]


def run_eval_fleet(cfg: Config, actor_params: Mapping[str, Any],
                   max_episodes: int = 100, n_robots: int = 8,
                   world: str = "rrc", out_dir: str = "results",
                   name: str = "model", env_kind: str = "kinematic",
                   device: Optional[Union[str, torch.device]] = None
                   ) -> dict:
    """The evaluation protocol as a fleet: the episodes split evenly
    across `n_robots` concurrent robots sharing one BatchingActorServer
    over `make_action_fn` (K1, the config's compute dtype), so the card
    sees coalesced bucket dispatches instead of one a step. Robot i is
    KinematicNavEnv(seed=train.seed + i) on `world`, or with
    env_kind='ros2' the namespaced adapters of `make_ros2_fleet` over a
    live multi-robot Gazebo world. An incomplete campaign (a robot that
    failed) raises. Runs on the card unless device='cpu'."""
    from dgvit_tpu_torch import serve

    if max_episodes % n_robots:
        raise ValueError(f"--episodes {max_episodes} must divide evenly "
                         f"across --fleet {n_robots} robots")
    dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
             else torch.float32)
    act = make_action_fn(cfg, actor_params, dtype=dtype, device=device)
    if env_kind == "ros2":
        # free-running physics over namespaced adapters (make_ros2_fleet)
        envs = serve.make_ros2_fleet(cfg, n_robots, device=device)
    else:
        envs = [KinematicNavEnv(seed=cfg.train.seed + i,
                                image_hw=tuple(cfg.model.image_size),
                                world=world)
                for i in range(n_robots)]
    out = serve.serve_fleet(cfg, envs, act,
                            episodes_per_robot=max_episodes // n_robots)
    if out["errors"]:
        # FleetRunner returns partial results with the robots' errors;
        # the evaluation protocol is strict
        raise RuntimeError(f"fleet eval incomplete, robots failed: "
                           f"{out['errors']}")

    class _Count:   # the collision count `_report` reads
        collision = out["collisions"]

    rep = _report(cfg, _Count(), out["successes"], out["episodes"],
                  out["durations"], out_dir, name)
    rep["serving"] = out["serving"]
    return rep


def checkpoint_actor(cfg: Config, path: str):
    """(actor params in the JAX package's layout, the step's name) out of
    a train-state checkpoint of the port's trainers: a step_N directory,
    or a checkpoints/ directory whose newest step is taken."""
    if not os.path.basename(os.path.normpath(path)).startswith("step_"):
        newest = ckpt.latest_checkpoint(path)
        if newest is None:
            raise FileNotFoundError(f"no step_* checkpoints under {path}")
        path = newest
    state = ckpt.restore_train_state(
        path, SACAgent(cfg, device="cpu").init_state(cfg.train.seed))
    return params_to_jax(state.actor.state_dict()), os.path.basename(path)


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
                        "eval. With --vec-eval also rand<K> / randh<K> / "
                        "randm<K>: each episode in a procedural layout of "
                        "a held-out ensemble")
    p.add_argument("--vec-eval", action="store_true",
                   help="run every episode at once, as the lanes of the "
                        "batched env on the card (run_eval_vec)")
    p.add_argument("--device-rollout", action="store_true",
                   help="each episode with the policy, the clip and the "
                        "command scaling on the card and the env behind a "
                        "host callback (train/device_rollout.py)")
    p.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="run the protocol as N concurrent robots sharing "
                        "one micro-batching actor server (serve/fleet.py);"
                        " episodes split evenly across robots")
    p.add_argument("--fleet-env", default="kinematic",
                   choices=["kinematic", "ros2"],
                   help="robots of --fleet: kinematic lanes, or namespaced "
                        "GazeboRos2Env adapters over a live multi-robot "
                        "Gazebo world (free-running physics)")
    p.add_argument("--world-seed", type=int, default=None,
                   help="--vec-eval: the seed of the world and records; "
                        "default the config's seed (held out for rand "
                        "specs)")
    p.add_argument("--obs-noise", type=float, default=0.0,
                   help="--vec-eval: N(0, sigma) sensor noise on [0, 1]")
    p.add_argument("--occlusion", type=float, default=0.0,
                   help="--vec-eval: fraction of pixels zeroed")
    p.add_argument("--greying", type=float, default=0.0,
                   help="--vec-eval: blend toward mid-grey")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)
    if bool(args.actor) == bool(args.checkpoint):
        p.error("exactly one of --actor / --checkpoint is required")

    if args.fleet and (args.vec_eval or args.device_rollout):
        p.error("--fleet is a host-loop mode; it composes with neither "
                "--vec-eval nor --device-rollout")

    cfg = Config.from_yaml(args.config) if args.config else Config()
    # the batched env and the fleet build their own worlds (rand specs
    # exist only in the batched env)
    env = None if (args.vec_eval or args.fleet) else KinematicNavEnv(
        seed=cfg.train.seed, image_hw=tuple(cfg.model.image_size),
        world=args.world)
    if args.checkpoint:
        try:
            params, name = checkpoint_actor(cfg, args.checkpoint)
        except FileNotFoundError as err:
            p.error(str(err))
    else:
        params = ckpt.load_params_npz(args.actor)
        name = os.path.basename(args.actor)
    if args.fleet:
        out = run_eval_fleet(cfg, params, args.episodes, args.fleet,
                             args.world, args.out, name,
                             env_kind=args.fleet_env, device=args.device)
    elif args.vec_eval:
        out = run_eval_vec(cfg, params, args.episodes, args.world, args.out,
                           name, obs_noise=args.obs_noise,
                           occlusion=args.occlusion, greying=args.greying,
                           world_seed=args.world_seed, device=args.device)
    else:
        out = run_eval(cfg, env, params, args.episodes, args.out, name,
                       device=args.device,
                       device_rollout_loop=args.device_rollout)
    print(f"success rate: {out['success_rate'] * 100:.1f}% "
          f"({out['successes']} goals), collisions: {out['collisions']}")


if __name__ == "__main__":
    main()
