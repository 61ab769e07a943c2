"""The reference-scale from-scratch training run, on PyTorch and CUDA.

Counterpart of the JAX package's `examples/reference_scale_run.py`, the
launcher of every round-5 training arm: the reference's headline
protocol (main.py:304-417: 800 episodes of at most 800 steps, SAC batch
32, buffer 30k) from scratch with prioritized replay and `nan_guard` in
bf16 on the kinematic world, then the testing.py evaluation (100
deterministic episodes: success rate and collisions) and a
`summary.json` with the JAX launcher's keys.

`--fused` trains with `train_fused` (16 lanes x 64 steps a round, one
update per env step, the ring and its priorities on the card; the ring
holds min(30000, 8192) rows); without it, the host loop `train` on
`KinematicNavEnv(seed=3407)`. The evaluation is `run_eval_vec` (one lane
an episode, record seed 7), or the host `run_eval` with `--host-eval`.
Runs on the card unless `--device cpu`.

The flagship actor's recipe (artifacts/r5/dr_randm32_s11_amin):
    python -m dgvit_tpu_torch.examples.reference_scale_run --episodes 800 \\
        --fused --resume --eval-world hospital --alpha-max 2.0 \\
        --world randm32 --seed 11 --alpha-min 0.1 --out results/flagship
and the DrQ arm drqc_rand8_amin adds `--world rand8 --world-assign lane
--aug-shift 4 --aug-critic-only` in place of the world and seed. The
sensor-fault arms of round 4 (aug_rand8) add `--aug patch_occlusion=0.25
--aug obs_noise=0.196 --aug-prob 0.5` to the fused loop.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

from dgvit_tpu_torch.config import Config


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="reference-scale from-scratch SAC run (PyTorch/CUDA)")
    p.add_argument("--episodes", type=int, default=800)
    p.add_argument("--eval-episodes", type=int, default=100,
                   help="testing.py:46 evaluates 100 episodes")
    p.add_argument("--out", default="results/ref_scale")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--fused", action="store_true",
                   help="train with the on-device loop (train_fused) "
                        "instead of the per-step host loop")
    p.add_argument("--n-envs", type=int, default=16)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--world", default="rrc",
                   help="training arena: rrc | hospital | rand<K> | "
                        "randm<K> (the last two on the fused loop only)")
    p.add_argument("--eval-world", default=None,
                   help="arena of the final evaluation (default --world)")
    p.add_argument("--alpha-min", type=float, default=None,
                   help="floor of the auto-tuned temperature "
                        "(sac.alpha_min)")
    p.add_argument("--alpha-max", type=float, default=None,
                   help="ceiling of the auto-tuned temperature "
                        "(sac.alpha_max)")
    p.add_argument("--aug", action="append", default=None,
                   metavar="KNOB=VALUE",
                   help="sensor-fault augmentation knob of the fused loop "
                        "(repeatable; envs/fault_aug.py), e.g. "
                        "--aug patch_occlusion=0.25")
    p.add_argument("--aug-prob", type=float, default=1.0)
    p.add_argument("--aug-shift", type=int, default=0,
                   help="DrQ random shift in pixels at update time "
                        "(sac.aug_shift); 0 trains on raw frames")
    p.add_argument("--aug-critic-only", action="store_true",
                   help="the shifted frames feed only the TD target and "
                        "the critic loss (sac.aug_actor=False)")
    p.add_argument("--aug-warmup", type=int, default=0,
                   help="updates before the DrQ shift turns on "
                        "(sac.aug_warmup)")
    p.add_argument("--seed", type=int, default=None,
                   help="training seed (cfg.train.seed); default the "
                        "reference's 3407")
    p.add_argument("--world-assign", choices=("reset", "lane"),
                   default="reset",
                   help="ensemble worlds of the fused loop: 'reset' draws "
                        "a lane's world each episode, 'lane' pins lane i "
                        "to world i %% K")
    p.add_argument("--host-eval", action="store_true",
                   help="evaluate with the per-step host loop (run_eval) "
                        "instead of the batched run_eval_vec")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    return p


def recipe_config(args: argparse.Namespace,
                  base: Optional[Config] = None) -> Config:
    """The run's configuration: `base` (the reference defaults when None)
    with the launcher's overrides: bf16, PER, nan_guard, from scratch, no
    mid-run evaluation, a checkpoint and a replay snapshot every 40
    episodes, and the flags' temperature clamps, DrQ knobs and seed."""
    cfg = base or Config()
    cfg.model.compute_dtype = "bfloat16"
    cfg.sac.prioritized_replay = True
    cfg.sac.nan_guard = True
    cfg.train.pre_train = False
    cfg.train.pre_buffer = False
    cfg.train.plot_interval = 10 ** 9
    cfg.train.eval_threshold = 10 ** 9
    cfg.train.reward_threshold = 10 ** 9
    cfg.train.save_interval = 40
    cfg.train.save_replay = True
    cfg.train.desc = "ref_scale_per"
    if args.alpha_max is not None:
        cfg.sac.alpha_max = args.alpha_max
    if args.alpha_min is not None:
        cfg.sac.alpha_min = args.alpha_min
    if args.aug_shift:
        cfg.sac.aug_shift = args.aug_shift
    if args.aug_critic_only:
        cfg.sac.aug_actor = False
    if args.aug_warmup:
        cfg.sac.aug_warmup = args.aug_warmup
    if args.seed is not None:
        cfg.train.seed = args.seed
    return cfg.validate()


def main(argv=None, base: Optional[Config] = None) -> dict:
    """Train, evaluate and write `summary.json` under --out; returns the
    summary. `base`: the configuration the recipe's overrides apply to
    (default: the reference's)."""
    p = parser()
    args = p.parse_args(argv)
    if args.aug and not args.fused:
        p.error("--aug is a fused-loop feature; pass --fused or drop "
                "the augmentation flags")
    cfg = recipe_config(args, base)

    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.models.jax_io import params_to_jax
    from dgvit_tpu_torch.train.evaluate import run_eval, run_eval_vec
    from dgvit_tpu_torch.train.fused_train import parse_aug, train_fused
    from dgvit_tpu_torch.train.train_rl import train

    fault_knobs = parse_aug(p, args.aug)

    hw = tuple(cfg.model.image_size)
    t0 = time.time()
    if args.fused:
        # one update per collected env step (main.py:394's cadence); the
        # episode budget stops the run, the round cap only guards it
        res_f = train_fused(
            cfg, out_dir=args.out, n_envs=args.n_envs, chunk=args.chunk,
            rounds=10 ** 6, rounds_per_dispatch=5,
            max_episodes=args.episodes, resume=args.resume,
            world=args.world, fault_knobs=fault_knobs,
            aug_prob=args.aug_prob, world_assign=args.world_assign,
            device=args.device)
        train_wall = time.time() - t0
        res = {"successes": res_f["goals"], "episodes": res_f["episodes"],
               "state": res_f["state"],
               "aborted_dead": res_f["aborted_dead"]}
        print(f"fused train done: {res_f['goals']} goals / "
              f"{res_f['episodes']} episodes / {res_f['env_steps']} steps / "
              f"{res_f['updates']} updates in {train_wall / 3600:.2f} h",
              flush=True)
    else:
        env = KinematicNavEnv(seed=3407, image_hw=hw,   # the reference SEED
                              max_steps=cfg.env.max_steps, world=args.world)
        res = train(cfg, env, out_dir=args.out, max_episodes=args.episodes,
                    resume=args.resume, device=args.device)
        train_wall = time.time() - t0
        print(f"train done: {res['successes']} goals / {res['episodes']} "
              f"episodes in {train_wall / 3600:.2f} h, max mean reward "
              f"{res['max_mean_reward']:.1f}", flush=True)

    actor = params_to_jax(res["state"].actor.state_dict())
    eval_world = args.eval_world or args.world
    if args.host_eval:
        ev = KinematicNavEnv(seed=7, image_hw=hw, max_steps=cfg.env.max_steps,
                             world=eval_world)
        r = run_eval(cfg, ev, actor, max_episodes=args.eval_episodes,
                     out_dir=args.out, name="ref_scale_eval",
                     device=args.device)
    else:
        cfg.train.seed = 7      # the evaluation's record seed
        r = run_eval_vec(cfg, actor, max_episodes=args.eval_episodes,
                         world=eval_world, out_dir=args.out,
                         name="ref_scale_eval", device=args.device)
    summary = {
        "mode": "fused" if args.fused else "host_loop",
        "world": args.world,
        "eval_world": eval_world,
        "alpha_max": args.alpha_max,
        "alpha_min": args.alpha_min,
        "aug_shift": args.aug_shift,
        "aug_actor": not args.aug_critic_only,
        "aug_warmup": args.aug_warmup,
        "seed": args.seed if args.seed is not None else 3407,
        "aug": fault_knobs,
        "world_assign": args.world_assign,
        "aborted_dead": res.get("aborted_dead", False),
        "aug_prob": args.aug_prob if fault_knobs else None,
        "train_episodes": res["episodes"],
        "train_successes": res["successes"],
        "max_mean_reward": (None if args.fused
                            else round(float(res["max_mean_reward"]), 2)),
        "train_hours": round(train_wall / 3600, 3),
        "eval_success_rate": r["success_rate"],
        "eval_collisions": r.get("collisions"),
        "eval_episodes": args.eval_episodes,
    }
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "summary.json").write_text(json.dumps(summary))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
