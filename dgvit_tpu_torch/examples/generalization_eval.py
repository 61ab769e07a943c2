"""The unseen-world generalization experiment, on PyTorch and CUDA.

Counterpart of the JAX package's `examples/generalization_eval.py`, the
launcher of the round-3 guided arms (artifacts/r3/gen_fused): train a
policy in the RRC arena, then evaluate it on the training arena and on
the hospital layout it never saw.

  1. BC warm start: scripted-pilot demos recorded on the host env in the
     RRC arena (`--bc-episodes`, at most 200 steps each), then
     `BCTrainer.fit` of a fp32 GoT policy (RMS final norm, no
     emb-dropout) at batch 64, saved as <out>/il/bc_warm_actor.npz; or
     `--bc-params` copied there byte for byte;
  2. the SAC fine-tune from the warm start (`train.pre_train`), bf16 with
     `nan_guard`, in `--train-world`: the on-device loop `train_fused`
     with `--fused` (`--rl-episodes` is its episode budget), else the
     host loop `train`; `--expert-buffer` feeds the demos to the guided
     update (`train.pre_buffer`); `--skip-rl` evaluates the warm start;
  3. evaluations on rrc and hospital (`run_eval_vec` with `--vec-eval`,
     one lane an episode, else the host `run_eval`), <out>/final_actor.npz
     in the JAX package's layout, and a last line of JSON with the JAX
     launcher's keys.

The gw10 arm (artifacts/r3/gen_fused/gw10_winner_actor.npz):
    python -m dgvit_tpu_torch.examples.generalization_eval --fused \\
        --vec-eval --expert-buffer --demos <demo dir> \\
        --bc-params artifacts/r3/gen_fused/bc_warm --rl-episodes 300 \\
        --eval-episodes 50 --alpha-init 0.05 --guidence-weight 10
and its base stage, the BC warm start alone:
    python -m dgvit_tpu_torch.examples.generalization_eval \\
        --bc-episodes 100 --bc-epochs 120 --skip-rl --vec-eval

Each stage's line gives its host-clock seconds. The JAX launcher's
persistent compile cache has no counterpart: the
kernels are built once into build/kernels/ (`ops/_build.py`) and reused.
Runs on the card unless `--device cpu`; without a card and without it,
it raises before it records anything.
"""

from __future__ import annotations

import argparse
import functools
import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional

from dgvit_tpu_torch.config import Config


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="unseen-world generalization experiment (PyTorch/CUDA)")
    p.add_argument("--bc-episodes", type=int, default=100)
    p.add_argument("--bc-epochs", type=int, default=120)
    p.add_argument("--rl-episodes", type=int, default=80)
    p.add_argument("--eval-episodes", type=int, default=30)
    p.add_argument("--alpha-init", type=float, default=1.0,
                   help="starting entropy temperature of the SAC fine-tune "
                        "(1.0 washes out the BC warm start; 0.05 keeps it)")
    p.add_argument("--alpha-max", type=float, default=None,
                   help="ceiling of the auto-tuned temperature "
                        "(sac.alpha_max) for long fine-tunes")
    p.add_argument("--guidence-weight", type=float, default=1.0,
                   help="expert BC anchor weight (DRL.py:51); the reward "
                        "scale is +-200, so Q magnitudes dwarf the default")
    p.add_argument("--gw-final", type=float, default=None,
                   help="decay guidence_weight geometrically to this value")
    p.add_argument("--gw-decay-steps", type=int, default=0,
                   help="learn steps over which the gw decay completes")
    p.add_argument("--per", action="store_true",
                   help="prioritized replay for the fine-tune")
    p.add_argument("--expert-buffer", action="store_true",
                   help="reference PRE_BUFFER workflow: feed the recorded "
                        "demos to the guided update as the expert buffer")
    p.add_argument("--skip-rl", action="store_true",
                   help="evaluate the BC warm start only")
    p.add_argument("--demos", default=None,
                   help="reuse a demo npz dir of an earlier run (skip "
                        "recording): <dir>/RRC/jax, <dir>/RRC/torch or any "
                        "<dir>/<world>/<recorder>/ layout")
    p.add_argument("--bc-params", default=None,
                   help="reuse a saved BC warm start, the npz's base path "
                        "(skip demos + BC)")
    p.add_argument("--fused", action="store_true",
                   help="run the SAC fine-tune through the on-device loop "
                        "(train/fused_train.py) with the demo corpus on the "
                        "card for expert guidance; --rl-episodes becomes "
                        "its episode budget")
    p.add_argument("--n-envs", type=int, default=16)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--dim", type=int, default=64,
                   help="GoT latent dim; pair --bc-params only with a fit "
                        "at the same dim")
    p.add_argument("--dim-head", type=int, default=64)
    p.add_argument("--train-world", default="rrc",
                   help="arena of the SAC fine-tune: rrc | hospital | "
                        "rand<K> (fused loop: a K-layout ensemble). Demos "
                        "and BC stay in RRC")
    p.add_argument("--vec-eval", action="store_true",
                   help="evaluate every episode at once as lanes of the "
                        "batched env on the card (run_eval_vec) instead of "
                        "the per-step host loop")
    p.add_argument("--seed", type=int, default=1,
                   help="RL fine-tune seed (cfg.train.seed / host env "
                        "seed); 1 = every round-3/4 arm's")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    return p


def bc_policy(cfg: Config, dim: int, dim_head: int):
    """The BC warm start's policy constructor: the config's trunk (the JAX
    launcher's GoTPolicy defaults are `Config()`'s widths) at `dim` and
    `dim_head`, an RMS final norm, no emb-dropout, fp32."""
    from dgvit_tpu_torch.models.policies import GoTPolicy

    m = cfg.model
    return functools.partial(
        GoTPolicy, block=m.block, head=m.head, mlp_dim=m.mlp_dim,
        image_size=tuple(m.image_size), patch_size=tuple(m.patch_size),
        final_norm="rms", emb_dropout=0.0, l_f_size=dim, dim_head=dim_head)


def demo_glob(demo_dir: Path) -> str:
    """The demo files of a corpus directory: the JAX recorder's
    <dir>/RRC/jax/, else the port's <dir>/RRC/torch/, else any two-level
    layout (a teacher corpus, <dir>/<world>/teacher/)."""
    for recorder in ("jax", "torch"):
        sub = demo_dir / "RRC" / recorder
        if sub.is_dir():
            return str(sub / "*.npz")
    return str(demo_dir / "*" / "*" / "*.npz")


def main(argv=None, base: Optional[Config] = None) -> dict:
    """Run the experiment; print and return the summary line's dict.
    `base`: the configuration the launcher's overrides apply to (default
    the reference's); the BC policy takes its widths."""
    p = parser()
    args = p.parse_args(argv)
    if args.skip_rl and args.bc_params:
        p.error("--skip-rl needs a fresh BC fit (drop --bc-params)")

    from dgvit_tpu_torch.agents.bc import BCTrainer
    from dgvit_tpu_torch.core import checkpoint as ckpt
    from dgvit_tpu_torch.core.device import resolve_device
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.models.jax_io import params_to_jax
    from dgvit_tpu_torch.train.demo_record import (policy_unit_pilot,
                                                   record_episodes)
    from dgvit_tpu_torch.train.evaluate import run_eval, run_eval_vec
    from dgvit_tpu_torch.train.train_bc import load_bc_dataset

    device = resolve_device(args.device)
    out = Path(args.out or tempfile.mkdtemp(prefix="gen_eval_"))
    print(f"workdir: {out}", flush=True)

    cfg = base or Config()
    cfg.model.compute_dtype = "bfloat16"
    cfg.model.latent_size = args.dim
    cfg.model.dim_head = args.dim_head
    cfg.train.pre_buffer = False
    cfg.train.plot_interval = 10 ** 9
    cfg.train.eval_threshold = 10 ** 9   # no mid-train eval pauses
    cfg.env.max_steps = 200
    hw = tuple(cfg.model.image_size)

    # ---- 1. demos + BC (deployment-consistent action units) ----------------
    demo_dir = Path(args.demos) if args.demos else out / "demos"
    hist = None
    if args.bc_params:
        (out / "il").mkdir(parents=True, exist_ok=True)
        shutil.copyfile(args.bc_params + "_actor.npz",
                        out / "il" / "bc_warm_actor.npz")
        print(f"reusing BC warm start: {args.bc_params}", flush=True)
    else:
        if args.demos is None:
            source, to_env = policy_unit_pilot(cfg)
            t0 = time.perf_counter()
            paths = record_episodes(KinematicNavEnv(seed=0, image_hw=hw),
                                    source, str(demo_dir),
                                    episodes=args.bc_episodes, max_steps=200,
                                    action_to_env=to_env)
            print(f"recorded {len(paths)} demo episodes in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        obs, act, goal = load_bc_dataset(demo_glob(demo_dir))
        print(f"BC dataset: {obs.shape[0]} transitions", flush=True)

        tr = BCTrainer(model=bc_policy(cfg, args.dim, args.dim_head),
                       batch_size=64, seed=1, device=device)
        t0 = time.perf_counter()
        best, hist = tr.fit(obs, goal, act, epochs=args.bc_epochs,
                            to_chw=False)
        print(f"BC val RMSE: {min(hist['val']):.4f} ({args.bc_epochs} "
              f"epochs in {time.perf_counter() - t0:.1f} s)", flush=True)
        ckpt.save_params_npz(str(out / "il"), "bc_warm", best)

    # ---- 2. SAC fine-tune ----------------------------------------------------
    if args.skip_rl:
        actor_params = best
        res = {"successes": 0, "episodes": 0}
        hist_note = "bc-only"
    else:
        cfg.train.pre_train = True
        cfg.train.pre_train_model = str(out / "il" / "bc_warm")
        cfg.sac.alpha = args.alpha_init
        cfg.sac.alpha_max = args.alpha_max
        cfg.sac.guidence_weight = args.guidence_weight
        cfg.sac.guidence_weight_final = args.gw_final
        cfg.sac.guidence_decay_steps = args.gw_decay_steps
        cfg.sac.prioritized_replay = args.per
        cfg.sac.nan_guard = True   # amplified guidance losses can overflow a
        #                            bf16 update; roll back instead of dying
        expert_glob = None
        if args.expert_buffer:
            cfg.train.pre_buffer = True
            expert_glob = demo_glob(demo_dir)
        t0 = time.perf_counter()
        if args.fused:
            from dgvit_tpu_torch.train.fused_train import train_fused

            cfg.train.seed = args.seed
            res_f = train_fused(cfg, out_dir=str(out / "rl"),
                                n_envs=args.n_envs, chunk=args.chunk,
                                rounds=10 ** 6, rounds_per_dispatch=5,
                                max_episodes=args.rl_episodes,
                                expert_glob=expert_glob,
                                world=args.train_world, device=device)
            res = {"successes": res_f["goals"],
                   "episodes": res_f["episodes"], "state": res_f["state"]}
            print(f"fused SAC: {res_f['goals']} goals / "
                  f"{res_f['episodes']} episodes / {res_f['updates']} "
                  f"updates in {time.perf_counter() - t0:.1f} s", flush=True)
        else:
            from dgvit_tpu_torch.train.train_rl import train

            env_rl = KinematicNavEnv(seed=args.seed, world=args.train_world,
                                     image_hw=hw)
            res = train(cfg, env_rl, out_dir=str(out / "rl"),
                        max_episodes=args.rl_episodes,
                        expert_glob=expert_glob, device=device)
            print(f"SAC: {res['successes']} goals in {res['episodes']} "
                  f"episodes, max mean reward {res['max_mean_reward']:.1f}, "
                  f"in {time.perf_counter() - t0:.1f} s", flush=True)
        actor_params = params_to_jax(res["state"].actor.state_dict())
        hist_note = (f"alpha0={args.alpha_init} expert={args.expert_buffer} "
                     + (f"amax={args.alpha_max} "
                        if args.alpha_max is not None else "")
                     + f"gw={args.guidence_weight}"
                     + (f"->{args.gw_final}@{args.gw_decay_steps}"
                        if args.gw_final is not None else "")
                     + (" per" if args.per else "")
                     + (f" d={args.dim}" if args.dim != 64 else "")
                     + (f" train_world={args.train_world}"
                        if args.train_world != "rrc" else ""))

    # ---- 3. evals: seen (rrc) vs unseen (hospital) ---------------------------
    results = {}
    for world in ("rrc", "hospital"):
        t0 = time.perf_counter()
        if args.vec_eval:
            r = run_eval_vec(cfg, actor_params,
                             max_episodes=args.eval_episodes, world=world,
                             out_dir=str(out / "eval"), name=f"gen_{world}",
                             device=device)
        else:
            ev = KinematicNavEnv(seed=7, world=world, image_hw=hw)
            r = run_eval(cfg, ev, actor_params,
                         max_episodes=args.eval_episodes,
                         out_dir=str(out / "eval"), name=f"gen_{world}",
                         device=device)
        results[world] = r["success_rate"]
        print(f"[{world}] success rate: {r['success_rate'] * 100:.1f}% "
              f"({r['successes']}/{args.eval_episodes}) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the deployment artifact: held-out and robustness evaluations read
    # <out>/final_actor.npz
    ckpt.save_params_npz(str(out), "final", actor_params)
    summary = {"rrc": results["rrc"], "hospital": results["hospital"],
               "bc_val_rmse": (float(min(hist["val"])) if hist else None),
               "sac_goals": res["successes"], "recipe": hist_note}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
