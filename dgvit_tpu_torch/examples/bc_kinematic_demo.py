"""Behaviour cloning end to end, on PyTorch and CUDA: record scripted-pilot
demonstrations in the kinematic env, clone the live GoT policy on them
(the attention_imitating.py workflow: BC directly on the DRL actor), and
evaluate goal-reaching success beside the scripted pilot's.

Counterpart of the JAX package's `examples/bc_kinematic_demo.py`. The
demos land under <out>/Data/RRC/torch/ and the fit reads the files
it recorded; the policy is the flagship actor's shape in fp32, fitted at
batch 32, then `run_eval` on unseen start/goal pairs.

    python -m dgvit_tpu_torch.examples.bc_kinematic_demo [--episodes 40]

Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import functools
import tempfile
from pathlib import Path
from typing import Optional

from dgvit_tpu_torch.config import Config


def main(argv=None, base: Optional[Config] = None) -> dict:
    """`base`: the configuration of the policy and the env (default the
    reference's). Returns run_eval's report."""
    p = argparse.ArgumentParser(
        description="behaviour cloning in the kinematic env (PyTorch/CUDA)")
    p.add_argument("--episodes", type=int, default=40)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--eval-episodes", type=int, default=20)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)

    from dgvit_tpu_torch.agents.bc import BCTrainer
    from dgvit_tpu_torch.core.device import resolve_device
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.models.policies import GoTPolicy
    from dgvit_tpu_torch.train.demo_record import (policy_unit_pilot,
                                                   record_episodes,
                                                   scripted_pilot)
    from dgvit_tpu_torch.train.evaluate import run_eval
    from dgvit_tpu_torch.train.train_bc import load_bc_dataset

    device = resolve_device(args.device)
    out = Path(args.out or tempfile.mkdtemp(prefix="bc_demo_"))
    print(f"workdir: {out}")

    # 1. scripted-pilot demonstrations in deployment action units
    cfg = base or Config()
    m = cfg.model
    hw = tuple(m.image_size)
    source, to_env = policy_unit_pilot(cfg)
    paths = record_episodes(
        KinematicNavEnv(seed=0, image_hw=hw), source, str(out / "Data"),
        episodes=args.episodes, max_steps=200, action_to_env=to_env)
    if not paths:
        raise SystemExit("the scripted pilot recorded no episode")
    obs, act, goal = load_bc_dataset(str(Path(paths[0]).parent / "*.npz"))
    print(f"recorded {len(paths)} episodes, {obs.shape[0]} transitions")

    # 2. behaviour-clone the live GoT policy (the config's actor, fp32)
    model = functools.partial(
        GoTPolicy, block=m.block, head=m.head, l_f_size=m.latent_size,
        dim_head=m.dim_head, mlp_dim=m.mlp_dim, image_size=hw,
        patch_size=tuple(m.patch_size))
    trainer = BCTrainer(model=model, batch_size=32, seed=1, device=device)
    best, hist = trainer.fit(obs, goal, act, epochs=args.epochs,
                             to_chw=False)
    print(f"BC: train {hist['train'][0]:.4f} -> {hist['train'][-1]:.4f}, "
          f"best val {min(hist['val']):.4f}")

    # 3. evaluate the cloned policy on unseen start/goal pairs
    res = run_eval(cfg, KinematicNavEnv(seed=123, image_hw=hw), best,
                   max_episodes=args.eval_episodes, out_dir=str(out),
                   device=device)

    # the scripted pilot on the same episodes
    ref_env = KinematicNavEnv(seed=123, image_hw=hw)
    wins = 0
    for _ in range(args.eval_episodes):
        r = ref_env.reset()
        g = r.to_goal
        for t in range(cfg.env.max_steps):
            s = ref_env.step(scripted_pilot(None, g, t), t)
            g = s.to_goal
            if s.done:
                wins += int(s.target)
                break
    print(f"cloned policy success: {res['success_rate'] * 100:.0f}% "
          f"({res['successes']}/{args.eval_episodes}); "
          f"scripted pilot: {wins * 100 // args.eval_episodes}% "
          f"({wins}/{args.eval_episodes})")
    return res


if __name__ == "__main__":
    main()
