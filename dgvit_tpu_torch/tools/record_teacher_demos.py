"""Record a trained policy's demonstrations on a procedural world
ensemble, on PyTorch and CUDA.

Counterpart of the repository's `tools/record_teacher_demos.py`: drive a
frozen teacher (`agents/teacher.SACTeacher`, e.g. the gw10 generalist)
through every member of a rand<K> ensemble (or one world preset) and keep
only the successful episodes (the goal's +200 reward seen) as a demo
corpus whose worlds match a student's training distribution. Demos land
in the reference npz layout (obs/act/goal/reward/next_obs/next_goal/done)
under <out>/<world>/teacher/ with policy-unit actions, which the
expert-guided trainers' `expert_glob` and
`examples/generalization_eval.py --demos` read.

    python -m dgvit_tpu_torch.tools.record_teacher_demos \\
        --actor artifacts/r3/gen_fused/gw10_winner_actor.npz \\
        --world rand8 --episodes 200 --out results/distill/demos

The teacher acts in fp32 (`Config()`'s compute dtype), one K1 launch a
step. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from dgvit_tpu_torch.agents.teacher import SACTeacher
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs.worlds import get_world, random_ensemble
from dgvit_tpu_torch.train.demo_record import record_episodes


def main(argv=None, base: Optional[Config] = None) -> list:
    """Record, filter and return the paths kept. `base`: the
    configuration of the teacher's actor (default the reference's,
    `Config()`)."""
    p = argparse.ArgumentParser(
        description="record a trained policy's demonstrations (PyTorch/CUDA)")
    p.add_argument("--actor", required=True,
                   help="<name>_actor.npz teacher params (save_params_npz)")
    p.add_argument("--world", default="rand8",
                   help="world preset or rand/randm/randh<K> ensemble spec; "
                        "episodes split evenly across ensemble members")
    p.add_argument("--world-seed", type=int, default=0,
                   help="ensemble stream seed (random_ensemble)")
    p.add_argument("--episodes", type=int, default=200)
    p.add_argument("--max-steps", type=int, default=200)
    p.add_argument("--out", default="results/distill/demos")
    p.add_argument("--keep-failures", action="store_true",
                   help="keep unsuccessful episodes too (default: only "
                        "episodes that reached the goal survive)")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)

    cfg = base or Config()
    d, f = os.path.split(args.actor)
    if not f.endswith("_actor.npz"):
        p.error(f"--actor must be a <name>_actor.npz file, got {f!r}")
    teacher = SACTeacher(cfg, f[: -len("_actor.npz")], d or ".",
                         device=args.device)
    source, to_env = teacher.as_pilot()

    try:
        members = list(random_ensemble(args.world, seed=args.world_seed))
    except ValueError:
        members = [get_world(args.world)]
    per = max(1, args.episodes // len(members))

    written = []
    for i, preset in enumerate(members):
        env = KinematicNavEnv(seed=1000 + i, world=preset,
                              image_hw=tuple(cfg.model.image_size))
        written += record_episodes(
            env, source, args.out, env_name=args.world, driver="teacher",
            episodes=per, max_steps=args.max_steps, start_index=i * per,
            action_to_env=to_env)

    kept = []
    for path in written:
        with np.load(path) as z:
            # +200 only fires at the goal (env_lab.py:170-181 scale)
            success = bool(z["reward"].max() >= 100.0)
        if success or args.keep_failures:
            kept.append(path)
        else:
            os.remove(path)
    print(f"teacher demos: kept {len(kept)} / dropped "
          f"{len(written) - len(kept)} "
          f"(of {len(written)} recorded over {len(members)} worlds) "
          f"-> {args.out}", flush=True)
    if not kept:
        raise SystemExit("no successful teacher episodes — corpus is empty")
    return kept


if __name__ == "__main__":
    main()
