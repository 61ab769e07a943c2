"""The sensor-fault robustness study of a full-geometry actor, on PyTorch
and CUDA.

Counterpart of the repository's `tools/robustness_sweep.py`: the
reference's perturbation suite (env_lab.py:33-90: Gaussian noise, blur,
pixel and contiguous occlusion, greying) as a 16-point grid, run per
world through the sweep path of `run_eval_vec`: one policy, one set of
consts and one reset per world, every point `env.max_steps` steps of
all episodes as lanes on the card (one K1 launch a step), the fault
realizations paired across points. Writes `sweep.jsonl` (one row a
point and world, the JAX tool's fields) and `sweep.md` (a table a
world), which `tools/robustness_compare.py` reads as it reads the JAX
tool's.

    python -m dgvit_tpu_torch.tools.robustness_sweep \\
        --actor artifacts/r5/drqc_rand8_amin_actor.npz \\
        --worlds rrc hospital --episodes 100 --out results/robustness

Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.train.evaluate import checkpoint_actor, run_eval_vec

# sigma = 50/255 is the reference's own training-time noise
# (env_lab.py:78-90); blur blends toward the 5x5-blurred frame;
# patch_occlusion zeroes one random rectangle of that area fraction
GRID = ([{}] +
        [{"obs_noise": s} for s in (0.1, 50 / 255, 0.3, 0.5)] +
        [{"blur": b} for b in (0.5, 1.0)] +
        [{"occlusion": f} for f in (0.25, 0.5, 0.75)] +
        [{"patch_occlusion": f} for f in (0.1, 0.25, 0.5)] +
        [{"greying": g} for g in (0.3, 0.6, 0.9)])
KNOBS = ("obs_noise", "blur", "occlusion", "patch_occlusion", "greying")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="sensor-fault robustness sweep of a trained actor "
                    "(PyTorch/CUDA)")
    p.add_argument("--actor", default=None,
                   help="actor params npz (save_params_npz output of either "
                        "package)")
    p.add_argument("--checkpoint", default=None,
                   help="train-state checkpoint of the port's trainers (a "
                        "step_N or checkpoints/ directory) instead of an "
                        "actor npz")
    p.add_argument("--worlds", nargs="+", default=["rrc", "hospital"])
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--out", default="results/robustness")
    p.add_argument("--config", default=None)
    p.add_argument("--export-actor", default=None,
                   help="also save the loaded actor params to this npz")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    return p


def main(argv=None) -> list:
    """Run the grid on every world; returns the rows written."""
    p = parser()
    args = p.parse_args(argv)
    if bool(args.actor) == bool(args.checkpoint):
        p.error("exactly one of --actor / --checkpoint is required")

    cfg = Config.from_yaml(args.config) if args.config else Config()
    cfg.model.compute_dtype = "bfloat16"
    if args.checkpoint:
        params, name = checkpoint_actor(cfg, args.checkpoint)
    else:
        params, name = (ckpt.load_params_npz(args.actor),
                        Path(args.actor).stem)
    if args.export_actor:
        d = Path(args.export_actor)
        ckpt.save_params_npz(str(d.parent), d.name.removesuffix(".npz")
                             .removesuffix("_actor"), params)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    rows = []
    with open(out_dir / "sweep.jsonl", "w") as fh:
        for world in args.worlds:
            t0 = time.perf_counter()
            reports = run_eval_vec(cfg, params, args.episodes, world,
                                   str(out_dir), name, sweep=GRID,
                                   device=args.device)
            print(f"{world}: {len(GRID)} points x {cfg.env.max_steps} steps"
                  f" of {args.episodes} lanes in "
                  f"{time.perf_counter() - t0:.1f} s (host clock)",
                  flush=True)
            for rep in reports:
                row = {"actor": name, "world": world,
                       "episodes": args.episodes,
                       **{k: rep[k] for k in KNOBS},
                       "success_rate": rep["success_rate"],
                       "successes": rep["successes"],
                       "collisions": rep["collisions"]}
                rows.append(row)
                fh.write(json.dumps(row) + "\n")
                fh.flush()
                print(json.dumps(row), flush=True)

    # a markdown table a world
    with open(out_dir / "sweep.md", "w") as fh:
        fh.write(f"# Robustness sweep — {name}, {args.episodes} eps/point\n")
        for world in args.worlds:
            fh.write(f"\n## {world}\n\n| fault | success | collisions |\n"
                     "|---|---|---|\n")
            for row in rows:
                if row["world"] != world:
                    continue
                fault = ", ".join(f"{k}={row[k]:.3g}" for k in KNOBS
                                  if row[k]) or "clean"
                fh.write(f"| {fault} | {row['success_rate'] * 100:.0f}% "
                         f"| {row['collisions']} |\n")
    print(f"wrote {out_dir}/sweep.jsonl and sweep.md", flush=True)
    return rows


if __name__ == "__main__":
    main()
