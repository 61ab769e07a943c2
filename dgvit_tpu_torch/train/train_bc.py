"""Offline imitation learning: Imitation_learning.py __main__ (:721-845)
as a command line, the counterpart of `dgvit_tpu/train/train_bc.py`:
glob the demos, fit BC, save the lowest-validation-loss actor
(`<name>_actor.npz`, the JAX package's layout) and the loss curves
(`<name>_loss_curves.npy`, a pickled {"train", "val"} dict).

    python -m dgvit_tpu_torch.train.train_bc --data-glob 'Data/*/*/*.npz' \\
        [--epochs 600 --batch-size 32 --device cpu]

Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from dgvit_tpu_torch.agents.bc import BCTrainer, il_policy
from dgvit_tpu_torch.core import checkpoint as ckpt


def load_bc_dataset(pattern: str):
    """(obs, act, goal) of every demo npz matching `pattern`, concatenated
    in natural order (plain sorted order without natsort)."""
    try:
        from natsort import natsorted
        files = natsorted(glob.glob(pattern))
    except ImportError:
        files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(pattern)
    obs, act, goal = [], [], []
    for f in files:
        with np.load(f) as d:
            obs.append(d["obs"])
            act.append(d["act"])
            goal.append(d["goal"])
    return (np.concatenate(obs), np.concatenate(act), np.concatenate(goal))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="dgvit_tpu_torch imitation learning (PyTorch/CUDA)")
    p.add_argument("--data-glob", required=True)
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--block", type=int, default=4)
    p.add_argument("--head", type=int, default=4)
    p.add_argument("--l-f-size", type=int, default=32)
    p.add_argument("--out", default="pytorch_models")
    p.add_argument("--name", default="gtrl")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)

    obs, act, goal = load_bc_dataset(args.data_glob)
    print(f"dataset: obs={obs.shape} act={act.shape} goal={goal.shape}")

    trainer = BCTrainer(
        model=il_policy(args.block, args.head, args.l_f_size),
        lr=args.lr, batch_size=args.batch_size, seed=args.seed,
        device=args.device)
    best, hist = trainer.fit(obs, goal, act, epochs=args.epochs, verbose=True)

    os.makedirs(args.out, exist_ok=True)
    path = ckpt.save_params_npz(args.out, args.name, best)
    np.save(os.path.join(args.out, f"{args.name}_loss_curves.npy"),
            {"train": hist["train"], "val": hist["val"]}, allow_pickle=True)
    print(f"best val loss {min(hist['val']):.4f} -> {path}")


if __name__ == "__main__":
    main()
