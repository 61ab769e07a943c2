"""Attention maps over a live episode: the reference's headline
introspection feature (visualizer.py get_local hooked at
simple_vit.py:61; the attention heatmaps of its README), Gazebo-free.

Counterpart of the JAX package's `examples/attention_maps.py`. A trained
actor drives one kinematic episode with its deterministic action while
`utils/visualizer.AttentionVisualizer` over `GoTPolicy(capture=True)`
keeps every block's softmax maps (`collect_episode`, on the card unless
--device cpu); then `render` writes a PNG grid: the depth frame with the
goal token's attention of each block laid over it (the goal token's row:
where the policy looks to decide its next command). The collection and
the rendering are apart: rendering needs matplotlib, which is imported
only there and named in the ImportError when it is missing.

    python -m dgvit_tpu_torch.examples.attention_maps \
        [--actor artifacts/r3/gen_fused/gw10_winner_actor.npz] \
        [--steps 40 --every 8 --world rrc --out results/attention] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.models.policies import build_actor
from dgvit_tpu_torch.utils.visualizer import AttentionVisualizer


def capture_policy(cfg: Config, params,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> AttentionVisualizer:
    """An active visualizer over the config's fp32 actor built with
    capture (`build_actor`), carrying `params` (a JAX tree, nested or
    flat), on `device`."""
    policy = build_actor(cfg, capture=True)
    viz = AttentionVisualizer(policy, params)
    policy.to(resolve_device(device)).eval()
    viz.activate()
    return viz


def collect_episode(viz: AttentionVisualizer, env, cfg: Config,
                    steps: int) -> List[dict]:
    """Up to `steps` env steps of the deterministic action tanh(mean),
    each step's record: the frame (H, W), the goal (2,), the action (2,)
    and every block's maps of the frame, (H, N, N) by sow path."""
    dev = next(viz.model.parameters()).device
    e = cfg.env
    r = env.reset()
    obs, goal = np.squeeze(r.state), r.to_goal
    out = []
    for t in range(steps):
        viz.clear()
        o = torch.as_tensor(obs[None], dtype=torch.float32, device=dev)
        g = torch.as_tensor(np.asarray(goal[:2], np.float32)[None],
                            device=dev)
        mean, _ = viz(o, g)
        a = torch.tanh(mean.float())[0].cpu().numpy()
        out.append({"frame": obs.copy(), "goal": np.asarray(
            goal[:2], np.float32), "action": a,
            "maps": {k: v[0] for k, v in viz.cache.items()}})
        s = env.step([(a[0] + 1) * e.linear_cmd_scale,
                      a[1] * e.angular_cmd_scale], t)
        obs, goal = np.squeeze(s.state), s.to_goal
        if s.done:
            break
    return out


def goal_rows(maps: dict, grid) -> List[np.ndarray]:
    """Each block's goal-token row over the patch tokens, averaged over
    the heads, as the patch grid (gh, gw), in block order."""
    return [maps[k].mean(0)[0, 1:].reshape(grid) for k in sorted(maps)]


def render(records: List[dict], dest: Union[str, Path], every: int,
           patch_size) -> Path:
    """The PNG grid of every `every`-th record: the frame, then each
    block's goal-token attention over it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("render needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ph, pw = patch_size
    rows = records[::every]
    grid = (rows[0]["frame"].shape[0] // ph, rows[0]["frame"].shape[1] // pw)
    n_blocks = len(rows[0]["maps"])
    fig, axes = plt.subplots(len(rows), n_blocks + 1,
                             figsize=(2.2 * (n_blocks + 1), 1.9 * len(rows)),
                             squeeze=False)
    for i, rec in enumerate(rows):
        frame, a = rec["frame"], rec["action"]
        axes[i][0].imshow(frame, cmap="gray")
        axes[i][0].set_ylabel(f"t={i * every}", fontsize=8)
        axes[i][0].set_title(f"v={a[0]:+.2f} w={a[1]:+.2f}", fontsize=7)
        for j, mp in enumerate(goal_rows(rec["maps"], grid)):
            up = np.kron(mp, np.ones((ph, pw)))   # patch grid -> pixels
            axes[i][j + 1].imshow(frame, cmap="gray")
            axes[i][j + 1].imshow(up, cmap="inferno", alpha=0.55)
            if i == 0:
                axes[i][j + 1].set_title(f"block {j} goal-attn", fontsize=7)
    for ax in fig.axes:
        ax.set_xticks([]), ax.set_yticks([])
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(dest, dpi=110)
    plt.close(fig)
    return dest


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--actor",
                   default="artifacts/r3/gen_fused/gw10_winner_actor.npz")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--every", type=int, default=8,
                   help="snapshot cadence (env steps between rows)")
    p.add_argument("--world", default="rrc")
    p.add_argument("--out", default="results/attention")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)

    cfg = Config()
    viz = capture_policy(cfg, ckpt.load_params_npz(args.actor), args.device)
    env = KinematicNavEnv(seed=11, world=args.world,
                          image_hw=tuple(cfg.model.image_size))
    records = collect_episode(viz, env, cfg, args.steps)
    dest = render(records, Path(args.out) / "goal_attention.png",
                  args.every, cfg.model.patch_size)
    n = len(records[::args.every])
    print(f"wrote {dest} ({n} timesteps x {len(records[0]['maps'])} "
          f"blocks)")
    return dest


if __name__ == "__main__":
    main()
