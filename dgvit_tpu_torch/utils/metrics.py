"""Observability: metrics logging, reward curves, profiler hooks.

Counterpart of `dgvit_tpu/utils/metrics.py`: matplotlib reward PNGs
(main.py:118-128), npy reward dumps (main.py:353,406), append-only txt
summaries (main.py:412-417, testing.py:146-150), structured JSONL, and
`torch.profiler` traces."""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import List


class RewardCurve:
    """Rolling-20 mean like main.py:341-342, with npy + optional png dumps."""

    def __init__(self, window: int = 20):
        self.window = window
        self.rewards: List[float] = []
        self.means: List[float] = []

    def append(self, episode_reward: float) -> float:
        self.rewards.append(float(episode_reward))
        mean = float(sum(self.rewards[-self.window:]) /
                     min(len(self.rewards), self.window))
        self.means.append(mean)
        return mean

    @property
    def max_mean(self) -> float:
        return max(self.means) if self.means else float("-inf")

    def save_npy(self, path: str):
        import numpy as np

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(path, np.asarray(self.means), allow_pickle=True,
                fix_imports=True)

    def save_png(self, path: str, title: str = ""):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # pragma: no cover
            return
        import numpy as np

        fig = plt.figure()
        plt.title(title)
        plt.xlabel("Episode")
        plt.ylabel("Overall Reward")
        plt.plot(np.arange(len(self.rewards)), self.rewards)
        plt.plot(np.arange(len(self.means)), self.means)
        plt.tight_layout()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        plt.savefig(path)
        plt.close(fig)


class MetricsLogger:
    """Structured JSONL metrics + the reference's append-only txt summaries."""

    def __init__(self, directory: str, run_name: str = "run"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = self.dir / f"{run_name}.jsonl"
        self.t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": step, "wall_s": round(time.time() - self.t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        with open(self.jsonl, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def last(self) -> dict:
        """The last record of the JSONL, or {} when there is none (a
        resumed run's counters)."""
        if not self.jsonl.exists():
            return {}
        with open(self.jsonl) as f:
            lines = [ln for ln in f if ln.strip()]
        return json.loads(lines[-1]) if lines else {}

    def append_txt(self, filename: str, text: str):
        """main.py:412-417 / testing.py:146-150 style run summaries."""
        with open(self.dir / filename, "a") as f:
            f.write(text)


class Profiler:
    """`torch.profiler` trace wrapper (host and CUDA activity): a Chrome
    trace lands in `log_dir`/trace.json when the block ends, and
    `key_averages()` gives the time by operator and kernel."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def key_averages(self):
        return self._prof.key_averages()

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(
            os.path.join(self.log_dir, "trace.json"))
        return False
