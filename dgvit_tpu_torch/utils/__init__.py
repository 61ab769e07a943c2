from dgvit_tpu_torch.utils.metrics import (MetricsLogger, Profiler,
                                           RewardCurve)
from dgvit_tpu_torch.utils.visualizer import AttentionVisualizer

__all__ = ["AttentionVisualizer", "MetricsLogger", "Profiler",
           "RewardCurve"]
