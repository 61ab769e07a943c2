from dgvit_tpu_torch.utils.metrics import (MetricsLogger, Profiler,
                                           RewardCurve)

__all__ = ["MetricsLogger", "Profiler", "RewardCurve"]
