"""Tanh-Gaussian policy helpers. Only the log-std clamp is on the serving
path (LOG_SIG [-20, 2])."""

from __future__ import annotations

import torch

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0


def clamp_log_std(log_std: torch.Tensor) -> torch.Tensor:
    return torch.clamp(log_std, LOG_SIG_MIN, LOG_SIG_MAX)
