"""Tanh-squashed Gaussian policy distribution with the reference's
log-prob. Counterpart of `dgvit_tpu/models/distributions.py`:

    x_t ~ N(mean, std);  y_t = tanh(x_t)
    action   = y_t * scale + bias
    log_prob = Normal(mean, std).log_prob(x_t)
               - log(scale * (1 - y_t^2) + 1e-6), summed over action dims
    mean_act = tanh(mean) * scale + bias

The LOG_SIG clamp [-20, 2] is applied by callers on log_std before this
module. `deterministic_sample` is the deterministic actors' exploration. The standard-normal draw comes from an explicit `torch.Generator`,
or is given as `noise`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0
EPSILON = 1e-6
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class TanhGaussianSample(NamedTuple):
    action: torch.Tensor     # (B, A) squashed, scaled sample
    log_prob: torch.Tensor   # (B, 1)
    mean: torch.Tensor       # (B, A) deterministic (tanh of mean), scaled


def clamp_log_std(log_std: torch.Tensor) -> torch.Tensor:
    return torch.clamp(log_std, LOG_SIG_MIN, LOG_SIG_MAX)


def normal_log_prob(x: torch.Tensor, mean: torch.Tensor,
                    std: torch.Tensor) -> torch.Tensor:
    """torch.distributions.Normal.log_prob:
    -((x - mean)^2) / (2 var) - log(std) - log(sqrt(2 pi))."""
    var = std * std
    return -torch.square(x - mean) / (2.0 * var) - torch.log(std) \
        - _LOG_SQRT_2PI


def sample(mean: torch.Tensor, log_std: torch.Tensor,
           generator: Optional[torch.Generator] = None,
           action_scale: float = 1.0, action_bias: float = 0.0,
           noise: Optional[torch.Tensor] = None) -> TanhGaussianSample:
    """Reparameterized sample (rsample), its log-prob and the deterministic
    mean action. `noise` overrides the standard-normal draw."""
    std = torch.exp(log_std)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    else:
        noise = noise.to(device=mean.device, dtype=mean.dtype)
    x_t = mean + std * noise
    y_t = torch.tanh(x_t)
    action = y_t * action_scale + action_bias
    log_prob = normal_log_prob(x_t, mean, std)
    log_prob = log_prob - torch.log(
        action_scale * (1.0 - torch.square(y_t)) + EPSILON)
    log_prob = log_prob.sum(dim=1, keepdim=True)
    mean_action = torch.tanh(mean) * action_scale + action_bias
    return TanhGaussianSample(action, log_prob, mean_action)


def deterministic_sample(mean: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         noise_std: float = 0.1, noise_clip: float = 0.25,
                         noise: Optional[torch.Tensor] = None
                         ) -> TanhGaussianSample:
    """A deterministic actor's exploration: its (already squashed) action
    plus clip(N(0, 1) x noise_std, +-noise_clip), log_prob 0 (the
    reference's), and the action itself as the mean. `noise` (raw
    standard normal draws) overrides the generator's."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    noise = torch.clamp(noise.to(device=mean.device, dtype=mean.dtype)
                        * noise_std, -noise_clip, noise_clip)
    return TanhGaussianSample(mean + noise,
                              torch.zeros(mean.shape[:1] + (1,),
                                          dtype=mean.dtype,
                                          device=mean.device), mean)
