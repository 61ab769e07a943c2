"""Initializers with the reference's PyTorch semantics, so a fresh model is
distributionally the same as one built by the JAX package:

  * Linear kernels: Xavier-uniform, gain 1;
  * Linear biases: the torch default U(-1/sqrt(fan_in), +1/sqrt(fan_in));
  * Conv2d kernels and biases: the torch default, the same uniform bound
    with fan_in = in_ch * kh * kw;
  * positional embeddings: standard normal.

Every function draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def torch_linear_bias_(t: torch.Tensor, fan_in: int,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def normal_(t: torch.Tensor, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, 1.0, generator=generator)


def init_linear_(layer: torch.nn.Linear,
                 generator: Optional[torch.Generator] = None) -> None:
    """Reference init for an nn.Linear (weight stored (out, in))."""
    fan_out, fan_in = layer.weight.shape
    xavier_uniform_(layer.weight, fan_in, fan_out, generator)
    if layer.bias is not None:
        torch_linear_bias_(layer.bias, fan_in, generator)


def init_conv_(layer: torch.nn.Conv2d,
               generator: Optional[torch.Generator] = None) -> None:
    """The torch Conv2d default (the JAX package's `torch_conv_kernel` and
    `torch_conv_bias`): kaiming_uniform(a=sqrt(5)) for the kernel, which is
    U(+-1/sqrt(fan_in)) with fan_in = in_ch * kh * kw, and the same bound
    for the bias."""
    fan_in = layer.weight[0].numel()
    torch_linear_bias_(layer.weight, fan_in, generator)
    if layer.bias is not None:
        torch_linear_bias_(layer.bias, fan_in, generator)
