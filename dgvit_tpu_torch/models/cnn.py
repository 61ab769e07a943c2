"""The CNN trunk of the convolutional actors and critic.

Counterpart of `dgvit_tpu/models/cnn.py`: three 5x5 stride-2 VALID
convolutions with 16, 64 and 256 channels, each followed by a ReLU, then
the global mean over the spatial grid (the reference's
AdaptiveAvgPool2d((1, 1))), (B, 256). A 128x160 frame gives 62x78, then
29x37, then 13x17 before the mean.

Layout. The JAX module is NHWC with HWIO kernels; here the convolutions
are NCHW with OIHW weights (an nn.Conv2d's), so a JAX kernel comes across
as `k.transpose(3, 2, 0, 1)` (`models/jax_io.py`). The inputs keep the
JAX module's conventions: a (B, H, W) frame gets a channel axis, and a
4-D input is a (B, H, W, C) stack (the `Deterministic` actor's 4-frame
stack), permuted to (B, C, H, W) here.

Precision. `TorchConv` computes in its compute dtype (None: the input's),
as the JAX module does: operands cast to it, the convolution's output in
it, then the bias added in it. The convolutions are cuDNN's through
`torch.nn.functional.conv2d`, as the JAX package leaves them to XLA
outside any Pallas kernel. On the card a bf16 convolution runs on the
tensor cores with fp32 accumulation; an fp32 one runs on TF32 tensor
cores (a 10-bit mantissa) while `torch.backends.cudnn.allow_tf32` is
True, which is PyTorch's default, and in full fp32 when it is False, as
chip_smoke.py sets it (its phase 23 prints the difference between the
two).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dgvit_tpu_torch.models import initializers as init


class TorchConv(nn.Conv2d):
    """VALID convolution with the torch Conv2d default init, computed in a
    compute dtype (None: the input's dtype)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 5,
                 stride: int = 2, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, features, kernel, stride=stride)
        self.compute_dtype = dtype
        init.init_conv_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), stride=self.stride)
        return y + self.bias.to(dt)[:, None, None]


class ConvTrunk(nn.Module):
    """conv(5, s2) -> ReLU, three times, then the global mean: (B, 256)."""

    def __init__(self, in_channels: int = 1,
                 features: Sequence[int] = (16, 64, 256),
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = (in_channels, *features)
        for i, f in enumerate(features):
            setattr(self, f"conv{i + 1}",
                    TorchConv(chans[i], f, dtype=dtype, generator=generator))
        self.depth = len(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W) or (B, H, W, C) -> (B, features[-1])."""
        x = x[:, None] if x.dim() == 3 else x.permute(0, 3, 1, 2)
        for i in range(self.depth):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return x.mean(dim=(2, 3))
