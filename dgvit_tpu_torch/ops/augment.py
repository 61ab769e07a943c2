"""Update-time image augmentation: the DrQ-v2 random shift.

Counterpart of `dgvit_tpu/ops/augment.py` (Yarats et al. 2021): each
frame, or each frame stack, is replicate-padded by `pad` pixels and
cropped back to its size at a per-sample integer offset in [0, 2 pad].
Plain PyTorch on the card (one `F.pad` and one gather); the result is a
copy of input pixels, so it is bit-equal to JAX's for the same offsets.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def random_shift(imgs: torch.Tensor, pad: int,
                 gen: Optional[torch.Generator] = None,
                 offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift a batch of frames by up to +-`pad` pixels on each axis.

    imgs: (B, H, W) or (B, C, H, W); every channel of a stack takes its
    sample's offset. offsets: (B, 2) crop offsets in [0, 2 pad] (row,
    column), else drawn from `gen`. pad=0 returns `imgs` itself."""
    if pad == 0:
        return imgs
    if pad < 0 or imgs.dim() not in (3, 4):
        raise ValueError(f"random_shift: pad {pad}, shape "
                         f"{tuple(imgs.shape)}")
    x = imgs[:, None] if imgs.dim() == 3 else imgs
    b, _, h, w = x.shape
    if offsets is None:
        offsets = torch.randint(0, 2 * pad + 1, (b, 2), generator=gen,
                                device=imgs.device)
    off = torch.as_tensor(offsets, device=imgs.device).long()
    xp = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    rows = (off[:, 0, None] + torch.arange(h, device=imgs.device))
    cols = (off[:, 1, None] + torch.arange(w, device=imgs.device))
    out = xp[torch.arange(b, device=imgs.device)[:, None, None, None],
             torch.arange(x.shape[1], device=imgs.device)[None, :, None,
                                                          None],
             rows[:, None, :, None], cols[:, None, None, :]]
    return out[:, 0] if imgs.dim() == 3 else out
