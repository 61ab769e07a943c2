"""Proportional prioritized replay on the device, for the on-device loop.

Counterpart of `dgvit_tpu/replay/device_per.py`, with the C++ buffer's
semantics (`replay/csrc/replay.cpp`, the cpprb contract): priorities are
stored as p^alpha with alpha 0.6, new rows are written at
max_priority^alpha, draws are uniform proportional (not stratified), the
importance weights are (p / total * stored)^-beta normalized by the
lowest-priority row's weight, and `per_update(|td| + eps)` raises the
running max.

No sum-tree: a (cap,) cumsum and a batched searchsorted on the card, a few
small launches an update and no read of the card by the host. `stored`
(the ring's fill) is the ring's host cursor, clamped to the capacity.

Two points where the card differs from the CPU and from XLA:
  * duplicates: a proportional draw repeats rows once priorities are
    skewed, and `prios[idx] = v` on CUDA keeps an arbitrary one of the
    duplicates' values. `per_update` keeps the last occurrence, as the C++
    loop and XLA's CPU scatter do: each row takes the value of the largest
    batch position that names it (a scatter of positions by amax, then a
    gather), so every duplicate writes the same value.
  * rounding: the CUDA cumsum is a parallel scan; where u * total lies
    within a few ulps of a boundary of the cumulative sums the drawn index
    may be the neighbour of the CPU's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from dgvit_tpu_torch.core.device import resolve_device

ALPHA = 0.6          # priority exponent (replay.cpp, cpprb's default)


@dataclass
class DevicePER:
    prios: torch.Tensor   # (cap,) fp32: p^alpha; 0 marks an empty slot
    max_p: torch.Tensor   # 0-dim fp32: the running raw max priority


def per_init(capacity: int,
             device: Optional[Union[str, torch.device]] = None) -> DevicePER:
    """Every slot empty, the running max at 1. On the card unless
    device='cpu'."""
    dev = resolve_device(device)
    return DevicePER(prios=torch.zeros(capacity, dtype=torch.float32,
                                       device=dev),
                     max_p=torch.ones((), dtype=torch.float32, device=dev))


def per_on_write(per: DevicePER, idx: torch.Tensor) -> DevicePER:
    """New rows `idx` take the max priority (replay.cpp: add), in place."""
    idx = torch.as_tensor(idx, device=per.prios.device).long()
    per.prios.index_put_((idx,), per.max_p ** ALPHA)
    return per


def per_sample(per: DevicePER, gen: Optional[torch.Generator], batch: int,
               stored: int, beta: float = 0.4,
               u: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (batch,) int64, importance weights (batch,) fp32):
    proportional draws and the cpprb weights. `u`: the (batch,) uniform
    draws in [0, 1), else drawn from `gen`."""
    prios = per.prios
    cap = prios.shape[0]
    c = torch.cumsum(prios, 0)
    total = c[-1]
    if u is None:
        u = torch.rand(batch, generator=gen, device=prios.device)
    u = torch.as_tensor(u, dtype=torch.float32, device=prios.device)
    idx = torch.clamp(torch.searchsorted(c, u * total, right=True), 0,
                      cap - 1)
    safe_total = torch.clamp(total, min=1e-30)
    p = prios[idx] / safe_total
    min_p = torch.min(torch.where(prios > 0, prios,
                                  torch.full_like(prios, float("inf"))))
    stored_f = float(min(int(stored), cap))
    max_w = (min_p / safe_total * stored_f) ** -beta
    w = (p * stored_f) ** -beta / torch.clamp(max_w, min=1e-30)
    return idx, w.float()


def last_wins(idx: torch.Tensor, values: torch.Tensor,
              capacity: int) -> torch.Tensor:
    """`values` with each duplicate of a row replaced by the value at the
    row's last batch position, so that a scatter of them keeps the last
    occurrence whatever order the device writes in."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.zeros(capacity, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, idx, pos, reduce="amax", include_self=False)
    return values[last[idx]]


def per_update(per: DevicePER, idx: torch.Tensor,
               raw_prio: torch.Tensor) -> DevicePER:
    """update_priorities(|td| + eps) (replay.cpp), in place: rows `idx`
    take raw_prio^alpha, the last occurrence winning among duplicates,
    and the running max rises to the batch's max."""
    idx = torch.as_tensor(idx, device=per.prios.device).long()
    raw = torch.as_tensor(raw_prio, device=per.prios.device).float()
    vals = last_wins(idx, raw ** ALPHA, per.prios.shape[0])
    per.prios.index_put_((idx,), vals)
    per.max_p.copy_(torch.maximum(per.max_p, torch.max(raw)))
    return per
