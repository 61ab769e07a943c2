"""Attention visualizer: the reference's `get_local` cache of attention
maps (visualizer.py:3-42, hooked at simple_vit.py:61).

Counterpart of `dgvit_tpu/utils/visualizer.py`, with its API: `activate`,
`deactivate`, `clear`, `cache` (numpy (B, H, N, N) maps) and
`goal_token_attention` (each map's first row, the goal token's). The
model is built with `capture=True` (GoT, SimpleViT, GoTPolicy,
GoTQNetwork, the ViT actors): each of its attention blocks keeps the
softmax probabilities of its last forward (`captured`). Active, a call
runs the forward with capture on (the composed route) and copies every
block's maps into `cache`, keyed by the block's path as the JAX package
names it (its sow path, e.g. 'trans/transformer/block_0/attn/attn/0').
Inactive, capture is switched off and the call is the module's ordinary
forward, the kernels where they apply, and the cache is left alone.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from dgvit_tpu_torch.models.jax_io import params_from_jax


def jax_path(name: str) -> str:
    """A capturing block's module path -> the JAX package's sow path."""
    name = re.sub(r"(^|\.)transformer\.(?:blocks\.)?(\d+)$",
                  r"\1transformer/block_\2", name)
    return name.replace(".", "/") + "/attn/attn/0"


class AttentionVisualizer:
    """Usage:
        viz = AttentionVisualizer(GoTPolicy(capture=True, ...), params)
        viz.activate()
        out = viz(obs, goal)
        viz.cache -> {'trans/transformer/block_0/attn/attn/0':
                      np.ndarray (B, H, N, N), ...}

    params: optional weights to load into the model, the JAX package's
    tree (nested, or flat as `load_params_npz` returns it)."""

    def __init__(self, model: nn.Module,
                 params: Optional[Mapping[str, Any]] = None):
        if params is not None:
            model.load_state_dict(params_from_jax(params))
        self.model = model
        self.is_activate = False
        self.cache: Dict[str, np.ndarray] = {}
        self._blocks = {name: m for name, m in model.named_modules()
                        if hasattr(m, "captured")}
        self._switches = [m for m in model.modules()
                          if hasattr(m, "capture")]

    def activate(self):
        self.is_activate = True

    def deactivate(self):
        self.is_activate = False

    def clear(self):
        self.cache = {}

    def __call__(self, *args, **kwargs):
        for m in self._switches:
            m.capture = self.is_activate
        if not self.is_activate:
            with torch.no_grad():
                return self.model(*args, **kwargs)
        for m in self._blocks.values():
            m.captured = None
        with torch.no_grad():
            out = self.model(*args, **kwargs)
        for name, m in self._blocks.items():
            if m.captured is not None:
                self.cache[jax_path(name)] = m.captured.float().cpu().numpy()
        return out

    def goal_token_attention(self) -> Dict[str, np.ndarray]:
        """Each block's goal-token row (x[:, 0]): (B, H, N) maps."""
        return {k: v[..., 0, :] for k, v in self.cache.items()
                if v.ndim == 4}
