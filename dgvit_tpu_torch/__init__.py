"""PyTorch / CUDA port of dgvit_tpu for NVIDIA Hopper (H100).

Serving: the trained GoT actor answers deterministic actions through one
hand-written CUDA kernel for the whole trunk
(`ops/got_megakernel.got_forward_fused`). Training: `agents.SACAgent`
takes the plain SAC update through hand-written forward and backward
block kernels (`ops/fused_transformer.py`, `ops/cls_block.py`) and the
trunk kernel started from an embedded stream. The package imports torch
and numpy only; it shares no code with the JAX package it mirrors.

Layout follows the JAX package (`models/`, `ops/`, `serve/`, `core/`) and
keeps its public tensor layout: images (B, H, W), goal (B, 2), latent
(B, 64). Entry points run on CUDA unless the caller passes device="cpu".
"""

from dgvit_tpu_torch.config import Config

__all__ = ["Config"]
