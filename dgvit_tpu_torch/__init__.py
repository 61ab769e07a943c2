"""PyTorch / CUDA port of dgvit_tpu for NVIDIA Hopper (H100).

Serving: the trained GoT actor answers deterministic actions through one
hand-written CUDA kernel for the whole trunk
(`ops/got_megakernel.got_forward_fused`). Training: `agents.SACAgent`
takes the plain SAC update through hand-written forward and backward
block kernels (`ops/fused_transformer.py`, `ops/cls_block.py`) and the
trunk kernel started from an embedded stream. Ingest:
`ops.preprocess_depth_auto` turns raw 512x640 depth frames into policy
states through a hand-written fused kernel (`ops/fused_preprocess.py`).
The env loop: `train.train_rl.train` trains on the host kinematic env
with the C++ replay buffer, and `train.evaluate.run_eval` evaluates. The
package imports torch and numpy only; it shares no code with the JAX
package it mirrors.

Layout follows the JAX package (`models/`, `ops/`, `agents/`, `replay/`,
`envs/`, `train/`, `serve/`, `core/`, `utils/`) and
keeps its public tensor layout: images (B, H, W), goal (B, 2), latent
(B, 64). Entry points run on CUDA unless the caller passes device="cpu".
"""

from dgvit_tpu_torch.config import Config

__all__ = ["Config"]
