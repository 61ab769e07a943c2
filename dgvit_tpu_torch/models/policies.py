"""The GoT actor and twin-Q critic. Counterparts of
`dgvit_tpu/models/policies.py::GoTPolicy` and `GoTQNetwork`.

GoTPolicy: goal -> fc_embed (no ReLU) as the goal token; GoT latent ->
relu(fc1 64->128) -> relu(fc2 128->128) -> mean and clamped log_std.
GoTQNetwork: goal -> relu(fc_embed) as the goal token; GoT latent with the
action appended -> twin heads relu(fc1 ->128) -> relu(fc2 128->32) -> fc3
and relu(fc11) -> relu(fc21) -> fc31, each (B, action_dim). The heads run
in the compute dtype, as the JAX package's TorchLinear does; the trunk's
`deterministic` and `inference` flags select its route (`models/got.py`).

`build_actor` and `build_critic` read the JAX package's opt-in switch
`DGVIT_TRUNK_GRAD=1` once, when they build a network: its gradient-bearing
trunk passes then go forward through K4 and backward through the
whole-trunk kernel K6 instead of the per-block kernels. As in the JAX
package, `model.dropout` of a config is not handed on to the networks
(only a `GoT(dropout > 0)` built directly takes the composed route for
that reason).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dgvit_tpu_torch.models.distributions import clamp_log_std
from dgvit_tpu_torch.models.got import GoT
from dgvit_tpu_torch.models.layers import Linear


class GoTPolicy(nn.Module):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 block: int = 4, head: int = 4, l_f_size: int = 64,
                 dim_head: int = 64, mlp_dim: int = 2048,
                 image_size: Tuple[int, int] = (128, 160),
                 patch_size: Tuple[int, int] = (16, 20),
                 patch_mode: str = "2d", channels: int = 1,
                 final_norm: str = "rms", emb_dropout: float = 0.1,
                 attn_impl: str = "auto", trunk_grad: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.fc_embed = Linear(pstate_dim, l_f_size, dtype=dtype, generator=g)
        self.trans = GoT(image_size=image_size, patch_size=patch_size,
                         dim=l_f_size, depth=block, heads=head,
                         dim_head=dim_head, mlp_dim=mlp_dim,
                         channels=channels, patch_mode=patch_mode,
                         final_norm=final_norm, emb_dropout=emb_dropout,
                         attn_impl=attn_impl, trunk_grad=trunk_grad,
                         dtype=dtype, generator=g)
        self.fc1 = Linear(l_f_size, 128, dtype=dtype, generator=g)
        self.fc2 = Linear(128, 128, dtype=dtype, generator=g)
        self.mean_linear = Linear(128, action_dim, dtype=dtype, generator=g)
        self.log_std_linear = Linear(128, action_dim, dtype=dtype,
                                     generator=g)

    def forward(self, istate: torch.Tensor, pstate: torch.Tensor, *,
                deterministic: bool = True, inference: bool = False,
                generator: Optional[torch.Generator] = None):
        """istate (B, H, W) or (B, C, H, W); pstate (B, pstate_dim).
        Returns (mean, log_std), each (B, action_dim)."""
        latent = self.trans(istate, self.fc_embed(pstate),
                            deterministic=deterministic, inference=inference,
                            generator=generator)
        return self.from_latent(latent)

    def from_latent(self, latent: torch.Tensor):
        """(mean, log_std) from the (B, l_f_size) trunk latent."""
        x = F.relu(self.fc1(latent))
        x = F.relu(self.fc2(x))
        return self.mean_linear(x), clamp_log_std(self.log_std_linear(x))


class GoTQNetwork(nn.Module):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 block: int = 4, head: int = 4, l_f_size: int = 64,
                 dim_head: int = 64, mlp_dim: int = 2048,
                 image_size: Tuple[int, int] = (128, 160),
                 patch_size: Tuple[int, int] = (16, 20),
                 patch_mode: str = "2d", channels: int = 1,
                 emb_dropout: float = 0.1, attn_impl: str = "auto",
                 trunk_grad: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        lin = lambda i, o: Linear(i, o, dtype=dtype, generator=g)
        self.fc_embed = lin(pstate_dim, l_f_size)
        self.trans = GoT(image_size=image_size, patch_size=patch_size,
                         dim=l_f_size, depth=block, heads=head,
                         dim_head=dim_head, mlp_dim=mlp_dim,
                         channels=channels, patch_mode=patch_mode,
                         emb_dropout=emb_dropout, attn_impl=attn_impl,
                         trunk_grad=trunk_grad, dtype=dtype, generator=g)
        self.fc1 = lin(l_f_size + action_dim, 128)
        self.fc2 = lin(128, 32)
        self.fc3 = lin(32, action_dim)
        self.fc11 = lin(l_f_size + action_dim, 128)
        self.fc21 = lin(128, 32)
        self.fc31 = lin(32, action_dim)

    def trunk(self, istate: torch.Tensor, pstate: torch.Tensor, *,
              deterministic: bool = True, inference: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Action-independent half: goal embed + GoT trunk -> (B, l_f)."""
        return self.trans(istate, F.relu(self.fc_embed(pstate)),
                          deterministic=deterministic, inference=inference,
                          generator=generator)

    def heads(self, latent: torch.Tensor, action: torch.Tensor):
        """Twin MLP heads over a trunk latent; the action joins here."""
        x = torch.cat([latent, action.to(latent.dtype)], dim=1)
        q1 = self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))
        q2 = self.fc31(F.relu(self.fc21(F.relu(self.fc11(x)))))
        return q1, q2

    def forward(self, istate: torch.Tensor, pstate: torch.Tensor,
                action: torch.Tensor, *, deterministic: bool = True,
                inference: bool = False,
                generator: Optional[torch.Generator] = None):
        """(q1, q2), each (B, action_dim)."""
        return self.heads(self.trunk(istate, pstate,
                                     deterministic=deterministic,
                                     inference=inference,
                                     generator=generator), action)


def _common(cfg):
    m, s = cfg.model, cfg.sac
    m.validate()
    return dict(action_dim=s.action_dim, pstate_dim=s.pstate_dim,
                block=m.block, head=m.head, l_f_size=m.latent_size,
                dim_head=m.dim_head, mlp_dim=m.mlp_dim,
                image_size=tuple(m.image_size),
                patch_size=tuple(m.patch_size), patch_mode=m.patch_mode,
                channels=cfg.env.frame_stack, emb_dropout=m.emb_dropout,
                trunk_grad=os.environ.get("DGVIT_TRUNK_GRAD") == "1")


def build_actor(cfg, dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                attn_impl: str = "auto") -> GoTPolicy:
    """The actor a config describes (GaussianTransformer on GoT only)."""
    return GoTPolicy(**_common(cfg), attn_impl=attn_impl, dtype=dtype,
                     generator=generator)


def build_critic(cfg, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> GoTQNetwork:
    """The twin-Q GoT critic a config describes."""
    return GoTQNetwork(**_common(cfg), dtype=dtype, generator=generator)
