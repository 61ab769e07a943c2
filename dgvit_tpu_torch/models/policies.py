"""The actor and critic zoo. Counterparts of
`dgvit_tpu/models/policies.py`, module for module, with the reference's
quirks kept:

GoT family (got_sac_network.py):
  * GoTPolicy: goal -> fc_embed (no ReLU) as the goal token; GoT latent ->
    relu(fc1 64->128) -> relu(fc2 128->128) -> mean and clamped log_std;
  * GoTQNetwork: goal -> relu(fc_embed) as the goal token; the GoT latent
    with the action appended -> twin heads relu(fc1 ->128) -> relu(fc2
    128->32) -> fc3 and relu(fc11) -> relu(fc21) -> fc31, each (B,
    action_dim); `trunk` and `heads` apply on their own;
  * DeterministicGoTPolicy: fc_embed (no ReLU), GoT, relu(fc1 ->128),
    relu(fc2 128->32), tanh(mean_linear). `build_actor` hands it no image
    size, patch size, emb-dropout or patch mode, as the JAX factory hands
    it none, so its defaults hold whatever the config says.
CNN family (a `ConvTrunk`, (B, 256), beside a 32-wide goal embedding):
  * GaussianPolicy: fc_embed with no ReLU, relu(fc1 288->128), relu(fc2
    128->32), mean and clamped log_std; one channel;
  * QNetwork: relu(fc_embed), the action appended, twin heads as above;
    one channel;
  * DeterministicPolicy: tanh(mean) over the same layers as GaussianPolicy;
    a 4-channel (B, H, W, 4) frame stack;
  * ValueNetwork: relu(fc_embed), relu(fc1), relu(fc2), fc3, in the JAX
    module's working layout (the reference sizes fc1 for inputs it never
    gets).
SimpleViT family (vit_sac_network.py; `models/simple_vit.py`, dim_head 64,
the class head left out): ViTGaussianPolicy and ViTDeterministicPolicy
(fc_embed with no ReLU, concat, relu(fc1 ->128), relu(fc2 128->32), then
mean/log_std or tanh(mean_linear)) and ViTQNetwork (relu(fc_embed), twin
heads). As in the JAX factory the ViT's image and patch sizes are the
module's defaults: its patch count follows the frames it is given.

A deterministic actor returns the tanh-squashed action itself; no caller
squashes it again. Every head runs in the compute dtype, as the JAX
package's TorchLinear does; every forward takes the GoT trunk's
`deterministic`, `inference` and `generator` keywords (the CNN and ViT
families have no dropout and ignore them).

`build_actor` and `build_critic` read the JAX package's opt-in switch
`DGVIT_TRUNK_GRAD=1` once, when they build a GoT network: its
gradient-bearing trunk passes then go forward through K4 and backward
through the whole-trunk kernel K6 instead of the per-block kernels. As in
the JAX package, `model.dropout` of a config is not handed on to the
networks (only a `GoT(dropout > 0)` built directly takes the composed
route for that reason).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dgvit_tpu_torch.models.cnn import ConvTrunk
from dgvit_tpu_torch.models.distributions import clamp_log_std
from dgvit_tpu_torch.models.got import GoT
from dgvit_tpu_torch.models.layers import Linear
from dgvit_tpu_torch.models.simple_vit import SimpleViT


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


class DeterministicGoTPolicy(nn.Module):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 block: int = 4, head: int = 4, l_f_size: int = 64,
                 dim_head: int = 64, mlp_dim: int = 2048,
                 image_size: Tuple[int, int] = (128, 160),
                 patch_size: Tuple[int, int] = (16, 20),
                 emb_dropout: float = 0.1, attn_impl: str = "auto",
                 trunk_grad: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.fc_embed = Linear(pstate_dim, l_f_size, dtype=dtype, generator=g)
        self.trans = GoT(image_size=image_size, patch_size=patch_size,
                         dim=l_f_size, depth=block, heads=head,
                         dim_head=dim_head, mlp_dim=mlp_dim,
                         emb_dropout=emb_dropout, attn_impl=attn_impl,
                         trunk_grad=trunk_grad, dtype=dtype, generator=g)
        self.fc1 = Linear(l_f_size, 128, dtype=dtype, generator=g)
        self.fc2 = Linear(128, 32, dtype=dtype, generator=g)
        self.mean_linear = Linear(32, action_dim, dtype=dtype, generator=g)

    def forward(self, istate: torch.Tensor, pstate: torch.Tensor, *,
                deterministic: bool = True, inference: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The tanh-squashed action, (B, action_dim)."""
        latent = self.trans(istate, self.fc_embed(pstate),
                            deterministic=deterministic, inference=inference,
                            generator=generator)
        x = F.relu(self.fc2(F.relu(self.fc1(latent))))
        return torch.tanh(self.mean_linear(x))


class _GoalConcat(nn.Module):
    """A trunk's latent beside a 32-wide goal embedding (no ReLU on the
    actors' embedding, a ReLU on the critics'), then relu(fc1 ->128) and
    relu(fc2 128->32): the shared body of the CNN and ViT actors."""

    def _body(self, latent, pstate):
        x = torch.cat([latent, self.fc_embed(pstate).to(latent.dtype)],
                      dim=1)
        return F.relu(self.fc2(F.relu(self.fc1(x))))


def _twin(self, x):
    q1 = self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))
    q2 = self.fc31(F.relu(self.fc21(F.relu(self.fc11(x)))))
    return q1, q2


def _twin_heads(module, width: int, action_dim: int, dtype, g) -> None:
    lin = lambda i, o: Linear(i, o, dtype=dtype, generator=g)
    module.fc1, module.fc2, module.fc3 = (lin(width, 128), lin(128, 32),
                                          lin(32, action_dim))
    module.fc11, module.fc21, module.fc31 = (lin(width, 128), lin(128, 32),
                                             lin(32, action_dim))


class GaussianPolicy(_GoalConcat):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 channels: int = 1, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.trunk = ConvTrunk(channels, dtype=dtype, generator=g)
        self.fc_embed = Linear(pstate_dim, 32, dtype=dtype, generator=g)
        self.fc1 = Linear(256 + 32, 128, dtype=dtype, generator=g)
        self.fc2 = Linear(128, 32, dtype=dtype, generator=g)
        self.mean_linear = Linear(32, action_dim, dtype=dtype, generator=g)
        self.log_std_linear = Linear(32, action_dim, dtype=dtype,
                                     generator=g)

    def forward(self, istate, pstate, *, deterministic: bool = True,
                inference: bool = False, generator=None):
        """(mean, log_std), each (B, action_dim)."""
        x = self._body(self.trunk(istate), pstate)
        return self.mean_linear(x), clamp_log_std(self.log_std_linear(x))


class DeterministicPolicy(_GoalConcat):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 channels: int = 4, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.trunk = ConvTrunk(channels, dtype=dtype, generator=g)
        self.fc_embed = Linear(pstate_dim, 32, dtype=dtype, generator=g)
        self.fc1 = Linear(256 + 32, 128, dtype=dtype, generator=g)
        self.fc2 = Linear(128, 32, dtype=dtype, generator=g)
        self.mean = Linear(32, action_dim, dtype=dtype, generator=g)

    def forward(self, istate, pstate, *, deterministic: bool = True,
                inference: bool = False, generator=None):
        """istate (B, H, W, 4): the tanh-squashed action."""
        return torch.tanh(self.mean(self._body(self.trunk(istate), pstate)))


class QNetwork(nn.Module):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 channels: int = 1, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.trunk = ConvTrunk(channels, dtype=dtype, generator=g)
        self.fc_embed = Linear(pstate_dim, 32, dtype=dtype, generator=g)
        _twin_heads(self, 256 + 32 + action_dim, action_dim, dtype, g)

    def forward(self, istate, pstate, action, *, deterministic: bool = True,
                inference: bool = False, generator=None):
        """(q1, q2), each (B, action_dim)."""
        x1 = self.trunk(istate)
        x2 = F.relu(self.fc_embed(pstate))
        return _twin(self, torch.cat([x1, x2.to(x1.dtype),
                                      action.to(x1.dtype)], dim=1))


class ValueNetwork(nn.Module):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 channels: int = 1, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.trunk = ConvTrunk(channels, dtype=dtype, generator=g)
        self.fc_embed = Linear(pstate_dim, 32, dtype=dtype, generator=g)
        self.fc1 = Linear(256 + 32, 128, dtype=dtype, generator=g)
        self.fc2 = Linear(128, 32, dtype=dtype, generator=g)
        self.fc3 = Linear(32, action_dim, dtype=dtype, generator=g)

    def forward(self, istate, pstate, *, deterministic: bool = True,
                inference: bool = False, generator=None):
        x1 = self.trunk(istate)
        x = torch.cat([x1, F.relu(self.fc_embed(pstate)).to(x1.dtype)],
                      dim=1)
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class ViTGaussianPolicy(_GoalConcat):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 dim: int = 256, depth: int = 2, heads: int = 8,
                 mlp_dim: int = 2048, attn_impl: str = "auto",
                 capture: bool = False, seq_shard: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.trans = SimpleViT(dim=dim, depth=depth, heads=heads,
                               mlp_dim=mlp_dim, attn_impl=attn_impl,
                               capture=capture, seq_shard=seq_shard,
                               head=False, dtype=dtype, generator=g)
        self.fc_embed = Linear(pstate_dim, 32, dtype=dtype, generator=g)
        self.fc1 = Linear(dim + 32, 128, dtype=dtype, generator=g)
        self.fc2 = Linear(128, 32, dtype=dtype, generator=g)
        self.mean_linear = Linear(32, action_dim, dtype=dtype, generator=g)
        self.log_std_linear = Linear(32, action_dim, dtype=dtype,
                                     generator=g)

    def forward(self, istate, pstate, *, deterministic: bool = True,
                inference: bool = False, generator=None):
        """(mean, log_std), each (B, action_dim)."""
        x = self._body(self.trans(istate), pstate)
        return self.mean_linear(x), clamp_log_std(self.log_std_linear(x))


class ViTDeterministicPolicy(_GoalConcat):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 dim: int = 256, depth: int = 2, heads: int = 8,
                 mlp_dim: int = 2048, attn_impl: str = "auto",
                 capture: bool = False, seq_shard: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.trans = SimpleViT(dim=dim, depth=depth, heads=heads,
                               mlp_dim=mlp_dim, attn_impl=attn_impl,
                               capture=capture, seq_shard=seq_shard,
                               head=False, dtype=dtype, generator=g)
        self.fc_embed = Linear(pstate_dim, 32, dtype=dtype, generator=g)
        self.fc1 = Linear(dim + 32, 128, dtype=dtype, generator=g)
        self.fc2 = Linear(128, 32, dtype=dtype, generator=g)
        self.mean_linear = Linear(32, action_dim, dtype=dtype, generator=g)

    def forward(self, istate, pstate, *, deterministic: bool = True,
                inference: bool = False, generator=None):
        """The tanh-squashed action, (B, action_dim)."""
        return torch.tanh(self.mean_linear(
            self._body(self.trans(istate), pstate)))


class ViTQNetwork(nn.Module):
    def __init__(self, action_dim: int = 2, pstate_dim: int = 2,
                 dim: int = 256, depth: int = 2, heads: int = 8,
                 mlp_dim: int = 2048, attn_impl: str = "auto",
                 seq_shard: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.trans = SimpleViT(dim=dim, depth=depth, heads=heads,
                               mlp_dim=mlp_dim, attn_impl=attn_impl,
                               seq_shard=seq_shard, head=False, dtype=dtype,
                               generator=g)
        self.fc_embed = Linear(pstate_dim, 32, dtype=dtype, generator=g)
        _twin_heads(self, dim + 32 + action_dim, action_dim, dtype, g)

    def forward(self, istate, pstate, action, *, deterministic: bool = True,
                inference: bool = False, generator=None):
        """(q1, q2), each (B, action_dim)."""
        x1 = self.trans(istate)
        x2 = F.relu(self.fc_embed(pstate))
        return _twin(self, torch.cat([x1, x2.to(x1.dtype),
                                      action.to(x1.dtype)], dim=1))


def _trunk_grad() -> bool:
    return os.environ.get("DGVIT_TRUNK_GRAD") == "1"


def _got(cfg):
    """The GoT trunk's arguments a config gives a GoTPolicy or GoTQNetwork."""
    m, s = cfg.model, cfg.sac
    return dict(block=m.block, head=m.head, l_f_size=m.latent_size,
                dim_head=m.dim_head, mlp_dim=m.mlp_dim,
                image_size=tuple(m.image_size),
                patch_size=tuple(m.patch_size), patch_mode=m.patch_mode,
                channels=cfg.env.frame_stack, emb_dropout=m.emb_dropout,
                trunk_grad=_trunk_grad())


def _vit(cfg, attn_impl: str):
    m = cfg.model
    return dict(dim=m.vit_dim, depth=m.vit_depth, heads=m.vit_heads,
                mlp_dim=m.mlp_dim, attn_impl=attn_impl,
                seq_shard=m.seq_shard)


def build_actor(cfg, dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                attn_impl: str = "auto") -> nn.Module:
    """The actor a config describes: model.actor_type (and, for the
    Transformer actors, model.backbone), mapped as the JAX factory maps
    them."""
    m, s = cfg.model, cfg.sac
    m.validate()
    common = dict(action_dim=s.action_dim, pstate_dim=s.pstate_dim,
                  dtype=dtype, generator=generator)
    if m.actor_type == "GaussianTransformer":
        if m.backbone == "simple_vit":
            return ViTGaussianPolicy(**common, **_vit(cfg, attn_impl))
        return GoTPolicy(**_got(cfg), attn_impl=attn_impl, **common)
    if m.actor_type == "GaussianConvNet":
        return GaussianPolicy(**common)
    if m.actor_type == "DeterministicTransformer":
        if m.backbone == "simple_vit":
            return ViTDeterministicPolicy(**common, **_vit(cfg, attn_impl))
        return DeterministicGoTPolicy(
            block=m.block, head=m.head, l_f_size=m.latent_size,
            dim_head=m.dim_head, mlp_dim=m.mlp_dim, attn_impl=attn_impl,
            trunk_grad=_trunk_grad(), **common)
    if m.actor_type == "Deterministic":
        return DeterministicPolicy(**common)
    raise ValueError(f"unknown actor_type {m.actor_type!r}")


def build_critic(cfg, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """The twin-Q critic a config describes: model.critic_type (and, for
    the Transformer critic, model.backbone)."""
    m, s = cfg.model, cfg.sac
    m.validate()
    common = dict(action_dim=s.action_dim, pstate_dim=s.pstate_dim,
                  dtype=dtype, generator=generator)
    if m.critic_type == "Transformer":
        if m.backbone == "simple_vit":
            return ViTQNetwork(**common, **_vit(cfg, "auto"))
        return GoTQNetwork(**_got(cfg), **common)
    if m.critic_type == "CNN":
        return QNetwork(**common)
    raise ValueError(f"unknown critic_type {m.critic_type!r}")
