"""Transformer building blocks with the JAX package's numerics.

`TransformerBlock` holds a pre-norm block's 11 parameters as raw tensors in
the fused kernels' order and (in, out) layout, so the kernels take them as
they are; its forward is the differentiable per-block kernel (K2, or K3
for the CLS-only final block). `Linear` is an nn.Linear that computes in a
given compute dtype, as the JAX package's TorchLinear does: operands cast
to that dtype, the product rounded to it, then the bias added in it.
`emb_dropout` is flax's Dropout with the mask drawn from an explicit
`torch.Generator`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dgvit_tpu_torch.models import initializers as init
from dgvit_tpu_torch.ops.cls_block import cls_final_block
from dgvit_tpu_torch.ops.fused_transformer import (_ln,
                                                   fused_transformer_block)


def emb_dropout(x: torch.Tensor, rate: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `Dropout(rate)` in training mode: keep each element with
    probability 1 - rate (the draw from `generator`), scale kept elements
    by 1 / (1 - rate) in x's dtype, zero the rest."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Linear(nn.Linear):
    """nn.Linear in a compute dtype (None: the input's dtype)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        init.init_linear_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        y = x.to(dt) @ self.weight.to(dt).t()
        return y + self.bias.to(dt) if self.bias is not None else y


class RMSNorm(nn.Module):
    """F.normalize(x, dim=-1) * sqrt(dim) * g: the L2 norm is clamped at
    1e-12, not added in quadrature. Computed in fp32, returned in x's
    dtype."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = torch.clamp(x32.norm(dim=-1, keepdim=True), min=self.eps)
        return (x32 / norm * x.shape[-1] ** 0.5 * self.g).to(x.dtype)


class LayerNorm(nn.Module):
    """torch nn.LayerNorm defaults (eps 1e-5, affine), computed in fp32 and
    returned in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ln(x.float(), self.weight, self.bias, self.eps).to(x.dtype)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)); x + MLP(LN(x)).

    Parameters, in the fused kernel's order: attn_norm_scale,
    attn_norm_bias, wqkv (d, 3*inner, no bias), wout (inner, d), bout,
    ff_norm_scale, ff_norm_bias, w1 (d, mlp), b1, w2 (mlp, d), b2.
    """

    ORDER = ("attn_norm_scale", "attn_norm_bias", "wqkv", "wout", "bout",
             "ff_norm_scale", "ff_norm_bias", "w1", "b1", "w2", "b2")

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        e = lambda *s: nn.Parameter(torch.empty(*s))
        self.attn_norm_scale = nn.Parameter(torch.ones(dim))
        self.attn_norm_bias = nn.Parameter(torch.zeros(dim))
        self.wqkv = e(dim, 3 * inner)
        self.wout = e(inner, dim)
        self.bout = e(dim)
        self.ff_norm_scale = nn.Parameter(torch.ones(dim))
        self.ff_norm_bias = nn.Parameter(torch.zeros(dim))
        self.w1 = e(dim, mlp_dim)
        self.b1 = e(mlp_dim)
        self.w2 = e(mlp_dim, dim)
        self.b2 = e(dim)
        g = generator
        init.xavier_uniform_(self.wqkv, dim, 3 * inner, g)
        init.xavier_uniform_(self.wout, inner, dim, g)
        init.torch_linear_bias_(self.bout, inner, g)
        init.xavier_uniform_(self.w1, dim, mlp_dim, g)
        init.torch_linear_bias_(self.b1, dim, g)
        init.xavier_uniform_(self.w2, mlp_dim, dim, g)
        init.torch_linear_bias_(self.b2, mlp_dim, g)

    def flat(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """The 11 parameters in kernel order, cast to the compute dtype and
        detached (for the no-grad kernels)."""
        return tuple(getattr(self, n).detach().to(dtype).contiguous()
                     for n in self.ORDER)

    def forward(self, x: torch.Tensor, cls_only: bool = False
                ) -> torch.Tensor:
        """(B, n, d) in the compute dtype -> (B, n, d), every row valid; or,
        with cls_only, the CLS row of the output, (B, d). Differentiable:
        the casts to the compute dtype keep the graph, so gradients reach
        the fp32 parameters (rounded to the compute dtype)."""
        w = tuple(getattr(self, n).to(x.dtype) for n in self.ORDER)
        if cls_only:
            return cls_final_block(x, w, self.heads, self.dim_head)
        return fused_transformer_block(x, w, self.heads, self.dim_head)
