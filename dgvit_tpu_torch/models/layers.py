"""Transformer building blocks with the JAX package's numerics.

`TransformerBlock` holds a pre-norm block's 11 parameters as raw tensors in
the fused kernels' order and (in, out) layout, so the kernels take them as
they are. Its forward takes the JAX block's two routes
(`dgvit_tpu/models/layers.py:226-296`):

  * fused: the differentiable per-block kernel (K2, or K3 for the CLS-only
    final block), when the block has no dropout and no capture,
    `attn_impl` is auto or fused, there are at most 256 tokens and the
    route rule passes (`ops/smem.py`: the kernels hold a frame in a
    thread block's shared memory on the card, and the block has an
    output projection);
  * composed, otherwise: LayerNorm, `attention`, residual, LayerNorm,
    `feed_forward`, residual, in PyTorch around the attention kernels.
    `attention` runs the whole section as one kernel (K7,
    `ops/fused_block.py`) for a tensor on the card where the route rule
    passes for K7, or projects q, k and v
    and calls `dot_product_attention` (K8 behind `impl`).

A block with heads == 1 and dim_head == dim has no output projection (no
`wout`, `bout`; JAX layers.py:132): the attention's output is the
heads' output itself, and the route rule refuses it every fused route.
With `capture` (the visualizer's attention maps, JAX layers.py:169-173)
the attention's softmax probabilities (`attention_probs`) are kept as the
block's `captured` record (B, H, N, N) on every forward, and only the
composed route with the plain attention runs.

The JAX package takes its fused routes when the backend is a TPU; here the
per-block kernels' wrappers run their plain versions on CPU tensors, so
the block route does not look at the device, while `attention` asks
whether the tensor is on the card (`_on_card`), as the JAX module asks for
a TPU. `Linear` is an nn.Linear that computes in a given compute dtype, as
the JAX package's TorchLinear does: operands cast to that dtype, the
product rounded to it, then the bias added in it. `dropout` is flax's
Dropout with the mask drawn from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dgvit_tpu_torch.models import initializers as init
from dgvit_tpu_torch.ops.attention import (IMPLS, attention_probs,
                                           dot_product_attention)
from dgvit_tpu_torch.ops.cls_block import cls_final_block
from dgvit_tpu_torch.ops.fused_block import (MAX_TOKENS,
                                             fused_attention_section)
from dgvit_tpu_torch.ops.fused_transformer import (_ln,
                                                   fused_transformer_block)
from dgvit_tpu_torch.ops.smem import route_fits

ATTN_IMPLS = IMPLS + ("fused",)


def dropout(x: torch.Tensor, rate: float,
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


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _prod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b: every matrix product of the composed blocks and of `Linear`
    goes through here (chip_smoke.py's `exact_sums` swaps it for float64
    sums, as it swaps `fused_transformer._prod`)."""
    return a @ b


def attention(x: torch.Tensor, wqkv: torch.Tensor,
              wout: Optional[torch.Tensor], bout: Optional[torch.Tensor],
              heads: int, dim_head: int, *,
              rate: float = 0.0, attn_impl: str = "auto",
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None,
              capture: Optional[Callable[[torch.Tensor], None]] = None
              ) -> torch.Tensor:
    """Multi-head self-attention of the composed block: x (B, n, d) and the
    block's projection weights, all in the compute dtype -> (B, n, d).
    On the card, with `attn_impl` auto or fused and n <= 256, the whole
    section is the kernel K7; otherwise q, k and v are projected here and
    attended by `dot_product_attention(impl=attn_impl)`. Dropout (`rate`,
    unless `deterministic`) follows the output projection either way.
    `wout` None: no output projection and no dropout after it.
    `capture`: handed the softmax probabilities (B, H, n, n), which the
    output is then computed from (dropout on them first, as on the
    output)."""
    b, n, d = x.shape
    if (attn_impl in ("auto", "fused") and capture is None and _on_card(x)
            and n <= MAX_TOKENS
            and route_fits(("K7",), n, d, heads, dim_head, 0, x.dtype,
                           x.device)):
        out = fused_attention_section(x, wqkv, wout, bout, heads, dim_head)
    else:
        qkv = _prod(x, wqkv).reshape(b, n, 3, heads, dim_head)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if capture is not None:
            probs = attention_probs(q, k, dim_head ** -0.5)
            capture(probs)
            if not deterministic:
                probs = dropout(probs, rate, generator)
            out = _prod(probs, v)
        else:
            out = dot_product_attention(
                q, k, v, dim_head ** -0.5,
                impl="auto" if attn_impl == "fused" else attn_impl)
        out = out.transpose(1, 2).reshape(b, n, heads * dim_head)
        if wout is None:
            return out
        out = _prod(out, wout) + bout
    return out if deterministic else dropout(out, rate, generator)


def feed_forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, *, rate: float = 0.0,
                 deterministic: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Linear -> GELU (exact erf form) -> dropout -> Linear -> dropout, in
    the compute dtype; the two products are plain matmuls, as the JAX
    package leaves them to XLA."""
    h = F.gelu(_prod(x, w1) + b1)
    if not deterministic:
        h = dropout(h, rate, generator)
    h = _prod(h, w2) + b2
    return h if deterministic else dropout(h, rate, generator)


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
        y = _prod(x.to(dt), self.weight.to(dt).t())
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
    ff_norm_scale, ff_norm_bias, w1 (d, mlp), b1, w2 (mlp, d), b2; with
    heads == 1 and dim_head == d there is no wout and no bout
    (`project_out` False). `capture`: keep the attention's probabilities
    of each forward in `captured`.
    """

    ORDER = ("attn_norm_scale", "attn_norm_bias", "wqkv", "wout", "bout",
             "ff_norm_scale", "ff_norm_bias", "w1", "b1", "w2", "b2")

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, attn_impl: str = "auto",
                 capture: bool = False):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attention impl {attn_impl!r}")
        self.heads, self.dim_head = heads, dim_head
        self.dropout, self.attn_impl = dropout, attn_impl
        self.project_out = not (heads == 1 and dim_head == dim)
        self.capture = bool(capture)
        self.captured: Optional[torch.Tensor] = None
        inner = heads * dim_head
        e = lambda *s: nn.Parameter(torch.empty(*s))
        self.attn_norm_scale = nn.Parameter(torch.ones(dim))
        self.attn_norm_bias = nn.Parameter(torch.zeros(dim))
        self.wqkv = e(dim, 3 * inner)
        if self.project_out:
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
        if self.project_out:
            init.xavier_uniform_(self.wout, inner, dim, g)
            init.torch_linear_bias_(self.bout, inner, g)
        init.xavier_uniform_(self.w1, dim, mlp_dim, g)
        init.torch_linear_bias_(self.b1, dim, g)
        init.xavier_uniform_(self.w2, mlp_dim, dim, g)
        init.torch_linear_bias_(self.b2, mlp_dim, g)

    def _keep(self, probs: torch.Tensor) -> None:
        self.captured = probs.detach()

    def flat(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """The 11 parameters in kernel order, cast to the compute dtype and
        detached (for the no-grad kernels)."""
        return tuple(getattr(self, n).detach().to(dtype).contiguous()
                     for n in self.ORDER)

    def fused_fits(self, x: torch.Tensor, cls_only: bool) -> bool:
        """Whether the per-block kernels hold x's frames on its device: the
        forward (K2f, or K3f for the CLS-only block) and, when autograd
        records, the backward (K2b, K3b) (`ops/smem.py`)."""
        kernels = ("K3f", "K3b") if cls_only else ("K2f", "K2b")
        if not torch.is_grad_enabled():
            kernels = kernels[:1]
        _, n, d = x.shape
        return route_fits(kernels, n, d, self.heads, self.dim_head,
                          self.w1.shape[1], x.dtype, x.device)

    def forward(self, x: torch.Tensor, cls_only: bool = False, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """(B, n, d) in the compute dtype -> (B, n, d), every row valid; or,
        with cls_only, the CLS row of the output, (B, d). Differentiable:
        the casts to the compute dtype keep the graph, so gradients reach
        the fp32 parameters (rounded to the compute dtype). `deterministic`
        False applies the block's dropout, its masks drawn from
        `generator`."""
        cast = lambda *names: (getattr(self, n).to(x.dtype) for n in names)
        if (self.attn_impl in ("auto", "fused") and self.dropout == 0.0
                and not self.capture and x.shape[1] <= MAX_TOKENS
                and self.fused_fits(x, cls_only)):
            w = tuple(cast(*self.ORDER))
            if cls_only:
                return cls_final_block(x.contiguous(), w, self.heads,
                                       self.dim_head)
            return fused_transformer_block(x.contiguous(), w, self.heads,
                                           self.dim_head)
        # composed: the norms keep their fp32 parameters, as the JAX
        # LayerNorm module does; the products' operands go to x's dtype
        wqkv, w1, b1, w2, b2 = cast("wqkv", "w1", "b1", "w2", "b2")
        wout, bout = (cast("wout", "bout") if self.project_out
                      else (None, None))
        drop = dict(rate=self.dropout, deterministic=deterministic,
                    generator=generator)
        h = _ln(x.float(), self.attn_norm_scale, self.attn_norm_bias)
        x = x + attention(h.to(x.dtype), wqkv, wout, bout, self.heads,
                          self.dim_head, attn_impl=self.attn_impl,
                          capture=self._keep if self.capture else None,
                          **drop)
        if cls_only:
            x = x[:, :1]    # only the CLS row survives the pooling
        h = _ln(x.float(), self.ff_norm_scale, self.ff_norm_bias)
        x = x + feed_forward(h.to(x.dtype), w1, b1, w2, b2, **drop)
        return x[:, 0] if cls_only else x
