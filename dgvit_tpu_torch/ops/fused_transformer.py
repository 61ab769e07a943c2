"""Plain PyTorch pieces of the fused pre-norm transformer block.

Counterpart of `dgvit_tpu/ops/fused_transformer.py`. The whole-trunk
kernel (`ops/got_megakernel.py`) and its plain version share these, and a
later per-block kernel will too. They follow the TPU kernel body
(`_block_body`), not the JAX package's unfused twin `_block_xla`, in the
two places where those differ:

  * GELU is the tanh form when the compute dtype is bf16 and an erf
    polynomial accurate to fp32 otherwise (`_gelu32`); the twin always
    uses erf;
  * attention probabilities are cast to the compute dtype before P.V.

Numerics: norm statistics, softmax and every accumulation run in fp32;
matrix operands are values of the compute dtype (products of bf16 values
are exact in fp32, so an fp32 product of up-cast operands is what a bf16
tensor-core product with fp32 accumulation computes).

A block's 11 parameters come in the kernel's order:
(attn_norm scale, attn_norm bias, wqkv (d, 3*inner), wout (inner, d),
 bout, ff_norm scale, ff_norm bias, w1 (d, mlp), b1, w2 (mlp, d), b2),
matrices stored (in, out); vectors (1, n) or (n,).
"""

from __future__ import annotations

from typing import Sequence

import torch

_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715
_INV_SQRT2 = 0.7071067811865476


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _ln(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of an fp32 tensor (population variance)."""
    m = x32.mean(dim=-1, keepdim=True)
    v = (x32 - m).square().mean(dim=-1, keepdim=True)
    return (x32 - m) * torch.rsqrt(v + eps) * _f32(scale).reshape(-1) \
        + _f32(bias).reshape(-1)


def _erf32(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf, |err| < 1.5e-7: the polynomial the TPU
    kernel evaluates, and the one the CUDA kernel evaluates."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _gelu32(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """GELU on fp32 pre-activations: tanh form for a bf16 compute dtype,
    the erf polynomial for fp32."""
    if cdt == torch.bfloat16:
        inner = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
        return 0.5 * x * (1.0 + torch.tanh(inner))
    return 0.5 * x * (1.0 + _erf32(x * _INV_SQRT2))


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Compute-dtype operands, fp32 product and accumulation."""
    return _f32(a) @ _f32(w)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads: int, dim_head: int, cdt: torch.dtype) -> torch.Tensor:
    """q (B, nq, inner), k/v (B, n, inner) in the compute dtype, every key
    valid -> (B, nq, inner) in the compute dtype."""
    b, nq, _ = q.shape
    n = k.shape[1]
    split = lambda t, r: t.reshape(b, r, heads, dim_head).transpose(1, 2)
    s = _f32(split(q, nq)) @ _f32(split(k, n)).transpose(-1, -2)
    s = s * dim_head ** -0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(cdt)
    o = (_f32(p) @ _f32(split(v, n))).to(cdt)          # (B, H, nq, dh)
    return o.transpose(1, 2).reshape(b, nq, heads * dim_head)


def _mlp(h: torch.Tensor, w1, b1, w2, b2, cdt) -> torch.Tensor:
    hid = _gelu32(_mm(h, w1) + _f32(b1).reshape(-1), cdt).to(cdt)
    return _f32(b2).reshape(-1) + _mm(hid, w2)


def block_plain(x32: torch.Tensor, w: Sequence[torch.Tensor], *,
                heads: int, dim_head: int, cdt: torch.dtype) -> torch.Tensor:
    """One full pre-norm block on an fp32 residual stream (B, n, d), every
    row a valid token. Returns the fp32 stream (no cast at the end)."""
    an_s, an_b, wqkv, wout, bout, fn_s, fn_b, w1, b1, w2, b2 = w
    inner = heads * dim_head
    h = _ln(x32, an_s, an_b).to(cdt)
    qkv = _mm(h, wqkv).to(cdt)
    o = _attention(qkv[..., :inner], qkv[..., inner:2 * inner],
                   qkv[..., 2 * inner:], heads, dim_head, cdt)
    x32 = x32 + (_mm(o, wout) + _f32(bout).reshape(-1))
    h = _ln(x32, fn_s, fn_b).to(cdt)
    return x32 + _mlp(h, w1, b1, w2, b2, cdt)
