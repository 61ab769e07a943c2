"""The CLS-only final transformer block (K3): `block(x)[:, 0]`, forward
and backward, plain and fused.

Counterpart of `dgvit_tpu/ops/cls_block.py`. GoT pools the goal token
after the last block, so the final block computes k/v for every row but
q, attention, out-projection and MLP for the CLS row alone. Its backward
keeps the same sparsity: the upstream gradient lives on the CLS row, so
the q/MLP/out-projection gradients run on one row per frame while the k/v
path still gives every row its input gradient; dx gets the k/v path on
every row, plus the q path and the residual g1 on row 0.

`cls_final_block` is differentiable: `cls_fwd_fused` (K3f) and
`cls_bwd_fused` (K3b) launch the CUDA kernels of `csrc/block_grad.cu` for
CUDA tensors and run `cls_fwd_plain` / `cls_bwd_plain` for CPU tensors.
`cls_bwd_plain` follows `_cls_bwd_body` step by step, with the rounding
points of `ops/fused_transformer.block_bwd_plain`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dgvit_tpu_torch.ops.fused_transformer import (
    _attention, _f32, _gelu32, _gelu_grad32, _grads_like, _heads, _ln,
    _ln_bwd, _ln_stats, _mlp, _mm, _tmm, check_block_args, launch_block_bwd,
    launch_block_fwd)


def _kv_rows(h1: torch.Tensor, wkv: torch.Tensor,
             cdt: torch.dtype) -> torch.Tensor:
    """k|v of every row from the normed rows h1 and wqkv's k|v columns,
    rounded to the compute dtype: the forward's and the backward's one
    product over every row (a tensor-core product in the bf16 CUDA
    bodies)."""
    return _mm(h1, wkv).to(cdt)


def cls_block_plain(x32: torch.Tensor, w: Sequence[torch.Tensor], *,
                    heads: int, dim_head: int, cdt: torch.dtype
                    ) -> torch.Tensor:
    """Final pre-norm block for the CLS row only: k/v from every row, q,
    attention, out-proj and MLP on row 0. (B, n, d) fp32 -> (B, d) fp32
    (no cast at the end)."""
    an_s, an_b, wqkv, wout, bout, fn_s, fn_b, w1, b1, w2, b2 = w
    inner = heads * dim_head
    h = _ln(x32, an_s, an_b).to(cdt)
    kv = _kv_rows(h, wqkv[:, inner:], cdt)
    q = _mm(h[:, :1], wqkv[:, :inner]).to(cdt)
    o = _attention(q, kv[..., :inner], kv[..., inner:], heads, dim_head, cdt)
    x1 = x32[:, 0] + (_mm(o[:, 0], wout) + _f32(bout).reshape(-1))
    h2 = _ln(x1, fn_s, fn_b).to(cdt)
    return x1 + _mlp(h2, w1, b1, w2, b2, cdt)


def cls_fwd_plain(x: torch.Tensor, w: Sequence[torch.Tensor], heads: int,
                  dim_head: int) -> torch.Tensor:
    """Plain version of K3f: (B, n, d) -> (B, d), compute dtype."""
    return cls_block_plain(_f32(x), w, heads=heads, dim_head=dim_head,
                           cdt=x.dtype).to(x.dtype)


def cls_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                  w: Sequence[torch.Tensor], heads: int, dim_head: int):
    """Plain version of K3b, after `_cls_bwd_body`: x (B, n, d) and the
    grad dy (B, d) of the pooled CLS outputs, both in the compute dtype ->
    (dx (B, n, d), the 11 weight grads in the weights' dtype)."""
    an_s, an_b, wqkv, wout, bout, fn_s, fn_b, w1, b1, w2, b2 = w
    cdt = x.dtype
    inner = heads * dim_head
    scale = dim_head ** -0.5
    x32, dy32, dy_c = _f32(x), _f32(dy), dy.to(cdt)

    # recompute: LN1 (all rows) -> k/v (all rows), q (CLS row) -> x1
    a_s32 = _f32(an_s).reshape(-1)
    xhat1, rstd1, h1_32 = _ln_stats(x32, a_s32, an_b)
    h1 = h1_32.to(cdt)
    kv = _kv_rows(h1, wqkv[:, inner:], cdt)
    h_cls = h1[:, :1]                                       # (B, 1, d)
    q = _heads(_mm(h_cls, wqkv[:, :inner]).to(cdt), heads)  # (B, H, 1, dh)
    k, v = _heads(kv[..., :inner], heads), _heads(kv[..., inner:], heads)
    s = _mm(q, _f32(k).transpose(-1, -2)) * scale           # (B, H, 1, n)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p32 = e / e.sum(dim=-1, keepdim=True)
    p_c = p32.to(cdt)
    o = _mm(p_c, v).to(cdt).transpose(1, 2).reshape(-1, inner)
    x1 = x32[:, 0] + (_mm(o, wout) + _f32(bout).reshape(-1))
    f_s32 = _f32(fn_s).reshape(-1)
    xhat2, rstd2, h2_32 = _ln_stats(x1, f_s32, fn_b)
    h2 = h2_32.to(cdt)

    # MLP forward + backward on the CLS rows
    pre = _mm(h2, w1) + _f32(b1).reshape(-1)
    hid = _gelu32(pre, cdt).to(cdt)
    dpre = _mm(dy_c, w2.t()) * _gelu_grad32(pre, cdt)
    dpre_c = dpre.to(cdt)
    dw1, db1 = _tmm(h2, dpre_c), dpre.sum(dim=0)
    dw2, db2 = _tmm(hid, dy_c), dy32.sum(dim=0)
    dh2 = _mm(dpre_c, w1.t())
    dln2_x, dfs, dfb = _ln_bwd(dh2, xhat2, rstd2, f_s32)
    g1 = dy32 + dln2_x                                      # (B, d)
    g1_c = g1.to(cdt)

    # attention backward
    dbout = g1.sum(dim=0)
    dwout = _tmm(o, g1_c)
    do_h = _mm(g1_c, wout.t()).to(cdt).reshape(-1, heads, 1, dim_head)
    dv = _mm(_f32(p_c).transpose(-1, -2), do_h)             # (B, H, n, dh)
    dp = _mm(do_h, _f32(v).transpose(-1, -2))               # (B, H, 1, n)
    ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
    ds = _f32((ds * scale).to(cdt))
    dq = _mm(ds, k).reshape(-1, inner)                      # (B, inner)
    dk = _mm(ds.transpose(-1, -2), q)                       # (B, H, n, dh)
    merge = lambda t: t.transpose(1, 2).reshape(t.shape[0], -1, inner)
    dq_c = dq.to(cdt)
    dkv_c = torch.cat([merge(dk), merge(dv)], dim=-1).to(cdt)
    dwqkv = torch.cat([_tmm(h_cls, dq_c), _tmm(h1, dkv_c)], dim=1)

    # dh1: the k/v path on every row, plus the q path on the CLS row
    dh1 = _mm(dkv_c, wqkv[:, inner:].t())
    dh1 = torch.cat([dh1[:, :1] + _mm(dq_c, wqkv[:, :inner].t())[:, None],
                     dh1[:, 1:]], dim=1)
    dln1_x, das, dab = _ln_bwd(dh1, xhat1, rstd1, a_s32)
    dx = torch.cat([dln1_x[:, :1] + g1[:, None], dln1_x[:, 1:]], dim=1)
    return dx.to(cdt), _grads_like((das, dab, dwqkv, dwout, dbout, dfs, dfb,
                                    dw1, db1, dw2, db2), w)


def cls_fwd_fused(x: torch.Tensor, w: Sequence[torch.Tensor], heads: int,
                  dim_head: int) -> torch.Tensor:
    """K3f: `block(x)[:, 0]`, (B, n, d) -> (B, d) in the compute dtype.
    CUDA tensors go to the kernel (and raise if it cannot run); CPU tensors
    to `cls_fwd_plain`. `cls_fwd_fused.launches` counts kernel launches."""
    check_block_args(x, w, heads, dim_head)
    if x.device.type == "cuda":
        out = launch_block_fwd(x, w, heads, dim_head, cls=True)
        cls_fwd_fused.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return cls_fwd_plain(x, w, heads, dim_head)


def cls_bwd_fused(x: torch.Tensor, dy: torch.Tensor,
                  w: Sequence[torch.Tensor], heads: int, dim_head: int):
    """K3b: the CLS block's backward from x (B, n, d) and dy (B, d):
    (dx (B, n, d), the 11 weight grads), in the compute dtype. CUDA tensors
    go to the kernel; CPU tensors to `cls_bwd_plain`.
    `cls_bwd_fused.launches` counts kernel launches."""
    check_block_args(x, w, heads, dim_head, dy=dy, cls=True)
    if x.device.type == "cuda":
        out = launch_block_bwd(x, dy, w, heads, dim_head, cls=True)
        cls_bwd_fused.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return cls_bwd_plain(x, dy, w, heads, dim_head)


cls_fwd_fused.launches = 0
cls_bwd_fused.launches = 0


class _ClsBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, heads, dim_head, *w):
        ctx.save_for_backward(x, *w)
        ctx.heads, ctx.dim_head = heads, dim_head
        return cls_fwd_fused(x, w, heads, dim_head)

    @staticmethod
    def backward(ctx, dy):
        x, *w = ctx.saved_tensors
        dx, grads = cls_bwd_fused(x, dy.contiguous(), w, ctx.heads,
                                  ctx.dim_head)
        return (dx, None, None, *grads)


def cls_final_block(x: torch.Tensor, w: Sequence[torch.Tensor], heads: int,
                    dim_head: int) -> torch.Tensor:
    """Differentiable `TransformerBlock(x)[:, 0]`: forward K3f, backward
    K3b. (B, n, d) -> (B, d), compute dtype."""
    return _ClsBlock.apply(x, heads, dim_head, *w)
