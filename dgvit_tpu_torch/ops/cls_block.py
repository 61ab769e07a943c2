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

When autograd records, the forward keeps the CLS row's intermediates (q,
the fp32 probabilities, o, x1, h2 and the MLP's fp32 pre-activations,
one fp32 record a frame: `cls_saved_width`) as its body computed them,
and the backward reads them instead of recomputing the CLS row's
single-row products. So it differentiates the forward that ran, the JAX
contract that `_cls_bwd_body` meets by recomputing with the forward's own
body. Only k and v (every row) are recomputed, by the same products.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dgvit_tpu_torch.ops.fused_transformer import (
    _attention, _f32, _gelu32, _gelu_grad32, _grads_like, _heads, _ln,
    _ln_bwd, _ln_stats, _mlp, _mm, _tmm, aligned_for, block_form,
    check_block_args, check_record_form, launch_block_bwd, launch_block_fwd)


def _kv_rows(h1: torch.Tensor, wkv: torch.Tensor,
             cdt: torch.dtype) -> torch.Tensor:
    """k|v of every row from the normed rows h1 and wqkv's k|v columns,
    rounded to the compute dtype: the forward's and the backward's one
    product over every row (a tensor-core product in the bf16 CUDA
    bodies)."""
    return _mm(h1, wkv).to(cdt)


def cls_saved_width(n: int, d: int, heads: int, dim_head: int,
                    mlp: int) -> int:
    """fp32 values of a frame's CLS record (`ClsSave` in
    csrc/block_common.cuh): q (inner), probabilities (heads x n), o
    (inner), x1 (d), h2 (d), z (mlp), in that order."""
    return 2 * heads * dim_head + heads * n + 2 * d + mlp


def _cls_row(x32, h1, kv, w, heads: int, dim_head: int, cdt):
    """The CLS row's forward from the rounded LN1 rows h1 and k|v of every
    row: (q (B, H, 1, dh) in cdt, p32 (B, H, 1, n), o (B, inner) in cdt,
    x1 (B, d) fp32, h2 (B, d) in cdt, z (B, mlp) fp32)."""
    _, _, wqkv, wout, bout, fn_s, fn_b, w1, b1, _, _ = w
    inner = heads * dim_head
    q = _heads(_mm(h1[:, :1], wqkv[:, :inner]).to(cdt), heads)
    k, v = _heads(kv[..., :inner], heads), _heads(kv[..., inner:], heads)
    s = _mm(q, _f32(k).transpose(-1, -2)) * dim_head ** -0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p32 = e / e.sum(dim=-1, keepdim=True)
    o = _mm(p32.to(cdt), v).to(cdt).transpose(1, 2).reshape(-1, inner)
    x1 = x32[:, 0] + (_mm(o, wout) + _f32(bout).reshape(-1))
    h2 = _ln_stats(x1, _f32(fn_s).reshape(-1), fn_b)[2].to(cdt)
    z = _mm(h2, w1) + _f32(b1).reshape(-1)
    return q, p32, o, x1, h2, z


def _pack(q, p32, o, x1, h2, z) -> torch.Tensor:
    b = x1.shape[0]
    return torch.cat([_f32(t).reshape(b, -1) for t in (q, p32, o, x1, h2, z)],
                     dim=1)


def _unpack(saved: torch.Tensor, n: int, w, heads: int, dim_head: int,
            cdt) -> tuple:
    """A frame record's parts (`cls_saved_width`), in `_cls_row`'s shapes
    and dtypes."""
    b, inner = saved.shape[0], heads * dim_head
    d, mlp = w[0].numel(), w[7].shape[-1]
    q, p32, o, x1, h2, z = torch.split(
        saved, [inner, heads * n, inner, d, d, mlp], dim=1)
    return (_heads(q.to(cdt)[:, None], heads), p32.reshape(b, heads, 1, n),
            o.to(cdt), x1, h2.to(cdt), z)


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
                  dim_head: int, save: bool = False):
    """Plain version of K3f: (B, n, d) -> (B, d), compute dtype; with
    `save`, (out, the CLS rows' records (B, `cls_saved_width`) fp32)."""
    if not save:
        return cls_block_plain(_f32(x), w, heads=heads, dim_head=dim_head,
                               cdt=x.dtype).to(x.dtype)
    cdt, x32 = x.dtype, _f32(x)
    h1 = _ln(x32, w[0], w[1]).to(cdt)
    row = _cls_row(x32, h1, _kv_rows(h1, w[2][:, heads * dim_head:], cdt),
                   w, heads, dim_head, cdt)
    hid = _gelu32(row[5], cdt).to(cdt)
    out = row[3] + (_f32(w[10]).reshape(-1) + _mm(hid, w[9]))
    return out.to(cdt), _pack(*row)


def cls_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                  w: Sequence[torch.Tensor], heads: int, dim_head: int,
                  saved: torch.Tensor = None):
    """Plain version of K3b, after `_cls_bwd_body`: x (B, n, d) and the
    grad dy (B, d) of the pooled CLS outputs, both in the compute dtype ->
    (dx (B, n, d), the 11 weight grads in the weights' dtype). `saved`:
    the records the forward kept (`cls_fwd_plain(..., save=True)`, K3f or
    K4 under autograd), read in place of the CLS row's forward; None
    recomputes it, as the JAX function does."""
    an_s, an_b, wqkv, wout, bout, fn_s, fn_b, w1, b1, w2, b2 = w
    cdt = x.dtype
    inner = heads * dim_head
    scale = dim_head ** -0.5
    x32, dy32, dy_c = _f32(x), _f32(dy), dy.to(cdt)

    # LN1 (all rows) -> k/v (all rows); the CLS row's q, p, o, x1, h2, z
    a_s32 = _f32(an_s).reshape(-1)
    xhat1, rstd1, h1_32 = _ln_stats(x32, a_s32, an_b)
    h1 = h1_32.to(cdt)
    kv = _kv_rows(h1, wqkv[:, inner:], cdt)
    h_cls = h1[:, :1]                                       # (B, 1, d)
    k, v = _heads(kv[..., :inner], heads), _heads(kv[..., inner:], heads)
    if saved is None:
        q, p32, o, x1, h2, pre = _cls_row(x32, h1, kv, w, heads, dim_head,
                                          cdt)
    else:
        q, p32, o, x1, h2, pre = _unpack(saved, x.shape[1], w, heads,
                                         dim_head, cdt)
    p_c = p32.to(cdt)
    f_s32 = _f32(fn_s).reshape(-1)
    xhat2, rstd2, _ = _ln_stats(x1, f_s32, fn_b)

    # MLP forward + backward on the CLS rows
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


def saved_buffer(x: torch.Tensor, w: Sequence[torch.Tensor], heads: int,
                 dim_head: int) -> torch.Tensor:
    """An empty (B, `cls_saved_width`) fp32 record buffer for x."""
    b, n, d = x.shape
    return torch.empty((b, cls_saved_width(n, d, heads, dim_head,
                                           w[7].shape[-1])),
                       dtype=torch.float32, device=x.device)


def check_saved(saved: torch.Tensor, x: torch.Tensor,
                w: Sequence[torch.Tensor], heads: int, dim_head: int) -> None:
    b, n, d = x.shape
    shape = (b, cls_saved_width(n, d, heads, dim_head, w[7].shape[-1]))
    if (saved.device != x.device or saved.dtype != torch.float32
            or tuple(saved.shape) != shape or not saved.is_contiguous()):
        raise ValueError(f"CLS record of {saved.dtype}, shape "
                         f"{tuple(saved.shape)} on {saved.device}: expected "
                         f"contiguous fp32 {shape} on {x.device}")


def cls_fwd_fused(x: torch.Tensor, w: Sequence[torch.Tensor], heads: int,
                  dim_head: int, save: bool = False, form: int = None):
    """K3f: `block(x)[:, 0]`, (B, n, d) -> (B, d) in the compute dtype;
    with `save`, (out, the CLS rows' records) as `cls_fwd_plain`. CUDA
    tensors go to the kernel (and raise if it cannot run) in `form`
    (None: `block_form`'s), which the records keep (`saved.form`); CPU
    tensors to `cls_fwd_plain`. `cls_fwd_fused.launches` counts wrapper
    calls that launch, `cls_fwd_fused.cluster_launches` those of the fp32
    cluster form (its two CUDA launches count once)."""
    check_block_args(x, w, heads, dim_head)
    if x.device.type == "cuda":
        if form is None:
            form = block_form(x, w, dim_head, True)
        saved = saved_buffer(x, w, heads, dim_head) if save else None
        out = launch_block_fwd(x, w, heads, dim_head, cls=True, saved=saved,
                               form=form)
        cls_fwd_fused.launches += 1
        cls_fwd_fused.cluster_launches += form == 2
        return (out, saved) if save else out
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return cls_fwd_plain(x, w, heads, dim_head, save)


def cls_bwd_fused(x: torch.Tensor, dy: torch.Tensor,
                  w: Sequence[torch.Tensor], heads: int, dim_head: int,
                  saved: torch.Tensor = None, form: int = None):
    """K3b: the CLS block's backward from x (B, n, d), dy (B, d) and the
    records its forward kept (`cls_fwd_fused(..., save=True)`): (dx (B, n,
    d), the 11 weight grads), in the compute dtype. CUDA tensors go to the
    kernel, which needs the records, in `form` (None: `block_form`'s rule;
    `_ClsBlock` passes its forward's); a form other than the one that
    wrote the records raises (`check_record_form`, on either device). CPU
    tensors go to `cls_bwd_plain`, which recomputes the records when
    `saved` is None. `cls_bwd_fused.launches` counts wrapper calls that
    launch, `cls_bwd_fused.cluster_launches` those of the fp32 cluster form
    (its two per-frame launches and the weight products count once)."""
    check_block_args(x, w, heads, dim_head, dy=dy, cls=True)
    if saved is not None:
        check_saved(saved, x, w, heads, dim_head)
        if form is not None:
            check_record_form(saved, form)
    if x.device.type == "cuda":
        if saved is None:
            raise ValueError("K3b differentiates the CLS row K3f computed: "
                             "pass the records cls_fwd_fused(..., save=True)"
                             " kept")
        if form is None:
            form = block_form(x, w, dim_head, True, dy)
        out = launch_block_bwd(x, dy, w, heads, dim_head, cls=True,
                               saved=saved, form=form)
        cls_bwd_fused.launches += 1
        cls_bwd_fused.cluster_launches += form == 2
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return cls_bwd_plain(x, dy, w, heads, dim_head, saved)


cls_fwd_fused.launches = cls_fwd_fused.cluster_launches = 0
cls_bwd_fused.launches = cls_bwd_fused.cluster_launches = 0


class _ClsBlock(torch.autograd.Function):
    """K3f forward, K3b backward. `record`: the call will be
    differentiated, so K3f keeps the CLS rows' records for K3b, and K3b
    runs the form K3f ran (a dy off a 16-byte boundary is copied,
    `aligned_for`)."""

    @staticmethod
    def forward(ctx, x, heads, dim_head, record, *w):
        if not record:
            return cls_fwd_fused(x, w, heads, dim_head)
        ctx.form = block_form(x, w, dim_head, True)
        out, saved = cls_fwd_fused(x, w, heads, dim_head, save=True,
                                   form=ctx.form)
        ctx.save_for_backward(x, saved, *w)
        ctx.heads, ctx.dim_head = heads, dim_head
        return out

    @staticmethod
    def backward(ctx, dy):
        x, saved, *w = ctx.saved_tensors
        dy = aligned_for(dy.contiguous(), ctx.form)
        dx, grads = cls_bwd_fused(x, dy, w, ctx.heads, ctx.dim_head, saved,
                                  form=ctx.form)
        return (dx, None, None, None, *grads)


def cls_final_block(x: torch.Tensor, w: Sequence[torch.Tensor], heads: int,
                    dim_head: int) -> torch.Tensor:
    """Differentiable `TransformerBlock(x)[:, 0]`: forward K3f, backward
    K3b. (B, n, d) -> (B, d), compute dtype. The CLS records are kept
    only when grad mode is on and an input requires grad."""
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *w))
    return _ClsBlock.apply(x, heads, dim_head, record, *w)
