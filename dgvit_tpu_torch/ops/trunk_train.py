"""The whole-trunk backward (K6): the gradient of
`blocks_cls_forward_fused` (K4) in one per-frame pass.

Counterpart of `dgvit_tpu/ops/trunk_train.py`. From the embedded stream x
(B, n, d) and the gradient dy (B, d) of the pooled, normed latent it
recomputes the chain of block inputs, runs the final norm's backward on
the CLS rows, the CLS-only block's backward, then the full blocks'
backward in reverse, and returns dx, the 11 gradients of every block in
the weights' dtype and the final norm's (dscale, dbias) in fp32.

`trunk_bwd_fused` launches the CUDA kernel of `csrc/block_grad.cu` for
CUDA tensors and runs `trunk_bwd_plain` for CPU tensors; nothing else
picks between them. `trunk_bwd_plain` chains the hand-written block
backwards (`cls_bwd_plain`, `block_bwd_plain`), not autograd of the
forward. The rounding points are the TPU kernel's: the stream is rounded
to the compute dtype after every block and after the CLS block, the CLS
gradient before the CLS block's backward, dx between blocks, and
everything the block backwards round inside. The TPU kernel's smaller MLP
chunk (its memory budget) is not part of the function and has no
counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from dgvit_tpu_torch.ops.cls_block import cls_block_plain, cls_bwd_plain
from dgvit_tpu_torch.ops.fused_transformer import (_DTYPES, _block_lib, _f32,
                                                   _ln_bwd, _ln_stats,
                                                   block_bwd_plain,
                                                   block_plain,
                                                   check_block_args,
                                                   tensor_core_bwd)

_NORMS = {"rms": 0, "layer": 1}
MAX_DEPTH = 8       # blocks the kernel's argument block holds


def final_norm_bwd_plain(dy32: torch.Tensor, cls32: torch.Tensor,
                         fs: torch.Tensor, fb: torch.Tensor,
                         final_norm: str):
    """Backward of the final RMS / Layer norm on fp32 CLS rows (B, d):
    (dcls (B, d), dscale (d,), dbias (d,)), the parameter gradients summed
    over the rows. rms: y = x / max(||x||, 1e-12) * sqrt(d) * g."""
    d = cls32.shape[-1]
    fs32 = _f32(fs).reshape(-1)
    if final_norm == "rms":
        norm = torch.sqrt((cls32 * cls32).sum(dim=-1, keepdim=True))
        nn = torch.clamp(norm, min=1e-12)
        u = cls32 / nn
        sd = d ** 0.5
        gdy = dy32 * fs32
        proj = (gdy * u).sum(dim=-1, keepdim=True)
        dcls = (sd / nn) * (gdy - u * proj)
        dfs = (sd * u * dy32).sum(dim=0)
        return dcls, dfs, torch.zeros_like(dfs)
    xhat, rstd, _ = _ln_stats(cls32, fs32, fb)
    return _ln_bwd(dy32, xhat, rstd, fs32)


def trunk_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                    blocks: Sequence[Sequence[torch.Tensor]],
                    fn: Tuple[torch.Tensor, torch.Tensor], heads: int,
                    dim_head: int, final_norm: str):
    """Plain PyTorch version of K6, on any device. Arguments and result as
    `trunk_bwd_fused`."""
    cdt = x.dtype
    xs = [x]
    for w in blocks[:-1]:
        xs.append(block_plain(_f32(xs[-1]), w, heads=heads,
                              dim_head=dim_head, cdt=cdt).to(cdt))
    cls = _f32(cls_block_plain(_f32(xs[-1]), blocks[-1], heads=heads,
                               dim_head=dim_head, cdt=cdt).to(cdt))
    dcls, dfs, dfb = final_norm_bwd_plain(_f32(dy), cls, fn[0], fn[1],
                                          final_norm)
    dx, g = cls_bwd_plain(xs[-1], dcls.to(cdt), blocks[-1], heads, dim_head)
    grads = [g]
    for xi, w in zip(reversed(xs[:-1]), reversed(blocks[:-1])):
        dx, g = block_bwd_plain(xi, dx, w, heads, dim_head)
        grads.append(g)
    return dx, tuple(reversed(grads)), (dfs.reshape(fn[0].shape),
                                        dfb.reshape(fn[1].shape))


def _check(x, dy, blocks, fn, heads, dim_head, final_norm) -> None:
    if final_norm not in _NORMS:
        raise ValueError(f"final_norm {final_norm!r}")
    for w in blocks:
        check_block_args(x, w, heads, dim_head, dy=dy, cls=True)
    d = x.shape[-1]
    for t in fn:
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (d,) or not t.is_contiguous()):
            raise TypeError(f"final-norm parameter of {t.dtype}, shape "
                            f"{tuple(t.shape)} on {t.device}: expected "
                            f"contiguous fp32 ({d},) on {x.device}")


def _launch(x, dy, blocks, fn, heads, dim_head, final_norm):
    lib = _block_lib()
    b, n, d = x.shape
    depth, mlp = len(blocks), blocks[0][7].shape[-1]
    if depth > MAX_DEPTH:
        raise ValueError(f"depth {depth}: the kernel takes at most "
                         f"{MAX_DEPTH} blocks")
    nbytes = lib.trunk_backward_workspace(_DTYPES[x.dtype], b, n, d, heads,
                                          dim_head, mlp, depth)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = [[torch.empty_like(t) for t in w] for w in blocks]
    dfn = (torch.empty_like(fn[0]), torch.empty_like(fn[1]))
    tensors = [x, dy, *[t for w in blocks for t in w], fn[0], fn[1], dx,
               *[t for g in grads for t in g], *dfn, ws]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    # the full blocks' inputs and grads past the first live in the
    # (aligned) workspace
    mma = depth > 1 and all(tensor_core_bwd(x, w, dim_head)
                            for w in blocks[:-1])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trunk_backward_launch(
            _DTYPES[x.dtype], ctypes.cast(ptrs, ctypes.c_void_p),
            len(tensors), b, n, d, heads, dim_head, mlp, depth,
            _NORMS[final_norm], dim_head ** -0.5, stream, int(mma))
    if err != 0:
        raise RuntimeError("trunk_bwd_fused launch failed: "
                           + lib.block_error_string(err).decode())
    trunk_bwd_fused.launches += 1
    return dx, tuple(tuple(g) for g in grads), dfn


def trunk_bwd_fused(x: torch.Tensor, dy: torch.Tensor,
                    blocks: Sequence[Sequence[torch.Tensor]],
                    fn: Tuple[torch.Tensor, torch.Tensor], heads: int,
                    dim_head: int, final_norm: str):
    """K6: the backward of `blocks_cls_forward_fused`.

    x:      (B, n, dim) embedded stream, the forward's input, compute dtype
    dy:     (B, dim) gradient of the forward's output, compute dtype
    blocks: per-block 11-tuples in the fused-transformer order, compute
            dtype, matrices (in, out), vectors (n,)
    fn:     final-norm (scale, bias), each (dim,) fp32
    Returns (dx (B, n, dim) in the compute dtype, per block the 11 weight
    gradients in the compute dtype, (dscale, dbias) in fp32).

    CUDA tensors go to the CUDA kernel (and raise if it cannot run); CPU
    tensors go to `trunk_bwd_plain`. `trunk_bwd_fused.launches` counts
    kernel launches (one per call: the per-frame pass and the
    weight-gradient products it is followed by)."""
    _check(x, dy, blocks, fn, heads, dim_head, final_norm)
    if x.device.type == "cuda":
        return _launch(x, dy, blocks, fn, heads, dim_head, final_norm)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return trunk_bwd_plain(x, dy, blocks, fn, heads, dim_head, final_norm)


trunk_bwd_fused.launches = 0
