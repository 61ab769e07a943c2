"""The whole-trunk backward (K6): the gradient of
`blocks_cls_forward_fused` (K4) in one per-frame pass.

Counterpart of `dgvit_tpu/ops/trunk_train.py`. From the embedded stream x
(B, n, d), the gradient dy (B, d) of the pooled, normed latent and the
streams K4 wrote in its forward (each full block's rounded output, the
inputs of the later blocks, and the rounded CLS row) it runs the final
norm's backward on the CLS rows, the CLS-only block's backward, then the
full blocks' backward in reverse, and returns dx, the 11 gradients of
every block in the weights' dtype and the final norm's (dscale, dbias) in
fp32. The kernel runs no forward: it differentiates the streams the
forward that ran produced, whichever body K4 took. That is the JAX
contract ("the block inputs are one function of x"), which JAX meets by
recomputing them with the forward's own body.

`trunk_bwd_fused` launches the CUDA kernel of `csrc/block_grad.cu` for
CUDA tensors and runs `trunk_bwd_plain` for CPU tensors; nothing else
picks between them. `trunk_bwd_plain` chains the hand-written block
backwards (`cls_bwd_plain`, `block_bwd_plain`), not autograd of the
forward; without streams it recomputes them with K4's plain version, as
the JAX function does. The rounding points are the TPU kernel's: the
stream is rounded to the compute dtype after every block and after the
CLS block, the CLS gradient before the CLS block's backward, dx between
blocks, and everything the block backwards round inside. The TPU
kernel's smaller MLP chunk (its memory budget) is not part of the
function and has no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from dgvit_tpu_torch.ops.cls_block import (check_saved, cls_bwd_plain,
                                           cls_fwd_plain)
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


def trunk_streams_plain(x: torch.Tensor,
                        blocks: Sequence[Sequence[torch.Tensor]],
                        heads: int, dim_head: int):
    """The streams of K4's plain forward (`blocks_forward_plain`): (xs
    (depth - 1, B, n, d), cls (B, d)) in x's dtype, and the CLS block's
    records (B, `cls_block.cls_saved_width`) fp32."""
    cdt = x.dtype
    xs = [x]
    for w in blocks[:-1]:
        xs.append(block_plain(_f32(xs[-1]), w, heads=heads,
                              dim_head=dim_head, cdt=cdt).to(cdt))
    cls, saved = cls_fwd_plain(xs[-1], blocks[-1], heads, dim_head, save=True)
    return (torch.stack(xs[1:]) if len(xs) > 1
            else x.new_empty((0, *x.shape))), cls, saved


def trunk_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                    blocks: Sequence[Sequence[torch.Tensor]],
                    fn: Tuple[torch.Tensor, torch.Tensor], heads: int,
                    dim_head: int, final_norm: str, streams=None):
    """Plain PyTorch version of K6, on any device. Arguments and result as
    `trunk_bwd_fused`; with `streams` None it recomputes them
    (`trunk_streams_plain`)."""
    cdt = x.dtype
    if streams is None:
        streams = trunk_streams_plain(x, blocks, heads, dim_head)
    xs = [x, *streams[0]]
    cls = _f32(streams[1])
    dcls, dfs, dfb = final_norm_bwd_plain(_f32(dy), cls, fn[0], fn[1],
                                          final_norm)
    dx, g = cls_bwd_plain(xs[-1], dcls.to(cdt), blocks[-1], heads, dim_head,
                          streams[2])
    grads = [g]
    for xi, w in zip(reversed(xs[:-1]), reversed(blocks[:-1])):
        dx, g = block_bwd_plain(xi, dx, w, heads, dim_head)
        grads.append(g)
    return dx, tuple(reversed(grads)), (dfs.reshape(fn[0].shape),
                                        dfb.reshape(fn[1].shape))


def _check(x, dy, blocks, fn, heads, dim_head, final_norm, streams) -> None:
    if final_norm not in _NORMS:
        raise ValueError(f"final_norm {final_norm!r}")
    for w in blocks:
        check_block_args(x, w, heads, dim_head, dy=dy, cls=True)
    b, n, d = x.shape
    if streams is not None:
        xs, cls, saved = streams
        check_saved(saved, x, blocks[-1], heads, dim_head)
        for t, shape in ((xs, (len(blocks) - 1, b, n, d)), (cls, (b, d))):
            if (t.device != x.device or t.dtype != x.dtype
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(
                    f"stream of {t.dtype}, shape {tuple(t.shape)} on "
                    f"{t.device}: expected contiguous {x.dtype} {shape} on "
                    f"{x.device}")
    for t in fn:
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (d,) or not t.is_contiguous()):
            raise TypeError(f"final-norm parameter of {t.dtype}, shape "
                            f"{tuple(t.shape)} on {t.device}: expected "
                            f"contiguous fp32 ({d},) on {x.device}")


def tensor_core_trunk(x: torch.Tensor, blocks: Sequence[Sequence[
        torch.Tensor]], dim_head: int) -> bool:
    """Whether K6 runs its per-frame pass on the bf16 tensor-core bodies
    (`block_bwd_mma` for its full blocks, `cls_bwd_mma` for its last):
    every block, the last one too, by `tensor_core_bwd` on x. Past the
    first block the inputs are K4's streams and every block's dy a
    workspace slot, all aligned where x is at these widths; the launch
    checks the same for every block and fails where this says yes and a
    block does not fit."""
    return all(tensor_core_bwd(x, w, dim_head) for w in blocks)


def _launch(x, dy, blocks, fn, heads, dim_head, final_norm, streams):
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
               *[t for g in grads for t in g], *dfn, ws, *streams]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    mma = tensor_core_trunk(x, blocks, dim_head)
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
                    dim_head: int, final_norm: str, streams=None):
    """K6: the backward of `blocks_cls_forward_fused`.

    x:       (B, n, dim) embedded stream, the forward's input, compute
             dtype
    dy:      (B, dim) gradient of the forward's output, compute dtype
    blocks:  per-block 11-tuples in the fused-transformer order, compute
             dtype, matrices (in, out), vectors (n,)
    fn:      final-norm (scale, bias), each (dim,) fp32
    streams: (xs (depth - 1, B, n, dim), cls (B, dim)) in the compute
             dtype and the CLS block's records (B, `cls_saved_width`)
             fp32: what the forward wrote (`blocks_forward_plain(...,
             streams=True)` or K4 under autograd). The kernel needs them;
             the plain version recomputes them when None.
    Returns (dx (B, n, dim) in the compute dtype, per block the 11 weight
    gradients in the compute dtype, (dscale, dbias) in fp32).

    CUDA tensors go to the CUDA kernel (and raise if it cannot run); CPU
    tensors go to `trunk_bwd_plain`. `trunk_bwd_fused.launches` counts
    kernel launches (one per call: the per-frame pass and the
    weight-gradient products it is followed by)."""
    _check(x, dy, blocks, fn, heads, dim_head, final_norm, streams)
    if x.device.type == "cuda":
        if streams is None:
            raise ValueError("K6 differentiates the streams K4 wrote: pass "
                             "them (blocks_cls_forward_fused keeps them "
                             "under autograd)")
        return _launch(x, dy, blocks, fn, heads, dim_head, final_norm,
                       streams)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return trunk_bwd_plain(x, dy, blocks, fn, heads, dim_head, final_norm,
                           streams)


trunk_bwd_fused.launches = 0
