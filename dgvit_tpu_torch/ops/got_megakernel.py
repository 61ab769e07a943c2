"""Whole-trunk GoT forwards: K1 and K4, with their plain versions.

Counterparts of `dgvit_tpu/ops/got_megakernel.py`:

  * `got_forward_fused` (K1) runs the whole inference trunk:
        patch-embed matmul + bias -> goal token prepended -> + positional
        embedding -> depth-1 full pre-norm blocks -> a CLS-only final block
        -> final RMS or Layer norm  =>  (B, dim) latent, compute dtype;
  * `blocks_cls_forward_fused` (K4) runs the same trunk from the blocks on,
    for a stream embedded outside the kernel (the no-grad forwards with
    live emb-dropout, and the gradient forwards of the opt-in
    trunk-gradient route). It is differentiable: its backward is the
    whole-trunk kernel K6 (`ops/trunk_train.py`), as the JAX function's
    custom VJP is. When the call will be differentiated, K4 also writes
    the streams between its blocks (each full block's rounded output and
    the rounded CLS row), and K6 differentiates exactly those: the JAX
    backward recomputes them with its forward's own body, which comes to
    the same thing there.

Both launch the hand-written CUDA kernels of `csrc/got_megakernel.cu` for
CUDA tensors and run `got_forward_plain` / `blocks_forward_plain` for CPU
tensors; nothing else picks between them. The plain versions are the
kernels' oracles: the CPU tests hold them against the JAX kernels, and the
chip smoke test holds the kernels against them on the card.

Numerics follow the TPU kernel bodies (`_mega_kernel`, `_blocks_kernel`):
the embedding is rounded to the compute dtype before the positional add,
the residual stream is rounded to the compute dtype after every block and
after the CLS block, and the final norm runs in fp32 on the rounded CLS
row. The TPU kernel pads 65 tokens to 72 and masks the padded keys; here
padded rows are simply never formed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from dgvit_tpu_torch.ops.cls_block import saved_buffer
from dgvit_tpu_torch.ops.fused_transformer import _f32, _ln, _mm
from dgvit_tpu_torch.ops.smem import (fwd_mma, k1_cluster, k1_cluster_fp32,
                                      k1_embed, tensor_core_widths,
                                      tf32_widths)
from dgvit_tpu_torch.ops.trunk_train import (trunk_bwd_fused,
                                             trunk_streams_plain)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NORMS = {"rms": 0, "layer": 1}
# K1's forms (csrc/got_megakernel.cu, got_forward_launch's `form`): the
# FMA trunk_kernel; k1_mma_kernel, two frames a thread block with every
# product on the tensor cores; k1_cluster_kernel, one frame over a
# cluster of CLUSTER CTAs; k1_cluster_fp32_kernel, the same in fp32 with
# every product on the tensor cores as 3xTF32
K1_FORMS = {"fma": 0, "mma": 1, "cluster": 2, "cluster_fp32": 3}
CLUSTER = 4
# The cluster form runs while CLUSTER x batch <= CLUSTER_LOAD x the SM
# count, two frames a block past that: where the two cross on an H100 80GB
# HBM3 (132 SMs, 700 W; chip_smoke.py phase 8), the cluster took 0.486 ms
# at B=90 against 0.541, and 0.594 against 0.538 at B=99
CLUSTER_LOAD = 2.75
# K4's forms (csrc/got_megakernel.cu, blocks_forward_launch's `mma`): the
# FMA trunk_kernel; trunk_mma_kernel<true>, the bf16 tensor-core body in
# its K4 form; trunk_mma_kernel<false>, the same body with every product
# on the tensor cores (no route takes it; chip_numerics.py measures it);
# k4_cluster_fp32_kernel, K1's fp32 cluster form from the blocks on
K4_FORMS = {"fma": 0, "mma": 1, "all_mma": 2, "cluster_fp32": 3}


def _final_norm32(cls: torch.Tensor, fs: torch.Tensor, fb: torch.Tensor,
                  final_norm: str) -> torch.Tensor:
    """Final RMS/Layer norm on fp32 CLS rows; fs/fb are fp32 (1, d) or (d,).
    RMS is x / max(||x||, 1e-12) * sqrt(d) * g."""
    d = cls.shape[-1]
    fs, fb = _f32(fs).reshape(-1), _f32(fb).reshape(-1)
    if final_norm == "rms":
        norm = torch.sqrt((cls * cls).sum(dim=-1, keepdim=True))
        return cls / torch.clamp(norm, min=1e-12) * (d ** 0.5) * fs
    return _ln(cls, fs, fb)


def stream_buffers(x: torch.Tensor, blocks, heads: int, dim_head: int):
    """Empty (xs, cls, saved) for K4's streams of x: xs (depth - 1, B, n,
    d), each full block's output, and cls (B, d), the CLS row before the
    final norm, in one allocation of x's dtype; saved (B,
    `cls_block.cls_saved_width`) fp32, the CLS block's records."""
    b, n, d = x.shape
    k = (len(blocks) - 1) * b * n * d
    buf = torch.empty(k + b * d, dtype=x.dtype, device=x.device)
    return (buf[:k].view(len(blocks) - 1, b, n, d), buf[k:].view(b, d),
            saved_buffer(x, blocks[-1], heads, dim_head))


def blocks_forward_plain(x: torch.Tensor, blocks, fn, heads: int,
                         dim_head: int, final_norm: str,
                         streams: bool = False):
    """Plain PyTorch version of K4, on any device. Arguments as
    `blocks_cls_forward_fused`. With `streams`, returns (out, (xs, cls,
    saved)): the streams K4 writes for K6 (`stream_buffers`), each value
    rounded to the compute dtype where the forward rounds it."""
    st = trunk_streams_plain(x, blocks, heads, dim_head)
    out = _final_norm32(_f32(st[1]), fn[0], fn[1], final_norm).to(x.dtype)
    return (out, st) if streams else out


def got_forward_plain(patches, goal, pe, pos, blocks, fn, heads: int,
                      dim_head: int, n_valid: int, final_norm: str
                      ) -> torch.Tensor:
    """Plain PyTorch version of the whole-trunk kernel, on any device.
    Arguments as `got_forward_fused`."""
    cdt = patches.dtype
    emb = (_mm(patches, pe[0]) + _f32(pe[1]).reshape(-1)).to(cdt)
    x = torch.cat([goal[:, None, :].to(cdt), emb], dim=1)
    x = (_f32(x) + _f32(pos[:n_valid])[None]).to(cdt)
    return blocks_forward_plain(x, blocks, fn, heads, dim_head, final_norm)


def _want_trunk(blocks, fn, d: int, heads: int, dim_head: int, cdt):
    """(tensor, shape, dtype) of every block weight and the final norm."""
    inner = heads * dim_head
    mlp = blocks[0][7].shape[1]
    want = [(fn[0], (d,), torch.float32), (fn[1], (d,), torch.float32)]
    for w in blocks:
        shapes = [(d,), (d,), (d, 3 * inner), (inner, d), (d,), (d,), (d,),
                  (d, mlp), (mlp,), (mlp, d), (d,)]
        want += [(t, s, cdt) for t, s in zip(w, shapes)]
    return want


def _verify(want, device, cdt, final_norm: str) -> None:
    if cdt not in _DTYPES:
        raise TypeError(f"compute dtype {cdt}: the kernel takes fp32 or bf16")
    if final_norm not in _NORMS:
        raise ValueError(f"final_norm {final_norm!r}")
    for t, shape, dt in want:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, input on {device}")
        if t.dtype != dt:
            raise TypeError(f"tensor of dtype {t.dtype}, expected {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"tensor of shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def _check(patches, goal, pe, pos, blocks, fn, heads, dim_head, n_valid,
           final_norm) -> None:
    cdt = patches.dtype
    b, n_patch, pd = patches.shape
    d = goal.shape[-1]
    if n_valid != n_patch + 1:
        raise ValueError(f"n_valid {n_valid} != n_patch + 1 = {n_patch + 1}:"
                         " the kernel takes the full patch grid")
    want = [(patches, (b, n_patch, pd), cdt), (goal, (b, d), cdt),
            (pe[0], (pd, d), cdt), (pe[1], (d,), cdt),
            (pos, (n_valid, d), cdt)]
    _verify(want + _want_trunk(blocks, fn, d, heads, dim_head, cdt),
            patches.device, cdt, final_norm)


def _flat_vectors(blocks, fn):
    """Block vectors and final-norm parameters as (n,) (the JAX layout
    keeps them (1, n))."""
    fn = tuple(t.reshape(-1) for t in fn)
    blocks = [tuple(t.reshape(-1) if t.dim() == 2 and t.shape[0] == 1
                    else t for t in w) for w in blocks]
    return blocks, fn


def k1_form_for(batch: int, n: int, pd: int, d: int, heads: int,
                dim_head: int, mlp: int, dtype: torch.dtype, aligned: bool,
                sms: int) -> str:
    """The form K1 takes (a key of K1_FORMS) for `batch` frames of n rows
    of patches of pd values on a card of `sms` SMs. The tensor-core
    kernels where their body takes the widths (`smem.tensor_core_widths`:
    bf16, d = dim_head = 64, at most 80 rows, mlp a multiple of 64), pd is
    a multiple of 16 and the staged pe_w fits the body's shared memory
    (`smem.k1_embed`), and the patches and matrix weights are 16-byte
    aligned: the cluster form where CLUSTER x batch <= CLUSTER_LOAD x sms
    (at most 90 frames on an H100) and each rank takes one head (heads =
    CLUSTER, mlp a multiple of CLUSTER x 64); else two frames a thread
    block. In fp32 at the same widths (`smem.tf32_widths`), the same
    cluster bound and heads, pd a multiple of 8 whose staged pe_w slice
    fits under the rest of the CTA's layout, and aligned patches and
    matrix weights: the fp32 cluster form. Every other call (fp32 past
    the cluster bound, other widths, longer frames) takes the FMA
    kernel."""
    cluster = (CLUSTER * batch <= CLUSTER_LOAD * sms and heads == CLUSTER
               and mlp % (CLUSTER * 64) == 0 and aligned)
    if tf32_widths(n, d, dim_head, mlp, dtype):
        fits = pd % 8 == 0 and k1_cluster_fp32(n, pd) == k1_cluster_fp32(n, 0)
        return "cluster_fp32" if cluster and fits else "fma"
    if not (tensor_core_widths(n, d, dim_head, mlp, dtype) and aligned
            and pd % 16 == 0 and k1_embed(pd) <= fwd_mma(n)):
        return "fma"
    if cluster and k1_embed(pd) <= k1_cluster(n, 0):
        return "cluster"
    return "mma"


def k1_form(patches, goal, pe, pos, blocks, fn, heads, dim_head, n_valid,
            final_norm) -> str:
    """K1's form for these arguments of `got_forward_fused` on their card
    (`k1_form_for`); the wrapper launches it, chip_smoke.py reads it."""
    b, _, pd = patches.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (
        patches, pe[0], *[w[i] for w in blocks for i in (2, 3, 7, 9)]))
    return k1_form_for(b, n_valid, pd, goal.shape[-1], heads, dim_head,
                       blocks[0][7].shape[1], patches.dtype, aligned,
                       _sm_count(patches.device))


def k4_form_for(n: int, d: int, heads: int, dim_head: int, mlp: int,
                dtype: torch.dtype, aligned: bool, streams: bool) -> str:
    """The form K4 takes (a key of K4_FORMS) for frames of n rows;
    `aligned`: x and every block's matrix weights 16-byte aligned;
    `streams`: the call writes K6's streams (autograd records it). bf16 at
    the tensor-core widths (`smem.tensor_core_widths`) and aligned: the
    tensor-core body's K4 form, which writes the streams too. fp32 at the
    same widths (`smem.tf32_widths`), 4 heads (one a rank), mlp a multiple
    of 4 x 64, aligned and without streams: the fp32 cluster form, at any
    batch (on an H100 80GB HBM3 at 700 W, chip_smoke.py phase 23a, it beat
    the FMA body from 1 to 512 frames). Every other call, the recording
    fp32 forward among them (K6's fp32 FMA bodies recompute each block's
    internals from the FMA forward), takes the FMA kernel."""
    if tensor_core_widths(n, d, dim_head, mlp, dtype):
        return "mma" if aligned else "fma"
    if (tf32_widths(n, d, dim_head, mlp, dtype) and heads == CLUSTER
            and mlp % (CLUSTER * 64) == 0 and aligned and not streams):
        return "cluster_fp32"
    return "fma"


def k4_form(x, blocks, heads, dim_head, streams=False) -> str:
    """K4's form for these arguments of `blocks_cls_forward_fused`
    (`k4_form_for`); the wrapper launches it, chip_smoke.py reads it."""
    _, n, d = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (
        x, *[w[i] for w in blocks for i in (2, 3, 7, 9)]))
    return k4_form_for(n, d, heads, dim_head, blocks[0][7].shape[1],
                       x.dtype, aligned, streams)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's SM count; 0 off the card (no kernel runs there)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built and
    loaded at the first launch, never at import)."""
    from dgvit_tpu_torch.ops import _build

    lib = _build.load("got_megakernel")
    lib.got_forward_launch.restype = ctypes.c_int
    lib.got_forward_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    lib.blocks_forward_launch.restype = ctypes.c_int
    lib.blocks_forward_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_void_p])
    lib.got_forward_smem.restype = ctypes.c_size_t
    lib.got_forward_smem.argtypes = [ctypes.c_int] * 7
    lib.k1_smem.restype = ctypes.c_size_t
    lib.k1_smem.argtypes = [ctypes.c_int] * 8
    lib.got_error_string.restype = ctypes.c_char_p
    lib.got_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(patches, goal, pe, pos, blocks, fn, heads, dim_head, n_valid,
            final_norm, form) -> torch.Tensor:
    lib = _kernel_lib()
    b, n_patch, pd = patches.shape
    d = goal.shape[-1]
    out = torch.empty((b, d), dtype=patches.dtype, device=patches.device)
    tensors = [patches, goal, pe[0], pe[1], pos,
               *[t for w in blocks for t in w], fn[0], fn[1], out]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    with torch.cuda.device(patches.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.got_forward_launch(
            _DTYPES[patches.dtype], ctypes.cast(ptrs, ctypes.c_void_p),
            len(tensors), b, n_patch, pd, d, heads, dim_head,
            blocks[0][7].shape[1], len(blocks), _NORMS[final_norm],
            dim_head ** -0.5, stream, K1_FORMS[form])
    if err != 0:
        raise RuntimeError(f"got_megakernel launch failed (K1, {form}): "
                           + lib.got_error_string(err).decode())
    got_forward_fused.launches += 1
    return out


def got_forward_fused(patches: torch.Tensor, goal: torch.Tensor,
                      pe: Tuple[torch.Tensor, torch.Tensor],
                      pos: torch.Tensor,
                      blocks: Sequence[Sequence[torch.Tensor]],
                      fn: Tuple[torch.Tensor, torch.Tensor], heads: int,
                      dim_head: int, n_valid: int, final_norm: str
                      ) -> torch.Tensor:
    """Fused whole-trunk GoT forward.

    patches: (B, n_patch, patch_dim), compute dtype (fp32 or bf16)
    goal:    (B, dim) embedded goal token, compute dtype
    pe:      (kernel (patch_dim, dim), bias (dim,)), compute dtype
    pos:     (n_valid, dim) positional embedding, compute dtype
    blocks:  per-block 11-tuples in the fused-transformer order, compute
             dtype, matrices (in, out)
    fn:      final-norm (scale, bias), each (dim,) fp32
    Returns the (B, dim) latent in the compute dtype.

    CUDA tensors go to the CUDA kernel in the form `k1_form` picks (and
    raise if it cannot run); CPU tensors go to the plain version.
    `got_forward_fused.launches` counts kernel launches.
    """
    pe = tuple(t.reshape(-1) if t.dim() == 2 and t.shape[0] == 1 else t
               for t in pe)
    blocks, fn = _flat_vectors(blocks, fn)
    _check(patches, goal, pe, pos, blocks, fn, heads, dim_head, n_valid,
           final_norm)
    if patches.device.type == "cuda":
        args = (patches, goal, pe, pos, blocks, fn, heads, dim_head, n_valid,
                final_norm)
        return _launch(*args, k1_form(*args))
    if patches.device.type != "cpu":
        raise ValueError(f"no kernel for device {patches.device}")
    return got_forward_plain(patches, goal, pe, pos, blocks, fn, heads,
                             dim_head, n_valid, final_norm)


got_forward_fused.launches = 0


def _launch_blocks(x, blocks, fn, heads, dim_head, final_norm, body=None,
                   streams=False):
    """K4's launch: out, or with `streams` (out, (xs, cls, saved)) as
    `blocks_forward_plain` returns them."""
    lib = _kernel_lib()
    b, n, d = x.shape
    out = torch.empty((b, d), dtype=x.dtype, device=x.device)
    st = (stream_buffers(x, blocks, heads, dim_head) if streams
          else (None, None, None))
    tensors = [x, *[t for w in blocks for t in w], fn[0], fn[1], out]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    # the form k4_form picks; `body` (a value of K4_FORMS) forces one, for
    # chip_smoke.py and chip_numerics.py
    mma = body if body is not None else K4_FORMS[
        k4_form(x, blocks, heads, dim_head, streams)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blocks_forward_launch(
            _DTYPES[x.dtype], ctypes.cast(ptrs, ctypes.c_void_p),
            len(tensors), b, n, d, heads, dim_head, blocks[0][7].shape[1],
            len(blocks), _NORMS[final_norm], dim_head ** -0.5, stream, mma,
            *[None if t is None else t.data_ptr() for t in st])
    if err != 0:
        raise RuntimeError("blocks_cls_forward_fused launch failed (K4, "
                           f"form {mma}): "
                           + lib.got_error_string(err).decode())
    blocks_cls_forward_fused.launches += 1
    blocks_cls_forward_fused.cluster_launches += mma == 3
    return (out, st) if streams else out


def _blocks_forward(x, blocks, fn, heads, dim_head, final_norm,
                    streams=False):
    """K4 on checked arguments: the kernel for CUDA tensors, the plain
    version for CPU tensors; with `streams` also the streams K6 reads."""
    if x.device.type == "cuda":
        return _launch_blocks(x, blocks, fn, heads, dim_head, final_norm,
                              streams=streams)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return blocks_forward_plain(x, blocks, fn, heads, dim_head, final_norm,
                                streams=streams)


class _BlocksCls(torch.autograd.Function):
    """K4 forward, K6 backward. `record`: the call will be differentiated,
    so K4 writes the streams and the backward hands them to K6."""

    @staticmethod
    def forward(ctx, x, heads, dim_head, final_norm, record, fs, fb, *flat):
        ctx.cfg = (heads, dim_head, final_norm)
        blocks = [flat[i:i + 11] for i in range(0, len(flat), 11)]
        if not record:
            return _blocks_forward(x, blocks, (fs, fb), heads, dim_head,
                                   final_norm)
        out, st = _blocks_forward(x, blocks, (fs, fb), heads, dim_head,
                                  final_norm, streams=True)
        ctx.save_for_backward(x, *st, fs, fb, *flat)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, xs, cls, saved, fs, fb, *flat = ctx.saved_tensors
        blocks = [tuple(flat[i:i + 11]) for i in range(0, len(flat), 11)]
        dx, gblocks, dfn = trunk_bwd_fused(x, dy.contiguous(), blocks,
                                           (fs, fb), *ctx.cfg,
                                           (xs, cls, saved))
        return (dx, None, None, None, None, *dfn, *[g for gb in gblocks
                                                    for g in gb])


def blocks_cls_forward_fused(x: torch.Tensor,
                             blocks: Sequence[Sequence[torch.Tensor]],
                             fn: Tuple[torch.Tensor, torch.Tensor],
                             heads: int, dim_head: int, final_norm: str
                             ) -> torch.Tensor:
    """Fused blocks -> CLS pool -> final norm (K4): (B, n, d) -> (B, d).

    x:      (B, n, dim) embedded stream (goal token, patches, positional
            embedding and dropout applied), compute dtype
    blocks: per-block 11-tuples in the fused-transformer order, compute
            dtype, matrices (in, out)
    fn:     final-norm (scale, bias), each (dim,) fp32
    Returns the (B, dim) latent in the compute dtype.

    Differentiable in x, every block weight and the final-norm parameters:
    the backward is `trunk_bwd_fused` (K6), on the streams K4 writes only
    when grad mode is on and an input requires grad (6.4 MB of bf16 and
    the CLS block's 3.0 MB of fp32 records at B=256 on the flagship
    trunk, held until the backward; no-grad forwards write none). CUDA tensors go to the CUDA
    kernels (and raise if they cannot run); CPU tensors go to the plain
    versions. `blocks_cls_forward_fused.launches` counts K4's launches,
    `blocks_cls_forward_fused.cluster_launches` those of the fp32 cluster
    form (`k4_form`).
    """
    blocks, fn = _flat_vectors(blocks, fn)
    b, n, d = x.shape
    _verify([(x, (b, n, d), x.dtype)]
            + _want_trunk(blocks, fn, d, heads, dim_head, x.dtype),
            x.device, x.dtype, final_norm)
    if heads > n:
        raise ValueError(f"{heads} heads over {n} rows")
    flat = [t for w in blocks for t in w]
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *fn, *flat))
    return _BlocksCls.apply(x, heads, dim_head, final_norm, record, *fn,
                            *flat)


blocks_cls_forward_fused.launches = 0
blocks_cls_forward_fused.cluster_launches = 0
