"""Shared memory of the port's kernel launches, and the route rule built on
it.

Each CUDA kernel of a frame (K1, K4, K2f, K2b, K3f, K3b, K6, K7) keeps a
whole frame, or a tile of its query rows (K7), in one thread block's
shared memory, so a launch fails for a frame longer than the device's
per-block limit allows. The functions below repeat, in plain Python, the
layouts the launches size their memory by:

  * `Smem<T>` (csrc/block_common.cuh): the FMA forward body of K1, K4,
    K2f and K3f;
  * `BwdSmem` (csrc/block_grad.cu): the FMA backward bodies of K2b and
    K3b;
  * `MmaBwdSmem` (csrc/block_grad.cu): K2b's tensor-core backward body;
  * `ClsMmaSmem` (csrc/block_grad.cu): K3b's tensor-core backward body;
  * `mmafwd::Layout` (csrc/block_mma_fwd.cuh): the tensor-core forward
    body of K2f, K3f, K4 and K1 (K1 also stages pe_w over it first);
  * `cl::Layout` (csrc/got_megakernel.cu): a CTA of K1's cluster form;
  * `cl32::Layout` (csrc/tf32_block.cuh): a CTA of K1's fp32 cluster
    form, and (with no patches) of K2f's and K4's;
  * `bw32::Layout` (csrc/block_grad.cu): a CTA of K2b's fp32 cluster
    form;
  * `ClsFwdLayout`, `ClsBwdLayout` and `cm32::kBytes` (csrc/block_grad.cu):
    a CTA of K3f's and K3b's fp32 cluster forms (the per-frame cluster
    launches), and of their batched CLS-row MLP launches;
  * K6's launch, the largest of the bodies it runs;
  * `SectionSmem<T>` (csrc/attention.cu): K7's FMA kernel, by query
    tile; `SectionMmaSmem` (csrc/attention.cu): its tensor-core form.

Each library exports the same numbers (`got_forward_smem`,
`block_forward_smem`, `block_backward_smem`, `trunk_backward_smem`,
`attention_section_smem`); chip_smoke.py holds the two against each other
on the card. `fits` decides from shapes alone, before any launch, whether
a kernel can hold a frame; the model's routes (`models/got.py`,
`models/layers.py`) send a frame that no kernel of the route can hold to
the composed blocks. On the CPU the wrappers run their plain versions,
which have no such limit (`limit_for` gives None). A block without an
output projection (heads == 1 and dim_head == d) fits no route.
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional

import torch

KERNELS = ("K1", "K4", "K2f", "K2b", "K3f", "K3b", "K6", "K7")
# the widths the bf16 tensor-core bodies are built for (block_mma_fwd.cuh,
# block_grad.cu: kMmaD, kMmaRows, kMmaChunk)
MMA_WIDTH, MMA_ROWS, MMA_CHUNK = 64, 80, 64
_WARPS = 8            # kWarps of block_common.cuh
_FRAMES = 2           # mmafwd::kFrames
_STAGES = 3           # mmafwd::kStages
_LD, _LD_QKV = MMA_WIDTH + 8, 3 * MMA_WIDTH + 8
_LD_KV = 2 * MMA_WIDTH + 8    # kLdKv
_CLS_CHUNK = 128              # kClsChunk
_LD_HID = MMA_CHUNK + 4   # mmafwd::kLdHid
_LD_W2 = 80               # mmafwd::kLdW2


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def _esize(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def fwd_fma(n: int, d: int, heads: int, dim_head: int, mlp: int,
            dtype: torch.dtype) -> int:
    """`Smem<T>`, the forward kernels' MLP chunk min(mlp, 256)."""
    es, hc, inner = _esize(dtype), min(mlp, 256), heads * dim_head
    qkv = n * (3 * dim_head + (2 if es == 2 else 1)) + n * inner
    acc = _a16(4 * n * d)
    prob = _a16(acc + 4 * n * d)
    h = _a16(prob + 4 * _WARPS * n)
    scratch = _a16(h + es * n * d)
    return _a16(scratch + es * max(qkv, n * hc))


def bwd_fma(n: int, d: int, mlp: int) -> int:
    """`BwdSmem`, the backward kernels' MLP chunk min(mlp, 128)."""
    nd, wide = 4 * n * d, max(n, min(mlp, 128))
    o = 0
    for size in (nd, nd, nd, nd, 4 * 4 * n, 4 * n * wide, 4 * n * wide):
        o = _a16(o + size)
    return _a16(o + 4 * _WARPS * n)


def _take(o: int, sizes: Iterable[int]) -> int:
    for size in sizes:
        o = _a16(o + size)
    return o


def bwd_mma(n: int) -> int:
    """`MmaBwdSmem(n)`: K2b's tensor-core body (d = dim_head = 64)."""
    np_, w = _a16(n), MMA_WIDTH
    rows, tile = 4 * n * w, 2 * np_ * _LD
    wqkv, w64 = 2 * w * _LD_QKV, 2 * w * _LD
    probs = 2 * np_ * (np_ + 8)
    u = _take(0, (rows, rows, rows, 4 * 4 * n, tile))
    after_x1 = _take(u, (rows,))
    attn = _take(after_x1, (wqkv, w64, tile, tile, tile, tile))
    mlp = _take(after_x1, (tile, tile, 2 * w64, 2 * w64, tile,
                           4 * np_ * _LD, tile))
    back = _take(u, (tile, wqkv, w64, tile, tile, tile, tile, probs, probs,
                     2 * np_ * _LD_QKV))
    return max(attn, mlp, back)


def bwd_cls_mma(n: int, heads: int, dim_head: int, mlp: int) -> int:
    """`ClsMmaSmem(n, heads * dim_head, mlp)`: K3b's tensor-core body."""
    np_, w = _a16(n), MMA_WIDTH
    rows, tile = 4 * n * w, 2 * np_ * _LD
    vec, wkv = 2 * heads * dim_head, 2 * w * _LD_KV
    chunks = -(-mlp // _CLS_CHUNK)
    u = _take(0, (rows, rows, 4 * (2 * n + 2), tile, vec, vec, vec, vec,
                  4 * w, 4 * w, 4 * w, 2 * w, 2 * w, 4 * n, 4 * n, 2 * wkv))
    head_loops = _take(u, (tile, tile, 2 * np_ * _LD_KV))
    mlp_part = _take(u, (2 * mlp, 4 * chunks * w))
    return max(head_loops, mlp_part)


def fwd_mma(n: int) -> int:
    """`mmafwd::Layout(n)`: the tensor-core forward body of K2f, K3f and
    K4."""
    tile = 2 * _FRAMES * _a16(n) * _LD
    wq, w64 = 2 * MMA_WIDTH * _LD_QKV, 2 * MMA_WIDTH * _LD
    warps = _FRAMES * _a16(n) // 16
    attn = _take(0, (tile, tile, tile, 2 * wq, 2 * w64))
    mlp = _take(0, (_STAGES * 2 * w64, 4 * warps * 16 * _LD_HID,
                    4 * MMA_CHUNK * _LD_W2))
    o = max(mlp, attn)
    return _take(o, (2 * 16 * _LD, 4 * _FRAMES * MMA_WIDTH,
                     4 * _FRAMES * MMA_WIDTH))


def k1_embed(pd: int) -> int:
    """The pe_w tile K1's tensor-core kernel stages at the front of its
    shared memory before the blocks (csrc/got_megakernel.cu, k1_bytes):
    pd rows of the body's 64-wide bf16 tiles."""
    return _a16(2 * pd * _LD)


def k1_cluster(n: int, pd: int) -> int:
    """`cl::Layout(n, pd)` (csrc/got_megakernel.cu): a CTA of K1's cluster
    form, one head's tiles and weights over the MLP's ring and the staged
    pe_w, then the out-projection's and the MLP's fp32 partials (16 x 64
    a warp) and the CLS row."""
    np_, w64 = _a16(n), 2 * MMA_WIDTH * _LD
    attn = _take(0, (2 * np_ * _LD, 2 * np_ * _LD, 2 * MMA_WIDTH * _LD_QKV,
                     w64))
    o = max(attn, _take(0, (_STAGES * 2 * w64,)), k1_embed(pd))
    part = 4 * (np_ // 16) * 16 * MMA_WIDTH
    return _take(o, (part, part, 4 * MMA_WIDTH))


# K1's fp32 cluster form (csrc/got_megakernel.cu, namespace cl32): fp32
# tiles, 64 columns of the k tile padded to 72, of the v tile, the weight
# tiles and the 16-column pe_w slice to 68 and 20
_LD_K32, _LD_W32, _LD_PE32 = MMA_WIDTH + 8, MMA_WIDTH + 4, MMA_WIDTH // 4 + 4


def k1_cluster_fp32(n: int, pd: int) -> int:
    """`cl32::Layout(n, pd)` (csrc/tf32_block.cuh): a CTA of K1's fp32
    cluster form (pd = 0: of K2f's and K4's), one head's fp32 k and v
    (rows padded to 16) and its q|k|v and wout slices, over them the MLP's
    two-stage ring and the rank's 16 columns of pe_w; then the two fp32
    partial tiles (16 x 64 a warp), the rank's embedding columns and the
    CLS row."""
    np_, w64 = _a16(n), 4 * MMA_WIDTH * _LD_W32
    attn = _take(0, (4 * np_ * _LD_K32, 4 * np_ * _LD_W32, 3 * w64, w64))
    o = max(attn, _take(0, (2 * 2 * w64,)), _take(0, (4 * pd * _LD_PE32,)))
    part = 4 * (np_ // 16) * 16 * MMA_WIDTH
    return _take(o, (part, part, 4 * np_ * (MMA_WIDTH // 4), 4 * MMA_WIDTH))


def bwd_cluster_fp32(n: int) -> int:
    """`bw32::Layout(n)` (csrc/block_grad.cu): a CTA of K2b's fp32 cluster
    form, the head's fp32 k, q and v tiles, the probabilities' tile (row
    stride rows + 4; dh2's partials over it), one region of four 64 x 68
    weight tiles (the head's weights, the MLP's ring, then wout's slice
    and the do tile, then wqkv's), the partial tile, each warp's x and x1
    tiles and the column sums by warp."""
    np_, w64 = _a16(n), 4 * MMA_WIDTH * _LD_W32
    part = 4 * (np_ // 16) * 16 * MMA_WIDTH
    return _take(0, (4 * np_ * _LD_K32, 4 * np_ * _LD_W32,
                     4 * np_ * _LD_W32, max(4 * np_ * (np_ + 4), part),
                     4 * w64, part, part, part, 4 * (np_ // 16) * MMA_WIDTH))


def cls_attend_fp32(n: int) -> int:
    """`ClsFwdLayout(n)` (csrc/block_grad.cu): a CTA of K3f's fp32 cluster
    form's attention launch, `cl32::Layout`'s attention tiles alone (the
    head's fp32 k and v, its q|k|v and wout slices; the out-projection's
    partial over the q|k|v slices, no MLP ring): 114,432 bytes at 65 or 80
    rows, so two CTAs fit an H100's 228 KB of shared memory an SM."""
    np_, w64 = _a16(n), 4 * MMA_WIDTH * _LD_W32
    return _take(0, (4 * np_ * _LD_K32, 4 * np_ * _LD_W32, 3 * w64, w64))


def cls_bwd_cluster_fp32(n: int) -> int:
    """`ClsBwdLayout(n)` (csrc/block_grad.cu): a CTA of K3b's fp32 cluster
    form's per-frame launch, `cls_attend_fp32`'s tiles alone (dh1's
    partial tile lies over k, the column sums over v, row 0's ds, p, do
    and q over the wout slice), so two CTAs fit an SM too."""
    return cls_attend_fp32(n)


# `cm32::kBytes` (csrc/block_grad.cu): a CTA of the batched CLS-row MLP
# launches of K3f's and K3b's fp32 cluster forms, four warps each staging
# one hidden chunk's w1 and w2 tiles (64 x 68 floats each); any width
CLS_MLP_FP32 = 4 * 2 * 4 * MMA_WIDTH * _LD_W32


def tf32_widths(n: int, d: int, dim_head: int, mlp: int,
                dtype: torch.dtype) -> bool:
    """The widths the fp32 cluster forms take (K1's, K4's, K2's and
    K3's): fp32, d = dim_head = 64, at most 80 rows, mlp a multiple of 64
    (heads, mlp a multiple of 256 and alignment aside)."""
    return (dtype == torch.float32 and d == dim_head == MMA_WIDTH
            and n <= MMA_ROWS and mlp % MMA_CHUNK == 0)


def trunk_bwd(n: int, d: int, heads: int, dim_head: int, mlp: int,
              mma: bool) -> int:
    """K6's launch: the largest backward body it runs (it runs no forward:
    it reads the streams K4 wrote)."""
    return max(4 * d, bwd_fma(n, d, mlp), bwd_mma(n) if mma else 0,
               bwd_cls_mma(n, heads, dim_head, mlp) if mma else 0)


def section(n: int, d: int, dim_head: int, qrows: int,
            dtype: torch.dtype) -> int:
    """`SectionSmem<T>`: K7 for a tile of qrows query rows."""
    es = _esize(dtype)
    per_word = 4 // es
    words = -(-dim_head // per_word)
    words += words % 2 == 0
    kv = es * n * words * per_word
    o = _take(0, (kv, kv, es * qrows * dim_head, es * qrows * dim_head,
                  4 * qrows * d))
    return _a16(o + 4 * _WARPS * n)


def section_mma(n: int) -> int:
    """`SectionMmaSmem(n)`: K7's tensor-core form, each of two frames' k
    and v of one head, and two heads' wqkv and wout slices."""
    tile = 2 * _FRAMES * _a16(n) * _LD
    return _take(0, (tile, tile, 2 * MMA_WIDTH * _LD_QKV * 2,
                     2 * MMA_WIDTH * _LD * 2))


def tensor_core_widths(n: int, d: int, dim_head: int, mlp: int,
                       dtype: torch.dtype) -> bool:
    """The widths the bf16 tensor-core bodies take: d = dim_head = 64, at
    most 80 rows, mlp a multiple of 64 (alignment aside)."""
    return (dtype == torch.bfloat16 and d == dim_head == MMA_WIDTH
            and n <= MMA_ROWS and mlp % MMA_CHUNK == 0)


def bytes_needed(kernel: str, n: int, d: int, heads: int, dim_head: int,
                 mlp: int, dtype: torch.dtype) -> int:
    """The most dynamic shared memory a launch of `kernel` may ask for at
    these shapes: where the wrapper may pick either body (the tensor-core
    widths, alignment decided at the call), the larger of the two."""
    mma = tensor_core_widths(n, d, dim_head, mlp, dtype)
    tf32 = tf32_widths(n, d, dim_head, mlp, dtype)
    fma = fwd_fma(n, d, heads, dim_head, mlp, dtype)
    if kernel == "K1":
        return max(fma, fwd_mma(n) if mma else 0,
                   k1_cluster(n, 0) if mma else 0,
                   k1_cluster_fp32(n, 0) if tf32 else 0)
    if kernel in ("K2f", "K4"):
        return max(fma, fwd_mma(n) if mma else 0,
                   k1_cluster_fp32(n, 0) if tf32 else 0)
    if kernel == "K3f":
        return max(fma, fwd_mma(n) if mma else 0,
                   max(cls_attend_fp32(n), CLS_MLP_FP32) if tf32 else 0)
    if kernel == "K3b":
        return max(bwd_fma(n, d, mlp),
                   bwd_cls_mma(n, heads, dim_head, mlp) if mma else 0,
                   max(cls_bwd_cluster_fp32(n), CLS_MLP_FP32) if tf32
                   else 0)
    if kernel == "K2b":
        return max(bwd_fma(n, d, mlp), bwd_mma(n) if mma else 0,
                   bwd_cluster_fp32(n) if tf32 else 0)
    if kernel == "K6":
        return trunk_bwd(n, d, heads, dim_head, mlp, mma)
    if kernel == "K7":
        return max(section(n, d, dim_head, 1, dtype),
                   section_mma(n) if tensor_core_widths(
                       n, d, dim_head, 0, dtype) else 0)
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


def fits(kernel: str, n: int, d: int, heads: int, dim_head: int, mlp: int,
         dtype: torch.dtype, limit: Optional[int]) -> bool:
    """Whether a launch of `kernel` holds n-row frames within `limit`
    bytes of shared memory a block (None: no limit)."""
    need = bytes_needed(kernel, n, d, heads, dim_head, mlp, dtype)
    return limit is None or need <= limit


@functools.lru_cache(maxsize=None)
def _optin(index: int) -> int:
    return torch.cuda.get_device_properties(
        index).shared_memory_per_block_optin


def limit_for(device: torch.device) -> Optional[int]:
    """The shared memory a block may opt into on `device`; None on the
    CPU, where the wrappers run their plain versions."""
    if device.type != "cuda":
        return None
    return _optin(device.index if device.index is not None
                  else torch.cuda.current_device())


def route_fits(kernels: Iterable[str], n: int, d: int, heads: int,
               dim_head: int, mlp: int, dtype: torch.dtype,
               device: torch.device) -> bool:
    """Whether every kernel of a route holds n-row frames on `device`. A
    block with heads == 1 and dim_head == d has no output projection,
    which every kernel takes: no route fits it, on any device."""
    if heads == 1 and dim_head == d:
        return False
    limit = limit_for(device)
    return all(fits(k, n, d, heads, dim_head, mlp, dtype, limit)
               for k in kernels)
