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
    body of K2f and K4;
  * K6's launch, the largest of the bodies it runs;
  * `SectionSmem<T>` (csrc/attention.cu): K7, by query tile.

Each library exports the same numbers (`got_forward_smem`,
`block_forward_smem`, `block_backward_smem`, `trunk_backward_smem`,
`attention_section_smem`); chip_smoke.py holds the two against each other
on the card. `fits` decides from shapes alone, before any launch, whether
a kernel can hold a frame; the model's routes (`models/got.py`,
`models/layers.py`) send a frame that no kernel of the route can hold to
the composed blocks. On the CPU the wrappers run their plain versions,
which have no such limit (`limit_for` gives None).
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
    """`mmafwd::Layout(n)`: the tensor-core forward body of K2f and K4."""
    tile = 2 * _FRAMES * _a16(n) * _LD
    wq, w64 = 2 * MMA_WIDTH * _LD_QKV, 2 * MMA_WIDTH * _LD
    warps = _FRAMES * _a16(n) // 16
    attn = _take(0, (tile, tile, tile, 2 * wq, 2 * w64))
    mlp = _take(0, (_STAGES * 2 * w64, 4 * warps * 16 * _LD_HID,
                    4 * MMA_CHUNK * _LD_W2))
    o = max(mlp, attn)
    return _take(o, (2 * 16 * _LD, 4 * _FRAMES * MMA_WIDTH,
                     4 * _FRAMES * MMA_WIDTH))


def trunk_bwd(n: int, d: int, heads: int, dim_head: int, mlp: int,
              dtype: torch.dtype, mma: bool) -> int:
    """K6's launch: the forward chain's `Smem<T>` and the largest backward
    body it runs."""
    return max(fwd_fma(n, d, heads, dim_head, mlp, dtype), bwd_fma(n, d, mlp),
               bwd_mma(n) if mma else 0,
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
    fma = fwd_fma(n, d, heads, dim_head, mlp, dtype)
    if kernel in ("K1", "K3f"):
        return fma
    if kernel in ("K4", "K2f"):
        return max(fma, fwd_mma(n) if mma else 0)
    if kernel == "K3b":
        return max(bwd_fma(n, d, mlp),
                   bwd_cls_mma(n, heads, dim_head, mlp) if mma else 0)
    if kernel == "K2b":
        return max(bwd_fma(n, d, mlp), bwd_mma(n) if mma else 0)
    if kernel == "K6":
        return trunk_bwd(n, d, heads, dim_head, mlp, dtype, mma)
    if kernel == "K7":
        return section(n, d, dim_head, 1, dtype)
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
    """Whether every kernel of a route holds n-row frames on `device`."""
    limit = limit_for(device)
    return all(fits(k, n, d, heads, dim_head, mlp, dtype, limit)
               for k in kernels)
