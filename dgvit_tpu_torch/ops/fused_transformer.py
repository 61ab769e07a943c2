"""The fused pre-norm transformer block (K2): its plain PyTorch pieces,
its hand-written backward, and the kernel wrappers.

Counterpart of `dgvit_tpu/ops/fused_transformer.py`. The whole-trunk
kernels (`ops/got_megakernel.py`), the CLS-only block (`ops/cls_block.py`)
and this block share the plain pieces. They follow the TPU kernel bodies
(`_block_body`, `_block_bwd_body`), not the JAX package's unfused twin
`_block_xla`, in the two places where those differ:

  * GELU is the tanh form when the compute dtype is bf16 and an erf
    polynomial accurate to fp32 otherwise (`_gelu32`, and its derivative
    `_gelu_grad32`); the twin always uses erf;
  * attention probabilities are cast to the compute dtype before P.V.

Numerics: norm statistics, softmax and every accumulation run in fp32;
matrix operands are values of the compute dtype (products of bf16 values
are exact in fp32, so an fp32 product of up-cast operands is what a bf16
tensor-core product with fp32 accumulation computes).

A block's 11 parameters come in the kernel's order:
(attn_norm scale, attn_norm bias, wqkv (d, 3*inner), wout (inner, d),
 bout, ff_norm scale, ff_norm bias, w1 (d, mlp), b1, w2 (mlp, d), b2),
matrices stored (in, out); vectors (n,).

`fused_transformer_block` is differentiable: `block_fwd_fused` (K2f) and
`block_bwd_fused` (K2b) launch the CUDA kernels of `csrc/block_grad.cu`
for CUDA tensors and run `block_fwd_plain` / `block_bwd_plain` for CPU
tensors; nothing else picks between them. `block_bwd_plain` is written by
hand after `_block_bwd_body`, not taken from autograd of `block_plain`:
in bf16 the two round at different points.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from dgvit_tpu_torch.ops.smem import tensor_core_widths

_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def block_fwd_plain(x: torch.Tensor, w: Sequence[torch.Tensor], heads: int,
                    dim_head: int) -> torch.Tensor:
    """Plain version of K2f: (B, n, d) -> (B, n, d), compute dtype."""
    return block_plain(_f32(x), w, heads=heads, dim_head=dim_head,
                       cdt=x.dtype).to(x.dtype)


def _gelu_grad32(z: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """d gelu / dz in `_gelu32`'s form: the tanh form's derivative for a
    bf16 compute dtype, Phi(z) + z phi(z) with the erf polynomial for
    fp32."""
    if cdt == torch.bfloat16:
        z2 = z * z
        inner = _SQRT_2_OVER_PI * (z + _GELU_C * z * z2)
        t = torch.tanh(inner)
        dinner = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * z2)
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * dinner
    phi = 0.5 * (1.0 + _erf32(z * _INV_SQRT2))
    return phi + z * _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


def _ln_stats(x32, scale, bias, eps: float = 1e-5):
    """LayerNorm forward keeping what its backward needs: (xhat, rstd, y)."""
    m = x32.mean(dim=-1, keepdim=True)
    v = (x32 - m).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(v + eps)
    xhat = (x32 - m) * rstd
    return xhat, rstd, xhat * scale + _f32(bias).reshape(-1)


def _ln_bwd(dh32, xhat, rstd, scale):
    """LayerNorm backward from the fp32 grad of its output: (dx, dscale,
    dbias), the parameter grads summed over every row."""
    dxhat = dh32 * scale
    rows = (dh32 * xhat).reshape(-1, dh32.shape[-1])
    mean_d = dxhat.mean(dim=-1, keepdim=True)
    mean_dx = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - mean_d - xhat * mean_dx)
    return dx, rows.sum(dim=0), dh32.reshape(-1, dh32.shape[-1]).sum(dim=0)


def _tmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^T B over every row of (..., K) and (..., N): (K, N) in fp32."""
    return _f32(a).reshape(-1, a.shape[-1]).t() @ _f32(b).reshape(
        -1, b.shape[-1])


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, n, heads * dh) -> (B, heads, n, dh)."""
    b, n, inner = t.shape
    return t.reshape(b, n, heads, inner // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, heads, n, dh) -> (B, n, heads * dh)."""
    b, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(b, n, h * dh)


def _grads_like(grads, w) -> Tuple[torch.Tensor, ...]:
    """fp32 grads cast to each weight's dtype and shape, as the TPU kernel
    casts its accumulators to the weight dtype."""
    return tuple(g.reshape(t.shape).to(t.dtype) for g, t in zip(grads, w))


def block_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                    w: Sequence[torch.Tensor], heads: int, dim_head: int):
    """Plain version of K2b, step by step after `_block_bwd_body`.

    x, dy: (B, n, d) in the compute dtype. Recomputes the forward, then
    returns (dx in the compute dtype, the 11 weight grads in the weights'
    dtype). Rounded to the compute dtype before their products: dy, dpre,
    g1, do and dqkv; ds after the scale; dv takes the rounded
    probabilities, ds the unrounded ones."""
    an_s, an_b, wqkv, wout, bout, fn_s, fn_b, w1, b1, w2, b2 = w
    cdt = x.dtype
    inner = heads * dim_head
    scale = dim_head ** -0.5
    x32, dy32, dy_c = _f32(x), _f32(dy), dy.to(cdt)

    # recompute the forward: LN1 -> qkv -> attention -> x1 -> LN2
    a_s32 = _f32(an_s).reshape(-1)
    xhat1, rstd1, h1_32 = _ln_stats(x32, a_s32, an_b)
    h1 = h1_32.to(cdt)
    qkv = _mm(h1, wqkv).to(cdt)
    q, k, v = (_heads(qkv[..., i * inner:(i + 1) * inner], heads)
               for i in range(3))
    s = _f32(q) @ _f32(k).transpose(-1, -2) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p32 = e / e.sum(dim=-1, keepdim=True)
    p_c = p32.to(cdt)
    o = _merge((_f32(p_c) @ _f32(v)).to(cdt))
    x1 = x32 + (_mm(o, wout) + _f32(bout).reshape(-1))
    f_s32 = _f32(fn_s).reshape(-1)
    xhat2, rstd2, h2_32 = _ln_stats(x1, f_s32, fn_b)
    h2 = h2_32.to(cdt)

    # MLP forward + backward
    pre = _mm(h2, w1) + _f32(b1).reshape(-1)
    hid = _gelu32(pre, cdt).to(cdt)
    dpre = _mm(dy_c, w2.t()) * _gelu_grad32(pre, cdt)
    dpre_c = dpre.to(cdt)
    dw1, db1 = _tmm(h2, dpre_c), dpre.reshape(-1, dpre.shape[-1]).sum(dim=0)
    dw2, db2 = _tmm(hid, dy_c), dy32.reshape(-1, dy32.shape[-1]).sum(dim=0)
    dh2 = _mm(dpre_c, w1.t())
    dln2_x, dfs, dfb = _ln_bwd(dh2, xhat2, rstd2, f_s32)
    g1 = dy32 + dln2_x
    g1_c = g1.to(cdt)

    # attention backward
    dbout = g1.reshape(-1, g1.shape[-1]).sum(dim=0)
    dwout = _tmm(o, g1_c)
    do_h = _heads(_mm(g1_c, wout.t()).to(cdt), heads)
    dv = _f32(p_c).transpose(-1, -2) @ _f32(do_h)
    dp = _f32(do_h) @ _f32(v).transpose(-1, -2)
    ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
    ds = _f32((ds * scale).to(cdt))
    dq = ds @ _f32(k)
    dk = ds.transpose(-1, -2) @ _f32(q)
    dqkv_c = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1).to(cdt)
    dwqkv = _tmm(h1, dqkv_c)
    dh1 = _mm(dqkv_c, wqkv.t())
    dln1_x, das, dab = _ln_bwd(dh1, xhat1, rstd1, a_s32)
    dx = (g1 + dln1_x).to(cdt)
    return dx, _grads_like((das, dab, dwqkv, dwout, dbout, dfs, dfb, dw1,
                            db1, dw2, db2), w)


def check_block_args(x: torch.Tensor, w: Sequence[torch.Tensor], heads: int,
                     dim_head: int, dy: torch.Tensor = None,
                     cls: bool = False) -> None:
    """Raise on what the block kernels do not take: another dtype than fp32
    or bf16, tensors on another device or of another dtype than x, wrong
    shapes, non-contiguous tensors."""
    cdt = x.dtype
    if cdt not in _DTYPES:
        raise TypeError(f"compute dtype {cdt}: the kernel takes fp32 or bf16")
    if x.dim() != 3:
        raise ValueError(f"x of shape {tuple(x.shape)}: expected (B, n, d)")
    b, n, d = x.shape
    inner = heads * dim_head
    mlp = w[7].shape[-1]
    shapes = [(d,), (d,), (d, 3 * inner), (inner, d), (d,), (d,), (d,),
              (d, mlp), (mlp,), (mlp, d), (d,)]
    want = list(zip(w, shapes))
    if dy is not None:
        want.append((dy, (b, d) if cls else (b, n, d)))
    for t, shape in [(x, (b, n, d))] + want:
        if t.device != x.device or t.dtype != cdt:
            raise TypeError(f"tensor of {t.dtype} on {t.device}; x is "
                            f"{cdt} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"tensor of shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if heads > n:
        raise ValueError(f"{heads} heads over {n} rows")


@functools.cache
def _block_lib() -> ctypes.CDLL:
    """The built per-block kernel library with its C signatures declared
    (built and loaded at the first launch, never at import)."""
    from dgvit_tpu_torch.ops import _build

    lib = _build.load("block_grad")
    shape = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    for fn in (lib.block_forward_launch, lib.block_backward_launch):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + shape \
            + [ctypes.c_int]
    for fn in (lib.block_forward_smem, lib.block_backward_smem):
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_int] * 8
    lib.trunk_backward_smem.restype = ctypes.c_size_t
    lib.trunk_backward_smem.argtypes = [ctypes.c_int] * 7
    lib.block_backward_workspace.restype = ctypes.c_size_t
    lib.block_backward_workspace.argtypes = [ctypes.c_int] * 8
    lib.trunk_backward_workspace.restype = ctypes.c_size_t
    lib.trunk_backward_workspace.argtypes = [ctypes.c_int] * 8
    lib.trunk_backward_launch.restype = ctypes.c_int
    lib.trunk_backward_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    lib.weight_product_segments.restype = ctypes.c_int
    lib.weight_product_segments.argtypes = [ctypes.c_long, ctypes.c_int,
                                            ctypes.c_int]
    lib.weight_product_launch.restype = ctypes.c_int
    lib.weight_product_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p])
    lib.block_error_string.restype = ctypes.c_char_p
    lib.block_error_string.argtypes = [ctypes.c_int]
    return lib


def tensor_core_fwd(x: torch.Tensor, w: Sequence[torch.Tensor],
                    dim_head: int) -> bool:
    """Whether a full block's forward (K2f, and each block of K4) runs on
    the bf16 tensor-core body (csrc/block_mma_fwd.cuh): bf16, d = dim_head
    = 64, at most 80 tokens, mlp a multiple of 64 (`smem.
    tensor_core_widths`), and x and the matrix weights 16-byte aligned.
    Every other call takes the FMA body, which takes any width."""
    _, n, d = x.shape
    return (tensor_core_widths(n, d, dim_head, w[7].shape[-1], x.dtype)
            and all(t.data_ptr() % 16 == 0
                    for t in (x, w[2], w[3], w[7], w[9])))


def tensor_core_bwd(x: torch.Tensor, w: Sequence[torch.Tensor],
                    dim_head: int, dy: torch.Tensor = None) -> bool:
    """Whether a block's backward runs its per-frame pass on a bf16
    tensor-core body (a full block, K2b and K6's full blocks:
    `block_bwd_mma`; the CLS-only block, K3b and K6's last block:
    `cls_bwd_mma`): the widths and alignment of `tensor_core_fwd`, and dy
    16-byte aligned. Every other call takes the FMA body, which takes any
    width."""
    return (tensor_core_fwd(x, w, dim_head)
            and (dy is None or dy.data_ptr() % 16 == 0))


def _call(fn, dtype, cls, tensors, x, heads, dim_head, mlp, *more) -> None:
    lib = _block_lib()
    b, n, d = x.shape
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[dtype], int(cls), ctypes.cast(ptrs, ctypes.c_void_p),
                 b, n, d, heads, dim_head, mlp, dim_head ** -0.5, stream,
                 *more)
    if err != 0:
        raise RuntimeError("block_grad launch failed: "
                           + lib.block_error_string(err).decode())


def launch_block_fwd(x, w, heads: int, dim_head: int, cls: bool):
    """K2f (cls False; on the tensor-core body where `tensor_core_fwd`
    says so) or K3f (cls True) on CUDA tensors."""
    b, n, d = x.shape
    out = torch.empty((b, d) if cls else (b, n, d), dtype=x.dtype,
                      device=x.device)
    mma = not cls and tensor_core_fwd(x, w, dim_head)
    _call(_block_lib().block_forward_launch, x.dtype, cls, [x, *w, out], x,
          heads, dim_head, w[7].shape[-1], int(mma))
    return out


def launch_block_bwd(x, dy, w, heads: int, dim_head: int, cls: bool):
    """K2b (cls False) or K3b (cls True) on CUDA tensors: (dx, grads);
    the per-frame pass on the tensor-core body where `tensor_core_bwd`
    says so."""
    b, n, d = x.shape
    mlp = w[7].shape[-1]
    nbytes = _block_lib().block_backward_workspace(
        _DTYPES[x.dtype], int(cls), b, n, d, heads, dim_head, mlp)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in w]
    mma = tensor_core_bwd(x, w, dim_head, dy)
    _call(_block_lib().block_backward_launch, x.dtype, cls,
          [x, dy, *w, dx, *grads, ws], x, heads, dim_head, mlp, int(mma))
    return dx, tuple(grads)


# The weight products of the backwards (csrc/block_grad.cu: kTile,
# kTargetCtas): C = A^T B split over fixed row segments, each segment's
# sums an fp32 partial, the partials added in segment order.
_TILE, _TARGET_CTAS = 64, 264


def wgrad_splits(rows: int, k: int, n: int) -> int:
    """`splits` of csrc/block_grad.cu: the row segments of a (k, n) weight
    product over `rows` rows, at least 128 rows each and about 264 thread
    blocks of 64 x 64 tiles in all."""
    tiles = -(-k // _TILE) * -(-n // _TILE)
    return min(-(-_TARGET_CTAS // tiles), max(rows // 128, 1))


def wgrad_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of one weight product (`wgrad_kernel` or
    `wgrad_mma_kernel`, then `wgrad_finish`): A^T B of a (R, K) and b (R,
    N) in the compute dtype, as an fp32 sum over each of the kernel's row
    segments, the segments' sums added in segment order, cast to the
    compute dtype."""
    rows, k, n = a.shape[0], a.shape[1], b.shape[1]
    seg = -(-rows // wgrad_splits(rows, k, n))
    out = torch.zeros(k, n, dtype=torch.float32, device=a.device)
    for r0 in range(0, rows, seg):
        out = out + _tmm(a[r0:r0 + seg], b[r0:r0 + seg])
    return out.to(a.dtype)


def weight_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One weight product of the backwards, A^T B: a (R, K) and b (R, N)
    in the compute dtype, rows of any stride, columns contiguous -> (K, N)
    in the compute dtype. CUDA tensors go to the kernel the backwards
    launch (bf16 on the tensor cores where `wgrad_mma_kernel` takes the
    operands, else `wgrad_kernel`); CPU tensors to `wgrad_plain`."""
    if a.dtype not in _DTYPES or b.dtype != a.dtype or b.device != a.device:
        raise TypeError(f"operands of {a.dtype} and {b.dtype}: one of fp32 "
                        "or bf16, on one device")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] \
            or a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("a (R, K) and b (R, N) with contiguous rows")
    if a.device.type == "cpu":
        return wgrad_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    lib = _block_lib()
    rows, k, n = a.shape[0], a.shape[1], b.shape[1]
    out = torch.empty(k, n, dtype=a.dtype, device=a.device)
    part = torch.empty(lib.weight_product_segments(rows, k, n) * k * n,
                       dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.weight_product_launch(
            _DTYPES[a.dtype], a.data_ptr(), a.stride(0), b.data_ptr(),
            b.stride(0), rows, k, n, out.data_ptr(), n, 0, part.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("weight_product launch failed: "
                           + lib.block_error_string(err).decode())
    return out


def block_fwd_fused(x: torch.Tensor, w: Sequence[torch.Tensor], heads: int,
                    dim_head: int) -> torch.Tensor:
    """K2f: one full pre-norm block, (B, n, d) -> (B, n, d) in the compute
    dtype (fp32 or bf16), every row a valid token. CUDA tensors go to the
    kernel (and raise if it cannot run); CPU tensors to `block_fwd_plain`.
    `block_fwd_fused.launches` counts kernel launches."""
    check_block_args(x, w, heads, dim_head)
    if x.device.type == "cuda":
        out = launch_block_fwd(x, w, heads, dim_head, cls=False)
        block_fwd_fused.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return block_fwd_plain(x, w, heads, dim_head)


def block_bwd_fused(x: torch.Tensor, dy: torch.Tensor,
                    w: Sequence[torch.Tensor], heads: int, dim_head: int):
    """K2b: the block's backward from its input x and the grad dy of its
    output, both (B, n, d): (dx, the 11 weight grads), all in the compute
    dtype. CUDA tensors go to the kernel; CPU tensors to
    `block_bwd_plain`. `block_bwd_fused.launches` counts kernel launches."""
    check_block_args(x, w, heads, dim_head, dy=dy)
    if x.device.type == "cuda":
        out = launch_block_bwd(x, dy, w, heads, dim_head, cls=False)
        block_bwd_fused.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return block_bwd_plain(x, dy, w, heads, dim_head)


block_fwd_fused.launches = 0
block_bwd_fused.launches = 0


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, heads, dim_head, *w):
        ctx.save_for_backward(x, *w)
        ctx.heads, ctx.dim_head = heads, dim_head
        return block_fwd_fused(x, w, heads, dim_head)

    @staticmethod
    def backward(ctx, dy):
        x, *w = ctx.saved_tensors
        dx, grads = block_bwd_fused(x, dy.contiguous(), w, ctx.heads,
                                    ctx.dim_head)
        return (dx, None, None, *grads)


def fused_transformer_block(x: torch.Tensor, w: Sequence[torch.Tensor],
                            heads: int, dim_head: int) -> torch.Tensor:
    """Differentiable full pre-norm block: forward K2f, backward K2b.
    x (B, n, d) and the 11 weights in the compute dtype; gradients reach
    x and every weight, in the weights' dtype."""
    return _FusedBlock.apply(x, heads, dim_head, *w)
