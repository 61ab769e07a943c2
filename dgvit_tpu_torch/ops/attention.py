"""Multi-head softmax attention over (B, H, N, D): the kernel K8, its plain
version and the dispatch.

Counterpart of `dgvit_tpu/ops/attention.py`. `dot_product_attention` keeps
the JAX function's `impl` values so that configurations carry across:

  * `xla`: the plain composition (matmul, softmax, matmul) in the inputs'
    dtype, as the JAX package leaves it to XLA (`attention_xla`);
  * `pallas`: the hand-written kernel of `csrc/attention.cu` for CUDA
    tensors (bf16 `attention_mma_kernel`, fp32 `attention_tf32_kernel`:
    both on the tensor cores) and its plain version `attention_plain` for
    CPU tensors; nothing else picks between those two. Like the TPU
    kernel it casts q, k and v to fp32, computes everything in fp32
    (scores, the exact softmax, P.V) and casts the output to q's dtype
    (the fp32 kernel streams the keys: the softmax in its streaming
    form, fp32 throughout). Differentiable: the
    backward recomputes through the plain version under autograd, as the
    JAX function's backward recomputes through its XLA path;
  * `auto`: the kernel for a CUDA tensor with N > 128 or D > 128, else the
    composition (the JAX rule, with "the tensor is on the card" in place
    of "the backend is a TPU");
  * `pallas_interpret` has no counterpart and raises.

The TPU kernel pads N and D to 128 and masks the padded keys; here padded
keys are never formed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
IMPLS = ("auto", "xla", "pallas")


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """The plain composition on (B, H, N, D), in the inputs' dtype."""
    dots = (q @ k.transpose(-1, -2)) * scale
    return torch.softmax(dots, dim=-1) @ v


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain PyTorch version of K8, on any device: fp32 throughout, the
    output cast to q's dtype."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    dots = (q32 @ k32.transpose(-1, -2)) * scale
    e = torch.exp(dots - dots.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return (p @ v32).to(q.dtype)


def attention_probs(q: torch.Tensor, k: torch.Tensor, scale: float
                    ) -> torch.Tensor:
    """The attention maps themselves, (B, H, N, N)."""
    return torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)


def reduce_attn(attn: torch.Tensor, reduction: float = 0.1,
                threshold: float = 0.5) -> torch.Tensor:
    """Damp weights above `threshold` by `reduction` and renormalise the
    rows (the attention-redistribution helper; off the main path)."""
    damped = torch.where(attn > threshold, attn * (1.0 - reduction), attn)
    return damped / damped.sum(dim=-1, keepdim=True)


@functools.cache
def _attention_lib() -> ctypes.CDLL:
    """The built attention kernel library with its C signatures declared
    (built and loaded at the first launch, never at import)."""
    from dgvit_tpu_torch.ops import _build

    lib = _build.load("attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_launch.restype = i
    lib.attention_launch.argtypes = [i, p, p, p, p, i, i, i, ctypes.c_float,
                                     p]
    lib.attention_fma_launch.restype = i
    lib.attention_fma_launch.argtypes = [p, p, p, p, i, i, i, ctypes.c_float,
                                         p]
    lib.attention_section_launch.restype = i
    lib.attention_section_launch.argtypes = (
        [i, p, p, p, p, p] + [i] * 5 + [ctypes.c_float, p, i])
    lib.attention_section_smem.restype = ctypes.c_size_t
    lib.attention_section_smem.argtypes = [i] * 6
    lib.attention_error_string.restype = ctypes.c_char_p
    lib.attention_error_string.argtypes = [i]
    return lib


def _check(q, k, v) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes fp32 or bf16")
    if q.dim() != 4:
        raise ValueError(f"q of shape {tuple(q.shape)}: expected "
                         "(B, H, N, D)")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share shape, dtype and device:"
                             f" {tuple(t.shape)} {t.dtype} on {t.device} vs "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")


def _launch(q, k, v, scale: float) -> torch.Tensor:
    lib = _attention_lib()
    b, h, n, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attention_launch(_DTYPES[q.dtype], q.data_ptr(),
                                   k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), b * h, n, d, scale,
                                   stream)
    if err != 0:
        raise RuntimeError(
            f"attention launch failed for (N, D) = ({n}, {d}) (fp32: a key "
            "tile of the head must fit a block's shared memory; bf16: K and "
            "V of the head): " + lib.attention_error_string(err).decode())
    attention_fused.launches += 1
    return out


def _forward(q, k, v, scale: float) -> torch.Tensor:
    _check(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v, scale)
    if q.device.type != "cpu":
        raise ValueError(f"no kernel for device {q.device}")
    return attention_plain(q, k, v, scale)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = attention_plain(*qkv, ctx.scale)
        return (*torch.autograd.grad(out, qkv, g), None)


def attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """K8: exact softmax attention on (B, H, N, D), fp32 or bf16 in and
    out, fp32 inside. CUDA tensors go to the kernel (and raise if it
    cannot run); CPU tensors to `attention_plain`. Differentiable through
    a recompute of the plain version; without a gradient to track it skips
    the autograd node, whose host time rivals the kernel's.
    `attention_fused.launches` counts kernel launches."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, float(scale))
    return _forward(q, k, v, float(scale))


attention_fused.launches = 0


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None, *,
                          impl: str = "auto") -> torch.Tensor:
    """Multi-head attention over (B, H, N, D), scores scaled by `scale`
    (D ** -0.5 when None). `impl`: auto | xla | pallas, as above."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "pallas_interpret":
        raise NotImplementedError(
            "impl='pallas_interpret' is the JAX package's CPU mode of its "
            "TPU kernel; here 'pallas' runs the kernel's plain version on "
            "CPU tensors")
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        n, d = q.shape[-2], q.shape[-1]
        impl = "pallas" if q.is_cuda and (n > 128 or d > 128) else "xla"
    if impl == "xla":
        return attention_xla(q, k, v, scale)
    return attention_fused(q, k, v, scale)
