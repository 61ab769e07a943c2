"""The fused attention section (K7): qkv projection, per-head softmax
attention and the output projection of one block as one kernel.

Counterpart of `dgvit_tpu/ops/fused_block.py`:

    x (B, n, d) @ wqkv (d, 3*inner)  ->  per frame and head
    softmax(q k^T * dim_head**-0.5) v  ->  @ wout (inner, d) + bout

`fused_attention_section` launches the CUDA kernel of `csrc/attention.cu`
for CUDA tensors and runs `attention_section_plain` for CPU tensors;
nothing else picks between them. Numerics are the TPU kernel's: matrix
operands are values of x's dtype T (fp32 or bf16), every product sums in
fp32, the softmax is fp32, and q, k, v, the probabilities and each head's
output are rounded to T; the output is rounded once, after the bias.
Differentiable: the backward recomputes through the plain version under
autograd, as the JAX function's backward recomputes through its XLA twin;
there is no backward kernel. The TPU kernel pads rows to a multiple of 8
and masks the padded keys; here padded rows are never formed.

The kernel has two forms (`tensor_core_section` picks): in bf16 at d =
dim_head = 64, at most 80 tokens and 16-byte aligned operands, the
tensor-core form `attn_section_mma_kernel` (two frames a thread block on
the parts of `csrc/block_mma_fwd.cuh`); every other call the FMA kernel
`attn_section_kernel`, which takes any width and up to 256 tokens.
"""

from __future__ import annotations

import torch

from dgvit_tpu_torch.ops.attention import _DTYPES, _attention_lib
from dgvit_tpu_torch.ops.fused_transformer import _attention, _f32, _mm
from dgvit_tpu_torch.ops.smem import tensor_core_widths

MAX_TOKENS = 256      # the TPU kernel's limit, kept so routes carry across


def attention_section_plain(x: torch.Tensor, wqkv: torch.Tensor,
                            wout: torch.Tensor, bout: torch.Tensor,
                            heads: int, dim_head: int) -> torch.Tensor:
    """Plain PyTorch version of K7, on any device. Arguments as
    `fused_attention_section`."""
    cdt = x.dtype
    inner = heads * dim_head
    qkv = _mm(x, wqkv).to(cdt)
    o = _attention(qkv[..., :inner], qkv[..., inner:2 * inner],
                   qkv[..., 2 * inner:], heads, dim_head, cdt)
    return (_mm(o, wout) + _f32(bout).reshape(-1)).to(cdt)


def _check(x, wqkv, wout, bout, heads, dim_head) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype}: the kernel takes fp32 or bf16")
    if x.dim() != 3:
        raise ValueError(f"x of shape {tuple(x.shape)}: expected (B, n, d)")
    b, n, d = x.shape
    inner = heads * dim_head
    if n > MAX_TOKENS:
        raise ValueError(f"{n} tokens: the fused section takes at most "
                         f"{MAX_TOKENS}")
    for t, shape in ((wqkv, (d, 3 * inner)), (wout, (inner, d)),
                     (bout, (d,))):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"tensor of {t.dtype} on {t.device}; x is "
                            f"{x.dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"tensor of shape {tuple(t.shape)}, expected "
                             f"{shape}")


def tensor_core_section(x: torch.Tensor, wqkv: torch.Tensor,
                        wout: torch.Tensor, dim_head: int) -> bool:
    """Whether K7 runs its bf16 tensor-core form: bf16, d = dim_head = 64,
    at most 80 tokens (`smem.tensor_core_widths`), and x, wqkv and wout
    16-byte aligned (the kernel's output is a fresh tensor). Every other
    call takes the FMA kernel."""
    _, n, d = x.shape
    return (tensor_core_widths(n, d, dim_head, 0, x.dtype)
            and all(t.data_ptr() % 16 == 0 for t in (x, wqkv, wout)))


def _launch(x, wqkv, wout, bout, heads, dim_head) -> torch.Tensor:
    lib = _attention_lib()
    b, n, d = x.shape
    x, wqkv, wout, bout = (t.contiguous() for t in (x, wqkv, wout, bout))
    y = torch.empty_like(x)
    mma = tensor_core_section(x, wqkv, wout, dim_head)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attention_section_launch(
            _DTYPES[x.dtype], x.data_ptr(), wqkv.data_ptr(), wout.data_ptr(),
            bout.data_ptr(), y.data_ptr(), b, n, d, heads, dim_head,
            dim_head ** -0.5, stream, int(mma))
    if err != 0:
        raise RuntimeError("fused_attention_section launch failed: "
                           + lib.attention_error_string(err).decode())
    fused_attention_section.launches += 1
    return y


def _forward(x, wqkv, wout, bout, heads, dim_head) -> torch.Tensor:
    _check(x, wqkv, wout, bout, heads, dim_head)
    if x.device.type == "cuda":
        return _launch(x, wqkv, wout, bout, heads, dim_head)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return attention_section_plain(x, wqkv, wout, bout, heads, dim_head)


class _Section(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, wout, bout, heads, dim_head):
        ctx.save_for_backward(x, wqkv, wout, bout)
        ctx.cfg = (heads, dim_head)
        return _forward(x, wqkv, wout, bout, heads, dim_head)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = attention_section_plain(*args, *ctx.cfg)
        return (*torch.autograd.grad(y, args, g), None, None)


def fused_attention_section(x: torch.Tensor, wqkv: torch.Tensor,
                            wout: torch.Tensor, bout: torch.Tensor,
                            heads: int, dim_head: int) -> torch.Tensor:
    """K7: x (B, n, d), wqkv (d, 3*inner), wout (inner, d), bout (d,), all
    in the compute dtype (fp32 or bf16), n <= 256 -> (B, n, d). CUDA
    tensors go to the kernel (and raise if it cannot run); CPU tensors to
    `attention_section_plain`. Differentiable in all four tensors through a
    recompute of the plain version. `fused_attention_section.launches`
    counts kernel launches."""
    return _Section.apply(x, wqkv, wout, bout, heads, dim_head)


fused_attention_section.launches = 0
