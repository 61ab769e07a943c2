"""The port's full pre-norm block with its backward (K2,
dgvit_tpu_torch/ops/fused_transformer.py) against the JAX package's
`fused_transformer_block` in Pallas interpret mode, on the CPU.

On CPU tensors the port's wrappers run their plain versions: the forward
`block_fwd_plain` and the hand-written backward `block_bwd_plain`, which
the CUDA kernels are held against on the card. The JAX gradients come from
`jax.vjp` of the interpret-mode kernel, whose backward is the TPU backward
kernel's body (`_block_bwd_body`).

Tolerances: fp32 2e-5 on the forward, rtol 5e-4 / atol 5e-5 on dx and the
11 weight gradients (another summation order, sums over every row); bf16
as tests/torch_kernel_cases.py states.
"""

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.ops.fused_transformer import fused_transformer_block as jfb
from dgvit_tpu_torch.ops.fused_transformer import (block_bwd_fused,
                                                   block_bwd_plain,
                                                   block_fwd_fused,
                                                   block_fwd_plain,
                                                   check_block_args,
                                                   fused_transformer_block,
                                                   tensor_core_bwd,
                                                   tensor_core_fwd,
                                                   weight_product,
                                                   wgrad_splits)
from torch_kernel_cases import (D, DIM_HEAD, HEADS, MLP, assert_close,
                                bf16_close, block_tree, rand, to_jax,
                                to_torch, weights)

CASES = [(2, 5), (3, 17)]   # (batch, tokens): 32x40 frames give 5 tokens


def jax_vjp(tree, x, dy, dtype):
    flat, _ = weights(tree, dtype)
    y, vjp = jax.vjp(lambda x, fl: jfb(x, fl, HEADS, DIM_HEAD, True),
                     to_jax(x, dtype), flat)
    dx, dflat = vjp(to_jax(dy, dtype))
    return y, dx, dflat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n", CASES)
def test_forward_matches_jax(batch, n, dtype):
    rng = np.random.default_rng(batch * 10 + n)
    tree, x = block_tree(rng), rand(rng, batch, n, D)
    flat, w = weights(tree, dtype)
    ref = jfb(to_jax(x, dtype), flat, HEADS, DIM_HEAD, True)
    block_fwd_fused.launches = 0
    out = block_fwd_fused(to_torch(x, dtype), w, HEADS, DIM_HEAD)
    assert out.dtype == getattr(torch, dtype) and out.shape == (batch, n, D)
    assert block_fwd_fused.launches == 0
    assert_close([out], [ref], dtype, 2e-5, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n", CASES)
def test_backward_matches_jax(batch, n, dtype):
    rng = np.random.default_rng(batch * 10 + n + 1)
    tree, x, dy = block_tree(rng), rand(rng, batch, n, D), rand(
        rng, batch, n, D)
    _, dx_ref, dflat = jax_vjp(tree, x, dy, dtype)
    _, w = weights(tree, dtype)
    block_bwd_fused.launches = 0
    dx, grads = block_bwd_fused(to_torch(x, dtype), to_torch(dy, dtype), w,
                                HEADS, DIM_HEAD)
    assert block_bwd_fused.launches == 0
    assert dx.dtype == getattr(torch, dtype) and dx.shape == x.shape
    assert all(g.shape == t.shape and g.dtype == t.dtype
               for g, t in zip(grads, w))
    assert_close([dx, *grads], [dx_ref, *dflat], dtype, 5e-4, 5e-5)


def test_autograd_function_takes_the_hand_backward():
    """fused_transformer_block's backward is block_bwd_fused: the grads of
    fp32 parameters cast to bf16 are the hand-written backward's bf16
    grads, and x's grad is its dx."""
    rng = np.random.default_rng(7)
    tree, x, dy = block_tree(rng), rand(rng, 2, 5, D), rand(rng, 2, 5, D)
    _, w = weights(tree, "float32")
    params = [t.clone().requires_grad_() for t in w]
    xb = to_torch(x, "bfloat16").requires_grad_()
    y = fused_transformer_block(xb, [p.to(torch.bfloat16) for p in params],
                                HEADS, DIM_HEAD)
    y.backward(to_torch(dy, "bfloat16"))
    dx, grads = block_bwd_plain(xb.detach(), to_torch(dy, "bfloat16"),
                                [p.detach().to(torch.bfloat16)
                                 for p in params], HEADS, DIM_HEAD)
    assert torch.equal(xb.grad, dx)
    for p, g in zip(params, grads):
        assert p.grad.dtype == torch.float32
        assert torch.equal(p.grad, g.float())


def test_bf16_catches_autograd_backward():
    """Autograd of the plain forward rounds at other points than the TPU
    backward; the bf16 check sees it in at least one gradient."""
    rng = np.random.default_rng(8)
    tree, x, dy = block_tree(rng), rand(rng, 3, 17, D), rand(rng, 3, 17, D)
    _, dx_ref, dflat = jax_vjp(tree, x, dy, "bfloat16")
    _, w = weights(tree, "bfloat16")
    xr = to_torch(x, "bfloat16").requires_grad_()
    wr = [t.clone().requires_grad_() for t in w]
    got = torch.autograd.grad(block_fwd_plain(xr, wr, HEADS, DIM_HEAD),
                              [xr, *wr], to_torch(dy, "bfloat16"))
    assert not bf16_close(got, [dx_ref, *dflat])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(9)
    _, w = weights(block_tree(rng), "float32")
    x = torch.zeros(2, 5, D)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        check_block_args(x.half(), [t.half() for t in w], HEADS, DIM_HEAD)
    with pytest.raises(TypeError):
        check_block_args(x, [w[0].double(), *w[1:]], HEADS, DIM_HEAD)
    with pytest.raises(ValueError, match="shape"):
        check_block_args(x, w, HEADS, DIM_HEAD, dy=torch.zeros(2, D))
    with pytest.raises(ValueError, match="contiguous"):
        check_block_args(torch.zeros(2, D, 5).transpose(1, 2), w, HEADS,
                         DIM_HEAD)


# (dtype, tokens, heads, dim_head, mlp, x offset in elements): which
# full-block backward body a call on the card takes
ROUTES = [
    ("bfloat16", 65, 4, 64, 2048, 0, True),    # the flagship block
    ("bfloat16", 80, 4, 64, 2048, 0, True),    # the most rows it holds
    ("bfloat16", 81, 4, 64, 2048, 0, False),   # 16x16 patches: 81 tokens
    ("bfloat16", 65, 2, 32, 2048, 0, False),   # narrow heads
    ("bfloat16", 65, HEADS, DIM_HEAD, MLP, 0, False),  # these tests' block
    ("bfloat16", 65, 4, 64, 96, 0, False),     # mlp not a multiple of 64
    ("bfloat16", 65, 4, 64, 2048, 1, False),   # x not 16-byte aligned
    ("float32", 65, 4, 64, 2048, 0, False),    # fp32 keeps the FMA body
]


@pytest.mark.parametrize("dtype,n,heads,dim_head,mlp,offset,mma", ROUTES)
def test_backward_body_route(dtype, n, heads, dim_head, mlp, offset, mma):
    """The bf16 tensor-core body takes the flagship widths; every other
    call takes the FMA body, which runs any width (both in
    ops/csrc/block_grad.cu)."""
    dt, inner = getattr(torch, dtype), heads * dim_head
    shapes = [(D,), (D,), (D, 3 * inner), (inner, D), (D,), (D,), (D,),
              (D, mlp), (mlp,), (mlp, D), (D,)]
    w = [torch.zeros(s, dtype=dt) for s in shapes]
    x = torch.zeros(2 * n * D + offset, dtype=dt)[offset:].view(2, n, D)
    dy = torch.zeros(2, n, D, dtype=dt)
    check_block_args(x, w, heads, dim_head, dy=dy)   # a call the wrappers take
    assert tensor_core_bwd(x, w, dim_head, dy) is mma


@pytest.mark.parametrize("dtype,n,heads,dim_head,mlp,offset,mma", ROUTES)
def test_forward_body_route(dtype, n, heads, dim_head, mlp, offset, mma):
    """The forward of a full block (K2f, each block of K4) takes the bf16
    tensor-core body (ops/csrc/block_mma_fwd.cuh) at the same widths as
    the backward; every other call the FMA body."""
    dt, inner = getattr(torch, dtype), heads * dim_head
    shapes = [(D,), (D,), (D, 3 * inner), (inner, D), (D,), (D,), (D,),
              (D, mlp), (mlp,), (mlp, D), (D,)]
    w = [torch.zeros(s, dtype=dt) for s in shapes]
    x = torch.zeros(2 * n * D + offset, dtype=dt)[offset:].view(2, n, D)
    check_block_args(x, w, heads, dim_head)
    assert tensor_core_fwd(x, w, dim_head) is mma
    # an unaligned weight matrix also keeps the FMA body
    w[9] = torch.zeros(mlp * D + 1, dtype=dt)[1:].view(mlp, D)
    assert tensor_core_fwd(x, w, dim_head) is False


# `splits` of csrc/block_grad.cu worked by hand: min(ceil(264 / tiles),
# max(R // 128, 1)), tiles = ceil(K / 64) * ceil(N / 64)
SPLITS = [
    ((16640, 64, 768), 22),    # h1^T dqkv at B=256: 12 tiles
    ((16640, 64, 2048), 9),    # h2^T dpre: 32 tiles
    ((16640, 2048, 64), 9),    # hid^T dy
    ((16640, 256, 64), 66),    # o^T g1c: 4 tiles
    ((256, 64, 2048), 2),      # a CLS operand: 256 rows // 128
    ((100, 64, 64), 1),        # fewer than 128 rows: one segment
    ((1000, 40, 96), 7),       # ragged tiles: 2 tiles, 1000 // 128 = 7
]


@pytest.mark.parametrize("shape,want", SPLITS)
def test_weight_product_segments(shape, want):
    assert wgrad_splits(*shape) == want


# (rows, K, N, row stride of a): the weight products' awkward shapes
PRODUCTS = [(1000, 40, 96, 40), (2592, 64, 192, 64), (500, 36, 64, 36),
            (256, 64, 256, 65 * 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,k,n,lda", PRODUCTS)
def test_weight_product_plain_matches_float64(rows, k, n, lda, dtype):
    """The plain weight product, which `weight_product` runs on CPU
    tensors (fp32 sums over the kernel's row segments, added in segment
    order, then cast), against A^T B in float64: fp32 within 1e-5 L, bf16
    within its one rounding (2^-8 of a value) plus 1e-5 L; a of the last
    shape is row 0 of each 65-row frame."""
    rng = np.random.default_rng(rows + k + n)
    dt = getattr(torch, dtype)
    base = torch.from_numpy(rng.standard_normal(rows * lda).astype(
        np.float32)).to(dt)
    a = base.as_strided((rows, k), (lda, 1))
    b = torch.from_numpy(rng.standard_normal((rows, n)).astype(
        np.float32)).to(dt)
    exact = a.double().t() @ b.double()
    out = weight_product(a, b)
    assert out.shape == (k, n) and out.dtype == dt
    scale = exact.abs().max().item()
    bound = 1e-5 * scale + (2.0 ** -8 * exact.abs() if dtype == "bfloat16"
                            else 0.0)
    assert bool(((out.double() - exact).abs() <= bound).all())
