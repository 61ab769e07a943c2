"""The port's CLS-only final block with its backward (K3,
dgvit_tpu_torch/ops/cls_block.py) against the JAX package's
`cls_final_block` in Pallas interpret mode, on the CPU: the forward
`block(x)[:, 0]`, and the row-sparse backward's full-row dx and 11 weight
gradients. Tolerances as tests/test_torch_block_grad.py."""

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.ops.cls_block import cls_final_block as jcls
from dgvit_tpu_torch.ops.cls_block import (cls_bwd_fused, cls_bwd_plain,
                                           cls_final_block, cls_fwd_fused,
                                           cls_fwd_plain)
from dgvit_tpu_torch.ops.fused_transformer import block_fwd_plain
from torch_kernel_cases import (D, DIM_HEAD, HEADS, assert_close,
                                bf16_close, block_tree, rand, to_jax,
                                to_torch, weights)

CASES = [(2, 5), (3, 17)]


def jax_vjp(tree, x, dy, dtype):
    flat, _ = weights(tree, dtype)
    y, vjp = jax.vjp(lambda x, fl: jcls(x, fl, HEADS, DIM_HEAD, True),
                     to_jax(x, dtype), flat)
    dx, dflat = vjp(to_jax(dy, dtype))
    return y, dx, dflat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n", CASES)
def test_forward_matches_jax(batch, n, dtype):
    rng = np.random.default_rng(batch * 10 + n)
    tree, x = block_tree(rng), rand(rng, batch, n, D)
    flat, w = weights(tree, dtype)
    ref = jcls(to_jax(x, dtype), flat, HEADS, DIM_HEAD, True)
    cls_fwd_fused.launches = 0
    out = cls_fwd_fused(to_torch(x, dtype), w, HEADS, DIM_HEAD)
    assert out.dtype == getattr(torch, dtype) and out.shape == (batch, D)
    assert cls_fwd_fused.launches == 0
    assert_close([out], [ref], dtype, 2e-5, 2e-5)


def test_forward_is_row_zero_of_the_full_block():
    """fp32: the CLS-only block equals the full block's row 0."""
    rng = np.random.default_rng(3)
    tree, x = block_tree(rng), to_torch(rand(rng, 3, 17, D), "float32")
    _, w = weights(tree, "float32")
    np.testing.assert_allclose(
        cls_fwd_plain(x, w, HEADS, DIM_HEAD).numpy(),
        block_fwd_plain(x, w, HEADS, DIM_HEAD)[:, 0].numpy(),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n", CASES)
def test_backward_matches_jax(batch, n, dtype):
    rng = np.random.default_rng(batch * 10 + n + 1)
    tree, x, dy = block_tree(rng), rand(rng, batch, n, D), rand(
        rng, batch, D)
    _, dx_ref, dflat = jax_vjp(tree, x, dy, dtype)
    _, w = weights(tree, dtype)
    cls_bwd_fused.launches = 0
    dx, grads = cls_bwd_fused(to_torch(x, dtype), to_torch(dy, dtype), w,
                              HEADS, DIM_HEAD)
    assert cls_bwd_fused.launches == 0
    assert dx.shape == x.shape and dx.dtype == getattr(torch, dtype)
    assert all(g.shape == t.shape and g.dtype == t.dtype
               for g, t in zip(grads, w))
    assert_close([dx, *grads], [dx_ref, *dflat], dtype, 5e-4, 5e-5)


def test_autograd_function_takes_the_hand_backward():
    rng = np.random.default_rng(7)
    tree, x, dy = block_tree(rng), rand(rng, 2, 5, D), rand(rng, 2, D)
    _, w = weights(tree, "float32")
    params = [t.clone().requires_grad_() for t in w]
    xb = to_torch(x, "bfloat16").requires_grad_()
    y = cls_final_block(xb, [p.to(torch.bfloat16) for p in params], HEADS,
                        DIM_HEAD)
    assert y.shape == (2, D)
    y.backward(to_torch(dy, "bfloat16"))
    dx, grads = cls_bwd_plain(xb.detach(), to_torch(dy, "bfloat16"),
                              [p.detach().to(torch.bfloat16)
                               for p in params], HEADS, DIM_HEAD)
    assert torch.equal(xb.grad, dx)
    for p, g in zip(params, grads):
        assert torch.equal(p.grad, g.float())


def test_bf16_catches_autograd_backward():
    rng = np.random.default_rng(8)
    tree, x, dy = block_tree(rng), rand(rng, 3, 17, D), rand(rng, 3, D)
    _, dx_ref, dflat = jax_vjp(tree, x, dy, "bfloat16")
    _, w = weights(tree, "bfloat16")
    xr = to_torch(x, "bfloat16").requires_grad_()
    wr = [t.clone().requires_grad_() for t in w]
    got = torch.autograd.grad(cls_fwd_plain(xr, wr, HEADS, DIM_HEAD),
                              [xr, *wr], to_torch(dy, "bfloat16"))
    assert not bf16_close(got, [dx_ref, *dflat])
