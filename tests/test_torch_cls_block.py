"""The port's CLS-only final block with its backward (K3,
dgvit_tpu_torch/ops/cls_block.py) against the JAX package's
`cls_final_block` in Pallas interpret mode, on the CPU: the forward
`block(x)[:, 0]`, and the row-sparse backward's full-row dx and 11 weight
gradients. Tolerances as tests/test_torch_block_grad.py."""

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.ops.cls_block import _cls_bwd_impl
from dgvit_tpu.ops.cls_block import cls_final_block as jcls
from dgvit_tpu_torch.ops import cls_block as cb
from dgvit_tpu_torch.ops.cls_block import (cls_bwd_fused, cls_bwd_plain,
                                           cls_final_block, cls_fwd_fused,
                                           cls_fwd_plain)
from dgvit_tpu_torch.ops.fused_transformer import (block_fwd_plain,
                                                   check_block_args,
                                                   tensor_core_bwd)
from torch_kernel_cases import (D, DIM_HEAD, HEADS, MLP, assert_close,
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


def test_fp32_kv_moves_past_the_pooled_limit(monkeypatch):
    """The wrong K3b of chip_smoke.py's phase 5 (k and v of the recompute
    left in fp32: the tensor-core body's projection unrounded) sits
    further from the plain version than phase 5's pooled bf16 limit on
    the card (mean |err| / L <= 2^-18 over dx and the 11 gradients), so
    that limit can see it."""
    rng = np.random.default_rng(8)
    tree, x, dy = block_tree(rng), rand(rng, 3, 17, D), rand(rng, 3, D)
    _, w = weights(tree, "bfloat16")
    args = (to_torch(x, "bfloat16"), to_torch(dy, "bfloat16"), w, HEADS,
            DIM_HEAD)
    dx, grads = cls_bwd_plain(*args)
    monkeypatch.setattr(cb, "_kv_rows", lambda h1, wkv, cdt: cb._mm(h1, wkv))
    bad_dx, bad_grads = cls_bwd_plain(*args)
    total = count = 0.0
    for out, ref in zip([bad_dx, *bad_grads], [dx, *grads]):
        err = (out.float() - ref.float()).abs()
        total += err.sum().item() / ref.float().abs().max().item()
        count += err.numel()
    assert total / count > 2.0 ** -18


def test_backward_matches_jax_at_the_flagship_widths():
    """bf16 at the widths the tensor-core body is built for (65 tokens,
    4 x 64 heads, mlp 2048): the plain K3b against the JAX kernel in
    interpret mode."""
    rng = np.random.default_rng(65)
    tree = block_tree(rng, heads=4, dim_head=64, mlp=2048)
    x, dy = rand(rng, 2, 65, D), rand(rng, 2, D)
    flat, w = weights(tree, "bfloat16")
    dx_ref, dflat = _cls_bwd_impl(to_jax(x, "bfloat16"),
                                  to_jax(dy, "bfloat16"), flat, heads=4,
                                  dim_head=64, interpret=True)
    dx, grads = cls_bwd_fused(to_torch(x, "bfloat16"),
                              to_torch(dy, "bfloat16"), w, 4, 64)
    assert_close([dx, *grads], [dx_ref, *dflat], "bfloat16", 0, 0)


# (dtype, tokens, heads, dim_head, mlp, x offset in elements, tensor-core
# body): which CLS-block backward body a call on the card takes
ROUTES = [
    ("bfloat16", 65, 4, 64, 2048, 0, True),    # the flagship CLS block
    ("bfloat16", 80, 4, 64, 2048, 0, True),    # the most rows it holds
    ("bfloat16", 81, 4, 64, 2048, 0, False),   # 16x16 patches: 81 tokens
    ("bfloat16", 65, 2, 32, 2048, 0, False),   # narrow heads
    ("bfloat16", 65, HEADS, DIM_HEAD, MLP, 0, False),  # these tests' block
    ("bfloat16", 65, 4, 64, 2048, 1, False),   # x not 16-byte aligned
    ("float32", 65, 4, 64, 2048, 0, False),    # fp32 keeps the FMA body
]


@pytest.mark.parametrize("dtype,n,heads,dim_head,mlp,offset,mma", ROUTES)
def test_backward_body_route(dtype, n, heads, dim_head, mlp, offset, mma):
    """K3b's per-frame pass takes the bf16 tensor-core body
    (`cls_bwd_mma`) at the flagship widths and the FMA body
    (`cls_bwd_body`) for every other call, by the rule of the full block's
    backward (both in ops/csrc/block_grad.cu)."""
    dt, inner = getattr(torch, dtype), heads * dim_head
    shapes = [(D,), (D,), (D, 3 * inner), (inner, D), (D,), (D,), (D,),
              (D, mlp), (mlp,), (mlp, D), (D,)]
    w = [torch.zeros(s, dtype=dt) for s in shapes]
    x = torch.zeros(2 * n * D + offset, dtype=dt)[offset:].view(2, n, D)
    dy = torch.zeros(2, D, dtype=dt)
    check_block_args(x, w, heads, dim_head, dy=dy, cls=True)
    assert tensor_core_bwd(x, w, dim_head, dy) is mma
