"""The port's blocks -> CLS block -> final norm kernel (K4,
dgvit_tpu_torch/ops/got_megakernel.py::blocks_cls_forward_fused) against
the JAX package's `blocks_cls_forward_fused` in Pallas interpret mode, and
the port's GoT routes and emb-dropout, on the CPU.

Tolerances: fp32 2e-5 (another summation order); bf16 as
tests/torch_kernel_cases.py states (the residual stream is rounded after
every block on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.models.got import GoT as JaxGoT
from dgvit_tpu.ops.got_megakernel import blocks_cls_forward_fused as jblocks
from dgvit_tpu_torch.models.layers import dropout as emb_dropout
from dgvit_tpu_torch.ops.got_megakernel import (blocks_cls_forward_fused,
                                                blocks_forward_plain)
from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_plain
from test_torch_megakernel import (DEPTH, DIM, IMG, PATCH, inputs,
                                   jax_got_tree, port_got)
from torch_kernel_cases import (DIM_HEAD, HEADS, assert_close, block_tree,
                                rand, to_jax, to_torch, weights)


def trunk(rng, final_norm, dtype):
    """(JAX blocks, JAX fn, port blocks, port fn) for DEPTH seeded blocks."""
    trees = [block_tree(rng) for _ in range(DEPTH)]
    pairs = [weights(t, dtype) for t in trees]
    s = (1 + 0.1 * rng.standard_normal(DIM)).astype(np.float32)
    b = (0.1 * rng.standard_normal(DIM)).astype(np.float32)
    if final_norm == "rms":
        b = np.zeros(DIM, np.float32)
    jfn = (jnp.asarray(s).reshape(1, -1), jnp.asarray(b).reshape(1, -1))
    return (tuple(p[0] for p in pairs), jfn, [p[1] for p in pairs],
            (torch.from_numpy(s), torch.from_numpy(b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("final_norm", ["rms", "layer"])
@pytest.mark.parametrize("batch,n", [(1, 5), (3, 17)])
def test_matches_jax_blocks_kernel(batch, n, final_norm, dtype):
    rng = np.random.default_rng(batch + n)
    jb, jfn, pb, pfn = trunk(rng, final_norm, dtype)
    x = rand(rng, batch, n, DIM)
    ref = jblocks(to_jax(x, dtype), jb, jfn, HEADS, DIM_HEAD, final_norm,
                  True)
    blocks_cls_forward_fused.launches = 0
    out = blocks_cls_forward_fused(to_torch(x, dtype), pb, pfn, HEADS,
                                   DIM_HEAD, final_norm)
    assert out.shape == (batch, DIM) and out.dtype == getattr(torch, dtype)
    assert blocks_cls_forward_fused.launches == 0
    assert_close([out], [ref], dtype, 2e-5, 2e-5)


def test_raises_when_a_gradient_is_needed():
    """K4 used to raise when autograd needed its gradient; it is now
    differentiable, and its backward is the whole-trunk backward (K6,
    `trunk_bwd_fused`: the plain version on the CPU)."""
    rng = np.random.default_rng(0)
    _, _, pb, pfn = trunk(rng, "rms", "float32")
    x = to_torch(rand(rng, 2, 5, DIM), "float32")
    dy = to_torch(rand(rng, 2, DIM), "float32")
    xr = x.clone().requires_grad_()
    wr = [[t.clone().requires_grad_() for t in w] for w in pb]
    fr = tuple(t.clone().requires_grad_() for t in pfn)
    blocks_cls_forward_fused(xr, wr, fr, HEADS, DIM_HEAD, "rms").backward(dy)
    dx, gblocks, dfn = trunk_bwd_plain(x, dy, pb, pfn, HEADS, DIM_HEAD, "rms")
    # the same function on copies of the same values: fp32 sums may be
    # taken in another order for another alignment, 1e-5 covers it
    same = lambda a, b: torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    assert same(xr.grad, dx)
    assert all(same(t.grad, g) for w, gs in zip(wr, gblocks)
               for t, g in zip(w, gs))
    assert all(same(t.grad, g) for t, g in zip(fr, dfn))
    with torch.no_grad():
        out = blocks_cls_forward_fused(x, pb, pfn, HEADS, DIM_HEAD, "rms")
    assert torch.equal(out, blocks_forward_plain(x.detach(), pb, pfn, HEADS,
                                                 DIM_HEAD, "rms"))


@pytest.mark.parametrize("final_norm", ["rms", "layer"])
def test_got_routes_match_jax(final_norm):
    """fp32, dropout off: the whole-trunk route (K1), the no-grad blocks
    route (K4) and the gradient-bearing route (K2/K3) of the port's GoT
    each give the JAX GoT's latent."""
    tree = jax_got_tree(12, final_norm)
    img, goal = inputs(13, 3)
    ref = np.asarray(JaxGoT(image_size=IMG, patch_size=PATCH, dim=DIM,
                            depth=DEPTH, heads=HEADS, dim_head=DIM_HEAD,
                            mlp_dim=128, final_norm=final_norm).apply(
        {"params": tree}, jnp.asarray(img), jnp.asarray(goal)))
    got = port_got(tree, final_norm, torch.float32)
    got.emb_dropout = 0.0
    i, g = torch.from_numpy(img), torch.from_numpy(goal)
    with torch.no_grad():
        routes = [got(i, g, inference=True),
                  got(i, g, inference=True, deterministic=False)]
    routes.append(got(i, g))
    for out in routes:
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-5,
                                   atol=2e-5)
    assert routes[2].requires_grad


def test_emb_dropout_is_flax_dropout():
    """Keep probability 1 - rate, kept values x / (1 - rate) in x's dtype,
    the mask from the generator alone."""
    x = torch.randn(64, 65, 64, generator=torch.Generator().manual_seed(0))
    draw = lambda t, seed: emb_dropout(t, 0.25,
                                       torch.Generator().manual_seed(seed))
    y = draw(x, 1)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.equal(y[kept], x[kept] / 0.75)
    assert torch.equal(y, draw(x, 1)) and not torch.equal(y, draw(x, 2))
    xb = x.bfloat16()
    yb = draw(xb, 1)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb[kept], (xb / 0.75)[kept])
    assert emb_dropout(x, 0.0, None) is x
