"""K2f's and K2b's fp32 cluster forms (dgvit_tpu_torch/ops/csrc/block_grad.cu:
block_fwd_cluster_fp32_kernel and block_bwd_cluster_fp32_kernel, one frame
over a cluster of 4 CTAs on the 3xTF32 body of tf32_block.cuh), on the CPU.

The kernels run only on the card (chip_smoke.py phases 5, 13b and 22a hold
them there). Here: the rule that picks them (`fp32_cluster_fwd`,
`block_form`, which K3's fp32 cluster forms share) and the form each launch
passes, the shared-memory mirror of
their layouts (`smem.k1_cluster_fp32(n, 0)`, `smem.bwd_cluster_fp32`),
and that CPU tensors at the widths they take still go to the plain
versions, held against the JAX package's `fused_transformer_block` (its
Pallas kernel in interpret mode, `jax.vjp` for the backward) at the
flagship's head and token widths: d = dim_head = 64, 4 heads, 65 tokens,
MLP 256, B = 2. Tolerances as tests/test_torch_block_grad.py states them
for fp32: 2e-5 on the forward, rtol 5e-4 / atol 5e-5 on dx and the 11
weight gradients (another summation order, sums over every row).
"""

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.ops.fused_transformer import fused_transformer_block as jfb
from dgvit_tpu_torch.ops import fused_transformer as ft
from dgvit_tpu_torch.ops import smem
from torch_kernel_cases import (assert_close, block_tree, rand, to_jax,
                                to_torch, weights)

FP32, BF16 = torch.float32, torch.bfloat16
H100 = 232448
D, HEADS, DIM_HEAD, MLP, N, BATCH = 64, 4, 64, 256, 65, 2


def block_weights(d, heads, dim_head, mlp, dtype, shift=None):
    """Seeded weights of one block as the kernels take them; `shift`
    names a matrix moved one element off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(5)
    inner = heads * dim_head
    shapes = [(d,), (d,), (d, 3 * inner), (inner, d), (d,), (d,), (d,),
              (d, mlp), (mlp,), (mlp, d), (d,)]
    w = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    if shift is not None:
        i = {"wqkv": 2, "wout": 3, "w1": 7, "w2": 9}[shift]
        w[i] = torch.zeros(w[i].numel() + 1, dtype=dtype)[1:].view(
            w[i].shape)
    return w


def frame(b, n, d, dtype, shift=False):
    if shift:
        return torch.zeros(b * n * d + 1, dtype=dtype)[1:].view(b, n, d)
    return torch.zeros(b, n, d, dtype=dtype)


# (case, dtype, tokens, d, heads, dim_head, mlp, what is unaligned, the
# cluster form): the 2d BC policy's blocks take it, nothing else does
ROUTES = [
    ("2d BC widths", FP32, 65, 64, 4, 64, 2048, None, True),
    ("80 rows", FP32, 80, 64, 4, 64, 2048, None, True),
    ("mlp 256", FP32, 65, 64, 4, 64, 256, None, True),
    ("il_policy d = 32", FP32, 65, 32, 4, 32, 2048, None, False),
    ("81 rows", FP32, 81, 64, 4, 64, 2048, None, False),
    ("2 heads", FP32, 65, 64, 2, 64, 2048, None, False),
    ("mlp 96", FP32, 65, 64, 4, 64, 96, None, False),
    ("mlp 64 x 4 + 64", FP32, 65, 64, 4, 64, 320, None, False),
    ("bf16", BF16, 65, 64, 4, 64, 2048, None, False),
    ("w1 unaligned", FP32, 65, 64, 4, 64, 2048, "w1", False),
    ("wout unaligned", FP32, 65, 64, 4, 64, 2048, "wout", False),
    ("x unaligned", FP32, 65, 64, 4, 64, 2048, "x", False),
    ("dy unaligned", FP32, 65, 64, 4, 64, 2048, "dy", False),
]


@pytest.mark.parametrize("case,dtype,n,d,heads,dim_head,mlp,shift,cluster",
                         ROUTES, ids=[r[0] for r in ROUTES])
def test_route_rule(case, dtype, n, d, heads, dim_head, mlp, shift,
                    cluster, monkeypatch):
    """fp32_cluster_fwd takes the 2d BC policy's widths (fp32, d =
    dim_head = 64, 4 heads, at most 80 tokens, mlp a multiple of 256,
    x, dy and the matrix weights 16-byte aligned) and nothing else; the
    launches of K2f and K2b pass its form (2), bf16 at the flagship
    widths the tensor-core body's (1), the rest the FMA body's (0). K3f
    and K3b take it at the same widths (their dy, (B, d), is a fresh
    tensor here). The launches are recorded here, not made."""
    w = block_weights(d, heads, dim_head, mlp, dtype,
                      shift if shift not in ("x", "dy") else None)
    x = frame(2, n, d, dtype, shift == "x")
    dy = frame(2, n, d, dtype, shift == "dy")
    fwd_ok = cluster or shift == "dy"
    assert ft.fp32_cluster_fwd(x, w, dim_head) is fwd_ok
    assert ft.fp32_cluster_fwd(x, w, dim_head, dy) is cluster
    other = int(dtype == BF16 and ft.tensor_core_fwd(x, w, dim_head))
    assert ft.block_form(x, w, dim_head, False) == (2 if fwd_ok else other)
    assert ft.block_form(x, w, dim_head, False, dy) == (2 if cluster
                                                        else other)
    assert ft.block_form(x, w, dim_head, True) == (2 if fwd_ok else other)
    assert ft.block_form(x, w, dim_head, True, dy[:, 0].contiguous()) == \
        (2 if fwd_ok else other)

    launched = []
    monkeypatch.setattr(ft, "_block_lib", lambda: type("Lib", (), {
        "block_forward_launch": None, "block_backward_launch": None,
        "block_backward_workspace": staticmethod(lambda *a: 16)})())
    monkeypatch.setattr(ft, "_call", lambda fn, dt, c, tensors, x, heads,
                        dim_head, mlp, form: launched.append((c, form)))
    ft.launch_block_fwd(x, w, heads, dim_head, False)
    ft.launch_block_bwd(x, dy, w, heads, dim_head, False)
    assert launched == [(False, 2 if fwd_ok else other),
                        (False, 2 if cluster else other)]


@pytest.mark.parametrize("n", [65, 80])
def test_layouts(n):
    """The mirrors against the layouts written out (tf32_block.cuh's
    cl32::Layout with no patches, block_grad.cu's bw32::Layout): K2f's CTA
    holds the head's fp32 k (rows of 72) and v (rows of 68), its q|k|v and
    wout slices (64 x 68 each; the MLP's two-stage ring over them) and two
    partial tiles (16 x 64 a warp), 160,768 bytes; K2b's the head's k, v
    and q, the probabilities (rows of 84; dh2's partials over them), one
    region of four 64 x 68 weight tiles, the partial tile, each warp's x
    and x1 tiles and the column sums by warp, 225,792 bytes. Rows pad to
    80, so both counts hold at 65 and 80 rows, and both fit an H100's
    opt-in."""
    np_ = 80
    w64 = 4 * 64 * 68
    part = 4 * np_ * 64
    k2f = max(4 * np_ * 72 + 4 * np_ * 68 + 4 * w64, 4 * w64) + 2 * part \
        + 4 * np_ * 16 + 4 * 64
    k2b = (4 * np_ * 72 + 2 * 4 * np_ * 68 + max(4 * np_ * (np_ + 4), part)
           + 4 * w64 + 3 * part + 4 * (np_ // 16) * 64)
    assert smem.k1_cluster_fp32(n, 0) == k2f == 160768 <= H100
    assert smem.bwd_cluster_fp32(n) == k2b == 225792 <= H100
    flag = (64, 4, 64, 2048, FP32)
    assert smem.bytes_needed("K2b", n, *flag) == 225792
    assert smem.bytes_needed("K2f", n, *flag) == max(
        smem.fwd_fma(n, *flag), 160768)
    # past 80 rows neither form is taken, and the bytes are the FMA bodies'
    assert smem.bytes_needed("K2b", 81, *flag) == smem.bwd_fma(81, 64, 2048)


def test_cpu_tensors_take_the_plain_versions():
    """At the widths the cluster forms take, CPU tensors run
    block_fwd_plain and block_bwd_plain (no launch, no cluster launch),
    and those match the JAX package's fused_transformer_block forward and
    VJP (interpret mode) at d = dim_head = 64, 4 heads, 65 tokens, MLP
    256, B = 2, fp32."""
    rng = np.random.default_rng(21)
    tree = block_tree(rng, heads=HEADS, dim_head=DIM_HEAD, mlp=MLP)
    x, dy = rand(rng, BATCH, N, D), rand(rng, BATCH, N, D)
    flat, w = weights(tree, "float32")
    xt, dyt = to_torch(x, "float32"), to_torch(dy, "float32")
    assert ft.block_form(xt, w, DIM_HEAD, False, dyt) == 2
    y_ref, vjp = jax.vjp(lambda x, fl: jfb(x, fl, HEADS, DIM_HEAD, True),
                         to_jax(x, "float32"), flat)
    dx_ref, dflat = vjp(to_jax(dy, "float32"))
    for fn in (ft.block_fwd_fused, ft.block_bwd_fused):
        fn.launches = fn.cluster_launches = 0
    y = ft.block_fwd_fused(xt, w, HEADS, DIM_HEAD)
    dx, grads = ft.block_bwd_fused(xt, dyt, w, HEADS, DIM_HEAD)
    for fn in (ft.block_fwd_fused, ft.block_bwd_fused):
        assert fn.launches == fn.cluster_launches == 0
    assert y.shape == dx.shape == (BATCH, N, D) and y.dtype == FP32
    assert all(g.shape == t.shape and g.dtype == FP32
               for g, t in zip(grads, w))
    assert_close([y], [y_ref], "float32", 2e-5, 2e-5)
    assert_close([dx, *grads], [dx_ref, *dflat], "float32", 5e-4, 5e-5)
    # the plain versions are what the wrappers ran
    assert torch.equal(y, ft.block_fwd_plain(xt, w, HEADS, DIM_HEAD))
    pdx, pgrads = ft.block_bwd_plain(xt, dyt, w, HEADS, DIM_HEAD)
    assert torch.equal(dx, pdx) and all(
        torch.equal(a, b) for a, b in zip(grads, pgrads))
