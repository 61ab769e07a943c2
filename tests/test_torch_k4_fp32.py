"""K4's fp32 cluster form (dgvit_tpu_torch/ops/csrc/got_megakernel.cu:
k4_cluster_fp32_kernel, K1's fp32 cluster form from the blocks on: one
frame over a cluster of 4 CTAs on the 3xTF32 body of tf32_block.cuh), on
the CPU.

The kernel runs only on the card (chip_smoke.py phases 5, 14b and 23a
hold it there). Here: the rule that picks it (`k4_form_for`, `k4_form`),
the shared-memory mirror of its layout (`smem.k1_cluster_fp32(n, 0)`),
and that CPU tensors at the widths it takes still go to the plain version,
held against the JAX package's `blocks_cls_forward_fused` (its Pallas
kernel in interpret mode, `jax.vjp` for the backward) at the flagship's
head and token widths: d = dim_head = 64, 4 heads, 65 tokens, depth 2,
MLP 256, B = 2. Tolerances: 2e-5 on the latent (another fp32 summation
order), rtol 5e-4 / atol 5e-5 on the gradients (as
tests/test_torch_fp32_block.py states them for the block's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.ops.got_megakernel import blocks_cls_forward_fused as jblocks
from dgvit_tpu_torch.ops import got_megakernel as gm
from dgvit_tpu_torch.ops import smem
from torch_kernel_cases import (assert_close, block_tree, rand, to_jax,
                                to_torch, weights)

FP32, BF16 = torch.float32, torch.bfloat16
H100 = 232448
D, HEADS, DIM_HEAD, MLP, N, DEPTH, BATCH = 64, 4, 64, 256, 65, 2, 2

# (case, k4_form_for's arguments: n, d, heads, dim_head, mlp, dtype,
# aligned, streams) -> form
FLAG = (65, 64, 4, 64, 2048, FP32, True, False)
ROUTES = [
    ("reference config", FLAG, "cluster_fp32"),
    ("17 rows", (17, *FLAG[1:]), "cluster_fp32"),
    ("80 rows", (80, *FLAG[1:]), "cluster_fp32"),
    ("mlp 256", (65, 64, 4, 64, 256, FP32, True, False), "cluster_fp32"),
    ("recording", (*FLAG[:7], True), "fma"),
    ("il_policy d = 32", (65, 32, 4, 32, 2048, FP32, True, False), "fma"),
    ("8 heads", (65, 64, 8, 64, 2048, FP32, True, False), "fma"),
    ("2 heads", (65, 64, 2, 64, 2048, FP32, True, False), "fma"),
    ("81 rows", (81, *FLAG[1:]), "fma"),
    ("mlp 192", (65, 64, 4, 64, 192, FP32, True, False), "fma"),
    ("mlp 64 x 4 + 64", (65, 64, 4, 64, 320, FP32, True, False), "fma"),
    ("misaligned", (*FLAG[:6], False, False), "fma"),
    # bf16 keeps its rule: the tensor-core body's K4 form where its widths
    # and alignment hold (recording or not), else the FMA body
    ("bf16", (65, 64, 4, 64, 2048, BF16, True, False), "mma"),
    ("bf16 recording", (65, 64, 4, 64, 2048, BF16, True, True), "mma"),
    ("bf16 misaligned", (65, 64, 4, 64, 2048, BF16, False, False), "fma"),
    ("bf16 d = 32", (65, 32, 4, 32, 2048, BF16, True, False), "fma"),
    ("bf16 81 rows", (81, 64, 4, 64, 2048, BF16, True, False), "fma"),
]


@pytest.mark.parametrize("case,args,form", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_k4_route_rule(case, args, form):
    """K4's form by dtype, width, heads, MLP, token count, alignment and
    whether the call writes K6's streams. The fp32 cluster form has no
    batch bound: it beat the FMA body from 1 to 512 frames on an H100
    (chip_smoke.py phase 23a), so the batch is no argument."""
    assert gm.k4_form_for(*args) == form


def trunk(rng, dtype="float32", mlp=MLP):
    """(JAX blocks, JAX fn, port blocks, port fn) of DEPTH seeded blocks at
    4 heads x 64 and the RMS final norm."""
    pairs = [weights(block_tree(rng, heads=HEADS, dim_head=DIM_HEAD,
                                mlp=mlp), dtype) for _ in range(DEPTH)]
    s = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    jfn = (jnp.asarray(s).reshape(1, -1), jnp.zeros((1, D), jnp.float32))
    return (tuple(p[0] for p in pairs), jfn, [list(p[1]) for p in pairs],
            (torch.from_numpy(s), torch.zeros(D)))


@pytest.mark.parametrize("batch", [1, 32, 2048])
def test_k4_form_reads_the_tensors(batch):
    """k4_form takes the widths and dtype from the tensors and the
    alignment from x and every block's matrices, at any batch: one matrix
    moved off a 16-byte boundary, or a call that records, sends fp32 to
    the FMA body."""
    rng = np.random.default_rng(3)
    _, _, blocks, _ = trunk(rng)
    x = torch.zeros(batch, N, D)
    assert gm.k4_form(x, blocks, HEADS, DIM_HEAD) == "cluster_fp32"
    assert gm.k4_form(x, blocks, HEADS, DIM_HEAD, streams=True) == "fma"
    shifted = torch.zeros(blocks[1][7].numel() + 1)[1:].view(
        blocks[1][7].shape)
    moved = [blocks[0], [*blocks[1][:7], shifted, *blocks[1][8:]]]
    assert gm.k4_form(x, moved, HEADS, DIM_HEAD) == "fma"
    off = torch.zeros(batch * N * D + 1)[1:].view(batch, N, D)
    assert gm.k4_form(off, blocks, HEADS, DIM_HEAD) == "fma"
    assert gm.K4_FORMS["cluster_fp32"] == 3


@pytest.mark.parametrize("n", [17, 65, 80])
def test_k4_cluster_layout(n):
    """The mirror of a CTA's shared memory against cl32::Layout(n, 0)
    written out: the head's fp32 k (rows of 72) and v (rows of 68), its
    q|k|v and wout slices (64 x 68 each; the MLP's two-stage ring over
    them), two partial tiles (16 x 64 a warp), the embedding columns K1
    uses (16 a row) and the CLS row; rows pad to a multiple of 16. It fits
    an H100's opt-in, and K4's bytes at these widths are the larger of it
    and the FMA body's."""
    np_ = -(-n // 16) * 16
    w64 = 4 * 64 * 68
    part = 4 * np_ * 64
    want = max(4 * np_ * 72 + 4 * np_ * 68 + 4 * w64, 4 * w64) + 2 * part \
        + 4 * np_ * 16 + 4 * 64
    assert smem.k1_cluster_fp32(n, 0) == want <= H100
    flag = (64, 4, 64, 2048, FP32)
    assert smem.bytes_needed("K4", n, *flag) == max(
        smem.fwd_fma(n, *flag), want)


def test_cpu_tensors_take_the_plain_version():
    """At the widths the cluster form takes, CPU fp32 tensors run
    blocks_forward_plain (no launch, no cluster launch), without and with
    grad, and match the JAX package's blocks_cls_forward_fused (interpret
    mode) and its VJP."""
    rng = np.random.default_rng(22)
    jb, jfn, pb, pfn = trunk(rng)
    x, dy = rand(rng, BATCH, N, D), rand(rng, BATCH, D)
    ref, vjp = jax.vjp(lambda x, jb, jfn: jblocks(
        x, jb, jfn, HEADS, DIM_HEAD, "rms", True), to_jax(x, "float32"), jb,
        jfn)
    jdx, jgb, jgfn = vjp(to_jax(dy, "float32"))
    fn = gm.blocks_cls_forward_fused
    fn.launches = fn.cluster_launches = 0
    xt = to_torch(x, "float32")
    with torch.no_grad():
        out = fn(xt, pb, pfn, HEADS, DIM_HEAD, "rms")
    assert out.shape == (BATCH, D) and out.dtype == FP32
    assert torch.equal(out, gm.blocks_forward_plain(xt, pb, pfn, HEADS,
                                                    DIM_HEAD, "rms"))
    assert_close([out], [ref], "float32", 2e-5, 2e-5)
    xr = xt.clone().requires_grad_()
    wr = [[t.clone().requires_grad_() for t in w] for w in pb]
    fr = tuple(t.clone().requires_grad_() for t in pfn)
    graded = fn(xr, wr, fr, HEADS, DIM_HEAD, "rms")
    assert_close([graded.detach()], [ref], "float32", 2e-5, 2e-5)
    graded.backward(to_torch(dy, "float32"))
    assert fn.launches == fn.cluster_launches == 0
    assert_close([xr.grad], [jdx], "float32", 5e-4, 5e-5)
    assert_close([t.grad for w in wr for t in w],
                 [g for gb in jgb for g in gb], "float32", 5e-4, 5e-5)
    assert_close([fr[0].grad], [jgfn[0]], "float32", 5e-4, 5e-5)
