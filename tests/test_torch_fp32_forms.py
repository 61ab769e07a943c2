"""The fp32 forms of K1 and K8 that run on the tensor cores as 3xTF32
(dgvit_tpu_torch/ops/csrc: k1_cluster_fp32_kernel in got_megakernel.cu,
attention_tf32_kernel in attention.cu), on the CPU.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there; tests/test_torch_exact_sums.py holds the rule
that picks K1's fp32 cluster form, `k1_form_for`). Here: the
shared-memory mirror of that form's layout (`smem.k1_cluster_fp32`), and
that CPU tensors at the widths those forms take still go to the plain
versions, held against the JAX package: K1's
at the flagship widths (d = dim_head = 64, 4 heads) against the
megakernel's XLA twin, K8's at 256 tokens against its Pallas kernel in
interpret mode. Tolerances as tests/test_torch_megakernel.py and
tests/test_torch_attention.py state them for fp32: 2e-5 and 1e-5, another
summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.models.got import patchify_2d as jax_patchify_2d
from dgvit_tpu.ops import attention as jattn
from dgvit_tpu.ops.fused_transformer import _block_params_flat
from dgvit_tpu.ops.got_megakernel import _mega_xla
from dgvit_tpu_torch.models.got import GoT, patchify_2d
from dgvit_tpu_torch.models.jax_io import params_from_jax
from dgvit_tpu_torch.ops import got_megakernel as gm
from dgvit_tpu_torch.ops import smem
from dgvit_tpu_torch.ops.attention import (attention_fused, attention_plain,
                                           dot_product_attention)

FP32 = torch.float32
H100 = 232448


@pytest.mark.parametrize("n,pd,total", [(65, 320, 160768),
                                        (80, 320, 160768),
                                        (17, 320, 106240),
                                        (65, 160, 160768)])
def test_k1_fp32_cluster_layout(n, pd, total):
    """`smem.k1_cluster_fp32` against `cl32::Layout` written out: a CTA
    holds the head's fp32 k (rows of 72) and v (rows of 68), its q|k|v
    and wout slices (64 x 68 each), over them the MLP's two-stage ring of
    w1 and w2 chunks (64 x 68 each) and the rank's pe_w slice (pd x 20);
    then two fp32 partial tiles (16 x 64 a warp), the rank's 16 embedding
    columns of every row and the CLS row. At 65 and 80 rows it stays under
    the FMA trunk_kernel's bytes, so K1's fp32 route rule is unchanged."""
    np_ = (n + 15) // 16 * 16
    w64 = 4 * 64 * 68
    attn = 4 * np_ * 72 + 4 * np_ * 68 + 3 * w64 + w64
    parts = 2 * 4 * np_ * 64 + 4 * np_ * 16 + 4 * 64
    want = max(attn, 2 * 2 * w64, 4 * pd * 20) + parts
    assert smem.k1_cluster_fp32(n, pd) == total == want <= H100
    assert smem.bytes_needed("K1", n, 64, 4, 64, 2048, FP32) == max(
        smem.fwd_fma(n, 64, 4, 64, 2048, FP32), total)
    if n >= 65:
        assert total < smem.fwd_fma(n, 64, 4, 64, 2048, FP32)
    # past 80 rows the form is not taken, and K1's bytes are the FMA body's
    assert smem.bytes_needed("K1", 81, 64, 4, 64, 2048, FP32) == \
        smem.fwd_fma(81, 64, 4, 64, 2048, FP32)


# K1 at the flagship's head and token widths, cut in depth, MLP and frame
DIM, HEADS, DIM_HEAD, MLP, DEPTH = 64, 4, 64, 256, 2
IMG, PATCH = (32, 40), (16, 20)
N_PATCH = (IMG[0] // PATCH[0]) * (IMG[1] // PATCH[1])


def got_tree(rng):
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    ln = lambda: {"scale": (1 + 0.1 * rng.standard_normal(DIM)).astype(
        np.float32), "bias": u(DIM)}
    inner = HEADS * DIM_HEAD
    pd = PATCH[0] * PATCH[1]
    return {
        "patch_embed": {"kernel": u(pd, DIM) * 0.3, "bias": u(DIM)},
        "pos_embedding": rng.standard_normal((1, N_PATCH + 1, DIM)).astype(
            np.float32),
        "transformer": {f"block_{i}": {
            "attn_norm": ln(),
            "attn": {"to_qkv": {"kernel": u(DIM, 3 * inner)},
                     "to_out": {"kernel": u(inner, DIM), "bias": u(DIM)}},
            "ff_norm": ln(),
            "ff": {"fc1": {"kernel": u(DIM, MLP), "bias": u(MLP)},
                   "fc2": {"kernel": u(MLP, DIM), "bias": u(DIM)}},
        } for i in range(DEPTH)},
        "norm_out": {"g": (1 + 0.1 * rng.standard_normal(DIM)).astype(
            np.float32)},
    }


def test_k1_fp32_cpu_tensors_take_the_plain_version():
    """At the widths K1's fp32 cluster form takes, a CPU call runs
    `got_forward_plain` (no launch), which agrees with the JAX
    megakernel's XLA twin in fp32."""
    rng = np.random.default_rng(20)
    tree = got_tree(rng)
    img = rng.uniform(0, 1, (3, *IMG)).astype(np.float32)
    goal = rng.standard_normal((3, DIM)).astype(np.float32)
    got = GoT(image_size=IMG, patch_size=PATCH, dim=DIM, depth=DEPTH,
              heads=HEADS, dim_head=DIM_HEAD, mlp_dim=MLP, final_norm="rms",
              dtype=FP32)
    got.load_state_dict(params_from_jax(tree))
    pe, pos, blocks, fn = got.fused_params(FP32)
    patches = patchify_2d(torch.from_numpy(img), *PATCH).contiguous()
    args = (patches, torch.from_numpy(goal), pe, pos, blocks, fn, HEADS,
            DIM_HEAD, N_PATCH + 1, "rms")
    assert gm.k1_form_for(3, N_PATCH + 1, patches.shape[-1], DIM, HEADS,
                          DIM_HEAD, MLP, FP32, True, 132) == "cluster_fp32"
    gm.got_forward_fused.launches = 0
    out = gm.got_forward_fused(*args)
    assert gm.got_forward_fused.launches == 0
    assert torch.equal(out, gm.got_forward_plain(*args))
    jfn = (jnp.asarray(tree["norm_out"]["g"]).reshape(1, -1),
           jnp.zeros((1, DIM), jnp.float32))
    jpe = tree["patch_embed"]
    ref = _mega_xla(
        jax_patchify_2d(jnp.asarray(img), *PATCH), jnp.asarray(goal),
        (jnp.asarray(jpe["kernel"]), jnp.asarray(jpe["bias"]).reshape(1, -1)),
        jnp.asarray(tree["pos_embedding"][0]),
        tuple(_block_params_flat(tree["transformer"][f"block_{i}"],
                                 jnp.float32) for i in range(DEPTH)),
        jfn, heads=HEADS, dim_head=DIM_HEAD, n_valid=N_PATCH + 1,
        final_norm="rms")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_k8_fp32_cpu_tensors_at_256_tokens():
    """K8 in fp32 at the SimpleViT's head width and 256 tokens: a CPU
    call runs `attention_plain` (no launch), against the JAX Pallas
    kernel in interpret mode; `auto` keeps the composition on the CPU."""
    rng = np.random.default_rng(256)
    shape = (1, 8, 256, 64)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    ref = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v),
                                      impl="pallas_interpret")
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    attention_fused.launches = 0
    out = dot_product_attention(tq, tk, tv, impl="pallas")
    assert attention_fused.launches == 0
    assert torch.equal(out, attention_plain(tq, tk, tv, 64 ** -0.5))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    auto = dot_product_attention(tq, tk, tv)
    assert attention_fused.launches == 0
    np.testing.assert_allclose(auto.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
