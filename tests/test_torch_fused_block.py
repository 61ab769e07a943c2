"""The port's fused attention section (K7,
dgvit_tpu_torch/ops/fused_block.py) against the JAX package's
`fused_attention_section` in Pallas interpret mode and its XLA twin
`_attention_section_xla`, on the CPU.

On CPU tensors the port's wrapper runs `attention_section_plain`, which
the CUDA kernel is held against on the card.

Tolerances: fp32 2e-5 against both (another summation order). bf16
against the kernel: both round q, k, v, the probabilities, each head's
output and the result to bf16 at the same points, so the check is
tests/torch_kernel_cases.py's; against the XLA twin, which rounds inside
its own operations instead, 2^-5 of the largest |output|. Gradients, fp32:
rtol 1e-4 / atol 1e-5 against jax.vjp of the interpret-mode kernel (whose
backward differentiates the twin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.ops import fused_block as jfb
from dgvit_tpu_torch.ops.fused_block import (attention_section_plain,
                                             fused_attention_section)
from torch_kernel_cases import (D, DIM_HEAD, HEADS, as_np, assert_close,
                                bf16_close, rand, to_jax, to_torch)

INNER = HEADS * DIM_HEAD
CASES = [(2, 5), (3, 17), (1, 65)]      # (batch, tokens)


def section(seed, batch, n):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    return rand(rng, batch, n, D), u(D, 3 * INNER), u(INNER, D), u(D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n", CASES)
def test_matches_jax_kernel(batch, n, dtype):
    arrs = section(batch * 10 + n, batch, n)
    ref = jfb.fused_attention_section(*(to_jax(a, dtype) for a in arrs),
                                      HEADS, DIM_HEAD, True)
    args = [to_torch(a, dtype) for a in arrs]
    fused_attention_section.launches = 0
    out = fused_attention_section(*args, HEADS, DIM_HEAD)
    assert fused_attention_section.launches == 0
    assert out.shape == (batch, n, D) and out.dtype == getattr(torch, dtype)
    assert torch.equal(out, attention_section_plain(*args, HEADS, DIM_HEAD))
    assert_close([out], [ref], dtype, 2e-5, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_xla_twin(dtype):
    arrs = section(7, 3, 17)
    ref = as_np(jfb._attention_section_xla(
        *(to_jax(a, dtype) for a in arrs), heads=HEADS, dim_head=DIM_HEAD))
    out = as_np(fused_attention_section(*(to_torch(a, dtype) for a in arrs),
                                        HEADS, DIM_HEAD))
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(out - ref).max() <= 2.0 ** -5 * np.abs(ref).max()


def test_gradients_match_jax():
    arrs = section(8, 2, 9)
    dy = rand(np.random.default_rng(9), 2, 9, D)
    _, vjp = jax.vjp(lambda *a: jfb.fused_attention_section(
        *a, HEADS, DIM_HEAD, True), *(jnp.asarray(a) for a in arrs))
    ref = vjp(jnp.asarray(dy))
    args = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = fused_attention_section(*args, HEADS, DIM_HEAD)
    assert out.grad_fn.name().startswith("_Section")
    out.backward(torch.from_numpy(dy))
    for t, r in zip(args, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_bf16_gradients_reach_fp32_parameters():
    """As the block hands them over: fp32 parameters cast to bf16 keep the
    graph, and the recompute's gradients come back in fp32."""
    arrs = section(10, 2, 5)
    x = to_torch(arrs[0], "bfloat16").requires_grad_()
    params = [torch.from_numpy(a).requires_grad_() for a in arrs[1:]]
    out = fused_attention_section(x, *(p.bfloat16() for p in params), HEADS,
                                  DIM_HEAD)
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 and p.grad.abs().sum() > 0
               for p in params)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, wqkv, wout, bout = (torch.from_numpy(a) for a in section(11, 2, 5))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fused_attention_section(x.half(), wqkv.half(), wout.half(),
                                bout.half(), HEADS, DIM_HEAD)
    with pytest.raises(ValueError, match="B, n, d"):
        fused_attention_section(x[0], wqkv, wout, bout, HEADS, DIM_HEAD)
    with pytest.raises(ValueError, match="shape"):
        fused_attention_section(x, wqkv[:, :-1], wout, bout, HEADS, DIM_HEAD)
    with pytest.raises(TypeError):
        fused_attention_section(x, wqkv.double(), wout, bout, HEADS, DIM_HEAD)
    with pytest.raises(ValueError, match="at most 256"):
        fused_attention_section(torch.zeros(1, 257, D), wqkv, wout, bout,
                                HEADS, DIM_HEAD)


@pytest.mark.parametrize("what", ["p", "o"], ids=["fp32 probabilities",
                                                 "o not rounded"])
def test_wrong_rounding_points_move_past_the_pooled_limit(what):
    """chip_smoke.py phase 15's wrong K7s (the probabilities, or each
    head's output, left in fp32 where the TPU kernel rounds them to the
    compute dtype) fail this suite's bf16 check against the JAX kernel in
    interpret mode and against the plain version, which passes it against
    the JAX kernel, and sit further from the plain version than the pooled
    bf16 limit K7 is held to on the card (mean |err| / L <= 2^-18): bf16,
    65 tokens, 4 x 64 heads."""
    import chip_smoke as cs

    rng = np.random.default_rng(67)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    arrs = (rand(rng, 16, 65, D), u(D, 3 * 256), u(256, D), u(D))
    jref = torch.from_numpy(np.array(jfb.fused_attention_section(
        *(to_jax(a, "bfloat16") for a in arrs), 4, 64, True), np.float32))
    args = [to_torch(a, "bfloat16") for a in arrs]
    plain = attention_section_plain(*args, 4, 64)
    bad = cs.k7_unrounded(what)(*args, 4, 64)
    assert torch.equal(attention_section_plain(*args, 4, 64), plain)
    assert bf16_close([plain], [jref])
    assert not bf16_close([bad], [jref]) and not bf16_close([bad], [plain])
    assert cs.pooled_rel([bad], [plain]) > cs.TRAIN_BF16_MEAN
