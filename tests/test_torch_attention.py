"""The port's attention over (B, H, N, D) (K8,
dgvit_tpu_torch/ops/attention.py) against the JAX package's
`dot_product_attention`, on the CPU.

On CPU tensors `impl="pallas"` runs `attention_plain`, which the CUDA
kernel is held against on the card; the JAX side runs its Pallas kernel in
interpret mode (`impl="pallas_interpret"`) and its einsum path
(`_attention_xla`).

Tolerances: fp32 1e-5 (another summation order over at most 257 keys).
bf16: the kernel computes in fp32 and rounds the output once, so against
the JAX kernel each output is within one bf16 ulp of its own size,
rtol 2^-7; the compositions round q k^T, the softmax and P.V to bf16 on
both sides but at other points inside each operation, so those are held
to 2^-5 of the largest |output|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.ops import attention as jattn
from dgvit_tpu_torch.ops.attention import (attention_fused, attention_plain,
                                           attention_probs, attention_xla,
                                           dot_product_attention,
                                           reduce_attn)
from torch_kernel_cases import as_np, rand, to_jax, to_torch

SHAPES = [(2, 2, 5, 16), (1, 3, 65, 64), (1, 1, 257, 16), (2, 1, 7, 160)]


def qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rand(rng, *shape) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel(shape, dtype):
    q, k, v = qkv(sum(shape), shape)
    scale = shape[-1] ** -0.5
    ref = jattn.dot_product_attention(*(to_jax(t, dtype) for t in (q, k, v)),
                                      impl="pallas_interpret")
    attention_fused.launches = 0
    out = dot_product_attention(*(to_torch(t, dtype) for t in (q, k, v)),
                                impl="pallas")
    assert attention_fused.launches == 0
    assert out.shape == shape and out.dtype == getattr(torch, dtype)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(
        rtol=2.0 ** -7, atol=2.0 ** -9)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol)
    assert torch.equal(out, attention_plain(
        *(to_torch(t, dtype) for t in (q, k, v)), scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_composition_matches_jax_xla_path(dtype):
    shape = (2, 2, 17, 16)
    q, k, v = qkv(1, shape)
    ref = as_np(jattn._attention_xla(*(to_jax(t, dtype) for t in (q, k, v)),
                                     0.25))
    args = [to_torch(t, dtype) for t in (q, k, v)]
    out = dot_product_attention(*args, impl="xla")
    assert torch.equal(out, attention_xla(*args, 0.25))
    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(as_np(out), ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(as_np(out) - ref).max() <= 2.0 ** -5 * np.abs(ref).max()


def test_gradients_match_jax():
    """fp32: the kernel route's backward (a recompute of the plain version
    under autograd) against jax.grad through the interpret-mode kernel,
    whose backward recomputes through the XLA path."""
    shape = (2, 2, 9, 16)
    q, k, v = qkv(2, shape)
    w = np.cos(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)

    def loss(q, k, v):
        return jnp.sum(jattn.dot_product_attention(
            q, k, v, impl="pallas_interpret") * jnp.asarray(w))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t)
                                              for t in (q, k, v)))
    args = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = dot_product_attention(*args, impl="pallas")
    assert out.grad_fn.name().startswith("_Attention")
    (out * torch.from_numpy(w)).sum().backward()
    for t, r in zip(args, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_dispatch_rule(monkeypatch):
    """auto on a CPU tensor is the composition whatever the shape (the
    kernel is for tensors on the card with N > 128 or D > 128); pallas is
    the kernel route; pallas_interpret and unknown names raise."""
    from dgvit_tpu_torch.ops import attention as pattn

    calls = []
    monkeypatch.setattr(pattn, "attention_fused",
                        lambda *a: calls.append("fused") or a[0])
    monkeypatch.setattr(pattn, "attention_xla",
                        lambda *a: calls.append("xla") or a[0])
    small, long_, wide = (torch.zeros(1, 1, 5, 16), torch.zeros(1, 1, 129, 16),
                          torch.zeros(1, 1, 5, 129))
    for t in (small, long_, wide):
        dot_product_attention(t, t, t)
    assert calls == ["xla"] * 3
    dot_product_attention(small, small, small, impl="pallas")
    dot_product_attention(small, small, small, impl="xla")
    assert calls[3:] == ["fused", "xla"]

    class OnCard:                      # what auto looks at, for a CUDA tensor
        is_cuda = True

        def __init__(self, n, d):
            self.shape = (1, 1, n, d)

    picks = []
    for n, d in ((65, 64), (128, 128), (129, 64), (65, 129), (257, 64)):
        del calls[:]
        t = OnCard(n, d)
        dot_product_attention(t, t, t)
        picks.append(calls[0])
    assert picks == ["xla", "xla", "fused", "fused", "fused"]
    with pytest.raises(NotImplementedError, match="pallas_interpret"):
        dot_product_attention(small, small, small, impl="pallas_interpret")
    with pytest.raises(ValueError, match="unknown attention impl"):
        dot_product_attention(small, small, small, impl="flash")


def test_kernel_route_rejects_what_the_kernel_does_not_take():
    t = torch.zeros(1, 1, 5, 16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        attention_fused(t.half(), t.half(), t.half(), 0.25)
    with pytest.raises(ValueError, match="B, H, N, D"):
        attention_fused(t[0], t[0], t[0], 0.25)
    with pytest.raises(ValueError, match="share shape"):
        attention_fused(t, t[:, :, :4], t, 0.25)


def test_attention_probs_and_reduce_attn_match_jax():
    shape = (2, 2, 9, 16)
    q, k, _ = qkv(3, shape)
    probs = attention_probs(torch.from_numpy(q), torch.from_numpy(k), 0.25)
    ref = jattn.attention_probs(jnp.asarray(q), jnp.asarray(k), 0.25)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    # sharpen the maps so that some weights pass the threshold
    sharp = torch.softmax(torch.from_numpy(q @ k.transpose(0, 1, 3, 2)), -1)
    assert (sharp > 0.5).any()
    out = reduce_attn(sharp, reduction=0.2, threshold=0.5)
    ref = jattn.reduce_attn(jnp.asarray(sharp.numpy()), reduction=0.2,
                            threshold=0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _split_pv(q, k, v, scale, split):
    """The bf16 kernel's numerics in plain PyTorch: scores and the exact
    softmax in fp32 (p = exp(s - max) times the reciprocal of the sum;
    past 80 keys the kernel takes the streaming form, which differs from
    this by fp32 roundings), then P.V as products of bf16 values summed in
    fp32, with p split into bf16 hi + lo (split) or rounded to bf16 once
    (not split)."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = (q32 @ k32.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    hi = p.bfloat16().float()
    out = hi @ v32
    if split:
        out = out + (p - hi).bfloat16().float() @ v32
    return out.to(q.dtype)


def test_kernel_probability_split_keeps_the_function():
    """The one place where the bf16 kernel's design could change the
    function: P.V on the tensor cores takes bf16 operands. Split into
    hi + lo, the probabilities keep ~16 bits and the output stays within
    chip_smoke.py's bf16 limits against `attention_plain` (each max
    <= 2^-6 L, pooled mean |err| / L <= 2^-18, L the largest |output|);
    rounded to bf16 once they fail the pooled limit. Read on this CPU:
    split max 3.8e-3 L, pooled 3.5e-7; rounded once pooled 2.0e-4."""
    pooled = {True: [0.0, 0], False: [0.0, 0]}
    for seed, shape in ((0, (4, 2, 65, 64)), (1, (2, 2, 257, 64))):
        q, k, v = (to_torch(t, "bfloat16") for t in qkv(seed, shape))
        scale = shape[-1] ** -0.5
        ref = attention_plain(q, k, v, scale).float()
        big = ref.abs().max().item()
        for split in (True, False):
            err = (_split_pv(q, k, v, scale, split).float() - ref).abs()
            assert err.max().item() <= 2.0 ** -6 * big
            pooled[split][0] += err.sum().item() / big
            pooled[split][1] += err.numel()
    mean = {split: total / count for split, (total, count) in pooled.items()}
    assert mean[True] <= 2.0 ** -18 < mean[False]


def test_autograd_node_only_where_a_gradient_is_tracked():
    q, k, v = (torch.from_numpy(t) for t in qkv(4, (1, 2, 9, 16)))
    out = attention_fused(q, k, v, 0.25)
    assert out.grad_fn is None
    assert torch.equal(out, attention_plain(q, k, v, 0.25))
    q.requires_grad_()
    with torch.no_grad():
        assert attention_fused(q, k, v, 0.25).grad_fn is None
    tracked = attention_fused(q, k, v, 0.25)
    assert tracked.grad_fn is not None and torch.equal(tracked.detach(), out)
