"""Shared inputs of the port's kernel tests: one pre-norm block's weights
at the small test geometry (dim 64, 2 heads x 16, MLP 128), as the JAX
kernels take them and as the port's kernels take them, from numpy; and
the bf16 closeness used by the tests.

bf16: both sides round to bf16 at the same points, so most values agree
bit for bit, but an fp32 sum taken in another order can flip a bf16
rounding of an intermediate (qkv, p, dpre, dqkv), and the flip moves what
follows by about one ulp of its own magnitude; at these sizes one flip can
touch a whole frame. With L a tensor's largest |value|: each tensor max
|err| <= 2^-7 L, and |err| / L pooled over all the tensors of a call
(output, or dx and the 11 grads) <= 2^-13. Measured on these cases: the
hand-placed backward pools 2e-8 to 4e-5, autograd of the plain forward
(which rounds at the forward's casts instead) 2e-4 to 4e-4."""

import jax.numpy as jnp
import numpy as np
import torch

from dgvit_tpu.ops.fused_transformer import _block_params_flat

D, HEADS, DIM_HEAD, MLP = 64, 2, 16, 128


def block_tree(rng, heads=HEADS, dim_head=DIM_HEAD, mlp=MLP):
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    ln = lambda: {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(
        np.float32), "bias": u(D)}
    inner = heads * dim_head
    return {"attn_norm": ln(),
            "attn": {"to_qkv": {"kernel": u(D, 3 * inner)},
                     "to_out": {"kernel": u(inner, D), "bias": u(D)}},
            "ff_norm": ln(),
            "ff": {"fc1": {"kernel": u(D, mlp), "bias": u(mlp)},
                   "fc2": {"kernel": u(mlp, D), "bias": u(D)}}}


def weights(tree, dtype: str):
    """(JAX flat tuple, port 11-tuple) of one block in a compute dtype."""
    flat = _block_params_flat(tree, getattr(jnp, dtype))
    port = tuple(torch.from_numpy(np.array(t.astype(jnp.float32)))
                 .reshape(-1 if t.shape[0] == 1 else t.shape)
                 .to(getattr(torch, dtype)).contiguous() for t in flat)
    return flat, port


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def to_jax(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def to_torch(a: np.ndarray, dtype: str):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype(jnp.float32))


def bf16_close(outs, refs) -> bool:
    """The bf16 check above, over matching lists of tensors."""
    total = count = 0.0
    for out, ref in zip(outs, refs):
        o = as_np(out)
        r = as_np(ref).reshape(o.shape)
        scale = np.abs(r).max()
        err = np.abs(o - r)
        if err.max() > 2.0 ** -7 * scale:
            return False
        total += (err / scale).sum()
        count += err.size
    return total / count <= 2.0 ** -13


def assert_close(outs, refs, dtype: str, rtol: float, atol: float):
    """fp32: each pair allclose(rtol, atol); bf16: `bf16_close`."""
    if dtype == "bfloat16":
        assert bf16_close(outs, refs)
        return
    for i, (out, ref) in enumerate(zip(outs, refs)):
        o = as_np(out)
        np.testing.assert_allclose(o, as_np(ref).reshape(o.shape), rtol=rtol,
                                   atol=atol, err_msg=f"tensor {i}")
