"""The port's building blocks against the JAX package on the CPU: the
norms, one pre-norm block (the plain version a later per-block kernel will
share) against the JAX fused-block Pallas kernel in interpret mode, the
config copy, and the parameter carry-over."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.models.layers import LayerNorm as JaxLayerNorm
from dgvit_tpu.models.layers import RMSNorm as JaxRMSNorm
from dgvit_tpu.ops.fused_transformer import (_block_params_flat,
                                             fused_transformer_block)
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core.checkpoint import load_params_npz
from dgvit_tpu_torch.models.jax_io import _BLOCK, params_from_jax
from dgvit_tpu_torch.models.layers import LayerNorm, RMSNorm, TransformerBlock

from test_torch_policy import ACTOR

D, HEADS, DIM_HEAD, MLP = 64, 2, 16, 128


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, D)).astype(np.float32) * 3
    g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32) * 0.1
    if kind == "rms":
        ref = JaxRMSNorm(D).apply({"params": {"g": g}}, x)
        mod = RMSNorm(D)
        mod.g.data = torch.from_numpy(g)
    else:
        ref = JaxLayerNorm(D).apply({"params": {"scale": g, "bias": b}}, x)
        mod = LayerNorm(D)
        mod.weight.data, mod.bias.data = torch.from_numpy(g), torch.from_numpy(b)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _block_tree(rng):
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    ln = lambda: {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(
        np.float32), "bias": u(D)}
    inner = HEADS * DIM_HEAD
    return {"attn_norm": ln(),
            "attn": {"to_qkv": {"kernel": u(D, 3 * inner)},
                     "to_out": {"kernel": u(inner, D), "bias": u(D)}},
            "ff_norm": ln(),
            "ff": {"fc1": {"kernel": u(D, MLP), "bias": u(MLP)},
                   "fc2": {"kernel": u(MLP, D), "bias": u(D)}}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_block_matches_jax_fused_block(dtype):
    """TransformerBlock (plain pre-norm block) against the JAX fused block
    kernel in interpret mode on 65 tokens (the JAX kernel pads to 72 and
    masks). fp32 2e-5. bf16: another fp32 summation order flips a few
    bf16 roundings inside the block (qkv, probabilities, hidden units) and
    each flip moves outputs by up to about one bf16 ulp of the output's
    largest magnitude (~9 here), so max |err| <= 2^-7 max|ref| and mean
    |err| <= 1e-3."""
    rng = np.random.default_rng(1)
    tree = _block_tree(rng)
    x = rng.standard_normal((2, 65, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = fused_transformer_block(jnp.asarray(x).astype(jdt),
                                  _block_params_flat(tree, jdt), HEADS,
                                  DIM_HEAD, True)
    blk = TransformerBlock(D, HEADS, DIM_HEAD, MLP)
    blk.load_state_dict({_BLOCK["/".join(path)]: torch.from_numpy(leaf)
                         for path, leaf in _leaves(tree)})
    with torch.no_grad():
        out = blk(torch.from_numpy(x).to(tdt))
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.dtype == tdt and out.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    else:
        err = np.abs(out.float().numpy() - ref)
        assert err.max() <= 2.0 ** -7 * np.abs(ref).max()
        assert err.mean() <= 1e-3


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_params_from_jax_layout():
    """Dense kernels (in, out) become nn.Linear weights (out, in); block
    matrices stay (in, out); every trained leaf lands on a parameter."""
    flat = load_params_npz(str(ACTOR))
    sd = params_from_jax(flat)
    # 5 heads/embeds x (kernel, bias); g, patch kernel/bias, pos; 4 blocks
    assert len(sd) == len(flat) == 10 + 4 + 4 * len(_BLOCK)
    np.testing.assert_array_equal(sd["fc1.weight"].numpy(),
                                  flat["fc1/kernel"].T)
    np.testing.assert_array_equal(sd["trans.patch_embed.weight"].numpy(),
                                  flat["trans/patch_embed/kernel"].T)
    np.testing.assert_array_equal(
        sd["trans.transformer.blocks.2.wqkv"].numpy(),
        flat["trans/transformer/block_2/attn/to_qkv/kernel"])
    assert tuple(sd["trans.pos_embedding"].shape) == (1, 65, 64)
    nested = {"params": {"fc1": {"kernel": flat["fc1/kernel"]}}}
    assert set(params_from_jax(nested)) == {"fc1.weight"}
    with pytest.raises(KeyError, match="no port parameter"):
        params_from_jax({"trans/transformer/block_0/attn/bogus": np.zeros(1)})


def test_config_copy_validates():
    cfg = Config.from_dict({"model": {"block": "3"},
                            "env": {"linear_cmd_scale": 0.5}})
    assert cfg.model.block == 3 and cfg.env.linear_cmd_scale == 0.5
    with pytest.raises(KeyError, match="model.blok"):
        Config.from_dict({"model": {"blok": 3}})
    with pytest.raises(TypeError, match="expected int"):
        Config.from_dict({"model": {"head": "four"}})
    with pytest.raises(ValueError, match="divide into patches"):
        Config.from_dict({"model": {"image_size": [100, 160]}})
    assert Config.from_dict({"model": {"actor_type": "GaussianConvNet"}}
                            ).model.actor_type == "GaussianConvNet"
    with pytest.raises(ValueError, match="actor_type"):
        Config.from_dict({"model": {"actor_type": "GaussianRNN"}})
