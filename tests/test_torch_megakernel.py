"""The port's whole-trunk forward (dgvit_tpu_torch/ops/got_megakernel.py)
against the JAX package's Pallas megakernel in interpret mode, on the CPU.

On a CPU tensor the port's `got_forward_fused` runs its plain PyTorch
version, which is what the CUDA kernel is held against on the card. Same
parameters (numpy-seeded, carried into the port by `params_from_jax`),
same inputs.

Tolerances: fp32 2e-5 (the two sides differ only in fp32 summation order).
bf16: max |err| <= 2^-6 (one bf16 ulp at magnitude 2-4; the latents reach
~4) and mean |err| <= 1e-3. Both sides round to bf16 at the same points,
so they agree bit for bit at these sizes, but another summation order may
flip a bf16 rounding somewhere. An erf GELU where the kernel uses tanh, or
a residual stream kept in fp32 across blocks, moves the mean error to
~3e-3 (test_bf16_catches_wrong_numerics).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.models.got import patchify_2d as jax_patchify_2d
from dgvit_tpu.ops.fused_transformer import _block_params_flat
from dgvit_tpu.ops.got_megakernel import _mega_xla
from dgvit_tpu.ops.got_megakernel import got_forward_fused as jax_fused
from dgvit_tpu_torch.models.got import GoT
from dgvit_tpu_torch.models.jax_io import params_from_jax
from dgvit_tpu_torch.ops import fused_transformer as pft
from dgvit_tpu_torch.ops.cls_block import cls_block_plain
from dgvit_tpu_torch.ops.got_megakernel import (got_forward_fused,
                                                got_forward_plain)

DIM, DEPTH, HEADS, DIM_HEAD, MLP = 64, 3, 2, 16, 128
IMG, PATCH = (32, 40), (16, 20)
N_PATCH = (IMG[0] // PATCH[0]) * (IMG[1] // PATCH[1])
PD = PATCH[0] * PATCH[1]
F32_TOL = 2e-5


def bf16_close(out: torch.Tensor, ref: np.ndarray) -> bool:
    err = np.abs(out.float().numpy() - ref)
    return err.max() <= 2.0 ** -6 and err.mean() <= 1e-3


def jax_got_tree(seed: int, final_norm: str):
    """A GoT parameter tree with the JAX package's paths, from numpy."""
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    ln = lambda: {"scale": (1 + 0.1 * rng.standard_normal(DIM)).astype(
        np.float32), "bias": u(DIM)}
    inner = HEADS * DIM_HEAD
    tree = {
        "patch_embed": {"kernel": u(PD, DIM) * 0.3, "bias": u(DIM)},
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
    }
    if final_norm == "rms":
        tree["norm_out"] = {"g": (1 + 0.1 * rng.standard_normal(DIM)).astype(
            np.float32)}
    else:
        tree["norm_out"] = ln()
    return tree


def inputs(seed: int, batch: int):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (batch, *IMG)).astype(np.float32)
    goal = rng.standard_normal((batch, DIM)).astype(np.float32)
    return img, goal


def jax_args(tree, img, goal, final_norm, cdt):
    """The JAX megakernel's arguments, cast as models/got.py casts them."""
    no = tree["norm_out"]
    if final_norm == "rms":
        fn = (jnp.asarray(no["g"]).reshape(1, -1),
              jnp.zeros((1, DIM), jnp.float32))
    else:
        fn = (jnp.asarray(no["scale"]).reshape(1, -1),
              jnp.asarray(no["bias"]).reshape(1, -1))
    pe = tree["patch_embed"]
    return (jax_patchify_2d(jnp.asarray(img), *PATCH).astype(cdt),
            jnp.asarray(goal).astype(cdt),
            (jnp.asarray(pe["kernel"]).astype(cdt),
             jnp.asarray(pe["bias"]).reshape(1, -1).astype(cdt)),
            jnp.asarray(tree["pos_embedding"][0]).astype(cdt),
            tuple(_block_params_flat(tree["transformer"][f"block_{i}"], cdt)
                  for i in range(DEPTH)),
            fn)


def port_got(tree, final_norm, cdt):
    got = GoT(image_size=IMG, patch_size=PATCH, dim=DIM, depth=DEPTH,
              heads=HEADS, dim_head=DIM_HEAD, mlp_dim=MLP,
              final_norm=final_norm, dtype=cdt)
    got.load_state_dict(params_from_jax(tree))
    return got


def port_trunk(got, img, goal, cdt, trunk=got_forward_fused):
    from dgvit_tpu_torch.models.got import patchify_2d

    pe, pos, blocks, fn = got.fused_params(cdt)
    patches = patchify_2d(torch.from_numpy(img), *PATCH).to(cdt)
    return trunk(patches.contiguous(), torch.from_numpy(goal).to(cdt),
                 pe, pos, blocks, fn, HEADS, DIM_HEAD, N_PATCH + 1,
                 got.final_norm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("final_norm", ["rms", "layer"])
def test_matches_jax_megakernel(final_norm, batch, dtype):
    tree = jax_got_tree(0, final_norm)
    img, goal = inputs(1 + batch, batch)
    jcdt, tcdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_fused(*jax_args(tree, img, goal, final_norm, jcdt), HEADS,
                    DIM_HEAD, N_PATCH + 1, final_norm, True)
    out = port_trunk(port_got(tree, final_norm, tcdt), img, goal, tcdt)
    assert out.dtype == tcdt and out.shape == (batch, DIM)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        assert bf16_close(out, ref)


@pytest.mark.parametrize("final_norm", ["rms", "layer"])
def test_matches_jax_xla_twin_fp32(final_norm):
    tree = jax_got_tree(2, final_norm)
    img, goal = inputs(3, 4)
    ref = _mega_xla(*jax_args(tree, img, goal, final_norm, jnp.float32),
                    heads=HEADS, dim_head=DIM_HEAD, n_valid=N_PATCH + 1,
                    final_norm=final_norm)
    out = port_trunk(port_got(tree, final_norm, torch.float32), img, goal,
                     torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_got_module_routes_through_wrapper():
    """GoT.forward's deterministic inference route on the CPU is the
    wrapper's plain version, bit for bit, and launches no kernel."""
    tree = jax_got_tree(4, "rms")
    img, goal = inputs(5, 3)
    got = port_got(tree, "rms", torch.bfloat16)
    got_forward_fused.launches = 0
    a = got(torch.from_numpy(img), torch.from_numpy(goal), inference=True)
    b = port_trunk(got, img, goal, torch.bfloat16, trunk=got_forward_plain)
    c = got_forward_plain(*got.trunk_args(torch.from_numpy(img),
                                          torch.from_numpy(goal)))
    assert torch.equal(a, b) and torch.equal(a, c)
    assert got_forward_fused.launches == 0


def test_bf16_catches_wrong_numerics(monkeypatch):
    """The bf16 tolerance is tight enough to see the two classic slips: an
    erf GELU where the kernel uses tanh, and a residual stream kept in fp32
    across blocks."""
    tree = jax_got_tree(6, "rms")
    img, goal = inputs(7, 4)
    ref = np.asarray(jax_fused(
        *jax_args(tree, img, goal, "rms", jnp.bfloat16), HEADS, DIM_HEAD,
        N_PATCH + 1, "rms", True).astype(jnp.float32))
    got = port_got(tree, "rms", torch.bfloat16)
    close = lambda trunk=got_forward_fused: bf16_close(
        port_trunk(got, img, goal, torch.bfloat16, trunk=trunk), ref)
    assert close()

    with monkeypatch.context() as m:
        erf_gelu = lambda x, cdt: 0.5 * x * (1.0 + torch.erf(x * pft._INV_SQRT2))
        m.setattr(pft, "_gelu32", erf_gelu)
        assert not close()
    # the plain trunk with the residual stream kept in fp32 across blocks
    from dgvit_tpu_torch.ops import got_megakernel as pgm

    def no_residual_cast(patches, goal, pe, pos, blocks, fn, heads,
                         dim_head, n_valid, final_norm):
        cdt = patches.dtype
        emb = (pft._mm(patches, pe[0]) + pe[1].float()).to(cdt)
        x = torch.cat([goal[:, None, :], emb], dim=1)
        x32 = (x.float() + pos.float()[None]).to(cdt).float()
        for w in blocks[:-1]:
            x32 = pft.block_plain(x32, w, heads=heads, dim_head=dim_head,
                                  cdt=cdt)
        cls = cls_block_plain(x32, blocks[-1], heads=heads,
                              dim_head=dim_head, cdt=cdt)
        return pgm._final_norm32(cls, *fn, final_norm).to(cdt)

    assert not close(no_residual_cast)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_keeps_streams_only_when_differentiated(dtype, monkeypatch):
    """K4 writes the streams K6 differentiates only when the call will be
    differentiated (grad mode on and an input requiring grad), keeps them
    for the backward, and they are the plain forward's streams; under
    torch.no_grad(), or with no input requiring grad, it writes none."""
    from dgvit_tpu_torch.ops import got_megakernel as pgm
    from torch_kernel_cases import block_tree, rand, to_torch, weights

    rng = np.random.default_rng(17)
    blocks = [weights(block_tree(rng), dtype)[1] for _ in range(DEPTH)]
    fn = (torch.from_numpy((1 + 0.1 * rng.standard_normal(DIM)).astype(
        np.float32)), torch.zeros(DIM))
    x = to_torch(rand(rng, 2, 5, DIM), dtype)
    asked, real = [], pgm._blocks_forward

    def spy(*args, **kwargs):
        asked.append(kwargs.get("streams", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(pgm, "_blocks_forward", spy)
    call = lambda t: pgm.blocks_cls_forward_fused(t, blocks, fn, HEADS,
                                                  DIM_HEAD, "rms")
    with torch.no_grad():
        quiet = call(x.clone().requires_grad_())
    assert quiet.grad_fn is None
    call(x)
    out = call(x.clone().requires_grad_())
    assert asked == [False, False, True]
    saved = out.grad_fn.saved_tensors
    ref, (xs, cls, rec) = pgm.blocks_forward_plain(
        x, blocks, fn, HEADS, DIM_HEAD, "rms", streams=True)
    assert torch.equal(out, ref)
    assert xs.shape == (DEPTH - 1, 2, 5, DIM) and cls.shape == (2, DIM)
    assert torch.equal(saved[1], xs) and torch.equal(saved[2], cls)
    assert rec.dtype == torch.float32 and torch.equal(saved[3], rec)
