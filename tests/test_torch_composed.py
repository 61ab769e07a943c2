"""The port's composed GoT route (dgvit_tpu_torch/models/layers.py and
got.py: LayerNorm, `attention`, `feed_forward` around the attention
kernels K7 and K8) against the JAX package's composed modules, on the CPU.

A model takes this route when its blocks have dropout, when `attn_impl` is
xla or pallas, with mean pooling, or with more than 256 tokens. The JAX
side runs `attn_impl="xla"` and `"pallas_interpret"` (its TPU kernel in
interpret mode); the port runs "xla" and "pallas", whose kernel wrapper
runs `attention_plain` on CPU tensors.

Tolerances: fp32 rtol 2e-5 / atol 2e-5 on latents and actions (other
summation orders through two blocks), rtol 1e-3 / atol 1e-4 on gradients;
bf16: both sides round after every operation but PyTorch and XLA fuse
different ones: latents within 2^-5 of the largest |latent| (0.5-0.9% was
read on such cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.models.got import GoT as JaxGoT
from dgvit_tpu.models.layers import Attention as JaxAttention
from dgvit_tpu.models.policies import GoTPolicy as JaxGoTPolicy
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.models import build_actor, layers
from dgvit_tpu_torch.models.got import GoT
from dgvit_tpu_torch.models.jax_io import params_from_jax, params_to_jax
from dgvit_tpu_torch.models.policies import GoTPolicy
from dgvit_tpu_torch.ops.attention import attention_fused
from dgvit_tpu_torch.ops.fused_block import fused_attention_section

D, HEADS, DIM_HEAD, MLP, DEPTH = 64, 2, 16, 64, 2
SMALL = dict(image_size=(32, 40), patch_size=(16, 20), dim=D, depth=DEPTH,
             heads=HEADS, dim_head=DIM_HEAD, mlp_dim=MLP, emb_dropout=0.0)
PORT_IMPL = {"xla": "xla", "pallas_interpret": "pallas", "auto": "auto"}


def seeded_tree(module, rng, *example):
    """The module's parameter tree filled from numpy."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *example))["params"]
    return jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


def got_pair(seed, batch=3, dtype=None, **over):
    """(JAX GoT, its seeded tree, the port's GoT carrying it, img, goal)."""
    cfg = dict(SMALL, **over)
    rng = np.random.default_rng(seed)
    jgot = JaxGoT(**cfg, dtype=None if dtype is None else jnp.bfloat16)
    ih, iw = cfg["image_size"]
    tree = seeded_tree(jgot, rng, jnp.zeros((1, ih, iw)), jnp.zeros((1, D)))
    port_cfg = dict(cfg, attn_impl=PORT_IMPL[cfg.get("attn_impl", "auto")])
    got = GoT(**port_cfg, dtype=dtype)
    got.load_state_dict(params_from_jax(tree))
    img = rng.uniform(0, 1, (batch, ih, iw)).astype(np.float32)
    goal = rng.standard_normal((batch, D)).astype(np.float32)
    return jgot, tree, got, img, goal


def no_block_kernels(monkeypatch):
    """The composed route must not reach the fused block or trunk."""
    def boom(*a, **k):
        raise AssertionError("the composed route reached a fused block")
    for name in ("fused_transformer_block", "cls_final_block"):
        monkeypatch.setattr(layers, name, boom)
    from dgvit_tpu_torch.models import got as got_mod
    for name in ("got_forward_fused", "blocks_cls_forward_fused"):
        monkeypatch.setattr(got_mod, name, boom)


@pytest.mark.parametrize("over", [
    dict(attn_impl="xla"), dict(attn_impl="pallas_interpret"),
    dict(attn_impl="xla", pool="mean"), dict(dropout=0.1),
    dict(attn_impl="xla", final_norm="layer"),
], ids=["xla", "pallas", "mean-pool", "dropout", "layer-norm"])
def test_composed_got_matches_jax(over, monkeypatch):
    """fp32 latents, acting (inference) and training flags alike: these
    models take the composed route whatever the flags."""
    jgot, tree, got, img, goal = got_pair(31, **over)
    ref = np.asarray(jgot.apply({"params": tree}, jnp.asarray(img),
                                jnp.asarray(goal)))
    no_block_kernels(monkeypatch)
    i, g = torch.from_numpy(img), torch.from_numpy(goal)
    with torch.no_grad():
        for flags in ({}, {"inference": True}):
            out = got(i, g, **flags)
            assert out.shape == (3, D)
            np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5,
                                       atol=2e-5)


def test_composed_got_bf16_matches_jax(monkeypatch):
    jgot, tree, got, img, goal = got_pair(32, dtype=torch.bfloat16,
                                          attn_impl="xla")
    ref = np.asarray(jgot.apply({"params": tree}, jnp.asarray(img),
                                jnp.asarray(goal)).astype(jnp.float32))
    no_block_kernels(monkeypatch)
    with torch.no_grad():
        out = got(torch.from_numpy(img), torch.from_numpy(goal))
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() \
        <= 2.0 ** -5 * np.abs(ref).max()


def test_257_tokens_take_the_composed_route(monkeypatch):
    """8x10 patches of a (128, 160) frame: 257 tokens, over every fused
    limit, attn_impl auto."""
    jgot, tree, got, img, goal = got_pair(
        33, batch=2, image_size=(128, 160), patch_size=(8, 10))
    ref = np.asarray(jgot.apply({"params": tree}, jnp.asarray(img),
                                jnp.asarray(goal)))
    no_block_kernels(monkeypatch)
    with torch.no_grad():
        out = got(torch.from_numpy(img), torch.from_numpy(goal),
                  inference=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_129_tokens_over_the_h100_limit_match_jax(monkeypatch):
    """8x20 patches of a (128, 160) frame: 129 tokens at the flagship
    widths. Under the H100's shared-memory limit (232,448 bytes a block)
    no fp32 fused kernel holds such a frame (ops/smem.py), so acting and
    training forwards take the composed route; fp32 latents as JAX's."""
    from dgvit_tpu_torch.ops import smem

    jgot, tree, got, img, goal = got_pair(
        34, batch=2, image_size=(128, 160), patch_size=(8, 20), heads=4,
        dim_head=64, mlp_dim=2048)
    assert got.num_patches + 1 == 129
    ref = np.asarray(jgot.apply({"params": tree}, jnp.asarray(img),
                                jnp.asarray(goal)))
    monkeypatch.setattr(smem, "limit_for", lambda device: 232448)
    no_block_kernels(monkeypatch)
    i, g = torch.from_numpy(img), torch.from_numpy(goal)
    with torch.no_grad():
        for flags in ({}, {"inference": True}):
            np.testing.assert_allclose(got(i, g, **flags).numpy(), ref,
                                       rtol=2e-5, atol=2e-5)


def test_composed_gradients_match_jax():
    """Parameter and goal gradients through the kernel route of the
    composed blocks (its backward recomputes the plain version)."""
    jgot, tree, got, img, goal = got_pair(34, attn_impl="pallas_interpret")
    cos = np.cos(np.arange(3 * D, dtype=np.float32)).reshape(3, D)

    def loss(p, g):
        return jnp.sum(jgot.apply({"params": p}, jnp.asarray(img), g)
                       * jnp.asarray(cos))

    ref_p, ref_g = jax.grad(loss, argnums=(0, 1))(tree, jnp.asarray(goal))
    g = torch.from_numpy(goal).requires_grad_()
    (got(torch.from_numpy(img), g) * torch.from_numpy(cos)).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(ref_g), rtol=1e-3,
                               atol=1e-4)
    mine = params_to_jax({n: p.grad for n, p in got.named_parameters()})
    ref = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(ref_p)[0]}
    assert mine.keys() == ref.keys()
    for key, r in ref.items():
        np.testing.assert_allclose(mine[key], r, rtol=1e-3, atol=1e-4,
                                   err_msg=key)


def test_both_attention_branches_match_jax(monkeypatch):
    """`attention` runs the fused section for a tensor on the card and the
    projections around `dot_product_attention` otherwise; here the first
    branch is entered by saying the tensor is on the card (its wrapper
    then runs the section's plain version)."""
    rng = np.random.default_rng(35)
    jattn = JaxAttention(D, HEADS, DIM_HEAD)
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    tree = seeded_tree(jattn, rng, jnp.zeros((1, 5, D)))
    ref = np.asarray(jattn.apply({"params": tree}, jnp.asarray(x)))
    w = [torch.from_numpy(np.asarray(a)) for a in (
        tree["to_qkv"]["kernel"], tree["to_out"]["kernel"],
        tree["to_out"]["bias"])]
    fused_attention_section.launches = attention_fused.launches = 0
    seen = []
    section = layers.fused_attention_section
    monkeypatch.setattr(layers, "fused_attention_section",
                        lambda *a: seen.append("section") or section(*a))
    composed = layers.attention(torch.from_numpy(x), *w, HEADS, DIM_HEAD)
    assert seen == []
    monkeypatch.setattr(layers, "_on_card", lambda t: True)
    fused = layers.attention(torch.from_numpy(x), *w, HEADS, DIM_HEAD)
    assert seen == ["section"]
    # xla and pallas never take the section, wherever the tensor is
    for impl in ("xla", "pallas"):
        out = layers.attention(torch.from_numpy(x), *w, HEADS, DIM_HEAD,
                               attn_impl=impl)
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert seen == ["section"]
    assert fused_attention_section.launches == attention_fused.launches == 0
    for out in (composed, fused):
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_dropout_sites_and_keep_rate(monkeypatch):
    """Block dropout sits after the attention section's output, after the
    GELU and after fc2, as in the JAX modules; the last block's MLP sees
    the CLS row alone. Masks come from the generator only."""
    _, _, got, img, goal = got_pair(36, batch=8, dropout=0.25)
    i, g = torch.from_numpy(img), torch.from_numpy(goal)
    sites = []
    real = layers.dropout

    def spy(x, rate, generator):
        y = real(x, rate, generator)
        sites.append((tuple(x.shape), rate, (y == 0).float().mean().item()))
        return y

    monkeypatch.setattr(layers, "dropout", spy)
    gen = lambda: torch.Generator().manual_seed(5)
    with torch.no_grad():
        a = got(i, g, deterministic=False, generator=gen())
        first = list(sites)
        b = got(i, g, deterministic=False, generator=gen())
        c = got(i, g, deterministic=False,
                generator=torch.Generator().manual_seed(6))
        del sites[:]
        d = got(i, g)
    n = 5
    assert [s[0] for s in first] == [
        (8, n, D), (8, n, MLP), (8, n, D),          # block 0
        (8, n, D), (8, 1, MLP), (8, 1, D)]          # CLS-only last block
    assert all(rate == 0.25 for _, rate, _ in first)
    big = [z for shape, _, z in first if np.prod(shape) >= 8 * n * D]
    assert all(abs(z - 0.25) < 0.04 for z in big)
    assert sites == []                              # deterministic: none
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, d)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_composed_policy_matches_jax(impl):
    """GoTPolicy with an `attn_impl`: actions' mean and log_std."""
    rng = np.random.default_rng(37)
    kw = dict(block=DEPTH, head=HEADS, l_f_size=D, dim_head=DIM_HEAD,
              mlp_dim=MLP, image_size=(32, 40), emb_dropout=0.0)
    jpol = JaxGoTPolicy(**kw, attn_impl=impl)
    tree = seeded_tree(jpol, rng, jnp.zeros((1, 32, 40)), jnp.zeros((1, 2)))
    obs = rng.uniform(0, 1, (4, 32, 40)).astype(np.float32)
    goal = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
    ref = jpol.apply({"params": tree}, jnp.asarray(obs), jnp.asarray(goal),
                     inference=True)
    pol = GoTPolicy(**kw, attn_impl=PORT_IMPL[impl])
    pol.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        out = pol(torch.from_numpy(obs), torch.from_numpy(goal),
                  inference=True)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)


def test_build_actor_hands_attn_impl_on():
    cfg = Config.from_dict({"model": {"block": 2, "head": 2, "dim_head": 16,
                                      "mlp_dim": 64}})
    actor = build_actor(cfg, attn_impl="pallas")
    assert not actor.trans.blocks_ok
    assert all(b.attn_impl == "pallas"
               for b in actor.trans.transformer.blocks)
    assert build_actor(cfg).trans.blocks_ok
    with pytest.raises(ValueError, match="unknown attention impl"):
        build_actor(cfg, attn_impl="flash")


def test_unported_options_raise_by_name():
    with pytest.raises(NotImplementedError, match="seq_shard"):
        GoT(**dict(SMALL, seq_shard=True))
