"""Attention capture, the visualizer and the block without an output
projection in the port (dgvit_tpu_torch/models/{layers,got,simple_vit,
policies}.py, utils/visualizer.py, examples/attention_maps.py) against the
JAX package, on the CPU (JAX tests/test_models.py:141, tests/test_aux.py:10
and tests/test_drivers.py:418).

The same numpy-seeded inputs and the JAX package's parameters (carried by
`params_from_jax`) go through both: every block's softmax maps within
atol 1e-5 of JAX's sown maps, under JAX's keys, and the outputs within
1e-5; a block with heads == 1 and dim_head == dim (no output projection)
within 1e-5, its parameters carried both ways.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.models import GoT as JaxGoT
from dgvit_tpu.models.policies import (GoTPolicy as JaxGoTPolicy,
                                       ViTGaussianPolicy as JaxViTPolicy)
from dgvit_tpu.models.simple_vit import SimpleViT as JaxSimpleViT
from dgvit_tpu.utils.visualizer import \
    AttentionVisualizer as JaxAttentionVisualizer
from dgvit_tpu_torch.models import got as got_mod
from dgvit_tpu_torch.models.got import GoT
from dgvit_tpu_torch.models.jax_io import params_from_jax, params_to_jax
from dgvit_tpu_torch.models.policies import (GoTPolicy, GoTQNetwork,
                                             ViTGaussianPolicy)
from dgvit_tpu_torch.models.simple_vit import SimpleViT
from dgvit_tpu_torch.ops import smem
from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain
from dgvit_tpu_torch.utils import AttentionVisualizer

HW = (32, 40)
GOT = dict(dim=32, depth=2, heads=2, dim_head=16, mlp_dim=64,
           image_size=HW)
TOL = dict(rtol=0, atol=1e-5)


def frames(b=2, seed=0, hw=HW):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (b, *hw)).astype(np.float32)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def sown(model, params, *args):
    """JAX's output and its sown maps, by the visualizer's keys."""
    viz = JaxAttentionVisualizer(model, params)
    viz.activate()
    out = viz(*args)
    return out, viz.cache


def test_got_capture_matches_jax():
    jm = JaxGoT(**GOT, capture=True)
    img, goal = frames(), np.random.default_rng(1).normal(
        0, 1, (2, 32)).astype(np.float32)
    params = as_np(jm.init(jax.random.PRNGKey(0), img, goal))
    out, maps = sown(jm, params, img, goal)
    port = GoT(**GOT, capture=True)
    port.load_state_dict(params_from_jax(params["params"]))
    viz = AttentionVisualizer(port)
    viz.activate()
    got = viz(torch.from_numpy(img), torch.from_numpy(goal))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    assert sorted(viz.cache) == sorted(maps) == [
        "transformer/block_0/attn/attn/0", "transformer/block_1/attn/attn/0"]
    for k, v in maps.items():
        assert viz.cache[k].shape == (2, 2, 5, 5)
        np.testing.assert_allclose(viz.cache[k], v, err_msg=k, **TOL)
        np.testing.assert_allclose(viz.cache[k].sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("family", ["got_policy", "vit_policy"])
def test_policy_capture_matches_jax(family):
    """GoTPolicy and the ViT actor through both visualizers: the same keys,
    the maps and the actions' means within 1e-5."""
    obs, goal = frames(seed=2, hw=(128, 160) if family == "vit_policy"
                       else HW), np.random.default_rng(3).uniform(
        -1, 1, (2, 2)).astype(np.float32)
    if family == "got_policy":
        kw = dict(block=2, head=2, l_f_size=32, dim_head=16, mlp_dim=64,
                  image_size=HW)
        jm, port = JaxGoTPolicy(**kw, capture=True), GoTPolicy(
            **kw, capture=True)
    else:
        kw = dict(dim=32, depth=2, heads=2, mlp_dim=64)
        jm, port = JaxViTPolicy(**kw, capture=True), ViTGaussianPolicy(
            **kw, capture=True)
    params = as_np(jm.init(jax.random.PRNGKey(4), obs, goal))
    (mean, _), maps = sown(jm, params, obs, goal)
    viz = AttentionVisualizer(port, params["params"])
    viz.activate()
    pmean, _ = viz(torch.from_numpy(obs), torch.from_numpy(goal))
    np.testing.assert_allclose(pmean.numpy(), np.asarray(mean), **TOL)
    assert sorted(viz.cache) == sorted(maps) and len(maps) == 2
    for k, v in maps.items():
        np.testing.assert_allclose(viz.cache[k], v, err_msg=k, **TOL)
    g = viz.goal_token_attention()
    assert all(v.shape == maps[k].shape[:2] + maps[k].shape[3:]
               for k, v in g.items())


def test_simple_vit_capture_matches_jax():
    jm = JaxSimpleViT(dim=32, depth=2, heads=2, dim_head=16, mlp_dim=64,
                      capture=True)
    img = frames(seed=5, hw=(128, 160))
    params = as_np(jm.init(jax.random.PRNGKey(6), img, method=jm.full))
    out, state = jm.apply(params, img, mutable=["intermediates"])
    maps = jax.tree_util.tree_leaves(state["intermediates"])
    port = SimpleViT(dim=32, depth=2, heads=2, dim_head=16, mlp_dim=64,
                     capture=True)
    port.load_state_dict(params_from_jax(params["params"]))
    got = port(torch.from_numpy(img))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    for blk, ref in zip(port.transformer, maps):
        assert blk.captured.shape == (2, 2, 64, 64)
        np.testing.assert_allclose(blk.captured.numpy(), np.asarray(ref),
                                   **TOL)


def test_visualizer_cache_api():
    """JAX's visualizer contract: inactive, an ordinary forward and no
    cache; active, one map a block, rows summing to 1, the goal rows;
    clear empties it."""
    model = GoT(**GOT, capture=True)
    img, goal = torch.from_numpy(frames(1)), torch.ones(1, 32)
    viz = AttentionVisualizer(model)
    out = viz(img, goal)
    assert out.shape == (1, 32) and viz.cache == {}
    viz.activate()
    torch.testing.assert_close(viz(img, goal), out, rtol=0, atol=1e-5)
    assert len(viz.cache) == 2
    for v in viz.cache.values():
        assert v.shape == (1, 2, 5, 5)
        np.testing.assert_allclose(v.sum(-1), 1.0, rtol=1e-5)
    assert all(v.shape == (1, 2, 5)
               for v in viz.goal_token_attention().values())
    viz.clear()
    assert viz.cache == {}
    viz.deactivate()
    viz(img, goal)
    assert viz.cache == {}


def test_inactive_visualizer_takes_the_kernels(monkeypatch):
    """Inactive, capture is off and acting runs the whole-trunk route (K1's
    wrapper); active, the composed route with the maps."""
    calls = []
    monkeypatch.setattr(got_mod, "got_forward_fused", lambda *a: (
        calls.append(1), got_forward_plain(*a))[1])
    policy = GoTPolicy(block=2, head=2, l_f_size=32, dim_head=16,
                       mlp_dim=64, image_size=HW, capture=True)
    assert not policy.trans.blocks_ok
    viz = AttentionVisualizer(policy)
    o, g = torch.from_numpy(frames(1)), torch.zeros(1, 2)
    inactive = viz(o, g, inference=True)[0]
    assert calls == [1] and policy.trans.blocks_ok
    viz.activate()
    active = viz(o, g, inference=True)[0]
    assert calls == [1] and not policy.trans.blocks_ok
    assert len(viz.cache) == 2
    torch.testing.assert_close(active, inactive, rtol=0, atol=1e-5)


def test_critic_trunk_captures():
    """GoTQNetwork built with capture keeps its trunk's maps."""
    q = GoTQNetwork(block=2, head=2, l_f_size=32, dim_head=16, mlp_dim=64,
                    image_size=HW, capture=True)
    viz = AttentionVisualizer(q)
    viz.activate()
    q1, _ = viz(torch.from_numpy(frames(3)), torch.zeros(3, 2),
                torch.zeros(3, 2))
    assert q1.shape == (3, 2) and len(viz.cache) == 2
    assert all(k.startswith("trans/transformer/block_") for k in viz.cache)


NO_PROJ = dict(dim=32, depth=2, heads=1, dim_head=32, mlp_dim=64,
               image_size=HW)


@pytest.mark.parametrize("route", ["acting", "learn_forward", "gradient"])
def test_block_without_output_projection_matches_jax(route):
    """heads == 1 and dim_head == dim: no to_out in JAX's tree and no
    wout / bout in the port's; the route rule refuses every fused route,
    so the composed blocks run; outputs within 1e-5 of JAX's."""
    jm = JaxGoT(**NO_PROJ, emb_dropout=0.0)
    img = frames(seed=7)
    goal = np.random.default_rng(8).normal(0, 1, (2, 32)).astype(np.float32)
    params = as_np(jm.init(jax.random.PRNGKey(9), img, goal))
    assert "to_out" not in params["params"]["transformer"]["block_0"]["attn"]
    ref = np.asarray(jm.apply(params, img, goal))
    port = GoT(**NO_PROJ, emb_dropout=0.0)
    blk = port.transformer.blocks[0]
    assert not blk.project_out and not hasattr(blk, "wout")
    sd = params_from_jax(params["params"])
    port.load_state_dict(sd)
    back = params_to_jax(port.state_dict())
    assert set(back) == {k for k in _flat(params["params"])}
    kw = {"acting": dict(inference=True),
          "learn_forward": dict(inference=True, deterministic=False),
          "gradient": dict()}[route]
    x, g = torch.from_numpy(img), torch.from_numpy(goal)
    out = port(x, g, **kw)
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    if route == "gradient":
        out.sum().backward()
        assert port.transformer.blocks[0].wqkv.grad is not None


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_route_rule_refuses_the_block_without_projection(monkeypatch):
    """On the card (the H100's limit) every fused route fits the flagship
    block and none fits the block without an output projection."""
    monkeypatch.setattr(smem, "limit_for", lambda device: 232448)
    dev = torch.device("cpu")
    for kernels in (("K1",), ("K4",), ("K4", "K6"), ("K2f", "K2b"),
                    ("K3f", "K3b"), ("K7",)):
        assert smem.route_fits(kernels, 65, 64, 4, 64, 2048,
                               torch.bfloat16, dev)
        assert not smem.route_fits(kernels, 65, 64, 1, 64, 2048,
                                   torch.bfloat16, dev)


def test_attention_maps_example(tmp_path):
    """The example end to end on a synthetic flagship actor: the maps of
    each block over a live episode and the PNG grid (> 10 kB)."""
    from dgvit_tpu.config import Config as JaxConfig
    from dgvit_tpu.core import checkpoint as jckpt
    from dgvit_tpu.models import build_actor
    from dgvit_tpu_torch.examples import attention_maps

    params = build_actor(JaxConfig()).init(
        jax.random.PRNGKey(0), np.zeros((1, 128, 160)),
        np.zeros((1, 2)))["params"]
    jckpt.save_params_npz(str(tmp_path), "viz", params)
    dest = attention_maps.main(["--actor", str(tmp_path / "viz_actor.npz"),
                                "--steps", "3", "--every", "1",
                                "--out", str(tmp_path / "attn"),
                                "--device", "cpu"])
    assert dest == tmp_path / "attn" / "goal_attention.png"
    assert dest.stat().st_size > 10_000


def test_render_names_matplotlib_when_missing(monkeypatch, tmp_path):
    from dgvit_tpu_torch.examples import attention_maps

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rec = {"frame": np.zeros((32, 40)), "action": np.zeros(2),
           "maps": {"trans/transformer/block_0/attn/attn/0":
                    np.full((1, 5, 5), 0.2)}}
    with pytest.raises(ImportError, match="matplotlib"):
        attention_maps.render([rec], tmp_path / "x.png", 1, (16, 20))


@pytest.mark.parametrize("family", ["got_channels", "vit"])
def test_capture_policy_builds_the_configs_actor(family):
    """The example's capture_policy builds the config's actor through
    build_actor (a frame-stack GoT, the ViT backbone): it takes that
    actor's parameters whole, and its mean equals the same actor's
    ordinary forward (capture off) within 1e-5; an actor without maps
    refuses capture."""
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.examples.attention_maps import capture_policy
    from dgvit_tpu_torch.models.policies import build_actor

    cfg = Config.from_dict({"model": {"block": 2, "head": 2,
                                      "latent_size": 32, "dim_head": 16,
                                      "mlp_dim": 64, "vit_dim": 32,
                                      "vit_heads": 2}})
    if family == "got_channels":
        cfg.model.image_size = list(HW)
        cfg.model.patch_mode, cfg.env.frame_stack = "channels", 3
        obs = np.random.default_rng(7).uniform(0, 1, (2, 3, *HW))
    else:
        cfg.model.backbone = "simple_vit"
        obs = frames(seed=7, hw=(128, 160))
    ref = build_actor(cfg, generator=torch.Generator().manual_seed(8))
    flat = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    viz = capture_policy(cfg, params_to_jax(flat), "cpu")
    assert type(viz.model) is type(ref) and viz.is_activate
    obs = torch.from_numpy(obs.astype(np.float32))
    goal = torch.from_numpy(np.random.default_rng(9).uniform(
        -1, 1, (2, 2)).astype(np.float32))
    mean, _ = viz(obs, goal)
    with torch.no_grad():
        want, _ = ref.eval()(obs, goal)
    np.testing.assert_allclose(mean.numpy(), want.numpy(), **TOL)
    assert viz.cache and all(np.isfinite(v).all()
                             for v in viz.cache.values())
    cfg.model.actor_type = "GaussianConvNet"
    with pytest.raises(ValueError, match="capture"):
        build_actor(cfg, capture=True)
