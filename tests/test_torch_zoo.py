"""The port's model zoo (dgvit_tpu_torch/models/{cnn,simple_vit,policies}.py)
against the JAX package's modules, on the CPU, at a small size.

Every network gets the JAX module's own initial parameters through
`params_from_jax` and the same inputs, drawn from a numpy seed. The JAX
side runs its composed path (attention `xla`, or `pallas_interpret` where
the port's `pallas` route is held: K8's plain version here, its backward
recomputed through the plain attention on both sides).

Tolerance: fp32, another summation order on each side: rtol 1e-5, atol
1e-5 (as tests/test_torch_policy.py), on outputs and gradients alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.models import cnn as jcnn
from dgvit_tpu.models import distributions as jdist
from dgvit_tpu.models import policies as jpol
from dgvit_tpu.models import simple_vit as jvit
from dgvit_tpu_torch.config import ACTOR_TYPES, CRITIC_TYPES, Config
from dgvit_tpu_torch.models import distributions, policies
from dgvit_tpu_torch.models.cnn import ConvTrunk
from dgvit_tpu_torch.models.jax_io import (_flatten, params_from_jax,
                                           params_to_jax)
from dgvit_tpu_torch.models.simple_vit import SimpleViT, posemb_sincos_2d

TOL = dict(rtol=1e-5, atol=1e-5)
HW = (32, 40)           # 4 patches of 16 x 20
CNN_HW = (29, 37)       # 13 x 17, 5 x 7, 1 x 2 after the three convs
B = 3
VIT = dict(dim=32, depth=1, heads=2, mlp_dim=64)
GOT = dict(block=2, head=2, l_f_size=32, dim_head=16, mlp_dim=64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are small, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw(seed, *shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def init(module, *args, method=None):
    """A JAX module's initial parameters (numpy leaves)."""
    p = module.init(jax.random.PRNGKey(0), *args, method=method)["params"]
    return jax.tree_util.tree_map(np.asarray, p)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("frames", ["single", "stack"])
def test_conv_trunk_matches_jax(frames):
    shape = (B, *CNN_HW) if frames == "single" else (B, *CNN_HW, 4)
    x = draw(1, *shape)
    jm = jcnn.ConvTrunk()
    params = init(jm, x)
    sd = {k[len("trunk."):]: v for k, v in
          params_from_jax({"trunk": params}).items()}
    port = ConvTrunk(1 if frames == "single" else 4)
    port.load_state_dict(sd)
    out = port(t(x))
    assert out.shape == (B, 256)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jm.apply({"params": params}, x)),
                               **TOL)


def test_posemb_sincos_2d_matches_jax():
    for h, w, dim in ((2, 2, 32), (8, 8, 256), (16, 16, 256)):
        np.testing.assert_array_equal(
            posemb_sincos_2d(h, w, dim).numpy(),
            np.asarray(jvit.posemb_sincos_2d(h, w, dim)))
    with pytest.raises(ValueError, match="multiple of 4"):
        posemb_sincos_2d(2, 2, 30)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_simple_vit_matches_jax(impl):
    """forward and predict; with impl 'pallas' (K8's route) also the
    gradient of every parameter and of the frames."""
    x = draw(2, B, *HW)
    jm = jvit.SimpleViT(dim_head=16, attn_impl="xla", **VIT)
    params = init(jm, x, method=jm.full)
    port = SimpleViT(dim_head=16, attn_impl=impl, **VIT)
    port.load_state_dict(params_from_jax(params))
    assert set(params_to_jax(port.state_dict())) == set(_flatten(params))
    xt = t(x).requires_grad_()
    latent, logits = port(xt), port.predict(xt)
    np.testing.assert_allclose(
        latent.detach().numpy(),
        np.asarray(jm.apply({"params": params}, x)), **TOL)
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jm.apply({"params": params}, x, method=jm.predict)),
        **TOL)
    if impl == "xla":
        return
    jk = jvit.SimpleViT(dim_head=16, attn_impl="pallas_interpret", **VIT)
    w = draw(3, B, VIT["dim"])

    def loss(p, img):
        return jnp.sum(jk.apply({"params": p}, img) * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    (port(xt) * t(w)).sum().backward()
    ref = params_from_jax(gp)
    for name, p in port.named_parameters():
        if name.startswith("head"):
            continue        # predict's head: no gradient in this loss
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)


def frames_for(name):
    return (B, *CNN_HW, 4) if name == "DeterministicPolicy" else (
        (B, *CNN_HW) if name in ("GaussianPolicy", "QNetwork",
                                 "ValueNetwork") else (B, *HW))


ZOO = {   # class name -> (JAX constructor, port constructor) at a small size
    "GaussianPolicy": ({}, {}),
    "QNetwork": ({}, {}),
    "DeterministicPolicy": ({}, {}),
    "ValueNetwork": ({}, {}),
    "DeterministicGoTPolicy": (dict(GOT, emb_dropout=0.0),
                               dict(GOT, emb_dropout=0.0)),
    "ViTGaussianPolicy": (VIT, VIT),
    "ViTQNetwork": (VIT, VIT),
    "ViTDeterministicPolicy": (VIT, VIT),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_network_matches_jax(name):
    """Each network of the zoo against the JAX module: outputs in both
    of the port's routes (inference and the gradient-bearing one), and
    the JAX tree's round trip through the port's state_dict."""
    jkw, pkw = ZOO[name]
    jm = getattr(jpol, name)(**jkw)
    obs, pobs = draw(4, *frames_for(name)), draw(5, B, 2)
    act = draw(6, B, 2)
    args = (obs, pobs, act) if "Network" in name and name != \
        "ValueNetwork" else (obs, pobs)
    params = init(jm, *args)
    port = getattr(policies, name)(**pkw)
    port.load_state_dict(params_from_jax(params))
    back = params_to_jax(port.state_dict())
    flat = _flatten(params)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    ref = jm.apply({"params": params}, *args)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for inference in (True, False):
        out = port(*map(t, args), inference=inference)
        out = out if isinstance(out, tuple) else (out,)
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                       err_msg=f"{name} {inference}", **TOL)
    if name.startswith(("Deterministic", "ViTDeterministic")):
        assert np.abs(np.asarray(ref[0])).max() <= 1.0   # squashed once


def test_deterministic_sample_matches_jax():
    mean = draw(7, 5, 2)
    noise = np.random.default_rng(8).normal(0, 3, (5, 2)).astype(np.float32)
    s = distributions.deterministic_sample(t(mean), noise=t(noise))
    r = jdist.deterministic_sample(None, jnp.asarray(mean),
                                   noise=jnp.asarray(noise))
    for a, b in zip(s, r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert s.log_prob.shape == (5, 1) and not s.log_prob.any()
    assert (s.action - s.mean).abs().max() <= 0.25       # the clip
    g = torch.Generator().manual_seed(0)
    drawn = distributions.deterministic_sample(t(mean), g)
    assert (drawn.action - t(mean)).abs().max() <= 0.25


def got_tiny(**model):
    return {"model": dict(block=1, head=2, latent_size=32, dim_head=16,
                          mlp_dim=64, image_size=list(HW), vit_dim=32,
                          vit_depth=1, vit_heads=2, **model)}


@pytest.mark.parametrize("backbone", ["got", "simple_vit"])
@pytest.mark.parametrize("actor_type", ACTOR_TYPES)
def test_build_actor_maps_as_jax(backbone, actor_type):
    d = got_tiny(backbone=backbone, actor_type=actor_type)
    cfg, jcfg = Config.from_dict(d), JaxConfig.from_dict(d)
    port, ref = policies.build_actor(cfg), jpol.build_actor(jcfg)
    assert type(port).__name__ == type(ref).__name__


@pytest.mark.parametrize("backbone", ["got", "simple_vit"])
@pytest.mark.parametrize("critic_type", CRITIC_TYPES)
def test_build_critic_maps_as_jax(backbone, critic_type):
    d = got_tiny(backbone=backbone, critic_type=critic_type)
    cfg, jcfg = Config.from_dict(d), JaxConfig.from_dict(d)
    port, ref = policies.build_critic(cfg), jpol.build_critic(jcfg)
    assert type(port).__name__ == type(ref).__name__


def test_deterministic_got_ignores_the_configs_frame_geometry():
    """JAX's factory hands DeterministicGoTPolicy no image size, patch size
    or emb-dropout; the port's does the same."""
    cfg = Config.from_dict(got_tiny(actor_type="DeterministicTransformer",
                                    emb_dropout=0.0))
    trunk = policies.build_actor(cfg).trans
    assert trunk.image_size == (128, 160) and trunk.emb_dropout == 0.1
    assert trunk.num_patches == 64


def test_unported_options_raise_by_name():
    with pytest.raises(NotImplementedError, match="seq_shard"):
        Config.from_dict({"model": {"seq_shard": True}})
    for kw, word in (({"capture": True}, "capture"),
                     ({"seq_shard": True}, "seq_shard")):
        with pytest.raises(NotImplementedError, match=word):
            SimpleViT(**VIT, **kw)
        with pytest.raises(NotImplementedError, match=word):
            policies.ViTGaussianPolicy(**VIT, **kw)
    for field, bad in (("actor_type", "Recurrent"), ("critic_type", "MLP"),
                       ("backbone", "resnet")):
        with pytest.raises(ValueError, match=field):
            Config.from_dict({"model": {field: bad}})


@pytest.mark.parametrize("actor_type,backbone", [
    ("DeterministicTransformer", "simple_vit"), ("GaussianConvNet", "got")])
def test_action_map_matches_jax(actor_type, backbone):
    """make_action_fn on a deterministic actor returns its output as it is
    (squashed once), on a Gaussian one tanh(mean): as JAX's export map."""
    from dgvit_tpu.serve import make_action_fn as jax_make_action_fn
    from dgvit_tpu_torch.serve import make_action_fn

    d = got_tiny(actor_type=actor_type, backbone=backbone)
    jcfg = JaxConfig.from_dict(d)
    obs, goal = draw(9, B, *HW), draw(10, B, 2)
    params = init(jpol.build_actor(jcfg), obs, goal)
    ref = jax_make_action_fn(jcfg, params, env_units=True)(obs, goal)
    out = make_action_fn(Config.from_dict(d), params, env_units=True,
                         dtype=torch.float32, device="cpu")(obs, goal)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
