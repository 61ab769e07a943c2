"""`sac.critic_latent_reuse` in the port (dgvit_tpu_torch/agents/sac.py)
against the JAX package's, on the CPU.

With reuse on, the actor step evaluates only the critic's twin heads, on
the trunk latent of the critic update's own forward and with the heads'
parameters from before the critic's Adam step (JAX sac.py:399-431,
:635-663, :750-760). Each of the four flavours (learn, learn_per,
learn_guidence, learn_guidence_per) runs one update from the same JAX
initial state on both sides, fp32, emb-dropout 0, lr_critic 0.05 (so the
pre- and post-update heads differ), with JAX's own action noise injected
into the port. Tolerances as tests/test_torch_sac.py: metrics and |TD
errors| rtol 1e-4 / atol 1e-5; parameters its two-level check. The same
update with the post-update heads must miss JAX's policy loss by more
than that tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.models import got as got_mod
from dgvit_tpu_torch.models import layers
from dgvit_tpu_torch.models.jax_io import params_from_jax, sac_state_from_jax
from dgvit_tpu_torch.models.policies import GoTQNetwork
from test_torch_sac import (as_numpy, guided_noise, make_batch, step_noise,
                            two_level_close)

TINY = dict(latent_size=32, dim_head=16, mlp_dim=64, block=2, head=2,
            image_size=[32, 40], emb_dropout=0.0)
B = 4
TOL = dict(rtol=1e-4, atol=1e-5)
FLAVOURS = ("learn", "learn_per", "learn_guidence", "learn_guidence_per")
N_EXPERT = 3


def cfg_dict(reuse=True, lr_critic=0.05, **model):
    return {"model": dict(TINY, **model),
            "sac": {"critic_latent_reuse": reuse, "lr_critic": lr_critic}}


def batches(seed):
    agent_b, expert_b = make_batch(seed, B), make_batch(seed + 100, B)
    agent_b["engage"] = np.array([[0.0], [1.0], [0.0], [0.0]], np.float32)
    return agent_b, expert_b


WEIGHTS = np.linspace(0.4, 1.6, B).astype(np.float32)


def run_jax(jagent, state, flavour, batch, expert):
    if flavour == "learn":
        return (*jagent.learn(state, batch), None)
    if flavour == "learn_per":
        return jagent.learn_per(state, batch, jnp.asarray(WEIGHTS))
    if flavour == "learn_guidence":
        return (*jagent.learn_guidence(state, batch, expert, N_EXPERT),
                None)
    return jagent.learn_guidence_per(state, batch, expert, N_EXPERT,
                                     jnp.asarray(WEIGHTS))


def run_port(agent, state, flavour, batch, expert, noise):
    if flavour == "learn":
        return (*agent.learn(state, batch, noise=noise), None)
    if flavour == "learn_per":
        return agent.learn_per(state, batch, WEIGHTS, noise=noise)
    if flavour == "learn_guidence":
        return (*agent.learn_guidence(state, batch, expert, N_EXPERT,
                                      noise=noise), None)
    return agent.learn_guidence_per(state, batch, expert, N_EXPERT, WEIGHTS,
                                    noise=noise)


@pytest.fixture(scope="module")
def jax_runs():
    """For each flavour: JAX's initial state, its reuse update and the
    noise it drew."""
    jagent = JaxSACAgent(JaxConfig.from_dict(cfg_dict()), row_noise=True)
    init = jagent.init_state(3)
    out = {}
    for flavour in FLAVOURS:
        batch, expert = batches(7)
        st = jax.tree_util.tree_map(jnp.asarray, as_numpy(init))
        noise = (guided_noise(jagent, st, 2 * B) if "guidence" in flavour
                 else step_noise(jagent, st, B))
        s2, metrics, td = run_jax(jagent, st, flavour, batch, expert)
        out[flavour] = dict(init=as_numpy(init), jax=as_numpy(s2),
                            metrics={k: float(v) for k, v in metrics.items()},
                            td=None if td is None else np.asarray(td),
                            noise=noise, batch=batch, expert=expert)
    return out


def port_update(run, flavour, post_update_heads=False, monkeypatch=None):
    agent = SACAgent(Config.from_dict(cfg_dict()), device="cpu")
    state = sac_state_from_jax(agent, run["init"])
    if post_update_heads:       # the heads read after the step: wrong
        monkeypatch.setattr(GoTQNetwork, "head_params", lambda self: {
            f"{n}.{k}": p.detach() for n in ("fc1", "fc2", "fc3", "fc11",
                                            "fc21", "fc31")
            for k, p in getattr(self, n).named_parameters()})
    return run_port(agent, state, flavour, run["batch"], run["expert"],
                    run["noise"])


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_reuse_update_matches_jax(jax_runs, flavour):
    run = jax_runs[flavour]
    state, metrics, td = port_update(run, flavour)
    for k, v in run["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    for kind, key in (("actor", "actor_params"), ("critic", "critic_params"),
                      ("critic_target", "critic_target_params")):
        two_level_close(dict(getattr(state, kind).named_parameters()),
                        params_from_jax(getattr(run["jax"], key)))
    if td is not None:
        np.testing.assert_allclose(td.numpy(), run["td"], **TOL)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_post_update_heads_miss_jax(jax_runs, flavour, monkeypatch):
    """The heads read after critic_opt.step() (Adam's in-place update) give
    another policy loss: the check above tells the two apart."""
    run = jax_runs[flavour]
    _, metrics, _ = port_update(run, flavour, post_update_heads=True,
                                monkeypatch=monkeypatch)
    ref = run["metrics"]["policy_loss"]
    assert abs(float(metrics["policy_loss"]) - ref) > \
        TOL["atol"] + TOL["rtol"] * abs(ref)


def port_flavour(flavour, reuse, seed=5, **cfg):
    agent = SACAgent(Config.from_dict(cfg_dict(reuse, **cfg)), device="cpu",
                     seed=seed)
    state = agent.init_state()
    batch, expert = batches(11)
    state, metrics, _ = run_port(agent, state, flavour, batch, expert, None)
    return state, metrics


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_frozen_critic_makes_reuse_equal_to_no_reuse(flavour):
    """lr_critic 0 and emb-dropout 0: the pre- and post-update critics are
    one, so reuse takes the same step (JAX tests/test_sac.py:358 and its
    PER and guided twin): actor parameters within 1e-6, metrics rtol
    1e-5 / atol 1e-6."""
    (sa, ma), (sb, mb) = (port_flavour(flavour, r, lr_critic=0.0)
                          for r in (False, True))
    for (name, a), b in zip(sa.actor.named_parameters(),
                            sb.actor.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for k in ma:
        np.testing.assert_allclose(float(mb[k]), float(ma[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("emb_dropout,moves", [(0.0, False), (0.1, True)])
def test_reuse_moves_no_draw_without_dropout(emb_dropout, moves):
    """The skipped critic trunk takes its dropout draws with it: with
    emb-dropout 0 the update's generator ends where reuse-off's does, with
    0.1 it does not."""
    ends = [port_flavour("learn", r, emb_dropout=emb_dropout)[0]
            .generator.get_state() for r in (False, True)]
    assert (not torch.equal(*ends)) == moves


def test_reuse_skips_one_trunk_forward(monkeypatch):
    """One K4 call fewer an update (the actor step's critic trunk), the
    per-block gradient route (K2, K3) as often as without reuse."""
    calls = {}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(got_mod, "blocks_cls_forward_fused", counting(
        "K4", got_mod.blocks_cls_forward_fused))
    monkeypatch.setattr(layers, "fused_transformer_block", counting(
        "K2", layers.fused_transformer_block))
    monkeypatch.setattr(layers, "cls_final_block", counting(
        "K3", layers.cls_final_block))
    counts = {}
    for flavour in ("learn", "learn_guidence"):
        for reuse in (False, True):
            calls.clear()
            port_flavour(flavour, reuse)
            counts[(flavour, reuse)] = dict(calls)
    for flavour in ("learn", "learn_guidence"):
        off, on = counts[(flavour, False)], counts[(flavour, True)]
        assert off["K4"] == 3 and on["K4"] == 2, (flavour, off, on)
        assert on["K2"] == off["K2"] > 0 and on["K3"] == off["K3"] > 0


def test_reuse_trains():
    """JAX tests/test_sac.py's reuse run: finite metrics, the actor and the
    critic both move."""
    agent = SACAgent(Config.from_dict(cfg_dict()), device="cpu", seed=7)
    state = agent.init_state()
    before = [[p.detach().clone() for p in m.parameters()]
              for m in (state.actor, state.critic)]
    state, metrics = agent.learn(state, make_batch(1, B))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for old, m in zip(before, (state.actor, state.critic)):
        assert any(not torch.equal(a, b) for a, b in zip(old, m.parameters()))


@pytest.mark.parametrize("model,sac,word", [
    ({"critic_type": "CNN"}, {}, "critic_latent_reuse"),
    ({"backbone": "simple_vit"}, {}, "GoT critic"),
    ({}, {"aug_shift": 2, "aug_actor": False}, "aug_actor")])
def test_reuse_refusals_match_jax(model, sac, word):
    """A non-GoT critic, and DrQ with raw frames in the actor step, are
    refused by a ValueError in both packages (JAX tests/test_sac.py and
    tests/test_augment.py:188), with JAX's words."""
    over = {"model": model, "sac": dict(sac, critic_latent_reuse=True)}
    with pytest.raises(ValueError, match=word) as jax_err:
        JaxSACAgent(JaxConfig.from_dict(over))
    with pytest.raises(ValueError, match=word) as port_err:
        SACAgent(Config.from_dict(over), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
