"""The port's SAC update (dgvit_tpu_torch/agents/sac.py) against the JAX
package's `SACAgent.learn`, on the CPU.

One update, fp32, emb-dropout 0, from a JAX `SACTrainState` carried into
the port after one JAX update (so the Adam moments and the counter are
not at their initial values). The action noise is JAX's own row noise
(`_row_noise_draw` on the step's keys), injected into the port. The JAX
side runs its composed (non-Pallas) path, as on any CPU.

Tolerances (fp32, another summation order on each side):
  * metrics, log_alpha, gradients: rtol 1e-4, atol 1e-5;
  * parameters after the Adam step and the Polyak-averaged target: the
    two-level check of tests/test_shardmap.py. Nearly every element within
    atol 5e-6 / rtol 1e-4, every element within 2.2 lr: an Adam step is
    about lr * sign(g) where the moments are young, so a gradient element
    near zero may flip its step.

The PER flavours (`learn_per`, `learn_guidence_per`) are held the same
way from the same carried state with importance weights, their per-row
|TD errors| within the metrics' tolerance.

The port's fp32 update at the flagship width is also held to a golden
file of the JAX update (tests/data/torch_sac_golden.npz), which
chip_smoke.py holds the CUDA kernels' update to, and the guided update
to tests/data/torch_sac_guided_golden.npz. Regenerate them with
`python tests/test_torch_sac.py [torch_sac_golden|torch_sac_guided_golden]`
(both without an argument).
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.models.jax_io import params_from_jax, sac_state_from_jax

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(latent_size=64, dim_head=16, mlp_dim=128, block=3, head=2,
             image_size=[32, 40], emb_dropout=0.0)
B = 6
TOL = dict(rtol=1e-4, atol=1e-5)


def make_batch(seed, b=B, hw=(32, 40)):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    return {"obs": f(b, *hw), "pobs": f(b, 2),
            "act": rng.uniform(-1, 1, (b, 2)).astype(np.float32),
            "rew": rng.normal(0, 1, (b, 1)).astype(np.float32),
            "next_obs": f(b, *hw), "next_pobs": f(b, 2),
            "done": np.zeros((b, 1), np.float32)}


def step_noise(agent, state, b):
    """The row noise JAX's learn draws at this state: the TD target's
    next-action noise and the actor step's policy noise."""
    key = jax.random.fold_in(state.rng, state.itera)
    k_tgt, _, k_act = jax.random.split(key, 3)
    a = agent.cfg.sac.action_dim
    return (np.array(agent._row_noise_draw(jax.random.split(k_tgt, 3)[0],
                                             b, a)),
            np.array(agent._row_noise_draw(jax.random.split(k_act, 3)[0],
                                             b, a)))


def jax_grads(agent, state, batch):
    """The critic and actor gradients of JAX's learn at this state."""
    cgrads, agrads = jax.jit(lambda st, bt: _grads(agent, st, bt))(
        state, batch)
    return (params_from_jax(jax.tree_util.tree_map(np.asarray, cgrads)),
            params_from_jax(jax.tree_util.tree_map(np.asarray, agrads)))


def _grads(agent, state, batch):
    key = jax.random.fold_in(state.rng, state.itera)
    k_tgt, k_crit, k_act = jax.random.split(key, 3)
    alpha = agent._alpha_of(state)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    target = agent._td_target(state, alpha, jb, k_tgt)

    def critic_loss(cp):
        q1, q2 = agent._apply_critic(cp, jb["obs"], jb["pobs"], jb["act"],
                                     dropout_key=k_crit)
        return (jnp.mean(jnp.square(q1 - target))
                + jnp.mean(jnp.square(q2 - target)))

    cgrads = jax.grad(critic_loss)(state.critic_params)
    updated, _, _ = agent._critic_update(state, jb, target, k_crit)
    k1, k2, k3 = jax.random.split(k_act, 3)

    def actor_loss(ap):
        s = agent._sample_actor(ap, jb["obs"], jb["pobs"], k1,
                                dropout_key=k2)
        q1, q2 = agent._apply_critic(updated.critic_params, jb["obs"],
                                     jb["pobs"], s.action, dropout_key=k3,
                                     inference=True)
        return jnp.mean(alpha * s.log_prob - jnp.minimum(q1, q2))

    return cgrads, jax.grad(actor_loss)(state.actor_params)


def as_numpy(state):
    return jax.tree_util.tree_map(np.asarray, state)


def two_level_close(port, ref, lr=1e-3):
    for name, t in port.items():
        x, y = t.detach().float().numpy(), np.asarray(ref[name])
        close = np.isclose(x, y, atol=5e-6, rtol=1e-4)
        assert close.mean() >= 0.995, \
            f"{name}: {(1 - close.mean()) * 100:.2f}% elements off"
        assert np.abs(x - y).max() <= 2.2 * lr, name


@pytest.fixture(scope="module")
def update():
    """One JAX update from a carried state, and the same update in the
    port."""
    jcfg = JaxConfig.from_dict({"model": SMALL})
    jagent = JaxSACAgent(jcfg, row_noise=True)
    s1, _ = jagent.learn(jagent.init_state(3), make_batch(1))
    batch = make_batch(2)
    noise = step_noise(jagent, s1, B)
    grads = jax_grads(jagent, s1, batch)
    carried = as_numpy(s1)
    s2, metrics = jagent.learn(s1, batch)
    agent = SACAgent(Config.from_dict({"model": SMALL}), device="cpu")
    state = sac_state_from_jax(agent, carried)
    state, port_metrics = agent.learn(state, batch, noise=noise)
    return dict(jax=as_numpy(s2), jax_metrics=metrics, jax_grads=grads,
                port=state, port_metrics=port_metrics, carried=carried)


def test_state_carry(update):
    """The carried state holds the JAX parameters, moments and counter."""
    agent = SACAgent(Config.from_dict({"model": SMALL}), device="cpu")
    state = sac_state_from_jax(agent, update["carried"])
    c = update["carried"]
    assert state.itera == int(c.itera) == 1
    assert state.log_alpha.item() == pytest.approx(float(c.log_alpha))
    ref = params_from_jax(c.critic_params)
    for name, p in state.critic.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), ref[name])
    mu = params_from_jax(c.actor_opt[0].mu)
    for name, p in state.actor.named_parameters():
        st = state.actor_opt.state[p]
        assert float(st["step"]) == int(c.actor_opt[0].count)
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name])


def test_metrics_match_jax(update):
    pm, jm = update["port_metrics"], update["jax_metrics"]
    for k in ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss", "alpha",
              "entropy"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("which", ["critic", "actor"])
def test_grads_match_jax(update, which):
    module = getattr(update["port"], which)
    ref = update["jax_grads"][0 if which == "critic" else 1]
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("which", ["actor", "critic", "critic_target"])
def test_params_after_update_match_jax(update, which):
    key = {"actor": "actor_params", "critic": "critic_params",
           "critic_target": "critic_target_params"}[which]
    port = dict(getattr(update["port"], which).named_parameters())
    two_level_close(port, params_from_jax(getattr(update["jax"], key)))


def test_log_alpha_and_counter_match_jax(update):
    np.testing.assert_allclose(update["port"].log_alpha.item(),
                               float(update["jax"].log_alpha), **TOL)
    assert update["port"].itera == int(update["jax"].itera) == 2


def small_agent(**sac):
    return SACAgent(Config.from_dict({"model": SMALL, "sac": sac}),
                    device="cpu", seed=5)


def snapshot(module):
    return [p.detach().clone() for p in module.parameters()]


def changed(before, module):
    return any(not torch.equal(a, b)
               for a, b in zip(before, module.parameters()))


def test_policy_freq_cadence():
    """The target moves when itera % policy_freq == 0, before the
    increment: at updates 0 and 2 of policy_freq 2, not at 1."""
    agent = small_agent(policy_freq=2)
    state = agent.init_state()
    moved = []
    for i in range(3):
        before = snapshot(state.critic_target)
        state, _ = agent.learn(state, make_batch(10 + i))
        moved.append(changed(before, state.critic_target))
    assert moved == [True, False, True] and state.itera == 3


def test_nan_guard_rolls_back_and_advances():
    agent = small_agent(nan_guard=True)
    state = agent.init_state()
    state, m = agent.learn(state, make_batch(20))
    assert float(m["skipped_nonfinite"]) == 0.0
    mods = (state.actor, state.critic, state.critic_target)
    before = [snapshot(m_) for m_ in mods]
    log_alpha = state.log_alpha.item()
    moments = copy.deepcopy(state.critic_opt.state_dict())
    bad = make_batch(21)
    bad["rew"][0, 0] = np.nan
    state, m = agent.learn(state, bad)
    assert float(m["skipped_nonfinite"]) == 1.0
    assert not np.isfinite(float(m["qf1_loss"]))
    assert state.itera == 2
    assert not any(changed(b, m_) for b, m_ in zip(before, mods))
    assert state.log_alpha.item() == log_alpha
    for k, v in moments["state"].items():
        now = state.critic_opt.state_dict()["state"][k]
        assert torch.equal(now["exp_avg"], v["exp_avg"])
        assert float(now["step"]) == float(v["step"])


@pytest.mark.parametrize("bound,start", [("alpha_max", 2.0),
                                         ("alpha_min", 0.5)])
def test_alpha_clamps(bound, start):
    """The auto-tuned temperature starts beyond its bound (1.0); after one
    update log_alpha sits on log(bound), where the same update without the
    bound leaves it near log(start)."""
    free = small_agent(alpha=start)
    state, _ = free.learn(free.init_state(), make_batch(30))
    assert abs(state.log_alpha.item() - np.log(start)) < 1e-3
    agent = small_agent(alpha=start, **{bound: 1.0})
    state, m = agent.learn(agent.init_state(), make_batch(30))
    assert state.log_alpha.item() == 0.0
    assert float(m["alpha"]) == pytest.approx(start)  # this step's alpha


def test_trunk_grad_learn_equals_the_default_route(monkeypatch):
    """With DGVIT_TRUNK_GRAD=1 (read when the networks are built) the
    gradient-bearing trunk passes go forward through K4 and backward
    through the whole-trunk backward K6 instead of K2/K3 each way; the
    update is the same one. fp32, emb-dropout live, both through the plain
    versions here: metrics to 1e-5, gradients rtol 1e-3 / atol 1e-5 (the
    final norm's backward is hand-written on one route and autograd on the
    other), parameters as against JAX (Adam's first step)."""
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_fused

    cfg = {"model": dict(SMALL, emb_dropout=0.1)}
    runs = {}
    for route in ("default", "trunk_grad"):
        if route == "trunk_grad":
            monkeypatch.setenv("DGVIT_TRUNK_GRAD", "1")
        agent = SACAgent(Config.from_dict(cfg), device="cpu", seed=5)
        state = agent.init_state()
        assert state.actor.trans.trunk_grad == (route == "trunk_grad")
        assert state.critic.trans.trunk_grad == (route == "trunk_grad")
        calls = []
        monkeypatch.setattr(gm, "trunk_bwd_fused", lambda *a: (
            calls.append(1), trunk_bwd_fused(*a))[1])
        state, m = agent.learn(state, make_batch(40))
        assert len(calls) == (2 if route == "trunk_grad" else 0)
        runs[route] = (state, m, {
            f"{k}.{n}": p.grad.clone() for k in ("actor", "critic")
            for n, p in getattr(state, k).named_parameters()})
    (s0, m0, g0), (s1, m1, g1) = runs["default"], runs["trunk_grad"]
    for k in m0:
        assert float(m1[k]) == pytest.approx(float(m0[k]), rel=1e-5,
                                             abs=1e-6), k
    for name, g in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    for kind in ("actor", "critic", "critic_target"):
        two_level_close(dict(getattr(s1, kind).named_parameters()),
                        {n: p.detach().numpy() for n, p in
                         getattr(s0, kind).named_parameters()})


# --------------------------------------------------------------------------
# the expert-guided update (learn_guidence)
# --------------------------------------------------------------------------

# (n_expert, engage rows): no valid expert row, some, all of them; with no
# agent row engaged and with some
GUIDED_CASES = [(0, False), (0, True), (4, False), (4, True), (B, False),
                (B, True)]
GUIDED_IDS = [f"n_expert={n}-engage={'some' if e else 'none'}"
              for n, e in GUIDED_CASES]
GUIDED_METRICS = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss",
                  "alpha", "n_expert", "guidence_weight")


def guided_batches(seed, engage, b=B):
    """An agent batch with engage flags and an expert batch whose 'act' is
    the expert's action."""
    agent_b, expert_b = make_batch(seed, b), make_batch(seed + 100, b)
    flags = np.zeros((b, 1), np.float32)
    if engage:
        flags[[1, 4]] = 1.0
    agent_b["engage"] = flags
    expert_b["done"][2] = 1.0
    return agent_b, expert_b


def guided_noise(agent, state, rows):
    """The row noise JAX's guided step draws over the merged rows: the TD
    target's next-action noise and the actor step's policy noise."""
    key = jax.random.fold_in(state.rng, state.itera)
    k_tgt, _, k_act, _, _ = jax.random.split(key, 5)
    a = agent.cfg.sac.action_dim
    return (np.array(agent._row_noise_draw(jax.random.split(k_tgt, 3)[0],
                                             rows, a)),
            np.array(agent._row_noise_draw(jax.random.split(k_act, 3)[0],
                                             rows, a)))


def jax_guided_grads(agent, state, batch, expert, n_expert):
    """The critic and actor gradients of JAX's guided step at this state
    (its `_guided_core` written out, as `_grads` writes out learn)."""
    def grads(state, batch, expert, n_expert):
        key = jax.random.fold_in(state.rng, state.itera)
        k_tgt, k_crit, k_act, k_g, k_e = jax.random.split(key, 5)
        alpha = agent._alpha_of(state)
        be = expert["obs"].shape[0]
        valid = (jnp.arange(be) < n_expert).astype(jnp.float32)
        keys = ("obs", "pobs", "act", "rew", "next_obs", "next_pobs", "done")
        merged = {k: jnp.concatenate([batch[k], expert[k]]) for k in keys}
        w = jnp.concatenate([jnp.ones(batch["obs"].shape[0]), valid]
                            ).reshape(-1, 1)
        target = agent._td_target(state, alpha, merged, k_tgt)

        def critic_loss(cp):
            q1, q2 = agent._apply_critic(cp, merged["obs"], merged["pobs"],
                                         merged["act"], dropout_key=k_crit)
            denom = jnp.sum(w) * q1.shape[1]
            return (jnp.sum(w * jnp.square(q1 - target)) / denom
                    + jnp.sum(w * jnp.square(q2 - target)) / denom)

        cgrads = jax.grad(critic_loss)(state.critic_params)
        upd, _ = agent.critic_tx.update(cgrads, state.critic_opt,
                                        state.critic_params)
        cp = optax.apply_updates(state.critic_params, upd)
        k1, k2, k3 = jax.random.split(k_act, 3)

        def bc(ap, rows, d, k):
            s = agent._sample_actor(ap, d["obs"], d["pobs"], k)
            sq = jnp.square(s.mean - d["act"])
            return jnp.sum(rows.reshape(-1, 1) * sq) / jnp.maximum(
                jnp.sum(rows) * sq.shape[1], 1.0)

        def actor_loss(ap):
            s = agent._sample_actor(ap, merged["obs"], merged["pobs"], k1,
                                    dropout_key=k2)
            q1, q2 = agent._apply_critic(cp, merged["obs"], merged["pobs"],
                                         s.action, dropout_key=k3,
                                         inference=True)
            per = alpha * s.log_prob - jnp.minimum(q1, q2)
            eng = batch["engage"].reshape(-1)
            return (jnp.sum(w * per) / (jnp.sum(w) * per.shape[1])
                    + (agent.guidence_weight * bc(ap, valid, expert, k_g)
                       * (n_expert > 0)
                       + agent.engage_weight * bc(ap, eng, batch, k_e)
                       * (jnp.sum(eng) > 0)))

        return cgrads, jax.grad(actor_loss)(state.actor_params)

    cg, ag = jax.jit(grads)(state, jax.tree_util.tree_map(jnp.asarray, batch),
                            jax.tree_util.tree_map(jnp.asarray, expert),
                            jnp.int32(n_expert))
    return (params_from_jax(jax.tree_util.tree_map(np.asarray, cg)),
            params_from_jax(jax.tree_util.tree_map(np.asarray, ag)))


@pytest.fixture(scope="module")
def guided():
    """For each case, one JAX guided update from a carried state and the
    same update in the port."""
    jcfg = JaxConfig.from_dict({"model": SMALL})
    jagent = JaxSACAgent(jcfg, row_noise=True)
    s1, _ = jagent.learn(jagent.init_state(3), make_batch(1))
    carried = as_numpy(s1)
    agent = SACAgent(Config.from_dict({"model": SMALL}), device="cpu")
    out = {}
    for n_expert, engage in GUIDED_CASES:
        batch, expert = guided_batches(50 + n_expert, engage)
        st = jax.tree_util.tree_map(jnp.asarray, carried)
        noise = guided_noise(jagent, st, 2 * B)
        grads = jax_guided_grads(jagent, st, batch, expert, n_expert)
        s2, metrics = jagent.learn_guidence(st, batch, expert, n_expert)
        state = sac_state_from_jax(agent, carried)
        state, pm = agent.learn_guidence(state, batch, expert, n_expert,
                                         noise=noise)
        out[(n_expert, engage)] = dict(
            jax=as_numpy(s2), jax_metrics=metrics, jax_grads=grads,
            port=state, port_metrics=pm)
    return out


@pytest.mark.parametrize("case", GUIDED_CASES, ids=GUIDED_IDS)
def test_guided_metrics_match_jax(guided, case):
    pm, jm = guided[case]["port_metrics"], guided[case]["jax_metrics"]
    assert set(pm) == set(GUIDED_METRICS) == set(jm)
    for k in GUIDED_METRICS:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    assert float(pm["n_expert"]) == case[0]


@pytest.mark.parametrize("which", ["critic", "actor"])
@pytest.mark.parametrize("case", GUIDED_CASES, ids=GUIDED_IDS)
def test_guided_grads_match_jax(guided, case, which):
    module = getattr(guided[case]["port"], which)
    ref = guided[case]["jax_grads"][0 if which == "critic" else 1]
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("which", ["actor", "critic", "critic_target"])
@pytest.mark.parametrize("case", GUIDED_CASES, ids=GUIDED_IDS)
def test_guided_params_after_update_match_jax(guided, case, which):
    key = {"actor": "actor_params", "critic": "critic_params",
           "critic_target": "critic_target_params"}[which]
    port = dict(getattr(guided[case]["port"], which).named_parameters())
    two_level_close(port, params_from_jax(getattr(guided[case]["jax"], key)))
    np.testing.assert_allclose(guided[case]["port"].log_alpha.item(),
                               float(guided[case]["jax"].log_alpha), **TOL)
    assert guided[case]["port"].itera == int(guided[case]["jax"].itera) == 2


def test_guided_updates_with_and_without_experts():
    """Mirrors tests/test_sac.py:134: the guided update runs, finite, with
    a full expert batch and with every expert row masked (n_expert 0,
    where the BC term is gated off and reports n_expert 0)."""
    agent = small_agent()
    state = agent.init_state()
    batch, expert = guided_batches(60, engage=True)
    state, m = agent.learn_guidence(state, batch, expert, B)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["n_expert"]) == B and state.itera == 1
    state, m = agent.learn_guidence(state, batch, expert, 0)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["n_expert"]) == 0 and state.itera == 2


@pytest.mark.parametrize("exp,agent_size,batch,want", [
    (100, 1000, 32, 3), (5000, 1000, 32, 32), (100, 0, 32, 32),
    (1000, 1000, 16, 16), (0, 50, 32, 0)])
def test_expert_batch_size(exp, agent_size, batch, want):
    """Mirrors tests/test_sac.py:151 (DRL.py:195): min(floor(exp / agent x
    batch), batch), the batch when the agent buffer is empty; the same as
    the JAX package's."""
    assert SACAgent.expert_batch_size(exp, agent_size, batch) == want
    assert JaxSACAgent.expert_batch_size(exp, agent_size, batch) == want


def test_guidence_weight_decay_over_updates():
    """Mirrors tests/test_round3_fixes.py:164: six guided updates from a
    fresh state report the geometric decay 10 -> 1 over 4 updates, read at
    the counter before each step (0, .25, .5, .75, 1, 1 of the way)."""
    agent = small_agent(guidence_weight=10.0, guidence_weight_final=1.0,
                        guidence_decay_steps=4)
    batch, expert = guided_batches(90, engage=True)
    state, seen = agent.init_state(), []
    for _ in range(6):
        state, m = agent.learn_guidence(state, batch, expert, 4)
        seen.append(float(m["guidence_weight"]))
    np.testing.assert_allclose(
        seen, [10.0 * 0.1 ** min(t / 4.0, 1.0) for t in range(6)], rtol=1e-5)


def test_guided_nan_guard_rolls_back_and_advances():
    """Mirrors tests/test_sac.py:275: nan_guard covers the guided step: a
    non-finite loss rolls the whole update back and the counter moves
    on."""
    agent = small_agent(nan_guard=True)
    state = agent.init_state()
    batch, expert = guided_batches(70, engage=True)
    state, m = agent.learn_guidence(state, batch, expert, 3)
    assert float(m["skipped_nonfinite"]) == 0.0
    mods = (state.actor, state.critic, state.critic_target)
    before = [snapshot(m_) for m_ in mods]
    log_alpha = state.log_alpha.item()
    expert["rew"][0, 0] = np.inf
    state, m = agent.learn_guidence(state, batch, expert, 3)
    assert float(m["skipped_nonfinite"]) == 1.0
    assert state.itera == 2
    assert not any(changed(b, m_) for b, m_ in zip(before, mods))
    assert state.log_alpha.item() == log_alpha


@pytest.mark.parametrize("itera,want", [(0, 2.0), (50, 2.0 * 0.05 ** 0.5),
                                        (100, 0.1), (250, 0.1)])
def test_guidence_weight_curriculum(itera, want):
    """Mirrors tests/test_round3_fixes.py:164: the guidance weight decays
    geometrically from guidence_weight to guidence_weight_final over
    guidence_decay_steps updates, read at the counter before the step,
    and stays constant without a final weight; the guided step reports
    it."""
    agent = small_agent(guidence_weight=2.0, guidence_weight_final=0.1,
                        guidence_decay_steps=100)
    assert float(agent.guidence_weight_at(itera)) == pytest.approx(
        want, rel=1e-6)
    assert float(small_agent(guidence_weight=2.0).guidence_weight_at(
        itera)) == 2.0
    state = agent.init_state()
    state.itera = itera
    batch, expert = guided_batches(80, engage=False)
    _, m = agent.learn_guidence(state, batch, expert, 2)
    assert float(m["guidence_weight"]) == pytest.approx(want, rel=1e-6)


# --------------------------------------------------------------------------
# the PER flavours (learn_per, learn_guidence_per)
# --------------------------------------------------------------------------

PER_METRICS = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss", "alpha")
PER_W = np.linspace(0.3, 1.7, B).astype(np.float32)


@pytest.fixture(scope="module")
def per_updates():
    """One JAX PER update, plain and guided (4 valid expert rows, some
    engage rows), from a carried state with importance weights PER_W, and
    the same updates in the port with JAX's row noise."""
    jagent = JaxSACAgent(JaxConfig.from_dict({"model": SMALL}),
                         row_noise=True)
    s1, _ = jagent.learn(jagent.init_state(3), make_batch(1))
    carried = as_numpy(s1)
    agent = SACAgent(Config.from_dict({"model": SMALL}), device="cpu")
    out = {}
    st = jax.tree_util.tree_map(jnp.asarray, carried)
    batch = make_batch(2)
    noise = step_noise(jagent, st, B)
    s2, jm, jtd = jagent.learn_per(st, batch, PER_W)
    state, pm, td = agent.learn_per(sac_state_from_jax(agent, carried),
                                    batch, PER_W, noise=noise)
    out["plain"] = dict(jax=as_numpy(s2), jm=jm, jtd=np.asarray(jtd),
                        port=state, pm=pm, td=td)
    st = jax.tree_util.tree_map(jnp.asarray, carried)
    batch, expert = guided_batches(90, engage=True)
    noise = guided_noise(jagent, st, 2 * B)
    s2, jm, jtd = jagent.learn_guidence_per(st, batch, expert, 4, PER_W)
    state, pm, td = agent.learn_guidence_per(
        sac_state_from_jax(agent, carried), batch, expert, 4, PER_W,
        noise=noise)
    out["guided"] = dict(jax=as_numpy(s2), jm=jm, jtd=np.asarray(jtd),
                         port=state, pm=pm, td=td)
    return out


@pytest.mark.parametrize("flavour", ["plain", "guided"])
def test_per_metrics_and_td_match_jax(per_updates, flavour):
    r = per_updates[flavour]
    want = PER_METRICS if flavour == "plain" else GUIDED_METRICS
    assert set(r["pm"]) == set(want) == set(r["jm"])
    for k in want:
        np.testing.assert_allclose(float(r["pm"][k]), float(r["jm"][k]),
                                   err_msg=k, **TOL)
    assert r["td"].shape == (B,) and r["td"].dtype == torch.float32
    np.testing.assert_allclose(r["td"].numpy(), r["jtd"], **TOL)


@pytest.mark.parametrize("which", ["actor", "critic", "critic_target"])
@pytest.mark.parametrize("flavour", ["plain", "guided"])
def test_per_params_after_update_match_jax(per_updates, flavour, which):
    r = per_updates[flavour]
    two_level_close(dict(getattr(r["port"], which).named_parameters()),
                    params_from_jax(getattr(r["jax"], f"{which}_params")))
    np.testing.assert_allclose(r["port"].log_alpha.item(),
                               float(r["jax"].log_alpha), **TOL)
    assert r["port"].itera == int(r["jax"].itera) == 2


def test_per_update_returns_td_errors_and_weights_matter():
    """Mirrors tests/test_sac.py:229: unit weights give the plain update's
    critic loss (the same update: the same draws), other weights another;
    the TD errors are per row and non-negative."""
    agent = small_agent()
    batch = make_batch(20)
    s1, m1, td = agent.learn_per(agent.init_state(), batch, np.ones(B))
    assert td.shape == (B,) and bool((td >= 0).all())
    s2, m2 = agent.learn(agent.init_state(), batch)
    assert float(m1["qf1_loss"]) == float(m2["qf1_loss"])
    for a, b in zip(s1.critic.parameters(), s2.critic.parameters()):
        assert torch.equal(a, b)
    _, m3, _ = agent.learn_per(agent.init_state(), batch,
                               np.linspace(0.1, 2.0, B))
    assert float(m3["qf1_loss"]) != pytest.approx(float(m1["qf1_loss"]),
                                                  rel=1e-6)


def bad_batch(seed):
    b = make_batch(seed)
    b["rew"] = np.full((B, 1), np.inf, np.float32)
    return b


def test_nan_guard_covers_guided_and_per_steps():
    """Mirrors tests/test_sac.py:275: the guided and the PER update roll a
    non-finite step back."""
    agent = small_agent(nan_guard=True)
    state = agent.init_state()
    before = snapshot(state.actor)
    expert = {k: v for k, v in make_batch(21).items()}
    bad = dict(bad_batch(22), engage=np.zeros((B, 1), np.float32))
    state, m = agent.learn_guidence(state, bad, expert, 2)
    assert float(m["skipped_nonfinite"]) == 1.0
    assert not changed(before, state.actor)
    state, m, _ = agent.learn_per(state, bad_batch(23), np.ones(B))
    assert float(m["skipped_nonfinite"]) == 1.0
    assert not changed(before, state.actor) and state.itera == 2
    state, m, _ = agent.learn_guidence_per(state, bad, expert, 2,
                                           np.ones(B))
    assert float(m["skipped_nonfinite"]) == 1.0
    assert not changed(before, state.actor) and state.itera == 3


def test_nan_guard_per_td_errors_stay_finite():
    """Mirrors tests/test_sac.py:303: a rolled-back PER step reports
    finite priorities."""
    agent = small_agent(nan_guard=True)
    _, m, td = agent.learn_per(agent.init_state(), bad_batch(30),
                               np.ones(B))
    assert float(m["skipped_nonfinite"]) == 1.0
    assert bool(torch.isfinite(td).all())
    np.testing.assert_array_equal(td.numpy(), np.ones(B, np.float32))


def test_nan_guard_neutral_priority_is_scale_aware():
    """Mirrors tests/test_sac.py:316: with half the batch poisoned, a
    rolled-back step's neutral priority is the mean of the finite |td|
    (rewards at the reference's +-200 scale, so it is far from 1)."""
    half_bad = make_batch(31)
    rew = np.full((B, 1), 200.0, np.float32)
    rew[: B // 2] = np.inf
    half_bad["rew"] = rew
    raw = small_agent()
    _, _, td_raw = raw.learn_per(raw.init_state(), half_bad, np.ones(B))
    td_raw = td_raw.numpy()
    finite = np.isfinite(td_raw)
    assert finite.any() and not finite.all()
    expected = np.abs(td_raw[finite]).mean()
    assert expected > 1.0
    guarded = small_agent(nan_guard=True)
    _, m, td = guarded.learn_per(guarded.init_state(), half_bad, np.ones(B))
    assert float(m["skipped_nonfinite"]) == 1.0
    np.testing.assert_allclose(td.numpy(), np.full(B, expected, np.float32),
                               rtol=1e-5)


# --------------------------------------------------------------------------
# the flagship golden update
# --------------------------------------------------------------------------

GOLDEN = ROOT / "tests" / "data" / "torch_sac_golden.npz"


def test_port_update_matches_golden():
    """The port's fp32 update at the flagship width, on the CPU, from the
    golden state (trained actor, seeded critic) with the golden noise,
    within chip_smoke.py's tolerances (stated there)."""
    import chip_smoke

    g = np.load(GOLDEN)
    run = chip_smoke.golden_update("cpu", g)
    bad, _ = chip_smoke.update_mismatches(run, chip_smoke.golden_ref(g))
    assert not bad, bad


def jax_golden():
    """The JAX update of the golden state: metrics, per-parameter gradient
    norms and update norms (port names), and the injected noise."""
    import chip_smoke

    cfg = JaxConfig.from_dict({"model": {"emb_dropout": 0.0}})
    agent = JaxSACAgent(cfg, row_noise=True)
    actor, critic = chip_smoke.golden_params()
    s0 = agent.init_state(chip_smoke.GOLDEN_SAC_SEED)
    unflat = lambda flat: jax.tree_util.tree_map(
        jnp.asarray, chip_smoke.unflatten(flat))
    ap, cp = unflat(actor), unflat(critic)
    s0 = s0.replace(actor_params=ap, critic_params=cp,
                    critic_target_params=jax.tree_util.tree_map(jnp.copy, cp),
                    actor_opt=agent.actor_tx.init(ap),
                    critic_opt=agent.critic_tx.init(cp))
    batch = chip_smoke.golden_batch()
    noise = step_noise(agent, s0, len(batch["rew"]))
    cgrads, agrads = jax_grads(agent, s0, batch)
    s0 = as_numpy(s0)          # learn donates the state it is given
    s1, metrics = agent.learn(s0, batch)
    out = {k: np.float32(metrics[k]) for k in chip_smoke.METRICS}
    out["noise_next"], out["noise_pi"] = noise
    norms = lambda d: {k: float(np.linalg.norm(v)) for k, v in d.items()}
    grads = {**{f"critic.{k}": v for k, v in norms(cgrads).items()},
             **{f"actor.{k}": v for k, v in norms(agrads).items()}}
    upd = {}
    for kind, key in (("actor", "actor_params"), ("critic", "critic_params"),
                      ("critic_target", "critic_target_params")):
        new = params_from_jax(as_numpy(getattr(s1, key)))
        old = params_from_jax(as_numpy(getattr(s0, key)))
        upd.update({f"{kind}.{k}": float(np.linalg.norm(
            new[k].numpy() - old[k].numpy())) for k in new})
    upd["log_alpha"] = float(abs(s1.log_alpha - s0.log_alpha))
    for kind, d in (("grad", grads), ("update", upd)):
        names = sorted(d)
        out[f"{kind}_names"] = np.array(names)
        out[f"{kind}_norms"] = np.array([d[n] for n in names], np.float64)
    return out


GOLDEN_GUIDED = ROOT / "tests" / "data" / "torch_sac_guided_golden.npz"


def test_port_guided_update_matches_golden():
    """The port's fp32 guided update at the flagship width, on the CPU,
    from the golden state with the golden noise over the merged rows,
    within chip_smoke.py's tolerances (stated there), against the JAX
    guided update's golden file."""
    import chip_smoke

    g = np.load(GOLDEN_GUIDED)
    run = chip_smoke.golden_update("cpu", g, guided=True)
    bad, _ = chip_smoke.update_mismatches(
        run, chip_smoke.golden_ref(g, chip_smoke.GUIDED_METRICS))
    assert not bad, bad


def jax_guided_golden():
    """The JAX guided update of the golden state: metrics, per-parameter
    gradient norms and update norms (port names), and the injected
    noise over the merged rows."""
    import chip_smoke

    cfg = JaxConfig.from_dict({"model": {"emb_dropout": 0.0}})
    agent = JaxSACAgent(cfg, row_noise=True)
    actor, critic = chip_smoke.golden_params()
    s0 = agent.init_state(chip_smoke.GOLDEN_SAC_SEED)
    unflat = lambda flat: jax.tree_util.tree_map(
        jnp.asarray, chip_smoke.unflatten(flat))
    ap, cp = unflat(actor), unflat(critic)
    s0 = s0.replace(actor_params=ap, critic_params=cp,
                    critic_target_params=jax.tree_util.tree_map(jnp.copy, cp),
                    actor_opt=agent.actor_tx.init(ap),
                    critic_opt=agent.critic_tx.init(cp))
    batch, expert = chip_smoke.golden_guided_batches()
    k = chip_smoke.GOLDEN_N_EXPERT
    noise = guided_noise(agent, s0, 2 * len(batch["rew"]))
    cgrads, agrads = jax_guided_grads(agent, s0, batch, expert, k)
    s0 = as_numpy(s0)          # the step donates the state it is given
    s1, metrics = agent.learn_guidence(s0, batch, expert, k)
    out = {k_: np.float32(metrics[k_]) for k_ in chip_smoke.GUIDED_METRICS}
    out["noise_next"], out["noise_pi"] = noise
    norms = lambda d: {k_: float(np.linalg.norm(v)) for k_, v in d.items()}
    grads = {**{f"critic.{n}": v for n, v in norms(cgrads).items()},
             **{f"actor.{n}": v for n, v in norms(agrads).items()}}
    upd = {}
    for kind, key in (("actor", "actor_params"), ("critic", "critic_params"),
                      ("critic_target", "critic_target_params")):
        new = params_from_jax(as_numpy(getattr(s1, key)))
        old = params_from_jax(as_numpy(getattr(s0, key)))
        upd.update({f"{kind}.{n}": float(np.linalg.norm(
            new[n].numpy() - old[n].numpy())) for n in new})
    upd["log_alpha"] = float(abs(s1.log_alpha - s0.log_alpha))
    for kind, d in (("grad", grads), ("update", upd)):
        names = sorted(d)
        out[f"{kind}_names"] = np.array(names)
        out[f"{kind}_norms"] = np.array([d[n] for n in names], np.float64)
    return out


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT))
    import conftest  # noqa: F401  (pins JAX to the CPU)

    for path, make, keys in (
            (GOLDEN, jax_golden, ("qf1_loss", "qf2_loss", "policy_loss",
                                  "entropy")),
            (GOLDEN_GUIDED, jax_guided_golden, ("qf1_loss", "qf2_loss",
                                                "policy_loss",
                                                "guidence_weight"))):
        if sys.argv[1:] and path.stem not in sys.argv[1:]:
            continue
        data = make()
        path.parent.mkdir(exist_ok=True)
        np.savez(path, **data)
        print(f"wrote {path}: " + ", ".join(
            f"{k} {float(data[k]):.6g}" for k in keys))
