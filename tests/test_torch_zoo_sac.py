"""The port's SAC update on every family of the zoo against the JAX
package's `SACAgent.learn`, on the CPU, at a small size.

Each family starts from the JAX agent's own initial train state, carried
into the port (`sac_state_from_jax`), and takes two updates on both sides
on the same seeded batches with JAX's own row noise injected into the
port (`test_torch_sac.step_noise`). Dropout is off on both sides (the
configs' emb-dropout 0; the DeterministicGoTPolicy, which the factory
hands no emb-dropout, has it set to 0 on both sides).

The families: the reference's configuration (GoT actor, CNN critic);
GaussianConvNet + CNN; the deterministic GoT actor + GoT critic; the
SimpleViT actor + critic; and head-only fine-tuning
(train.policy_attention_fix and critic_attention_fix) on the GoT pair,
whose frozen `trans` and `fc_embed` stay bit-equal. The `Deterministic`
actor (a CNN on (B, H, W, 4) stacks) has no update to match: JAX's
init_state builds the critic beside it for single frames and JAX's update
fails on it, and the port's agent refuses it by name.

Tolerances (fp32, another summation order on each side): metrics and
log_alpha rtol 1e-5, atol 1e-5 after the first update and rtol 1e-4
after the second (the first update's parameters feed it); parameters
after the Adam steps and the Polyak-averaged target by
test_torch_sac.two_level_close (an Adam step is about lr * sign(g), so a
gradient element near zero may flip its step).
"""

import numpy as np
import pytest
import torch

from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.models.jax_io import params_from_jax, sac_state_from_jax
from test_torch_sac import as_numpy, make_batch, step_noise, two_level_close

B = 6
HW = (32, 40)
TINY = dict(latent_size=32, dim_head=16, mlp_dim=64, block=2, head=2,
            image_size=list(HW), emb_dropout=0.0, vit_dim=32, vit_depth=1,
            vit_heads=2)
FAMILIES = {   # name -> (backbone, actor_type, critic_type, train flags)
    "got_actor_cnn_critic": ("got", "GaussianTransformer", "CNN", {}),
    "cnn_gaussian": ("got", "GaussianConvNet", "CNN", {}),
    "got_deterministic": ("got", "DeterministicTransformer", "Transformer",
                          {}),
    "vit": ("simple_vit", "GaussianTransformer", "Transformer", {}),
    "got_attention_fix": ("got", "GaussianTransformer", "Transformer",
                          {"policy_attention_fix": True,
                           "critic_attention_fix": True}),
}
METRICS = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss", "alpha",
           "entropy")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are small, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_cfg(name):
    backbone, actor, critic, train = FAMILIES[name]
    return {"model": dict(TINY, backbone=backbone, actor_type=actor,
                          critic_type=critic),
            "sac": {"batch_size": B}, "train": train}


def jax_agent(name):
    jagent = JaxSACAgent(JaxConfig.from_dict(family_cfg(name)),
                         row_noise=True)
    if FAMILIES[name][1] == "DeterministicTransformer":
        jagent.actor = jagent.actor.clone(emb_dropout=0.0)
    return jagent, jagent.init_state(3)


@pytest.fixture(scope="module", params=list(FAMILIES))
def updates(request):
    """Two JAX updates and the same two in the port, from JAX's initial
    state."""
    name = request.param
    jagent, js = jax_agent(name)
    agent = SACAgent(Config.from_dict(family_cfg(name)), device="cpu")
    state = sac_state_from_jax(agent, as_numpy(js))
    if FAMILIES[name][1] == "DeterministicTransformer":
        state.actor.trans.emb_dropout = 0.0
    before = {k: {n: p.detach().clone() for n, p in
                  getattr(state, k).named_parameters()}
              for k in ("actor", "critic")}
    steps = []
    for i in range(2):
        batch = make_batch(10 + i, B, HW)
        noise = step_noise(jagent, js, B)
        js, jm = jagent.learn(js, batch)
        state, pm = agent.learn(state, batch, noise=noise)
        steps.append(({k: float(v) for k, v in jm.items()},
                      {k: float(v) for k, v in pm.items()}))
    return dict(name=name, jax=as_numpy(js), port=state, steps=steps,
                before=before, agent=agent)


def test_metrics_match_jax(updates):
    for i, (jm, pm) in enumerate(updates["steps"]):
        rtol = 1e-5 if i == 0 else 1e-4
        for k in METRICS:
            np.testing.assert_allclose(pm[k], jm[k], rtol=rtol, atol=1e-5,
                                       err_msg=f"step {i} {k}")
            assert np.isfinite(pm[k])


@pytest.mark.parametrize("which", ["actor", "critic", "critic_target"])
def test_params_match_jax(updates, which):
    key = {"actor": "actor_params", "critic": "critic_params",
           "critic_target": "critic_target_params"}[which]
    port = dict(getattr(updates["port"], which).named_parameters())
    two_level_close(port, params_from_jax(getattr(updates["jax"], key)))


def test_temperature_and_counter_match_jax(updates):
    s, j = updates["port"], updates["jax"]
    np.testing.assert_allclose(s.log_alpha.item(), float(j.log_alpha),
                               rtol=1e-5, atol=1e-5)
    assert s.itera == int(j.itera) == 2
    if updates["agent"].deterministic_actor:     # alpha 0, never tuned
        assert all(m["alpha"] == 0.0 and m["alpha_loss"] == 0.0
                   for _, m in updates["steps"])
        assert s.log_alpha.item() == 0.0


def test_frozen_subtrees(updates):
    """With head-only fine-tuning, `trans` and `fc_embed` stay bit-equal
    and outside the Adam, the heads move; without it the trunk moves."""
    fixed = updates["name"] == "got_attention_fix"
    for kind in ("actor", "critic"):
        module = getattr(updates["port"], kind)
        opt = getattr(updates["port"], f"{kind}_opt")
        held = {id(p) for g in opt.param_groups for p in g["params"]}
        moved = {n: not torch.equal(p, updates["before"][kind][n])
                 for n, p in module.named_parameters()}
        frozen = [n for n in moved if n.startswith(("trans.", "fc_embed."))]
        heads = [n for n in moved if n not in frozen]
        assert heads and any(moved[n] for n in heads)
        if fixed:
            assert frozen and not any(moved[n] for n in frozen), kind
            assert not any(id(p) in held for n, p in
                           module.named_parameters() if n in frozen)
        elif frozen:
            assert any(moved[n] for n in frozen), kind


def test_attention_fix_only_on_transformer_networks():
    """The flags reach the Transformer actors and critic only (JAX
    sac.py:177-185): beside a CNN critic the critic trains whole."""
    cfg = Config.from_dict({"model": dict(TINY, critic_type="CNN"),
                            "train": {"policy_attention_fix": True,
                                      "critic_attention_fix": True}})
    agent = SACAgent(cfg, device="cpu")
    state = agent.init_state()
    assert agent.actor_fix and not agent.critic_fix
    assert all(p.requires_grad for p in state.critic.parameters())
    assert not any(p.requires_grad for p in state.actor.trans.parameters())
    with pytest.raises(NotImplementedError, match="Deterministic"):
        SACAgent(Config.from_dict({"model": dict(
            TINY, actor_type="Deterministic")}), device="cpu")


@pytest.mark.parametrize("name", ["cnn_gaussian", "vit", "got_deterministic"])
def test_batched_loops_run_the_family(tmp_path, name):
    """train_fused and train_vec run every family JAX's loops run: a round
    of collection and one update, the actor saved in JAX's layout."""
    from dgvit_tpu_torch.train.fused_train import train_fused
    from dgvit_tpu_torch.train.vec_rollout import train_vec

    cfg = Config.from_dict(dict(family_cfg(name), env={"max_steps": 20}))
    out = train_fused(cfg, out_dir=str(tmp_path / "f"), n_envs=2, chunk=6,
                      rounds=1, updates_per_round=1, ring_capacity=32,
                      device="cpu")
    assert out["updates"] == 1 and out["env_steps"] == 12
    out = train_vec(cfg, out_dir=str(tmp_path / "v"), n_envs=2, chunk=6,
                    total_env_steps=12, device="cpu")
    assert out["env_steps"] == 12


FOUR_CHANNEL = {"model": dict(TINY, actor_type="Deterministic",
                              critic_type="CNN"), "sac": {"batch_size": B}}


def test_jax_update_fails_on_the_four_channel_actor():
    """JAX's own update cannot run the Deterministic actor: its init_state
    builds the critic beside it for single frames, and the update hands
    that critic the actor's (B, H, W, 4) stacks."""
    jagent = JaxSACAgent(JaxConfig.from_dict(FOUR_CHANNEL))
    state = jagent.init_state(3)
    batch = make_batch(10, B, HW)
    rng = np.random.default_rng(110)
    for k in ("obs", "next_obs"):
        batch[k] = rng.uniform(0, 1, (B, *HW, 4)).astype(np.float32)
    with pytest.raises(Exception, match="(?i)shape"):
        jagent.learn(state, batch)


def test_env_loops_refuse_the_four_channel_actor(tmp_path):
    """The agent refuses the Deterministic actor by name, so every loop
    that trains or evaluates through it raises before it writes
    anything."""
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.train import evaluate, train_rl
    from dgvit_tpu_torch.train.fused_train import train_fused
    from dgvit_tpu_torch.train.vec_rollout import train_vec

    cfg = Config.from_dict(FOUR_CHANNEL)
    env = KinematicNavEnv(seed=0, image_hw=HW)
    for run in (lambda: SACAgent(cfg, device="cpu"),
                lambda: train_rl.train(cfg, env, str(tmp_path), device="cpu"),
                lambda: evaluate.run_eval_vec(cfg, {}, device="cpu"),
                lambda: train_fused(cfg, str(tmp_path), device="cpu"),
                lambda: train_vec(cfg, str(tmp_path), device="cpu")):
        with pytest.raises(NotImplementedError, match="Deterministic"):
            run()
    assert not list(tmp_path.iterdir())
