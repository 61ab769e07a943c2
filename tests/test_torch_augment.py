"""The port's DrQ random shift (dgvit_tpu_torch/ops/augment.py) and the
update's `sac.aug_shift` / `aug_actor` / `aug_warmup` against the JAX
package's, on the CPU.

`random_shift` on JAX's own offsets is bit-equal to JAX's (it copies
pixels). The augmented updates run from a JAX state carried over by
`sac_state_from_jax` with JAX's offsets (`fold_in(step key, 101 / 102)`
for the agent batch's obs / next_obs, 103 / 104 for the expert's) and
JAX's row noise injected, held under tests/test_torch_sac.py's
tolerances: metrics rtol 1e-4 / atol 1e-5 and its two-level check of the
parameters. The geometry checks mirror tests/test_augment.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.ops import augment as jaug
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.models.jax_io import params_from_jax, sac_state_from_jax
from dgvit_tpu_torch.ops.augment import random_shift

from test_torch_sac import (B, SMALL, TOL, as_numpy, guided_batches,
                            guided_noise, make_batch, step_noise,
                            two_level_close)


def jax_offsets(key, b, pad):
    """The offsets JAX's random_shift draws from `key`."""
    return np.array(jax.random.randint(key, (b, 2), 0, 2 * pad + 1))


@pytest.mark.parametrize("shape,pad", [((5, 12, 14), 3), ((3, 4, 12, 14), 2),
                                       ((2, 32, 40), 4)])
def test_random_shift_bit_equal_to_jax(shape, pad):
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jaug.random_shift(jnp.asarray(x), key, pad))
    out = random_shift(torch.from_numpy(x), pad,
                       offsets=torch.from_numpy(jax_offsets(key, shape[0],
                                                            pad)))
    np.testing.assert_array_equal(out.numpy(), ref)


# --------------------------------------------------------------------------
# mirrors of tests/test_augment.py
# --------------------------------------------------------------------------

def test_constant_image_invariant():
    x = torch.full((3, 16, 20), 0.37)
    out = random_shift(x, 4, torch.Generator().manual_seed(0))
    assert torch.equal(out, x)


def test_pad_zero_is_identity():
    x = torch.rand(2, 8, 10)
    assert random_shift(x, 0, torch.Generator().manual_seed(2)) is x


def test_shift_is_a_translate_of_the_padded_frame():
    pad = 3
    x = torch.rand(4, 12, 14, generator=torch.Generator().manual_seed(3))
    out = random_shift(x, pad, torch.Generator().manual_seed(4)).numpy()
    xp = np.pad(x.numpy(), ((0, 0), (pad, pad), (pad, pad)), mode="edge")
    for i in range(4):
        assert any(np.array_equal(out[i], xp[i, dy:dy + 12, dx:dx + 14])
                   for dy in range(2 * pad + 1)
                   for dx in range(2 * pad + 1)), i


def test_channels_shift_together_and_deterministic():
    x = torch.rand(2, 4, 12, 14, generator=torch.Generator().manual_seed(5))
    g = lambda: torch.Generator().manual_seed(6)
    out1, out2 = random_shift(x, 2, g()), random_shift(x, 2, g())
    assert torch.equal(out1, out2)
    assert torch.equal(out1[:, 1], random_shift(x[:, 1], 2, g()))


def small_agent(**sac):
    return SACAgent(Config.from_dict({"model": SMALL, "sac": sac}),
                    device="cpu", seed=5)


def actor_params(state):
    return [p.detach().clone() for p in state.actor.parameters()]


def max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def test_aug_shift_changes_the_update_but_zero_is_raw():
    """aug_shift=0 reproduces the default update bit for bit and draws
    nothing extra; aug_shift=2 changes it and stays finite."""
    batch = make_batch(7)
    ref = small_agent()
    ref_st, _ = ref.learn(ref.init_state(), batch)
    zero = small_agent(aug_shift=0)
    z_st = zero.init_state()
    assert z_st.aug_generator is None
    z_st, _ = zero.learn(z_st, batch)
    assert max_diff(actor_params(ref_st), actor_params(z_st)) == 0.0
    assert torch.equal(ref_st.generator.get_state(),
                       z_st.generator.get_state())
    aug = small_agent(aug_shift=2)
    a_st, m = aug.learn(aug.init_state(), batch)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert max_diff(actor_params(ref_st), actor_params(a_st)) > 0
    # the dropout and noise stream is the one the raw update drew
    assert torch.equal(ref_st.generator.get_state(),
                       a_st.generator.get_state())


def test_aug_critic_only_differs_from_both_raw_and_full():
    batch = make_batch(10)

    def run(**kw):
        agent = small_agent(**kw)
        st, m = agent.learn(agent.init_state(), batch)
        assert all(np.isfinite(float(v)) for v in m.values()), kw
        return actor_params(st)

    raw, full = run(), run(aug_shift=2)
    critic_only = run(aug_shift=2, aug_actor=False)
    assert max_diff(critic_only, raw) > 0
    assert max_diff(critic_only, full) > 0


def test_aug_critic_only_guided_and_per_paths():
    agent = small_agent(aug_shift=2, aug_actor=False)
    st = agent.init_state()
    batch, expert = guided_batches(11, engage=False)
    st, m = agent.learn_guidence(st, batch, expert, 2)
    assert all(np.isfinite(float(v)) for v in m.values())
    plain = {k: v for k, v in batch.items() if k != "engage"}
    st, m, td = agent.learn_per(st, plain, np.ones(B, np.float32))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert torch.isfinite(td).all() and td.shape == (B,)


def test_aug_warmup_gates_the_shift_by_step():
    batch = make_batch(13)
    raw = small_agent()
    raw_st, _ = raw.learn(raw.init_state(), batch)
    warm = small_agent(aug_shift=2, aug_warmup=5)
    w_st, _ = warm.learn(warm.init_state(), batch)        # itera 0 < 5
    assert max_diff(actor_params(w_st), actor_params(raw_st)) == 0.0
    st5 = warm.init_state()
    st5.itera = 5
    w5, _ = warm.learn(st5, batch)
    r5 = raw.init_state()
    r5.itera = 5
    r5, _ = raw.learn(r5, batch)
    assert max_diff(actor_params(w5), actor_params(r5)) > 0


def test_aug_knobs_need_a_shift():
    for sac in ({"aug_warmup": 3}, {"aug_actor": False},
                {"aug_shift": -1}):
        with pytest.raises(ValueError, match="aug_"):
            Config.from_dict({"sac": sac})


def test_aug_generator_survives_a_checkpoint(tmp_path):
    from dgvit_tpu_torch.core import checkpoint as ckpt

    agent = small_agent(aug_shift=2)
    st = agent.init_state()
    st, _ = agent.learn(st, make_batch(1))
    ckpt.save_train_state(str(tmp_path), 1, st)
    back = ckpt.restore_train_state(str(tmp_path / "step_1"),
                                    agent.init_state(seed=99))
    assert torch.equal(back.aug_generator.get_state(),
                       st.aug_generator.get_state())
    one, _ = agent.learn(st, make_batch(2))
    two, _ = agent.learn(back, make_batch(2))
    assert max_diff(actor_params(one), actor_params(two)) == 0.0


# --------------------------------------------------------------------------
# the augmented updates against JAX's, on JAX's offsets
# --------------------------------------------------------------------------

PAD = 2
CASES = {"full": {"aug_shift": PAD},
         "critic_only": {"aug_shift": PAD, "aug_actor": False},
         "in_warmup": {"aug_shift": PAD, "aug_warmup": 5},
         "past_warmup": {"aug_shift": PAD, "aug_warmup": 1,
                         "aug_actor": False}}


def update_offsets(state, b, guided):
    key = jax.random.fold_in(state.rng, state.itera)
    tags = (101, 102, 103, 104) if guided else (101, 102)
    return [torch.from_numpy(jax_offsets(jax.random.fold_in(key, t), b, PAD))
            for t in tags]


@pytest.fixture(scope="module")
def aug_updates():
    out = {}
    for name, sac in CASES.items():
        jagent = JaxSACAgent(JaxConfig.from_dict({"model": SMALL,
                                                  "sac": sac}),
                             row_noise=True)
        s1, _ = jagent.learn(jagent.init_state(3), make_batch(1))
        carried = as_numpy(s1)
        agent = SACAgent(Config.from_dict({"model": SMALL, "sac": sac}),
                         device="cpu")
        for guided in (False, True):
            st = jax.tree_util.tree_map(jnp.asarray, carried)
            shifts = update_offsets(st, B, guided)
            state = sac_state_from_jax(agent, carried)
            if guided:
                batch, expert = guided_batches(60, engage=True)
                noise = guided_noise(jagent, st, 2 * B)
                s2, jm = jagent.learn_guidence(st, batch, expert, 4)
                state, pm = agent.learn_guidence(state, batch, expert, 4,
                                                 noise=noise, shifts=shifts)
            else:
                batch = make_batch(2)
                noise = step_noise(jagent, st, B)
                s2, jm = jagent.learn(st, batch)
                state, pm = agent.learn(state, batch, noise=noise,
                                        shifts=shifts)
            out[name, guided] = dict(jax=as_numpy(s2), jm=jm, port=state,
                                     pm=pm)
    return out


IDS = [f"{n}-{'guided' if g else 'plain'}" for n in CASES
       for g in (False, True)]
KEYS = [(n, g) for n in CASES for g in (False, True)]


@pytest.mark.parametrize("case", KEYS, ids=IDS)
def test_augmented_update_metrics_match_jax(aug_updates, case):
    r = aug_updates[case]
    assert set(r["pm"]) == set(r["jm"])
    for k in r["jm"]:
        np.testing.assert_allclose(float(r["pm"][k]), float(r["jm"][k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("which", ["actor", "critic"])
@pytest.mark.parametrize("case", KEYS, ids=IDS)
def test_augmented_update_params_match_jax(aug_updates, case, which):
    r = aug_updates[case]
    two_level_close(dict(getattr(r["port"], which).named_parameters()),
                    params_from_jax(getattr(r["jax"], f"{which}_params")))
    np.testing.assert_allclose(r["port"].log_alpha.item(),
                               float(r["jax"].log_alpha), **TOL)


def test_guided_update_shifts_the_expert_frames(monkeypatch):
    """The guided update shifts four frame sets (agent and expert, obs and
    next_obs), each on its own offsets; with aug_actor False the BC loss
    reads the expert's raw frames."""
    from dgvit_tpu_torch.agents import sac as sac_mod

    seen = []
    real = sac_mod.random_shift

    def spy(imgs, pad, gen=None, offsets=None):
        out = real(imgs, pad, gen, offsets)
        seen.append((imgs.clone(), out.clone()))
        return out

    monkeypatch.setattr(sac_mod, "random_shift", spy)
    bc_obs = []
    real_bc = SACAgent._bc_mse

    def bc_spy(self, state, obs, *a):
        bc_obs.append(obs.clone())
        return real_bc(self, state, obs, *a)

    monkeypatch.setattr(SACAgent, "_bc_mse", bc_spy)
    agent = small_agent(aug_shift=PAD, aug_actor=False)
    batch, expert = guided_batches(70, engage=False)
    agent.learn_guidence(agent.init_state(), batch, expert, 3)
    assert len(seen) == 4
    for (raw, out), want in zip(seen, (batch["obs"], batch["next_obs"],
                                       expert["obs"], expert["next_obs"])):
        np.testing.assert_array_equal(raw.numpy(), want)
        assert not torch.equal(raw, out)
    np.testing.assert_array_equal(bc_obs[0].numpy(), expert["obs"])
