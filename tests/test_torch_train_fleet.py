"""Fleet-collection training in the port (dgvit_tpu_torch/train/train_fleet.py)
on the CPU, mirroring the JAX package's tests/test_train_fleet.py (its
non-slow cases), and the learner held to SACAgent's updates.

N robot threads stream transitions into the shared replay buffer while one
SAC learner updates and publishes into the served copy of the actor that
the server acts on:
  * the robots' transitions land in the buffer, the learner consumes them
    at the update:step cadence and drains to it after collection ends;
  * PER, guided (PRE_BUFFER) and guided PER updates dispatch;
  * the served copy ends equal to the learner's actor, and every
    dispatch acted on one whole published version (`audit`: each
    dispatch's float64 checksum of what K1 reads of the served copy, the
    trunk's cached casts and the other parameters, equals one publish's),
    also in the 8-robot zero-wait stress run, and a stale cast cache
    fails it;
  * one fleet update on a fixed batch equals `SACAgent.learn` (and
    `learn_guidence_per`, with the same priority update) bit for bit;
  * resume, the episode budget's divisibility, the command line, the
    refusal of --mesh-data by name, and the saved actor read through the
    JAX package's load_params_npz.
"""

import glob

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.core import checkpoint as jckpt
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.models.jax_io import params_to_jax
from dgvit_tpu_torch.replay import (PrioritizedReplayBuffer, ReplayBuffer,
                                    reference_schema)
from dgvit_tpu_torch.train import demo_record
from dgvit_tpu_torch.train import train_fleet as mod
from dgvit_tpu_torch.train.train_fleet import FleetLearner, train_fleet

HW = (32, 40)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fleet_cfg(cls=Config, **sac):
    cfg = cls.from_dict({
        "model": {"block": 1, "head": 2, "latent_size": 16, "mlp_dim": 32,
                  "image_size": HW, "patch_size": (16, 20)},
        "env": {"max_steps": 12},
        "sac": {"batch_size": 16, "buffer_size": 4096, **sac},
    })
    cfg.train.save = False
    return cfg


_RECORDS = {}


def _envs(n, seed0=100):
    for s in range(seed0, seed0 + n):
        if s not in _RECORDS:
            _RECORDS[s] = default_records(seed=s)
    return [KinematicNavEnv(_RECORDS[s], image_hw=HW)
            for s in range(seed0, seed0 + n)]


def run(cfg, tmp_path, n=2, **kw):
    kw.setdefault("max_episodes", n)
    kw.setdefault("max_wait_ms", 10.0)
    return train_fleet(cfg, _envs(n), out_dir=str(tmp_path), device="cpu",
                       **kw)


def same_module(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))


def audited(out):
    """Every dispatch read one whole published version."""
    published = set(out["audit"]["published"])
    dispatched = out["audit"]["dispatched"]
    assert len(out["audit"]["published"]) == out["updates"] + 1
    assert len(dispatched) == out["serving"]["dispatches"]
    return all(s in published for s in dispatched)


def test_fleet_collects_and_learns(tmp_path):
    cfg = fleet_cfg()
    cfg.train.save = True
    out = run(cfg, tmp_path, n=4, max_episodes=8, audit=True)

    assert out["errors"] == {}
    assert out["episodes"] == 8
    assert out["env_steps"] > 0
    # every robot action went through the shared server (the first step of
    # an episode asks for an action too, and is stored)
    assert out["serving"]["requests"] == out["serving"]["rows"]
    assert out["serving"]["rows"] >= out["env_steps"]
    assert 0 < out["updates"] <= out["env_steps"]
    assert int(out["state"].itera) == out["updates"]
    init = SACAgent(cfg, device="cpu", seed=cfg.train.seed).init_state(
        cfg.train.seed)
    assert not same_module(init.actor, out["state"].actor)   # it learned
    # the served copy ends as the learner's actor, and every dispatch
    # acted on one published version
    assert same_module(out["served"], out["state"].actor)
    assert audited(out)
    assert glob.glob(str(tmp_path / cfg.train.checkpoint_dir / "step_*"))


def test_fleet_learner_drains_to_cadence_after_collection(tmp_path):
    out = run(fleet_cfg(), tmp_path, n=2, max_episodes=4,
              updates_per_step=0.5)
    want = int(out["env_steps"] * 0.5)
    assert abs(out["updates"] - want) <= 1


def test_fleet_per_variant(tmp_path):
    out = run(fleet_cfg(prioritized_replay=True), tmp_path)
    assert out["updates"] > 0 and out["errors"] == {}


def test_fleet_dispatch_publish_interleave_stress(tmp_path):
    """8 robots, no coalescing wait and two updates a step: the most
    interleaving of server dispatches with publishes. A torn read of the
    served copy shows as a dispatch checksum that no publish made; PER
    runs its |td| readback outside the lock."""
    cfg = fleet_cfg(prioritized_replay=True)
    out = run(cfg, tmp_path, n=8, max_episodes=8, updates_per_step=2.0,
              max_wait_ms=0.0, audit=True)
    assert out["errors"] == {}
    assert out["updates"] > 0
    assert int(out["state"].itera) == out["updates"]
    assert same_module(out["served"], out["state"].actor)
    assert audited(out)


def demos(tmp_path):
    env = KinematicNavEnv(default_records(seed=0), image_hw=HW)
    assert demo_record.record_episodes(
        env, demo_record.scripted_pilot, str(tmp_path / "demos"),
        episodes=2, max_steps=20)
    return str(tmp_path / "demos" / "RRC" / "torch" / "*.npz")


@pytest.mark.parametrize("per", [False, True], ids=["guided", "guided_per"])
def test_fleet_guided_variant(tmp_path, per, monkeypatch):
    """PRE_BUFFER: expert demos feed the guided update beside the fleet
    stream (main.py:223-268 + DRL.py's guided update)."""
    cfg = fleet_cfg(prioritized_replay=per)
    cfg.train.pre_buffer = True
    calls = []
    for name in ("learn", "learn_per", "learn_guidence",
                 "learn_guidence_per"):
        real = getattr(SACAgent, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(SACAgent, name, spy)
    out = run(cfg, tmp_path / "out", expert_glob=demos(tmp_path))
    assert out["updates"] > 0 and out["errors"] == {}
    want = "learn_guidence_per" if per else "learn_guidence"
    assert calls == [want] * out["updates"]


def test_fleet_resume(tmp_path):
    cfg = fleet_cfg()
    cfg.train.save = True
    out1 = run(cfg, tmp_path)
    out2 = run(cfg, tmp_path, resume=True)
    assert int(out2["state"].itera) == \
        int(out1["state"].itera) + out2["updates"]
    # the served copy starts from the restored actor: it ends as the
    # learner's
    assert same_module(out2["served"], out2["state"].actor)


def test_fleet_periodic_checkpoints_pruned(tmp_path):
    cfg = fleet_cfg()
    cfg.train.save = True
    out = run(cfg, tmp_path, n=2, max_episodes=4, save_every_updates=2)
    steps = glob.glob(str(tmp_path / cfg.train.checkpoint_dir / "step_*"))
    assert out["updates"] >= 8
    # the newest 3 periodic ones, then the final save (its step may be one
    # of them)
    assert 3 <= len(steps) <= 4


def test_fleet_episode_budget_must_divide():
    with pytest.raises(ValueError, match="divide evenly"):
        train_fleet(fleet_cfg(), _envs(3), max_episodes=4, device="cpu")


def test_mesh_data_raises_by_name(tmp_path):
    """--mesh-data other than the process group's world size (one process
    here) raises by name; tests/test_torch_fleet_mesh.py runs it on two
    ranks."""
    with pytest.raises(ValueError, match="--mesh-data 8: .* 1 rank"):
        run(fleet_cfg(), tmp_path, mesh_data=8)
    with pytest.raises(ValueError, match="--mesh-data 2"):
        mod.main(["--fleet", "2", "--episodes", "2", "--mesh-data", "2",
                  "--out", str(tmp_path), "--config", _write_cfg(tmp_path),
                  "--device", "cpu"])


def test_cli_smoke(tmp_path, capsys):
    mod.main(["--fleet", "2", "--episodes", "2", "--out", str(tmp_path),
              "--config", _write_cfg(tmp_path), "--device", "cpu"])
    assert "fleet train done" in capsys.readouterr().out


def _write_cfg(tmp_path):
    import yaml

    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(fleet_cfg().to_dict()))
    return str(p)


def test_saved_actor_reads_into_the_jax_package(tmp_path):
    cfg = fleet_cfg()
    cfg.train.save = True
    out = run(cfg, tmp_path)
    path = glob.glob(str(tmp_path / "models" / "*_actor.npz"))
    assert path == [out["actor_npz"]]
    jcfg = fleet_cfg(JaxConfig)
    template = JaxSACAgent(jcfg).init_state(0).actor_params
    loaded = jckpt.load_params_npz(path[0], template)
    want = params_to_jax(out["state"].actor.state_dict())
    leaves = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert len(leaves) == len(want)
    for p, v in leaves:
        np.testing.assert_array_equal(
            np.asarray(v), want["/".join(str(k.key) for k in p)])


# -- one fleet update against SACAgent's -------------------------------------

def filled(cls, cfg, n=64, seed=3, expert=False):
    s = cfg.sac
    buf = cls(256, reference_schema(HW, s.action_dim, s.pstate_dim,
                                    expert=expert), seed=cfg.train.seed)
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.uniform(0, 1, sh).astype(np.float32)
    rows = {"obs": f(n, *HW), "pobs": f(n, 2), "next_pobs": f(n, 2),
            "rew": rng.normal(0, 5, n).astype(np.float32),
            "next_obs": f(n, *HW),
            "done": (rng.uniform(size=n) < 0.2).astype(np.float32),
            ("act_exp" if expert else "act"):
                rng.uniform(-1, 1, (n, 2)).astype(np.float32)}
    if not expert:
        rows["engage"] = np.zeros(n, np.float32)
    buf.add(**rows)
    return buf


def twins(cfg):
    agent = SACAgent(cfg, device="cpu", seed=cfg.train.seed)
    return agent, agent.init_state(cfg.train.seed), \
        agent.init_state(cfg.train.seed)


def test_one_fleet_update_equals_learn_bit_for_bit():
    import copy
    import threading

    cfg = fleet_cfg()
    agent, state, ref = twins(cfg)
    buf, twin = filled(ReplayBuffer, cfg), filled(ReplayBuffer, cfg)
    served = copy.deepcopy(state.actor).requires_grad_(False)
    learner = FleetLearner(agent, cfg, buf, served, threading.Lock())
    for _ in range(2):
        state, metrics = learner.update(state)
        d = twin.sample(cfg.sac.batch_size)
        for k in ("engage", "weights", "indexes"):
            d.pop(k, None)
        ref, want = agent.learn(ref, {k: torch.from_numpy(v)
                                      for k, v in d.items()})
        assert metrics.keys() == want.keys()
        for k in want:
            assert torch.equal(metrics[k], want[k]), k
    assert same_module(state.actor, ref.actor)
    assert same_module(state.critic, ref.critic)
    assert same_module(served, state.actor)


def test_one_guided_per_update_equals_learn_guidence_per():
    import copy
    import threading

    cfg = fleet_cfg(prioritized_replay=True)
    agent, state, ref = twins(cfg)
    buf = filled(PrioritizedReplayBuffer, cfg)
    twin = filled(PrioritizedReplayBuffer, cfg)
    ebuf, etwin = (filled(ReplayBuffer, cfg, n=40, seed=4, expert=True)
                   for _ in range(2))
    served = copy.deepcopy(state.actor).requires_grad_(False)
    learner = FleetLearner(agent, cfg, buf, served, threading.Lock(),
                           ebuf, 40)
    b = cfg.sac.batch_size
    for _ in range(2):
        state, metrics = learner.update(state)
        ab = twin.sample(b)
        w, idx = ab.pop("weights"), ab.pop("indexes")
        k = agent.expert_batch_size(40, twin.get_stored_size(), b)
        eb = etwin.sample(b)
        eb["act"] = eb.pop("act_exp")
        ref, want, td = agent.learn_guidence_per(
            ref, {k_: torch.from_numpy(v) for k_, v in ab.items()},
            {k_: torch.from_numpy(v) for k_, v in eb.items()}, k, w)
        twin.update_priorities(idx, np.abs(td.float().numpy()) + 1e-6)
        for key in want:
            assert torch.equal(metrics[key], want[key]), key
    assert same_module(state.actor, ref.actor)
    assert same_module(state.critic, ref.critic)
    assert same_module(served, state.actor)
    # the priority updates were the same: the next draws agree
    a, c = buf.sample(b), twin.sample(b)
    np.testing.assert_array_equal(a["indexes"], c["indexes"])
    np.testing.assert_array_equal(a["weights"], c["weights"])


def test_audit_reads_the_casts_k1_launches_with():
    """A dispatch's checksum covers the trunk's cached casts that K1
    launches with, not only the parameters: a stale cast cache under a
    current key fails the audit although the parameters are the
    published ones."""
    import copy
    import threading

    cfg = fleet_cfg()
    agent, state, _ = twins(cfg)
    served = copy.deepcopy(state.actor).requires_grad_(False)
    audit = {"published": [], "dispatched": []}
    learner = FleetLearner(agent, cfg, filled(ReplayBuffer, cfg), served,
                           threading.Lock(), audit=audit)
    learner.publish(state)
    obs, pobs = torch.zeros((3,) + HW), torch.zeros((3, 2))
    gen = torch.Generator().manual_seed(0)
    assert learner.dispatch(obs, pobs, gen).shape == (3, 2)
    assert audit["dispatched"][-1] == audit["published"][-1]

    (w, b), pos, blocks, fn = served.trans._cache
    served.trans._cache = ((w + 1.0, b), pos, blocks, fn)
    learner.dispatch(obs, pobs, gen)
    assert same_module(served, state.actor)
    assert audit["dispatched"][-1] not in audit["published"]
