"""The port's env-in-the-loop trainer and evaluator
(dgvit_tpu_torch/train, core/checkpoint.py, utils/metrics.py)
on the CPU, at a tiny geometry, against the JAX package where the two can
agree.

Sampled trajectories cannot equal JAX's (the port draws action noise from
the `torch.Generator` in its state, JAX from threaded keys), so the loop is
tested for its contract: it runs end to end, skips a bad initialization,
starts learning when the buffer holds `batch_size` transitions, triggers
evaluation and saves under the reference's file names, resumes so that the
next update is reproduced bit for bit, and refuses the flavours that are
not ported. The prioritized-replay steps of the loop (sample with
importance weights, `learn_per` or `learn_guidence_per`, the priority
update) are held to JAX's on the same transitions in the same C++
buffer: the same rows drawn, |TD errors| within rtol 1e-4 / atol 1e-5,
and after the steps a draw of 64 rows gives JAX's rows and weights
within rtol 1e-4. Deterministic runs can agree and are compared: `run_eval` and
the trainer's `evaluate` with an actor carried over from JAX give the JAX
package's episode lengths, successes and collisions, and episode rewards
within 1e-3 (fp32 on both sides; actions differ by ~1e-6, which moves a
reward of tens by less). No test asserts on a learning curve.
"""

import glob
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.core import checkpoint as jckpt
from dgvit_tpu.envs import KinematicNavEnv as JaxKinematicNavEnv
from dgvit_tpu.train import evaluate as jax_evaluate
from dgvit_tpu.train import train_rl as jax_train_rl
from dgvit_tpu.utils import metrics as jmetrics
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.envs import KinematicNavEnv, ResetResult, StepResult
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.envs.worlds import get_world
from dgvit_tpu_torch.models.jax_io import (params_from_jax, params_to_jax,
                                           sac_state_from_jax)
from dgvit_tpu_torch.envs.replay_env import load_demo_npz
from dgvit_tpu_torch.train import demo_record
from dgvit_tpu_torch.train import evaluate as port_evaluate
from dgvit_tpu_torch.train import train_rl
from dgvit_tpu_torch.utils import MetricsLogger, Profiler, RewardCurve

HW = (32, 40)
TINY = {
    "model": {"block": 2, "head": 2, "latent_size": 32, "dim_head": 16,
              "mlp_dim": 64, "image_size": HW, "patch_size": (16, 20)},
    "sac": {"batch_size": 4, "buffer_size": 256},
    "env": {"max_steps": 12, "max_episodes": 3},
    "train": {"pre_buffer": False, "plot_interval": 1000,
              "eval_threshold": 0, "reward_threshold": 1e9},
}


def tiny_cfg(cls=Config, **train):
    cfg = cls.from_dict(TINY)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


_RECORDS = {}


def records(seed, world=None):
    """Start/goal records of a seed, drawn once (the JAX package's sampler
    takes seconds a call; tests/test_torch_envs.py holds the two equal)."""
    key = (seed, world)
    if key not in _RECORDS:
        _RECORDS[key] = default_records(
            seed=seed, world=world and get_world(world))
    return _RECORDS[key]


def run(cfg, tmp_path, seed=0, **kw):
    env = KinematicNavEnv(records(seed), image_hw=HW)
    return train_rl.train(cfg, env, out_dir=str(tmp_path), device="cpu", **kw)


class ScriptedEnv:
    """Episodes of a fixed length that never end by themselves; `bad`
    episodes end on their first step (a bad initialization)."""

    def __init__(self, bad=()):
        self.bad = set(bad)
        self.episode = -1
        self.collision = 0
        self.steps = 0

    def _state(self):
        rng = np.random.default_rng(self.steps)
        return rng.uniform(0, 1, (*HW, 1)).astype(np.float32)

    def reset(self):
        self.episode += 1
        goal = np.asarray([0.5, 0.1, 0.0, 0.0], np.float32)
        return ResetResult(self._state(), 0.0, 0.0, goal)

    def step(self, action, t):
        self.steps += 1
        done = self.episode in self.bad and t == 0
        if done:
            self.collision += 1
        goal = np.asarray([0.5, 0.1, action[0], action[1]], np.float32)
        return StepResult(self._state(), 1.0, done, goal, False)


class Recorder:
    """An env that notes each episode's length and reward sum."""

    def __init__(self, env):
        self.env = env
        self.episodes = []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def __setattr__(self, name, value):
        if name in ("env", "episodes"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.env, name, value)

    def reset(self):
        self.episodes.append([0, 0.0])
        return self.env.reset()

    def step(self, action, t):
        out = self.env.step(action, t)
        self.episodes[-1][0] += 1
        self.episodes[-1][1] += out.reward
        return out


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------

def test_training_loop_runs_end_to_end(tmp_path):
    timings = {}
    out = run(tiny_cfg(), tmp_path, max_episodes=3, timings=timings)
    assert out["episodes"] >= 1
    assert np.isfinite(out["max_mean_reward"])
    assert out["state"].itera == timings["updates"] > 0
    assert timings["env_steps"] > timings["updates"]
    assert all(timings[k] > 0 for k in ("env", "act", "sample", "learn"))
    rows = [json.loads(line) for line in
            (tmp_path / "train_gtrl_98.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, out["episodes"] + 1))
    assert np.isfinite(rows[-1]["qf1_loss"]) and "alpha" in rows[-1]
    # final full-state checkpoint, actor export and summary
    assert (tmp_path / "checkpoints" / f"step_{out['state'].itera}"
            / "train_state.pt").exists()
    name = ckpt.reference_name("98", int(out["max_mean_reward"]), 3407)
    assert list((tmp_path / "models").glob("98_reward_*_nbCol_100_seed_3407"
                                           "_actor.npz"))
    assert name.startswith("98_reward_")
    text = (tmp_path / "training_data.txt").read_text()
    assert "Successes: " in text and "critic_type: Transformer" in text


def test_learning_starts_at_batch_size_and_bad_init_is_skipped(tmp_path):
    cfg = tiny_cfg()
    cfg.env.max_steps = 4          # 3 stored transitions an episode
    cfg.sac.batch_size = 5
    timings = {}
    env = ScriptedEnv(bad={1, 2})
    out = train_rl.train(cfg, env, out_dir=str(tmp_path), max_episodes=6,
                         device="cpu", timings=timings)
    # two of six episodes ended on their first step: not counted, nothing
    # stored, no reward logged
    assert out["episodes"] == 4
    assert timings["env_steps"] == 4 * 4 + 2
    stored = 4 * 3
    # one update per stored transition from the batch_size-th on
    assert timings["updates"] == stored - (cfg.sac.batch_size - 1)
    assert out["state"].itera == timings["updates"]
    rows = (tmp_path / "train_gtrl_98.jsonl").read_text().splitlines()
    assert len(rows) == 4
    assert json.loads(rows[0])["episode_reward"] == 3.0   # first step free


def test_eval_trigger_saves_under_reference_names(tmp_path):
    cfg = tiny_cfg(reward_threshold=-1e9, eval_epoch=2, desc="t1")
    out = run(cfg, tmp_path, max_episodes=2)
    rows = [json.loads(line) for line in
            (tmp_path / "train_gtrl_t1.jsonl").read_text().splitlines()]
    evals = [r for r in rows if "eval_reward" in r]
    assert evals, "no evaluation ran"
    saved = sorted(p.name for p in (tmp_path / "models").glob("eval_*"))
    assert saved, "the evaluation saved no actor"
    first = evals[0]
    assert saved[0].startswith("eval_t1_") and saved[0].endswith(
        f"_reward_{int(first['eval_reward'])}_nbCol_"
        f"{int(first['eval_collisions'])}_seed_3407_actor.npz") or len(
            evals) > 1
    assert (tmp_path / "curves" / "eval_reward_mean_t1.npy").exists()
    assert out["episodes"] >= 1


def test_eval_needs_more_episodes_than_the_threshold(tmp_path):
    cfg = tiny_cfg(reward_threshold=-1e9, eval_threshold=50)
    run(cfg, tmp_path, max_episodes=2)
    assert not list((tmp_path / "models").glob("eval_*"))


def test_resume_reproduces_the_next_update(tmp_path):
    cfg = tiny_cfg()
    out1 = run(cfg, tmp_path, seed=13, max_episodes=2)
    s1 = out1["state"]
    assert s1.itera > 0
    # "restart the process": a fresh train() with resume, no new episodes
    out2 = run(cfg, tmp_path, seed=13, max_episodes=0, resume=True)
    s2 = out2["state"]
    assert s2.itera == s1.itera and s2 is not s1
    for a, b in zip(s1.actor.parameters(), s2.actor.parameters()):
        assert torch.equal(a, b)
    rng = np.random.default_rng(0)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    batch = {"obs": f(4, *HW), "pobs": f(4, 2), "act": f(4, 2),
             "rew": f(4, 1), "next_obs": f(4, *HW), "next_pobs": f(4, 2)}
    agent = SACAgent(cfg, device="cpu")
    _, m1 = agent.learn(s1, batch)
    _, m2 = agent.learn(s2, batch)
    # the same dropout masks and action noise (the generator's state is in
    # the checkpoint), the same Adam moments: bit-equal
    for k in m1:
        assert float(m1[k]) == float(m2[k]), k
    for kind in ("actor", "critic", "critic_target"):
        for a, b in zip(getattr(s1, kind).parameters(),
                        getattr(s2, kind).parameters()):
            assert torch.equal(a, b), kind
    assert s1.log_alpha.item() == s2.log_alpha.item()


def test_resume_without_a_checkpoint_starts_fresh(tmp_path):
    out = run(tiny_cfg(), tmp_path, max_episodes=0, resume=True)
    assert out["state"].itera == 0 and out["episodes"] == 0


def test_periodic_checkpoints_and_warm_replay_resume(tmp_path, monkeypatch):
    cfg = tiny_cfg(save_replay=True, save_interval=1)
    cfg.env.max_steps = 10
    run(cfg, tmp_path, seed=17, max_episodes=5)
    steps = list((tmp_path / "checkpoints").glob("step_*"))
    snaps = list((tmp_path / "checkpoints").glob("replay_step_*.npz"))
    assert snaps and 1 <= len(steps) <= 4 and len(snaps) <= 3
    seen = {}
    orig = train_rl.ReplayBuffer.load_transitions

    def spy(self, file):
        orig(self, file)
        seen["stored"] = self.get_stored_size()

    monkeypatch.setattr(train_rl.ReplayBuffer, "load_transitions", spy)
    run(cfg, tmp_path, seed=17, max_episodes=0, resume=True)
    assert seen.get("stored", 0) > 0, "resume did not reload transitions"


def test_prefetched_training_loop(tmp_path):
    cfg = tiny_cfg()
    cfg.sac.prefetch_batches = True
    out = run(cfg, tmp_path, seed=14, max_episodes=2)
    assert out["episodes"] >= 1 and out["state"].itera > 0
    # the worker was stopped and joined
    assert not [t for t in threading.enumerate()
                if t.name == "BatchPrefetcher"]


def test_if_test_loads_actor_and_critic_and_skips_learning(tmp_path):
    cfg = tiny_cfg()
    donor = SACAgent(cfg, device="cpu")
    donor_state = donor.init_state(99)
    actor_file, _ = donor.save(donor_state, "m", str(tmp_path / "ckpt"),
                               reward=1.0, seed=99)
    cfg2 = tiny_cfg(if_test=True,
                    test_model=actor_file[: -len("_actor.npz")])
    out = run(cfg2, tmp_path / "out", seed=8, max_episodes=1)
    st = out["state"]
    assert st.itera == 0
    for kind in ("critic", "critic_target"):
        for a, b in zip(donor_state.critic.parameters(),
                        getattr(st, kind).parameters()):
            assert torch.equal(a, b)
    for a, b in zip(donor_state.actor.parameters(), st.actor.parameters()):
        assert torch.equal(a, b)
    assert not (tmp_path / "out" / "checkpoints").exists()


def test_pre_train_warm_start_loads_actor_only(tmp_path):
    cfg = tiny_cfg()
    donor = SACAgent(cfg, device="cpu")
    donor_state = donor.init_state(123)
    ckpt.save_params_npz(str(tmp_path / "il"), "warm",
                         params_to_jax(donor_state.actor.state_dict()))
    cfg2 = tiny_cfg(pre_train=True,
                    pre_train_model=str(tmp_path / "il" / "warm"))
    out = run(cfg2, tmp_path / "out", seed=7, max_episodes=0)
    for a, b in zip(donor_state.actor.parameters(),
                    out["state"].actor.parameters()):
        assert torch.equal(a, b)
    fresh = SACAgent(cfg, device="cpu", seed=cfg.train.seed).init_state(
        cfg.train.seed)
    for a, b in zip(fresh.critic.parameters(),
                    out["state"].critic.parameters()):
        assert torch.equal(a, b)


def test_frame_stacked_loop(tmp_path):
    cfg = tiny_cfg()
    cfg.model.patch_mode = "channels"
    cfg.env.use_frame_stack = True
    cfg.env.max_steps = 8
    out = run(cfg, tmp_path, seed=11, max_episodes=2)
    assert out["episodes"] >= 1 and np.isfinite(out["max_mean_reward"])
    cfg.model.patch_mode = "2d"
    with pytest.raises(ValueError, match="channels"):
        run(cfg, tmp_path, max_episodes=1)
    stacker = train_rl.FrameStacker(3)
    ref = jax_train_rl.FrameStacker(3)
    a, b = np.zeros((2, 2)), np.ones((2, 2))
    np.testing.assert_array_equal(stacker.reset(a), ref.reset(a))
    np.testing.assert_array_equal(stacker.push(b), ref.push(b))
    assert stacker.push(b).shape == (3, 2, 2)


@pytest.mark.parametrize("flavour", ["train_elastic", "env_replay",
                                     "env_ros2", "reference_config"])
def test_unported_flavours_raise_by_name(tmp_path, flavour):
    cfg = tiny_cfg()
    word = {"env_replay": "--env replay", "env_ros2": "--env ros2",
            "reference_config": "--env replay"}.get(flavour, flavour)
    with pytest.raises(NotImplementedError, match=word):
        if flavour == "train_elastic":
            train_rl.train_elastic(cfg, lambda: None)
        elif flavour.startswith("env_"):
            train_rl.main(["--env", flavour[4:], "--device", "cpu",
                           "--out", str(tmp_path)])
        else:       # the translated config reaches the same refusal
            path = tmp_path / "config.yaml"
            path.write_text("SEED: 3\nGoT-SAC:\n  critic_type: CNN\n")
            train_rl.main(["--reference-config", str(path), "--env",
                           "replay", "--device", "cpu",
                           "--out", str(tmp_path)])
    assert not list(tmp_path.glob("*.jsonl"))      # nothing ran instead


# --------------------------------------------------------------------------
# prioritized replay in the host loop
# --------------------------------------------------------------------------

def per_transitions(n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.uniform(0, 1, sh).astype(np.float32)
    return {"obs": f(n, *HW), "act": rng.uniform(-1, 1, (n, 2)).astype(
                np.float32), "pobs": f(n, 2), "next_pobs": f(n, 2),
            "rew": rng.normal(0, 5, n).astype(np.float32),
            "next_obs": f(n, *HW), "engage": np.zeros(n, np.float32),
            "done": (rng.uniform(size=n) < 0.2).astype(np.float32)}


def jax_step_noise(jagent, state, rows, n_split):
    key = jax.random.fold_in(state.rng, state.itera)
    keys = jax.random.split(key, n_split)
    return tuple(np.array(jagent._row_noise_draw(
        jax.random.split(keys[i], 3)[0], rows, 2)) for i in (0, 2))


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_host_per_steps_match_jax(guided):
    """Three of the loop's PER steps on the same 24 transitions in the
    port's and the JAX package's C++ buffers (same seed): each step draws
    the same rows, the update's |TD errors| (which become the rows'
    priorities) agree, and a draw after them gives the same rows and
    importance weights: the priorities agree."""
    from dgvit_tpu.replay.buffer import PrioritizedReplayBuffer as JaxPER
    from dgvit_tpu_torch.replay import (PrioritizedReplayBuffer,
                                        reference_schema)

    d = dict(TINY, model=dict(TINY["model"], emb_dropout=0.0),
             sac=dict(TINY["sac"], prioritized_replay=True))
    cfg, jcfg = Config.from_dict(d), JaxConfig.from_dict(d)
    schema = reference_schema(HW, 2, 2)
    buf, jbuf = PrioritizedReplayBuffer(64, schema, seed=5), \
        JaxPER(64, schema, seed=5)
    rows = per_transitions(24, 0)
    buf.add(**rows)
    jbuf.add(**rows)
    expert = {k: v.reshape(4, -1) if k in ("rew", "done") else v
              for k, v in per_transitions(4, 1).items() if k != "engage"}
    jagent = JaxSACAgent(jcfg, row_noise=True)
    jstate = jagent.init_state(3)
    agent = SACAgent(cfg, device="cpu")
    state = sac_state_from_jax(agent, jax.tree_util.tree_map(np.asarray,
                                                             jstate))
    bs = cfg.sac.batch_size
    for _ in range(3):
        d_, jd = buf.sample(bs), jbuf.sample(bs)
        np.testing.assert_array_equal(d_["indexes"], jd["indexes"])
        np.testing.assert_allclose(d_["weights"], jd["weights"], rtol=1e-4)
        w, idx = d_.pop("weights"), d_.pop("indexes")
        jw = jd.pop("weights")
        jidx = jd.pop("indexes")
        if guided:
            noise = jax_step_noise(jagent, jstate, 2 * bs, 5)
            jstate, _, jtd = jagent.learn_guidence_per(
                jstate, jd, expert, 2, jw)
            state, _, td = agent.learn_guidence_per(state, d_, expert, 2, w,
                                                    noise=noise)
        else:
            d_.pop("engage")
            jd.pop("engage")
            noise = jax_step_noise(jagent, jstate, bs, 3)
            jstate, _, jtd = jagent.learn_per(jstate, jd, jw)
            state, _, td = agent.learn_per(state, d_, w, noise=noise)
        np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=1e-4,
                                   atol=1e-5)
        buf.update_priorities(idx, np.abs(td.numpy()) + 1e-6)
        jbuf.update_priorities(jidx, np.abs(np.asarray(jtd)) + 1e-6)
    after, jafter = buf.sample(64), jbuf.sample(64)
    np.testing.assert_array_equal(after["indexes"], jafter["indexes"])
    np.testing.assert_allclose(after["weights"], jafter["weights"],
                               rtol=1e-4)
    assert len(np.unique(after["weights"])) > 1


def spy_per(monkeypatch):
    """Count learn_per / learn_guidence_per and the priority updates."""
    from dgvit_tpu_torch.replay import PrioritizedReplayBuffer

    calls = {"per": 0, "guided_per": 0, "priorities": []}
    per, gper = SACAgent.learn_per, SACAgent.learn_guidence_per
    upd = PrioritizedReplayBuffer.update_priorities

    def spy_learn(self, *a, **k):
        calls["per"] += 1
        return per(self, *a, **k)

    def spy_guided(self, *a, **k):
        calls["guided_per"] += 1
        return gper(self, *a, **k)

    def spy_upd(self, idx, prios):
        calls["priorities"].append(np.asarray(prios).copy())
        return upd(self, idx, prios)

    monkeypatch.setattr(SACAgent, "learn_per", spy_learn)
    monkeypatch.setattr(SACAgent, "learn_guidence_per", spy_guided)
    monkeypatch.setattr(PrioritizedReplayBuffer, "update_priorities",
                        spy_upd)
    return calls


@pytest.mark.parametrize("flavour", ["plain", "prefetch", "guided"])
def test_per_training_loop_runs(tmp_path, monkeypatch, flavour):
    """train() with sac.prioritized_replay: every update is learn_per
    (PER takes precedence over prefetch_batches, as in the JAX loop's
    order) or, with the expert buffer, learn_guidence_per, each followed
    by a priority update of finite |td| + 1e-6."""
    cfg, kw = tiny_cfg(), {}
    cfg.sac.prioritized_replay = True
    cfg.sac.nan_guard = True
    if flavour == "prefetch":
        cfg.sac.prefetch_batches = True
    if flavour == "guided":
        cfg.train.pre_buffer = True
        kw["expert_glob"] = record_demos(tmp_path)
    calls = spy_per(monkeypatch)
    plain = spy_updates(monkeypatch)
    out = run(cfg, tmp_path / "run", max_episodes=2, **kw)
    n = calls["guided_per"] if flavour == "guided" else calls["per"]
    assert n > 0 and n == len(calls["priorities"]) == out["state"].itera
    assert plain["learn"] == 0 and not plain["guided"]
    for p in calls["priorities"]:
        assert p.shape == (cfg.sac.batch_size,)
        assert np.isfinite(p).all() and (p >= 1e-6).all()


class FakeTeleop:
    """A duck-typed intervention source (train_rl's `intervention`
    contract): always engaged, one fixed command."""

    def __init__(self):
        self.engaged = True
        self.reads = 0

    def read_action(self):
        self.reads += 1
        return [0.3, 0.2]


def record_demos(tmp_path, seed=1, episodes=2, max_steps=15):
    """Scripted demos recorded by the port, and the glob that finds them."""
    env = KinematicNavEnv(records(seed), image_hw=HW)
    paths = demo_record.record_episodes(
        env, demo_record.scripted_pilot, str(tmp_path / "Data"),
        episodes=episodes, max_steps=max_steps)
    assert paths
    return str(tmp_path / "Data" / "RRC" / "torch" / "*.npz")


def spy_updates(monkeypatch):
    """Count the agent's plain and guided updates, keeping the guided
    ones' engage flags and expert counts."""
    calls = {"learn": 0, "guided": []}
    learn, guided = SACAgent.learn, SACAgent.learn_guidence

    def spy_learn(self, *a, **k):
        calls["learn"] += 1
        return learn(self, *a, **k)

    def spy_guided(self, state, batch, expert, n_expert, *a, **k):
        calls["guided"].append((float(torch.as_tensor(
            batch["engage"]).sum()), int(n_expert)))
        return guided(self, state, batch, expert, n_expert, *a, **k)

    monkeypatch.setattr(SACAgent, "learn", spy_learn)
    monkeypatch.setattr(SACAgent, "learn_guidence", spy_guided)
    return calls


@pytest.mark.parametrize("flavour", ["expert_glob", "human_intervention",
                                     "intervention"])
def test_guided_flavours_run(tmp_path, monkeypatch, flavour):
    """The expert buffer (train.pre_buffer with demos), human intervention
    with a teleop source, and a teleop source alone run: the first two
    send every update through learn_guidence (with no expert buffer, on an
    all-masked expert batch), the last stores the teleop's commands with
    engage = 1 and updates with the plain learn, as the JAX trainer
    does."""
    cfg, kw = tiny_cfg(), {}
    tele = FakeTeleop()
    if flavour == "expert_glob":
        cfg.train.pre_buffer = True
        kw["expert_glob"] = record_demos(tmp_path)
    elif flavour == "human_intervention":
        cfg.train.human_intervention = True
        kw["intervention"] = tele
    else:
        kw["intervention"] = tele
    calls = spy_updates(monkeypatch)
    out = run(cfg, tmp_path / "run", max_episodes=2, **kw)
    assert out["episodes"] >= 1
    if flavour == "intervention":
        assert tele.reads > 0 and calls["learn"] > 0 and not calls["guided"]
        return
    assert calls["guided"] and calls["learn"] == 0
    if flavour == "expert_glob":
        assert all(k > 0 for _, k in calls["guided"])
    else:
        assert tele.reads > 0
        assert all(k == 0 and e == cfg.sac.batch_size
                   for e, k in calls["guided"])


def test_rl_training_with_expert_buffer(tmp_path, monkeypatch):
    """Mirrors tests/test_drivers.py:45: demos recorded with the port's own
    recorder, then training with train.pre_buffer and the expert buffer;
    the updates are guided, with expert_batch_size's count of valid expert
    rows."""
    glob_ = record_demos(tmp_path, seed=1)
    data = train_rl.load_expert_dataset(glob_)
    cfg = tiny_cfg(pre_buffer=True)
    calls = spy_updates(monkeypatch)
    out = run(cfg, tmp_path / "r2", seed=2, max_episodes=2,
              expert_glob=glob_)
    assert out["episodes"] >= 1 and calls["guided"]
    n = data["obs"].shape[0]
    stored = [cfg.sac.batch_size + i for i in range(len(calls["guided"]))]
    assert [k for _, k in calls["guided"]] == [
        SACAgent.expert_batch_size(n, m, cfg.sac.batch_size) for m in stored]


def test_human_intervention_engage_rows_reach_guided_step(tmp_path,
                                                          monkeypatch):
    """Mirrors tests/test_drivers.py:252: with train.human_intervention, an
    engaged teleop and no expert buffer, the loop reads the teleop's
    commands and every update is the guided one on engage = 1 rows."""
    cfg = tiny_cfg(human_intervention=True)
    tele = FakeTeleop()
    calls = spy_updates(monkeypatch)
    out = run(cfg, tmp_path, max_episodes=2, intervention=tele)
    assert tele.reads > 0 and out["episodes"] >= 1
    assert calls["guided"] and all(e > 0 for e, _ in calls["guided"])


def test_teleop_command_is_stored_in_policy_units(tmp_path, monkeypatch):
    """The executed command is the teleop's; the stored action is its
    inverse mapping (policy units, clipped), with engage = 1."""
    cfg = tiny_cfg(human_intervention=True)
    added = []
    real = train_rl.ReplayBuffer.add

    def spy_add(self, **kw):
        added.append(kw)
        return real(self, **kw)

    monkeypatch.setattr(train_rl.ReplayBuffer, "add", spy_add)
    env = Recorder(ScriptedEnv())
    commands = []
    step = env.env.step
    env.env.step = lambda a, t: (commands.append(list(a)), step(a, t))[1]
    train_rl.train(cfg, env, out_dir=str(tmp_path), max_episodes=1,
                   intervention=FakeTeleop(), device="cpu")
    e = cfg.env
    want = np.clip([0.3 / e.linear_cmd_scale - 1.0, 0.2 / e.angular_cmd_scale],
                   -1, 1)
    assert added and all(kw["engage"] == 1.0 for kw in added)
    np.testing.assert_allclose(added[0]["act"], want, rtol=1e-6)
    np.testing.assert_allclose(commands[1], [(want[0] + 1)
                                             * e.linear_cmd_scale,
                                             want[1] * e.angular_cmd_scale],
                               rtol=1e-6)


def test_demo_recorder_matches_jax(tmp_path):
    """The port's recorder writes the reference layout (the JAX package's
    tests/test_drivers.py test_demo_recorder_reference_layout) and, on the
    same env records and pilot, the same arrays as the JAX recorder."""
    from dgvit_tpu.train import demo_record as jax_demo

    rec = records(3)
    port = demo_record.record_episodes(
        KinematicNavEnv(rec, image_hw=HW), demo_record.scripted_pilot,
        str(tmp_path / "port"), episodes=1, max_steps=20)
    ref = jax_demo.record_episodes(
        JaxKinematicNavEnv(rec, image_hw=HW), jax_demo.scripted_pilot,
        str(tmp_path / "jax"), episodes=1, max_steps=20)
    d, j = np.load(port[0]), np.load(ref[0])
    assert set(d.files) == set(j.files) == {
        "obs", "act", "goal", "reward", "next_obs", "next_goal", "done"}
    n = d["obs"].shape[0]
    assert d["obs"].shape == (n, *HW) and d["act"].shape == (n, 2)
    assert d["goal"].shape == (n, 4) and d["done"].dtype == bool
    assert (np.abs(d["act"]).sum(1) > 0).all()     # no zero actions
    for k in d.files:
        np.testing.assert_allclose(d[k], j[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_load_demo_npz_matches_jax(tmp_path):
    """load_demo_npz concatenates in the order given and resizes a
    truncated field to the obs count (the reference's quirk guard), as
    the JAX package's does."""
    from dgvit_tpu.envs.replay_env import load_demo_npz as jax_load

    rng = np.random.default_rng(5)
    paths = []
    for i, n in enumerate((3, 5)):
        f = lambda *shape: rng.uniform(0, 1, shape).astype(np.float32)
        fields = dict(obs=f(n, *HW), act=f(n, 2), goal=f(n, 4),
                      reward=f(n - 1 if i else n), next_obs=f(n, *HW),
                      next_goal=f(n, 4), done=np.zeros(n, bool))
        paths.append(str(tmp_path / f"demo_{i}.npz"))
        np.savez(paths[-1], **fields)
    port, ref = load_demo_npz(paths), jax_load(paths)
    assert port["reward"].shape == (8,) and port["obs"].shape == (8, *HW)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_expert_files_load_in_natural_order(tmp_path):
    """The expert glob's files are concatenated in natural order (digit
    runs compared as numbers: 2.npz before 10.npz), as the reference's
    natsort orders them."""
    names = [f"{i}.npz" for i in (1, 10, 11, 12, 2, 3, 9)]
    assert sorted(names, key=train_rl.natural_key) == [
        f"{i}.npz" for i in (1, 2, 3, 9, 10, 11, 12)]
    assert sorted(["demo_b2", "demo_a10", "demo_a9"],
                  key=train_rl.natural_key) == ["demo_a9", "demo_a10",
                                                "demo_b2"]
    for i in range(1, 13):
        np.savez(tmp_path / f"{i}.npz", obs=np.full((1, *HW), i, np.float32),
                 act=np.zeros((1, 2)), goal=np.zeros((1, 4)),
                 reward=np.zeros(1), next_obs=np.zeros((1, *HW)),
                 next_goal=np.zeros((1, 4)), done=np.zeros(1, bool))
    data = train_rl.load_expert_dataset(str(tmp_path / "*.npz"))
    assert data["obs"][:, 0, 0].tolist() == list(range(1, 13))
    assert train_rl.load_expert_dataset(str(tmp_path / "none*.npz")) is None


@pytest.mark.parametrize("channels", [False, True])
def test_expert_buffer_frame_stack(tmp_path, channels):
    """With the online frame stack, single-frame demos are repeated to the
    stack depth and 4-channel demos go channels-first; without it,
    channel 0 of 4-channel demos is kept (the JAX trainer's to_stack)."""
    rng = np.random.default_rng(6)
    shape = (3, *HW, 4) if channels else (3, *HW)
    obs = rng.uniform(0, 1, shape).astype(np.float32)
    np.savez(tmp_path / "d.npz", obs=obs, act=np.ones((3, 2)),
             goal=np.zeros((3, 4)), reward=np.zeros(3), next_obs=obs,
             next_goal=np.zeros((3, 4)), done=np.zeros(3, bool))
    cfg = tiny_cfg()
    pattern = str(tmp_path / "*.npz")
    buf, n = train_rl.expert_buffer(cfg, pattern, (4, *HW), stacked=True)
    got = buf.sample(3)["obs"]
    want = obs.transpose(0, 3, 1, 2) if channels else np.repeat(
        obs[:, None], 4, axis=1)
    assert n == 3 and got.shape == (3, 4, *HW)
    assert all(any(np.array_equal(g, w) for w in want) for g in got)
    if channels:
        buf, _ = train_rl.expert_buffer(cfg, pattern, HW, stacked=False)
        got = buf.sample(3)["obs"]
        assert all(any(np.array_equal(g, w) for w in obs[..., 0])
                   for g in got)


def test_entry_points_without_a_card_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = KinematicNavEnv(records(0), image_hw=HW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_rl.train(tiny_cfg(), env, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_evaluate.run_eval(tiny_cfg(), env, {}, out_dir=str(tmp_path))


def test_command_lines(tmp_path, capsys):
    import yaml

    cfg = tiny_cfg()
    cfg.env.max_steps = 8
    cfg_yaml = tmp_path / "cfg.yaml"
    cfg_yaml.write_text(yaml.safe_dump(cfg.to_dict()))
    out = tmp_path / "run"
    train_rl.main(["--config", str(cfg_yaml), "--episodes", "1", "--out",
                   str(out), "--device", "cpu", "--world", "hospital"])
    assert "done: " in capsys.readouterr().out
    ckpt_dir = out / "checkpoints"
    assert ckpt.latest_checkpoint(str(ckpt_dir))
    common = ["--config", str(cfg_yaml), "--episodes", "1", "--device", "cpu",
              "--out", str(tmp_path / "eval")]
    port_evaluate.main(["--checkpoint", str(ckpt_dir), *common])
    assert "success rate: " in capsys.readouterr().out
    step = sorted(ckpt_dir.glob("step_*"))[0]
    port_evaluate.main(["--checkpoint", str(step), *common])
    actor = glob.glob(str(out / "models" / "*_actor.npz"))[0]
    port_evaluate.main(["--actor", actor, "--world", "hospital", *common])
    assert (tmp_path / "eval" / "testing_data.txt").read_text().count(
        "Model = ") == 3
    with pytest.raises(SystemExit):
        port_evaluate.main(["--checkpoint", str(ckpt_dir), "--actor", actor])
    with pytest.raises(SystemExit):
        port_evaluate.main(["--checkpoint", str(tmp_path / "nothing"),
                            *common])


# --------------------------------------------------------------------------
# deterministic runs against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """A JAX train state at the tiny geometry, as numpy, and its agent."""
    jcfg = tiny_cfg(JaxConfig)
    jagent = JaxSACAgent(jcfg)
    jstate = jagent.init_state(5)
    return jcfg, jagent, jstate, jax.tree_util.tree_map(np.asarray, jstate)


@pytest.mark.parametrize("world", ["rrc", "hospital"])
def test_run_eval_matches_jax_run_eval(tmp_path, carried, world):
    jcfg, _, jstate, tree = carried
    cfg = tiny_cfg()
    cfg.env.max_steps = jcfg.env.max_steps = 25
    jenv = Recorder(JaxKinematicNavEnv(records(2, world), image_hw=HW,
                                       world=world))
    env = Recorder(KinematicNavEnv(records(2, world), image_hw=HW,
                                  world=world))
    ref = jax_evaluate.run_eval(jcfg, jenv, jstate.actor_params,
                                max_episodes=6, out_dir=str(tmp_path / "j"))
    out = port_evaluate.run_eval(cfg, env, tree.actor_params,
                                 max_episodes=6, out_dir=str(tmp_path / "p"),
                                 device="cpu")
    jcfg.env.max_steps = 12
    assert [n for n, _ in env.episodes] == [n for n, _ in jenv.episodes]
    assert out["successes"] == ref["successes"]
    assert out["collisions"] == ref["collisions"]
    assert out["success_rate"] == ref["success_rate"]
    assert out["durations"] == ref["durations"]
    for (_, a), (_, b) in zip(env.episodes, jenv.episodes):
        assert abs(a - b) <= 1e-3
    assert sum(n for n, _ in env.episodes) >= 60
    assert (tmp_path / "p" / "testing_data.txt").read_text() == \
        (tmp_path / "j" / "testing_data.txt").read_text()


def test_trainer_evaluate_matches_jax_evaluate(carried):
    jcfg, jagent, jstate, tree = carried
    cfg = tiny_cfg()
    agent = SACAgent(cfg, device="cpu")
    state = sac_state_from_jax(agent, tree)
    from dgvit_tpu.core.rng import RngStream as JaxRngStream

    jenv = JaxKinematicNavEnv(records(4), image_hw=HW)
    env = KinematicNavEnv(records(4), image_hw=HW)
    ref = jax_train_rl.evaluate(jenv, jagent, jstate, JaxRngStream(0), 15,
                                0.25, 1.0, 1.0, eval_episodes=4)
    out = train_rl.evaluate(env, agent, state, 15, 0.25, 1.0, 1.0,
                            eval_episodes=4)
    assert out[1] == ref[1]                        # collisions
    assert abs(out[0] - ref[0]) <= 1e-3            # mean reward
    assert env.indice_position == jenv.indice_position


def test_params_round_trip_and_jax_loads_a_port_actor(tmp_path, carried):
    jcfg, _, jstate, tree = carried
    for kind in ("actor_params", "critic_params"):
        flat = {"/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    getattr(tree, kind))[0]}
        back = params_to_jax(params_from_jax(getattr(tree, kind)))
        assert sorted(back) == sorted(flat)
        for k in flat:
            assert back[k].shape == flat[k].shape
            np.testing.assert_array_equal(back[k], flat[k])
    # an actor saved by the port's trainer loads into the JAX package
    out = run(tiny_cfg(), tmp_path, max_episodes=1)
    path = glob.glob(str(tmp_path / "models" / "*_actor.npz"))[0]
    loaded = jckpt.load_params_npz(path, jstate.actor_params)
    want = params_to_jax(out["state"].actor.state_dict())
    leaves = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert len(leaves) == len(want)
    for p, v in leaves:
        np.testing.assert_array_equal(
            np.asarray(v), want["/".join(str(k.key) for k in p)])
    # and back into the port, with the same actions
    agent = SACAgent(tiny_cfg(), device="cpu")
    state = agent.init_state(0)
    state.actor.load_state_dict(params_from_jax(ckpt.load_params_npz(path)))
    obs = np.random.default_rng(0).uniform(0, 1, (3, *HW)).astype(np.float32)
    goal = np.zeros((3, 2), np.float32)
    a = agent.act_batch(state.actor, obs, goal, evaluate=True)
    b = agent.act_batch(out["state"].actor, obs, goal, evaluate=True)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# checkpoints, rng, metrics, config
# --------------------------------------------------------------------------

def test_train_state_checkpoint_round_trip(tmp_path):
    cfg = tiny_cfg()
    agent = SACAgent(cfg, device="cpu")
    state = agent.init_state(3)
    rng = np.random.default_rng(1)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    batch = {"obs": f(4, *HW), "pobs": f(4, 2), "act": f(4, 2),
             "rew": f(4, 1), "next_obs": f(4, *HW), "next_pobs": f(4, 2)}
    for _ in range(2):
        agent.learn(state, batch)
    path = ckpt.save_train_state(str(tmp_path), state.itera, state)
    assert os.path.basename(path) == "step_2"
    assert os.listdir(path) == ["train_state.pt"]
    other = ckpt.restore_train_state(path, agent.init_state(77))
    assert other.itera == 2
    assert other.log_alpha.item() == state.log_alpha.item()
    assert torch.equal(other.generator.get_state(),
                       state.generator.get_state())
    for name in ("actor_opt", "critic_opt", "alpha_opt"):
        a = getattr(state, name).state_dict()["state"]
        b = getattr(other, name).state_dict()["state"]
        assert a.keys() == b.keys() and len(a) > 0
        for k in a:
            for field in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(a[k][field], b[k][field])


def test_checkpoint_directory_helpers(tmp_path):
    d = tmp_path / "ck"
    assert ckpt.latest_checkpoint(str(d)) is None
    assert ckpt.prune_checkpoints(str(d)) == 0
    for n in (5, 20, 100, 7):
        (d / f"step_{n}").mkdir(parents=True)
        (d / f"replay_step_{n}.npz").write_bytes(b"")
    (d / "step_x").mkdir()
    assert ckpt.latest_checkpoint(str(d)) == jckpt.latest_checkpoint(str(d))
    assert ckpt.latest_checkpoint(str(d)).endswith("step_100")
    assert ckpt.prune_step_files(str(d), "replay_step", keep=2) == 2
    assert sorted(p.name for p in d.glob("*.npz")) == [
        "replay_step_100.npz", "replay_step_20.npz"]
    assert ckpt.prune_checkpoints(str(d), keep=3) == 1
    assert not (d / "step_5").exists() and (d / "step_x").exists()
    assert ckpt.prune_checkpoints(str(d), keep=0) == 3
    for args in (("eval_98_3", 12, 3407, 2), ("98", -5, 1)):
        assert ckpt.reference_name(*args) == jckpt.reference_name(*args)


def test_save_params_npz_layout_matches_jax(tmp_path, carried):
    _, _, jstate, tree = carried
    a = ckpt.save_params_npz(str(tmp_path / "p"), "m", tree.actor_params)
    b = jckpt.save_params_npz(str(tmp_path / "j"), "m", jstate.actor_params)
    assert os.path.basename(a) == os.path.basename(b) == "m_actor.npz"
    x, y = np.load(a), np.load(b)
    assert sorted(x.files) == sorted(y.files)
    for k in x.files:
        np.testing.assert_array_equal(x[k], y[k])
    c = ckpt.save_params_npz(str(tmp_path / "p"), "m",
                             ckpt.load_params_npz(a), kind="critic")
    assert c.endswith("m_critic.npz")


def test_metrics(tmp_path):
    curve, ref = RewardCurve(window=3), jmetrics.RewardCurve(window=3)
    assert curve.max_mean == ref.max_mean == float("-inf")
    for r in (1.0, -4.0, 10.0, 2.5, 7.0):
        assert curve.append(r) == ref.append(r)
    assert curve.means == ref.means and curve.max_mean == ref.max_mean
    curve.save_npy(str(tmp_path / "c" / "curve.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "c" / "curve.npy"),
                                  np.asarray(ref.means))
    curve.save_png(str(tmp_path / "c" / "curve.png"), title="t")
    log = MetricsLogger(str(tmp_path / "m"), "run")
    log.log(3, loss=torch.tensor(0.5), name="x", n=np.float32(2.0))
    log.append_txt("summary.txt", "line\n")
    row = json.loads((tmp_path / "m" / "run.jsonl").read_text())
    assert row["step"] == 3 and row["loss"] == 0.5 and row["name"] == "x"
    assert row["n"] == 2.0 and "wall_s" in row
    assert (tmp_path / "m" / "summary.txt").read_text() == "line\n"
    with Profiler(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert any(e.key for e in prof.key_averages())
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_config_fields_keep_the_jax_names_and_defaults():
    port, ref = Config(), JaxConfig()
    for section in ("env", "train", "sac", "model"):
        a, b = getattr(port, section), getattr(ref, section)
        for name, value in vars(a).items():
            assert hasattr(b, name), f"{section}.{name} is not a JAX field"
            assert value == getattr(b, name), f"{section}.{name}"
    with pytest.raises(KeyError, match="train.nope"):
        Config.from_dict({"train": {"nope": 1}})
    with pytest.raises(ValueError, match="vis_sensor"):
        Config.from_dict({"env": {"vis_sensor": "lidar"}})
    with pytest.raises(NotImplementedError, match="seq_shard"):
        Config.from_dict({"model": {"seq_shard": True}})
    with pytest.raises(ValueError, match="critic_type"):
        Config.from_dict({"model": {"critic_type": "MLP"}})
    d = tiny_cfg().to_dict()
    assert d["model"]["image_size"] == list(HW)
    assert Config.from_dict(d).to_dict() == d
