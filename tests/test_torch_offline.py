"""The port's offline trainer (dgvit_tpu_torch/train/train_offline.py) and
`train_rl --env replay` against the JAX package's, on the CPU, at a tiny
geometry.

The same demos fill both packages' C++ sum-tree buffers (the same rows
drawn for the same seed). JAX's `train_offline` runs two updates; the port
resumes from JAX's state after the first through the checkpointer
contract (`resume(state) -> (state, step)`) and runs the second on the
same batch, with JAX's action noise injected and emb-dropout 0: every
parameter within 1e-5 of JAX's (a carried state, so Adam's moments are
not at their first step), the metrics rtol 1e-4 / atol 1e-5. The
sigma-noise augmentation draws from a generator of its own, keyed by the
step, so the update's draws do not move and a resumed run draws the noise
of the run without the break. PER runs `learn_per` and writes |td| + 1e-6
as the sampled rows' priorities (JAX tests/test_sac.py:253).
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml as pyyaml

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.train import train_offline as jax_offline
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.rng import generator
from dgvit_tpu_torch.models.jax_io import params_from_jax, sac_state_from_jax
from dgvit_tpu_torch.train import train_offline, train_rl

HW = (32, 40)
N = 24
TINY = {"model": {"block": 2, "head": 2, "latent_size": 32, "dim_head": 16,
                  "mlp_dim": 64, "image_size": list(HW), "emb_dropout": 0.0},
        "sac": {"batch_size": 4, "buffer_size": 16},
        "train": {"seed": 5}}


def demos(seed=0, n=N, channels=True):
    rng = np.random.default_rng(seed)
    frame = (n, *HW, 4) if channels else (n, *HW)
    done = np.zeros(n, bool)
    done[n // 2 - 1] = done[-1] = True
    return {"obs": rng.random(frame, np.float32),
            "act": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            "goal": rng.random((n, 4), np.float32),
            "reward": rng.normal(0, 1, n - 3).astype(np.float32),
            "next_obs": rng.random(frame, np.float32),
            "next_goal": rng.random((n, 4), np.float32),
            "done": done}


def tiny(cls=Config, **sac):
    cfg = cls.from_dict(TINY)
    for k, v in sac.items():
        setattr(cfg.sac, k, v)
    return cfg


class Recorder:
    """The checkpointer contract: resume hands back `start` (a state
    maker and a step), maybe_save records the steps and a copy of what it
    is offered."""

    def __init__(self, start=None, keep=lambda s: None):
        self.start, self.keep = start, keep
        self.resumed, self.saved = [], []

    def resume(self, state):
        self.resumed.append(state)
        if self.start is None:
            return state, 0
        make, step = self.start
        return make(), step

    def maybe_save(self, step, state):
        self.saved.append((step, self.keep(state)))


def plain_noise(state, b, a=2):
    """The action noise JAX's plain update draws at `state` (no row
    noise): the TD target's next action, then the policy's."""
    key = jax.random.fold_in(state.rng, state.itera)
    k_tgt, _, k_act = jax.random.split(key, 3)
    return tuple(np.asarray(jax.random.normal(jax.random.split(k, 3)[0],
                                              (b, a), jnp.float32))
                 for k in (k_tgt, k_act))


def test_fill_buffer_matches_jax():
    """The same rows in the same buffer layout: channel 0 of the frames,
    the goal's first two values, the reward resized, engage 0; the same
    draw for the same seed."""
    data = demos()
    port = train_offline.fill_buffer_from_demos(data, tiny())
    ref = jax_offline.fill_buffer_from_demos(data, tiny(JaxConfig))
    assert port.prioritized and port.capacity == N == ref.capacity
    assert port.get_stored_size() == ref.get_stored_size() == N
    a, b = port.sample(8), ref.sample(8)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rows = a["indexes"]
    np.testing.assert_array_equal(a["obs"], data["obs"][rows, ..., 0])
    np.testing.assert_array_equal(a["pobs"], data["goal"][rows, :2])
    np.testing.assert_array_equal(a["rew"].reshape(-1),
                                  np.resize(data["reward"], N)[rows])
    assert not a["engage"].any()


@pytest.fixture(scope="module")
def jax_two_updates(tmp_path_factory):
    """JAX's train_offline for two updates, the state after each."""
    out = tmp_path_factory.mktemp("jax")
    cfg = tiny(JaxConfig)
    buf = jax_offline.fill_buffer_from_demos(demos(), cfg)
    rec = Recorder(keep=lambda s: jax.tree_util.tree_map(np.asarray, s))
    state, stats = jax_offline.train_offline(cfg, buf, steps=2,
                                             out_dir=str(out),
                                             checkpointer=rec)
    assert [s for s, _ in rec.saved] == [1, 2]
    return rec.saved[0][1], jax.tree_util.tree_map(np.asarray, state), stats


def test_one_update_matches_jax(jax_two_updates, tmp_path, monkeypatch):
    s1, s2, stats = jax_two_updates
    cfg = tiny()
    agent = SACAgent(cfg, device="cpu", seed=5)
    noise = plain_noise(jax.tree_util.tree_map(jnp.asarray, s1), 4)
    learn = SACAgent.learn
    monkeypatch.setattr(SACAgent, "learn", lambda self, st, b: learn(
        self, st, b, noise=noise))
    buf = train_offline.fill_buffer_from_demos(demos(), cfg)
    buf.sample(4)                   # JAX's first update drew this batch
    rec = Recorder(start=(lambda: sac_state_from_jax(agent, s1), 1))
    state, port_stats = train_offline.train_offline(
        cfg, buf, steps=2, out_dir=str(tmp_path), checkpointer=rec,
        device="cpu")
    assert len(rec.resumed) == 1 and [s for s, _ in rec.saved] == [2]
    assert state.itera == int(s2.itera) == 2
    for kind, key in (("actor", "actor_params"), ("critic", "critic_params"),
                      ("critic_target", "critic_target_params")):
        ref = params_from_jax(getattr(s2, key))
        for name, p in getattr(state, kind).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{kind}.{name}")
    for k, v in stats["final"].items():
        np.testing.assert_allclose(port_stats["final"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def assert_noised(raw, aug, step, sigma=50.0, seed=5):
    """`aug` is `raw` with obs + sigma / 255 x N(0, 1) drawn from the seed
    augment_key(seed, step), clipped to [0, 1], and every other key
    unchanged."""
    gen = generator(train_offline.augment_key(seed, step))
    noise = torch.randn(raw["obs"].shape, generator=gen)
    want = torch.clamp(raw["obs"] + sigma / 255.0 * noise, 0.0, 1.0)
    torch.testing.assert_close(aug["obs"], want, rtol=0, atol=0)
    for k in raw:
        if k != "obs":
            assert torch.equal(aug[k], raw[k]), k
    assert not torch.equal(aug["obs"], raw["obs"])


def test_augment_noise_has_its_own_stream(tmp_path, monkeypatch):
    """augment_sigma adds sigma / 255 x N(0, 1) to obs alone, clipped to
    [0, 1], from a generator of its own seeded augment_key(train.seed,
    step) at every step; with emb-dropout live the update's generator
    ends where the run without the noise ends."""
    cfg = tiny()
    cfg.model.emb_dropout = 0.1
    seen = []
    learn = SACAgent.learn
    monkeypatch.setattr(SACAgent, "learn", lambda self, st, b: (
        seen.append({k: v.clone() for k, v in b.items()}),
        learn(self, st, b))[1])
    ends, batches = {}, {}
    for sigma in (0.0, 50.0):
        seen.clear()
        buf = train_offline.fill_buffer_from_demos(demos(), cfg)
        state, _ = train_offline.train_offline(
            cfg, buf, steps=3, out_dir=str(tmp_path), augment_sigma=sigma,
            device="cpu")
        ends[sigma] = state.generator.get_state()
        batches[sigma] = list(seen)
    assert torch.equal(ends[0.0], ends[50.0])
    for step, (raw, aug) in enumerate(zip(batches[0.0], batches[50.0])):
        assert_noised(raw, aug, step)


class ResumeAt:
    """The checkpointer contract, resuming at `step` with the state as
    given."""

    def __init__(self, step):
        self.step = step

    def resume(self, state):
        return state, self.step

    def maybe_save(self, step, state):
        pass


def test_resumed_run_draws_the_unbroken_noise(tmp_path, monkeypatch):
    """A run resumed at step 2 draws, at steps 2 and 3, the obs noise of
    the run without the break (each step's generator state equal, each
    augmented batch the step's noise over its raw one): the noise is keyed
    by the step, as JAX folds the step into its key."""
    cfg = tiny()
    calls = []
    augment = train_offline.augment_obs

    def spy(batch, sigma, gen):
        state = gen.get_state().clone()
        out = augment(batch, sigma, gen)
        calls.append((state, batch, out))
        return out

    monkeypatch.setattr(train_offline, "augment_obs", spy)
    runs = {}
    for start in (0, 2):
        calls.clear()
        buf = train_offline.fill_buffer_from_demos(demos(), cfg)
        train_offline.train_offline(
            cfg, buf, steps=4, out_dir=str(tmp_path), augment_sigma=50.0,
            checkpointer=ResumeAt(start), device="cpu")
        runs[start] = list(calls)
        for step, (_, raw, aug) in enumerate(calls, start):
            assert_noised(raw, aug, step)
    assert len(runs[0]) == 4 and len(runs[2]) == 2
    for (resumed, _, _), (unbroken, _, _) in zip(runs[2], runs[0][2:]):
        assert torch.equal(resumed, unbroken)
    assert not torch.equal(runs[0][0][0], runs[0][2][0])


def test_per_updates_priorities(tmp_path, monkeypatch):
    """With sac.prioritized_replay the updates are learn_per's and the
    sampled rows get |td| + 1e-6; with augment_sigma they are plain
    (JAX's rule)."""
    cfg = tiny(prioritized_replay=True)
    calls = {"per": [], "plain": 0}
    learn, learn_per = SACAgent.learn, SACAgent.learn_per

    def counting_per(self, st, b, w):
        out = learn_per(self, st, b, w)
        calls["per"].append(out[2].clone())
        return out

    def counting(self, st, b):
        calls["plain"] += 1
        return learn(self, st, b)

    monkeypatch.setattr(SACAgent, "learn_per", counting_per)
    monkeypatch.setattr(SACAgent, "learn", counting)
    buf = train_offline.fill_buffer_from_demos(demos(), cfg)
    written = []
    update = buf.update_priorities
    buf.update_priorities = lambda idx, pr: (
        written.append((np.array(idx), np.array(pr))), update(idx, pr))[1]
    state, stats = train_offline.train_offline(cfg, buf, steps=3,
                                               out_dir=str(tmp_path),
                                               log_every=1, device="cpu")
    assert len(calls["per"]) == 3 and calls["plain"] == 0
    assert np.isfinite(stats["final"]["policy_loss"])
    for td, (idx, pr) in zip(calls["per"], written):
        assert idx.shape == (4,)
        np.testing.assert_allclose(pr, np.abs(td.numpy()) + 1e-6,
                                   rtol=1e-6)
    lines = (tmp_path / "offline.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3]
    buf = train_offline.fill_buffer_from_demos(demos(), cfg)
    train_offline.train_offline(cfg, buf, steps=2, out_dir=str(tmp_path),
                                augment_sigma=2.0, device="cpu")
    assert len(calls["per"]) == 3 and calls["plain"] == 2


def test_main_saves_a_train_state(tmp_path):
    """The CLI: demos by glob, N updates, --save writes a train state that
    restores with its counter."""
    for i in range(2):
        np.savez(tmp_path / f"demo_{i}.npz", **demos(seed=i, n=12))
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(pyyaml.safe_dump(Config.from_dict(TINY).to_dict()))
    out = tmp_path / "run"
    stats = train_offline.main([
        "--data-glob", str(tmp_path / "demo_*.npz"), "--steps", "2",
        "--out", str(out), "--save", "--config", str(yaml),
        "--device", "cpu"])
    assert stats["steps_per_sec"] > 0
    path = ckpt.latest_checkpoint(str(out / "checkpoints"))
    agent = SACAgent(Config.from_dict(TINY), device="cpu")
    assert ckpt.restore_train_state(path, agent.init_state()).itera == 2


def test_env_replay_trains(tmp_path):
    """`train_rl --env replay` steps a ReplayEnv over the --expert-glob
    demos (JAX train_rl.py:490-492): the logged frames drive the episode
    and the trainer writes its metrics."""
    data = demos(n=12)
    data["done"][:] = False
    data["done"][-1] = True
    np.savez(tmp_path / "demo_0.npz", **data)
    cfg = Config.from_dict(TINY)
    cfg.env.max_steps = 20
    cfg.train.pre_buffer = False
    cfg.train.plot_interval = 1000
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(pyyaml.safe_dump(cfg.to_dict()))
    out = tmp_path / "run"
    train_rl.main(["--env", "replay", "--expert-glob",
                   str(tmp_path / "demo_*.npz"), "--config", str(yaml),
                   "--episodes", "1", "--device", "cpu", "--out", str(out)])
    assert glob.glob(str(out / "*.jsonl"))
