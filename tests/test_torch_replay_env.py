"""The port's recorded-data env (dgvit_tpu_torch/envs/replay_env.py)
against the JAX package's `ReplayEnv`, on the CPU: the same logged
transitions give the same states, rewards, flags, goals and divergences,
step for step (exact: both only slice and cast the same arrays), across
the end of the data and back (JAX tests/test_envs.py:127)."""

import numpy as np
import pytest

from dgvit_tpu.envs.replay_env import ReplayEnv as JaxReplayEnv
from dgvit_tpu_torch.envs import ReplayEnv
from dgvit_tpu_torch.envs.base import ResetResult, StepResult


def demo_data(n=5, hw=(32, 40), channels=4, seed=0, reward_len=None):
    rng = np.random.default_rng(seed)
    frame = (n, *hw, channels) if channels else (n, *hw)
    done = np.zeros(n, bool)
    done[2] = done[-1] = True
    return {"obs": rng.random(frame, np.float32),
            "act": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            "goal": rng.random((n, 4), np.float32),
            "reward": np.arange(reward_len or n, dtype=np.float32) - 1.0,
            "next_obs": rng.random(frame, np.float32),
            "next_goal": rng.random((n, 4), np.float32),
            "done": done}


def assert_same(port, ref):
    assert type(port) in (ResetResult, StepResult)
    assert port._fields == ref._fields
    for name, a, b in zip(port._fields, port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, name


def drive(env, steps, rng):
    out = [env.reset()]
    for t in range(steps):
        s = env.step(rng.uniform(-1, 1, 2), t)
        out.append(s)
        if s.done:
            out.append(env.reset())
    return out


@pytest.mark.parametrize("channels,channel,reward_len", [
    (4, 0, None), (4, 2, None), (4, None, None), (0, 0, None), (4, 0, 3)],
    ids=["ch0", "ch2", "all-channels", "2d-frames", "short-reward"])
def test_replay_env_matches_jax(channels, channel, reward_len):
    data = demo_data(channels=channels, reward_len=reward_len)
    port, ref = ReplayEnv(data=data, channel=channel), \
        JaxReplayEnv(data=data, channel=channel)
    got = drive(port, 12, np.random.default_rng(1))
    want = drive(ref, 12, np.random.default_rng(1))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same(a, b)
    assert port.divergence == ref.divergence and len(port.divergence) == 12
    assert port.collision == ref.collision == 0


def test_replay_env_episode_reward_and_target():
    """The JAX package's stepping test: five steps to the end of the
    episode, one divergence a step, the logged reward; target is done with
    a positive reward, and reset wraps to the start."""
    data = demo_data()
    data["done"][2] = False
    env = ReplayEnv(data=data)
    assert env.reset().state.shape == (32, 40, 1)
    steps, s = 0, None
    while s is None or not s.done:
        s = env.step([0.1, 0.0], steps)
        steps += 1
    assert steps == 5 and len(env.divergence) == 5
    assert s.reward == 3.0 and s.target
    np.testing.assert_array_equal(env.reset().state[..., 0],
                                  data["obs"][0, ..., 0])
    data["reward"][:] = -1.0
    env = ReplayEnv(data=data)
    env.reset()
    assert not [env.step([0, 0], t) for t in range(5)][-1].target


def test_replay_env_from_glob(tmp_path):
    """Files matching the pattern, sorted and concatenated, as JAX reads
    them; no match and no data are refused."""
    for i, seed in enumerate((3, 4)):
        np.savez(tmp_path / f"demo_{i}.npz", **demo_data(seed=seed))
    pattern = str(tmp_path / "demo_*.npz")
    port, ref = ReplayEnv(glob_pattern=pattern), \
        JaxReplayEnv(glob_pattern=pattern)
    assert port.n == ref.n == 10
    for a, b in zip(drive(port, 10, np.random.default_rng(2)),
                    drive(ref, 10, np.random.default_rng(2))):
        assert_same(a, b)
    with pytest.raises(FileNotFoundError):
        ReplayEnv(glob_pattern=str(tmp_path / "none_*.npz"))
    with pytest.raises(ValueError, match="glob_pattern"):
        ReplayEnv()
