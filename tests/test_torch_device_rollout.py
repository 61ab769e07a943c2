"""The device-rollout loop of the port (dgvit_tpu_torch/train/device_rollout.py
and run_eval(..., device_rollout_loop=True)) on the CPU.

JAX runs the episode as one jitted lax.scan with the env behind an ordered
io_callback; its own test is slow-marked, so the scan is not run here.
Its semantics are written out instead as a host loop over the JAX
package's actor and env (`scan_reference`): the env stepped on every one
of max_steps steps with t = 0 and zero commands after the end, reward and
target zeroed after it, steps = sum(dones == 0) + min(sum(dones > 0), 1).
The port's RolloutResult is held to it on the same parameters and
records: dones, targets and steps equal, the clipped actions within
ACTION_TOL, the rewards within REWARD_TOL (fp32 actions of the two
packages differ by a few ulps). run_eval's device-rollout report equals
the host loop's in successes, success rate and durations; its collision
count is the env's, which keeps counting while a collided robot sits
through the frozen steps (JAX's quirk, kept), and equals the reference's.
"""

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.envs import KinematicNavEnv as JaxKinematicNavEnv
from dgvit_tpu.models import build_actor as jax_build_actor
from dgvit_tpu.serve import make_action_fn as jax_action_fn
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs.base import ResetResult, StepResult
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.serve import make_action_fn
from dgvit_tpu_torch.train import evaluate
from dgvit_tpu_torch.train.device_rollout import RolloutResult, device_rollout

HW = (32, 40)
MAX_STEPS, EPISODES = 30, 8
ACTION_TOL = 1e-6    # clipped fp32 actions of the two packages
REWARD_TOL = 1e-4    # rewards of tens, moved by those actions' ulps
PARAM_SEED, RECORD_SEED = 2, 5   # episodes with goals and collisions


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(cls=Config, **model):
    return cls.from_dict({
        "model": {"block": 1, "head": 2, "latent_size": 16, "mlp_dim": 32,
                  "image_size": HW, "patch_size": (16, 20), **model},
        "env": {"max_steps": MAX_STEPS}})


@pytest.fixture(scope="module")
def setup():
    jcfg = cfg_of(JaxConfig)
    params = jax_build_actor(jcfg).init(
        jax.random.PRNGKey(PARAM_SEED), np.zeros((1, *HW)),
        np.zeros((1, 2)))["params"]
    return jcfg, params, default_records(seed=RECORD_SEED)


def port_state(cfg, params):
    agent = SACAgent(cfg, device="cpu")
    actor = make_action_fn(cfg, params, dtype=torch.float32,
                           device="cpu").policy
    return agent, type("State", (), {"actor": actor})()


def scan_reference(env, act, max_steps, l_scale, a_scale):
    """JAX's device_rollout scan body (dgvit_tpu/train/device_rollout.py:
    83-99) as a host loop: (rewards, dones, actions, steps, targets)."""
    r = env.reset()
    obs, goal, ended = r.state[..., 0], r.to_goal, 0.0
    rews, dones, acts, targets = [], [], [], []
    for _ in range(max_steps):
        a = np.clip(np.asarray(act(obs[None], goal[None, :2]))[0], -1.0,
                    1.0).astype(np.float32)
        a_in = np.array([(a[0] + 1.0) * l_scale, a[1] * a_scale],
                        np.float32)
        if ended > 0:
            a_in = np.zeros_like(a_in)
        s = env.step([float(a_in[0]), float(a_in[1])], 0)
        rews.append(0.0 if ended > 0 else s.reward)
        targets.append(0.0 if ended > 0 else float(s.target))
        ended = max(ended, float(s.done))
        dones.append(ended)
        acts.append(a)
        obs, goal = s.state[..., 0], s.to_goal
    dones = np.asarray(dones, np.float32)
    steps = int((dones == 0).sum()) + min(int((dones > 0).sum()), 1)
    return (np.asarray(rews, np.float32), dones, np.stack(acts), steps,
            np.asarray(targets, np.float32))


def test_rollout_result_matches_the_scan_reference(setup):
    jcfg, params, recs = setup
    cfg = cfg_of()
    agent, state = port_state(cfg, params)
    jact = jax.jit(jax_action_fn(jcfg, params))
    env, jenv = (KinematicNavEnv(recs, image_hw=HW),
                 JaxKinematicNavEnv(recs, image_hw=HW))
    e = cfg.env
    ended_early = hits = 0
    for ep in range(EPISODES):
        out = device_rollout(agent, state, env, MAX_STEPS,
                             e.linear_cmd_scale, e.angular_cmd_scale,
                             seed=ep)
        assert isinstance(out, RolloutResult)
        rews, dones, acts, steps, targets = scan_reference(
            jenv, jact, MAX_STEPS, e.linear_cmd_scale, e.angular_cmd_scale)
        assert out.rewards.shape == (MAX_STEPS,)
        assert out.actions.shape == (MAX_STEPS, 2)
        np.testing.assert_array_equal(out.dones.numpy(), dones)
        np.testing.assert_array_equal(out.targets.numpy(), targets)
        assert int(out.steps) == steps and out.steps.dtype == torch.int32
        np.testing.assert_allclose(out.actions.numpy(), acts, rtol=0,
                                   atol=ACTION_TOL)
        np.testing.assert_allclose(out.rewards.numpy(), rews, rtol=0,
                                   atol=REWARD_TOL)
        assert (np.abs(out.actions.numpy()) <= 1.0).all()
        ended_early += int(dones[-1] > 0)
        hits += int(targets.sum() > 0)
        assert env.collision == jenv.collision
    assert ended_early > hits > 0    # goals and collisions both ran


class Scripted:
    """An env that ends its episode at step `end` (done, target when
    `reach`) and records every step's command and t."""

    DT = 0.1

    def __init__(self, end=3, reach=True):
        self.end, self.reach = end, reach
        self.calls, self.n = [], 0

    def _frame(self):
        return np.full((*HW, 1), 0.5, np.float32)

    def reset(self):
        self.n = 0
        return ResetResult(state=self._frame(), xR=0.0, yR=0.0,
                           to_goal=np.array([0.5, 0.1, 0, 0], np.float32))

    def step(self, action, t):
        self.calls.append((list(action), t))
        self.n += 1
        done = self.n >= self.end
        return StepResult(state=self._frame(), reward=float(self.n),
                          done=done, to_goal=np.array([0.5, 0.1, 0, 0],
                                                      np.float32),
                          target=done and self.reach)


def test_env_stepped_every_step_with_t0_and_frozen_commands(setup):
    _, params, _ = setup
    cfg = cfg_of()
    agent, state = port_state(cfg, params)
    env = Scripted(end=3)
    out = device_rollout(agent, state, env, 12, 0.25, 1.0)
    assert len(env.calls) == 12                       # every step
    assert {t for _, t in env.calls} == {0}           # t = 0 always
    assert all(c != [0.0, 0.0] for c, _ in env.calls[:3])
    assert all(c == [0.0, 0.0] for c, _ in env.calls[3:])   # frozen
    np.testing.assert_array_equal(out.rewards.numpy()[:3], [1, 2, 3])
    assert (out.rewards.numpy()[3:] == 0).all()       # zeroed after the end
    np.testing.assert_array_equal(out.targets.numpy(),
                                  [0, 0, 1] + [0] * 9)
    np.testing.assert_array_equal(out.dones.numpy(), [0, 0] + [1] * 10)
    assert int(out.steps) == 3                        # 2 + min(10, 1)
    # the commands are the clipped actions scaled
    a = out.actions.numpy()[0]
    np.testing.assert_allclose(env.calls[0][0], [(a[0] + 1) * 0.25, a[1]],
                               rtol=1e-6)
    # an episode that never ends counts every step
    never = device_rollout(agent, state, Scripted(end=99), 12, 0.25, 1.0)
    assert int(never.steps) == 12 and not never.dones.numpy().any()


def test_run_eval_device_rollout_report(setup, tmp_path):
    jcfg, params, recs = setup
    cfg = cfg_of()
    host = evaluate.run_eval(cfg, KinematicNavEnv(recs, image_hw=HW), params,
                             EPISODES, str(tmp_path), device="cpu")
    out = evaluate.run_eval(cfg, KinematicNavEnv(recs, image_hw=HW), params,
                            EPISODES, str(tmp_path), device="cpu",
                            device_rollout_loop=True)
    for key in ("successes", "success_rate", "durations"):
        assert out[key] == host[key]
    assert host["successes"] > 0 and host["collisions"] > 0
    # the collision count of the frozen steps, as JAX's scan leaves it
    jenv = JaxKinematicNavEnv(recs, image_hw=HW)
    jact = jax.jit(jax_action_fn(jcfg, params))
    for _ in range(EPISODES):
        scan_reference(jenv, jact, MAX_STEPS, cfg.env.linear_cmd_scale,
                       cfg.env.angular_cmd_scale)
    assert out["collisions"] == jenv.collision > host["collisions"]


def test_device_rollout_cli(setup, tmp_path):
    import yaml

    from dgvit_tpu_torch.core import checkpoint as ckpt

    _, params, _ = setup
    cfg = cfg_of()
    npz = ckpt.save_params_npz(str(tmp_path), "rollout", params)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    evaluate.main(["--actor", npz, "--config", str(path), "--episodes", "2",
                   "--device-rollout", "--device", "cpu",
                   "--out", str(tmp_path / "cli")])
    assert (tmp_path / "cli" / "testing_data.txt").exists()


def test_channels_mode_raises(setup, tmp_path):
    cfg = cfg_of(patch_mode="channels")
    with pytest.raises(ValueError, match="channels"):
        evaluate.run_eval(cfg, Scripted(), {}, 1, str(tmp_path),
                          device="cpu", device_rollout_loop=True)
