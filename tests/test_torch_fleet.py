"""Fleet serving in the port (dgvit_tpu_torch/serve/fleet.py and
train/evaluate.py::run_eval_fleet) on the CPU, mirroring the JAX package's
tests/test_fleet.py case for case, and held against the JAX package.

N robots share one BatchingActorServer (the port's make_action_fn, plain
PyTorch on the CPU): the batched fleet matches a direct run, requests
coalesce, the reference evaluation semantics hold per robot (bad-init
exclusion from the counters, the stream and the reward; sim-clock
durations; a dead robot's error on its report), and the namespaced ROS 2
adapters run over tests/fake_ros2.py. Against JAX: run_eval_fleet of
both packages on the same actor parameters and env records, each server
pinned to bucket (1,) so every dispatch is one frame, gives each robot's
commands within ACTION_TOL (fp32 on both sides) and equal successes,
collisions and durations.
"""

import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.envs import KinematicNavEnv as JaxKinematicNavEnv
from dgvit_tpu.models import build_actor as jax_build_actor
from dgvit_tpu.train import evaluate as jax_evaluate
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.serve import (BatchingActorServer, FleetRunner,
                                   make_action_fn, serve_fleet)
from dgvit_tpu_torch.serve.fleet import fleet_buckets
from dgvit_tpu_torch.train import evaluate

import fake_ros2
from test_torch_ros2_adapter import drop_port_adapter

HW = (32, 40)
# fp32 commands of the two packages on the same actor differ by the two
# libraries' summation orders: at most 1.2e-7 here (one fp32 ulp at 1)
ACTION_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fleet_cfg(max_steps=12, cls=Config):
    return cls.from_dict({
        "model": {"block": 1, "head": 2, "latent_size": 16, "mlp_dim": 32,
                  "image_size": HW, "patch_size": (16, 20)},
        "env": {"max_steps": max_steps},
    })


def jax_params(cfg_dict_cls=JaxConfig, seed=0, hw=HW, cfg=None):
    cfg = cfg or fleet_cfg(cls=cfg_dict_cls)
    return jax_build_actor(cfg).init(
        jax.random.PRNGKey(seed), np.zeros((1, *hw)),
        np.zeros((1, 2)))["params"]


_RECORDS = {}


def records(seed):
    """The start/goal records of a seed, drawn once (the port's sampler
    equals the JAX package's, tests/test_torch_envs.py)."""
    if seed not in _RECORDS:
        _RECORDS[seed] = default_records(seed=seed)
    return _RECORDS[seed]


@pytest.fixture(scope="module")
def actor_setup():
    cfg = fleet_cfg()
    act = make_action_fn(cfg, jax_params(), dtype=torch.float32,
                         device="cpu")
    return cfg, act


def _kin_envs(n):
    return [KinematicNavEnv(records(100 + i), image_hw=HW) for i in range(n)]


def direct(act):
    return lambda o, g: act(o[None], g[None])[0]


def test_fleet_buckets_capped_at_the_fleet():
    assert fleet_buckets(6) == (1, 2, 4, 6)
    assert fleet_buckets(8) == (1, 2, 4, 8)
    assert fleet_buckets(1) == (1,)
    assert fleet_buckets(100) == (1, 2, 4, 8, 16, 32, 64, 100)


def test_fleet_matches_direct_run(actor_setup):
    cfg, act = actor_setup
    n = 4
    # bucket 1: every dispatch the shape of the direct batch-1 calls
    with BatchingActorServer(act, max_wait_ms=30.0, buckets=(1,)) as srv:
        out_srv = FleetRunner(_kin_envs(n), srv, cfg).run(
            episodes_per_robot=2)
    out_dir = FleetRunner(_kin_envs(n), direct(act), cfg).run(
        episodes_per_robot=2)

    assert out_srv["episodes"] == out_dir["episodes"] == 2 * n
    assert out_srv["successes"] == out_dir["successes"]
    assert out_srv["collisions"] == out_dir["collisions"]
    assert out_srv["bad_inits"] == out_dir["bad_inits"]
    np.testing.assert_allclose(out_srv["durations"], out_dir["durations"])
    np.testing.assert_allclose(out_srv["total_reward"],
                               out_dir["total_reward"], rtol=1e-4)
    assert [r.robot for r in out_srv["per_robot"]] == list(range(n))
    assert sum(r.successes for r in out_srv["per_robot"]) == \
        out_srv["successes"]


def test_fleet_coalesces_requests(actor_setup):
    cfg, act = actor_setup
    n = 6
    out = serve_fleet(cfg, _kin_envs(n), act, episodes_per_robot=1,
                      max_wait_ms=50.0)
    st = out["serving"]
    assert st["requests"] == st["rows"] >= n  # one per robot-step
    assert st["dispatches"] < st["requests"]
    assert st["mean_batch"] > 1.0
    dt = KinematicNavEnv.DT
    for d in out["durations"]:
        assert abs(d / dt - round(d / dt)) < 1e-6
        assert d <= cfg.env.max_steps * dt + 1e-9


def test_fleet_partial_failure_returns_completed_reports(actor_setup):
    cfg, act = actor_setup

    class Boom:
        def reset(self):
            raise RuntimeError("sensor offline")

    envs = _kin_envs(2) + [Boom()]
    out = serve_fleet(cfg, envs, act, episodes_per_robot=2, max_wait_ms=30.0)
    assert out["errors"] == {2: "RuntimeError: sensor offline"}
    assert out["per_robot"][2].error == "RuntimeError: sensor offline"
    assert out["episodes"] == 4
    assert all(r.error is None and r.episodes == 2
               for r in out["per_robot"][:2])
    assert out["serving"]["rows"] >= 4

    # the strict eval caller turns attached errors back into a failure
    with mock.patch.object(evaluate, "KinematicNavEnv",
                           side_effect=lambda **kw: Boom()), \
            pytest.raises(RuntimeError, match="fleet eval incomplete"):
        evaluate.run_eval_fleet(cfg, jax_params(), max_episodes=2,
                                n_robots=2, device="cpu")


def test_fleet_mid_campaign_death_keeps_finished_episodes(actor_setup):
    cfg, act = actor_setup

    class DiesAfterOneEpisode:
        def __init__(self, inner):
            self.inner = inner
            self.resets = 0
            self.DT = inner.DT

        def reset(self):
            self.resets += 1
            if self.resets > 1:
                raise RuntimeError("battery died")
            return self.inner.reset()

        def step(self, a, t):
            return self.inner.step(a, t)

    envs = [_kin_envs(1)[0], DiesAfterOneEpisode(_kin_envs(2)[1])]
    out = FleetRunner(envs, direct(act), cfg).run(episodes_per_robot=2)
    assert out["errors"] == {1: "RuntimeError: battery died"}
    assert out["per_robot"][0].episodes == 2
    assert out["per_robot"][1].episodes == 1
    assert out["episodes"] == 3


def _still(hw=HW):
    from dgvit_tpu_torch.envs.base import ResetResult
    return ResetResult(state=np.zeros((*hw, 1), np.float32), xR=0.0, yR=0.0,
                       to_goal=np.zeros(4, np.float32))


def test_bad_init_episode_excluded_from_stream_and_reward(actor_setup):
    cfg, act = actor_setup
    from dgvit_tpu_torch.envs.base import StepResult

    class BadInit:
        DT = 0.1

        def reset(self):
            return _still()

        def step(self, a, t):
            return StepResult(state=np.zeros((*HW, 1), np.float32),
                              reward=-100.0, done=True,
                              to_goal=np.zeros(4, np.float32), target=False)

    rows = []
    out = FleetRunner([BadInit()], direct(act), cfg,
                      on_transition=lambda *tr: rows.append(tr)).run(1)
    assert out["bad_inits"] == 1 and out["episodes"] == 0
    assert rows == []
    assert out["total_reward"] == 0.0


def test_fleet_durations_use_sim_clock_when_available(actor_setup):
    cfg, act = actor_setup
    from dgvit_tpu_torch.envs.base import StepResult

    class ClockedEnv:
        DT = 0.1

        def __init__(self):
            self.t = 0.0

        def sim_now(self):
            return self.t

        def reset(self):
            self.t = 5.0
            return _still()

        def step(self, a, t):
            self.t += 0.25  # free-running at real-time factor 2.5
            hit = t == 2
            return StepResult(state=np.zeros((*HW, 1), np.float32),
                              reward=1.0, done=hit,
                              to_goal=np.zeros(4, np.float32), target=hit)

    out = FleetRunner([ClockedEnv()], direct(act), cfg).run(1)
    assert out["successes"] == 1
    assert out["durations"] == [pytest.approx(0.75)]  # not 3 * 0.1


def test_fleet_transition_stream(actor_setup):
    cfg, act = actor_setup
    n = 3
    rows = []
    out = FleetRunner(_kin_envs(n), direct(act), cfg,
                      on_transition=lambda *tr: rows.append(tr)).run(1)
    assert {r[0] for r in rows} == set(range(n))
    for robot, obs, a, goal, rew, nobs, ngoal, done in rows:
        assert obs.shape == nobs.shape == HW
        assert a.shape == (2,) and np.all(np.abs(a) <= cfg.env.max_action)
        assert goal.shape == ngoal.shape == (4,)
        assert np.isfinite(rew) and isinstance(done, bool)
    per_robot_last = {r[0]: r for r in rows}
    assert sum(r[-1] for r in per_robot_last.values()) <= out["episodes"]


def test_evaluate_fleet_mode(actor_setup, tmp_path):
    import yaml

    from dgvit_tpu_torch.core import checkpoint as ckpt

    cfg = fleet_cfg(max_steps=10)
    params = jax_params(seed=1)
    out = evaluate.run_eval_fleet(cfg, params, max_episodes=4, n_robots=2,
                                  out_dir=str(tmp_path), device="cpu")
    assert 0.0 <= out["success_rate"] <= 1.0
    assert out["serving"]["rows"] >= 4
    assert (tmp_path / "testing_data.txt").exists()

    with pytest.raises(ValueError, match="divide evenly"):
        evaluate.run_eval_fleet(cfg, params, max_episodes=5, n_robots=2,
                                out_dir=str(tmp_path), device="cpu")

    # the command line
    npz = ckpt.save_params_npz(str(tmp_path), "fleet_test", params)
    cfg_yaml = tmp_path / "cfg.yaml"
    cfg_yaml.write_text(yaml.safe_dump(cfg.to_dict()))
    out_dir = tmp_path / "cli"
    evaluate.main(["--actor", npz, "--config", str(cfg_yaml),
                   "--episodes", "4", "--fleet", "2", "--out", str(out_dir),
                   "--device", "cpu"])
    assert (out_dir / "testing_data.txt").exists()
    for other in ("--vec-eval", "--device-rollout"):  # host-loop only
        with pytest.raises(SystemExit):
            evaluate.main(["--actor", npz, "--config", str(cfg_yaml),
                           "--fleet", "2", other, "--device", "cpu"])


def test_run_eval_fleet_matches_jax(monkeypatch, tmp_path):
    """run_eval_fleet of the port and of the JAX package on the same actor
    and env records, each server pinned to bucket (1,)."""
    n, episodes = 2, 4
    jcfg, cfg = fleet_cfg(cls=JaxConfig), fleet_cfg()
    params = jax_params(seed=2)
    commands = {"jax": {}, "port": {}}

    def recording(cls, key):
        class Recording(cls):
            def step(self, action, t):
                commands[key].setdefault(self.robot, []).append(
                    [float(action[0]), float(action[1])])
                return super().step(action, t)

        def make(seed, image_hw, world):
            env = Recording(records(seed), image_hw=image_hw, world=world)
            env.robot = seed - cfg.train.seed
            return env
        return make

    def pinned(server, runner):
        def run(cfg, envs, act_fn, episodes_per_robot=1, **kw):
            with server(act_fn, max_wait_ms=1.0, buckets=(1,)) as srv:
                out = runner(envs, srv, cfg).run(episodes_per_robot)
            out["serving"] = srv.stats()
            return out
        return run

    import dgvit_tpu.serve as jax_serve
    import dgvit_tpu_torch.serve as port_serve

    monkeypatch.setattr(jax_evaluate, "KinematicNavEnv",
                        recording(JaxKinematicNavEnv, "jax"))
    monkeypatch.setattr(evaluate, "KinematicNavEnv",
                        recording(KinematicNavEnv, "port"))
    monkeypatch.setattr(jax_serve, "serve_fleet", pinned(
        jax_serve.BatchingActorServer, jax_serve.FleetRunner))
    monkeypatch.setattr(port_serve, "serve_fleet", pinned(
        BatchingActorServer, FleetRunner))
    ref = jax_evaluate.run_eval_fleet(jcfg, params, max_episodes=episodes,
                                      n_robots=n, out_dir=str(tmp_path))
    out = evaluate.run_eval_fleet(cfg, params, max_episodes=episodes,
                                  n_robots=n, out_dir=str(tmp_path),
                                  device="cpu")
    assert sorted(commands["port"]) == sorted(commands["jax"]) == [0, 1]
    for robot in range(n):
        a = np.asarray(commands["port"][robot])
        b = np.asarray(commands["jax"][robot])
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ACTION_TOL)
    assert out["successes"] == ref["successes"]
    assert out["collisions"] == ref["collisions"]
    assert out["durations"] == ref["durations"]
    assert out["success_rate"] == ref["success_rate"]
    assert out["serving"]["padded_rows"] == 0
    assert out["serving"]["rows"] == out["serving"]["dispatches"]


# -- ROS 2 fleets over the fake rclpy ----------------------------------------

@pytest.fixture()
def ros2(monkeypatch):
    world = fake_ros2.install()
    drop_port_adapter()
    import time as _time
    monkeypatch.setattr(_time, "sleep", lambda s: None)
    from dgvit_tpu_torch.envs import ros2_adapter
    assert ros2_adapter.HAS_ROS2
    yield ros2_adapter, world
    fake_ros2.uninstall()
    drop_port_adapter()


def _prime_robot(world, ns, x=0.0, y=0.0):
    rng = np.random.default_rng(abs(hash(ns)) % 2**31)
    img = rng.uniform(0.1, 8.0, (64, 80)).astype(np.float32)
    world.deliver(f"{ns}/camera/depth/image_raw",
                  fake_ros2.Image(height=64, width=80, encoding="32FC1",
                                  data=img.tobytes()))
    world.deliver(f"{ns}/odom", fake_ros2.Odometry(x=x, y=y))
    world.deliver(f"{ns}/front_laser/scan",
                  fake_ros2.LaserScan([5.0] * 36))


def test_ros2_fleet_namespaced_and_free_running(ros2):
    from dgvit_tpu_torch.serve.fleet import make_ros2_fleet

    _, world = ros2
    cfg = fleet_cfg(max_steps=3)
    recs = [[{"xR": 0.0, "yR": 0.0, "xG": 3.0, "yG": 0.0}],
            [{"xR": 1.0, "yR": 1.0, "xG": -3.0, "yG": 0.0}]]
    envs = make_ros2_fleet(cfg, 2, records_per_robot=recs, device="cpu")
    assert envs[0].node.name == "dgvit_env_robot0"
    assert envs[1].node.name == "dgvit_env_robot1"
    for i in range(2):
        _prime_robot(world, f"/robot{i}", x=float(i), y=float(i))

    out = FleetRunner(envs, lambda o, g: np.array([0.1, 0.0], np.float32),
                      cfg).run(episodes_per_robot=1)
    assert out["robots"] == 2 and out["episodes"] == 2

    names = [c.state.name for c in world.calls("gazebo/set_entity_state")]
    assert sorted(names) == ["scout0", "scout1",
                             "target_cone0", "target_cone1"]
    for i in range(2):
        assert names.index(f"scout{i}") < names.index(f"target_cone{i}")
    assert len(world.twists("/robot0/cmd_vel")) >= 3  # steps + stop()
    assert len(world.twists("/robot1/cmd_vel")) >= 3
    assert not world.twists("/cmd_vel")
    assert not world.calls("/unpause_physics")
    assert not world.calls("/pause_physics")


def test_evaluate_fleet_ros2_env(ros2, monkeypatch, tmp_path):
    """run_eval_fleet(env_kind='ros2') over namespaced adapters (the
    command line's --fleet N --fleet-env ros2) on the fake rclpy."""
    import dgvit_tpu_torch.serve as serve_pkg

    _, world = ros2
    # the adapter's states are the reference's 128x160 frames
    cfg = Config.from_dict({
        "model": {"block": 1, "head": 2, "latent_size": 16, "mlp_dim": 32,
                  "image_size": (128, 160), "patch_size": (64, 80)},
        "env": {"max_steps": 3, "vis_sensor": "depth_image"},
    })
    params = jax_params(hw=(128, 160), cfg=JaxConfig.from_dict(cfg.to_dict()))
    real = serve_pkg.make_ros2_fleet

    def primed(c, n, **kw):
        recs = [[{"xR": 0.0, "yR": 0.0, "xG": 3.0, "yG": 0.0}]
                for _ in range(n)]
        envs = real(c, n, records_per_robot=recs, **kw)
        for i in range(n):
            _prime_robot(world, f"/robot{i}")
        return envs

    monkeypatch.setattr(serve_pkg, "make_ros2_fleet", primed)
    out = evaluate.run_eval_fleet(cfg, params, max_episodes=2, n_robots=2,
                                  out_dir=str(tmp_path), env_kind="ros2",
                                  device="cpu")
    assert out["serving"]["rows"] >= 2
    assert world.twists("/robot0/cmd_vel") and world.twists("/robot1/cmd_vel")
    assert not world.calls("/unpause_physics")


def test_ros2_single_robot_default_unchanged(ros2):
    ros2_adapter, world = ros2
    cfg = Config.from_dict({"env": {"vis_sensor": "depth_image",
                                    "max_steps": 2}})
    env = ros2_adapter.GazeboRos2Env(
        cfg, position_records=[{"xR": 0, "yR": 0, "xG": 2, "yG": 2}],
        device="cpu")
    _prime_robot(world, "")
    env.reset()
    env.step([0.1, 0.0], 0)
    assert [c.state.name for c in world.calls("gazebo/set_entity_state")] == \
        ["scout", "target_cone"]
    assert world.twists("/cmd_vel")
    assert len(world.calls("/unpause_physics")) == 2  # reset + step
