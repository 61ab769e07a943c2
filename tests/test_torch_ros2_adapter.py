"""The port's GazeboRos2Env (dgvit_tpu_torch/envs/ros2_adapter.py) over the
fake rclpy stack (tests/fake_ros2.py), on the CPU.

Mirrors the JAX package's tests/test_ros2_adapter.py case for case: the
reference GazeboEnv's reset/step/teleport/decode contract
(env_lab.py:190-343,409-472) with no ROS 2 install. Then against the
JAX adapter on the same messages: the states of one raw frame through
each sensor's chain (depth with JAX's noise draws injected, within
TOL_UNIT, the uint16 form allowing a u8 step that x / hi * 255 flips as
tests/test_torch_preprocess.py does; fisheye and camera images), and a
reset and steps (reward, done, target and the collision count equal,
the goal vector within TOL_GOAL).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu_torch.config import Config

import fake_ros2

TOL_UNIT = 1e-5     # states in [0, 1], fp32 chains of both packages
TOL_GOAL = 1e-6     # the goal vector, as tests/test_torch_envs.py holds it
PORT_ADAPTER = "dgvit_tpu_torch.envs.ros2_adapter"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are small, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def drop_port_adapter():
    """Forget the port's adapter module, whose rclpy gate is read at
    import (fake_ros2 drops the JAX package's only)."""
    sys.modules.pop(PORT_ADAPTER, None)
    pkg = sys.modules.get("dgvit_tpu_torch.envs")
    if pkg is not None and hasattr(pkg, "ros2_adapter"):
        delattr(pkg, "ros2_adapter")


@pytest.fixture()
def ros2(monkeypatch):
    world = fake_ros2.install()
    drop_port_adapter()
    # reset and step sleep 0.2 / 0.1 s (env_lab.py:204,330-343)
    import time as _time
    monkeypatch.setattr(_time, "sleep", lambda s: None)
    from dgvit_tpu_torch.envs import ros2_adapter
    assert ros2_adapter.HAS_ROS2
    yield ros2_adapter, world
    fake_ros2.uninstall()
    drop_port_adapter()


def _cfg(sensor="depth_image", cls=Config):
    return cls.from_dict({"env": {"vis_sensor": sensor}})


TOPIC = {"depth_image": "/camera/depth/image_raw",
         "fish_image": "/camera_fesh/image_raw",
         "image": "/camera/image_raw"}


def _mk_env(ros2_adapter, world, sensor="depth_image", records=None):
    env = ros2_adapter.GazeboRos2Env(_cfg(sensor), position_records=records,
                                     device="cpu")
    return env, TOPIC[sensor]


def _depth_msg(h=64, w=80, encoding="32FC1", seed=0, zero=False):
    rng = np.random.default_rng(seed)
    if encoding == "32FC1":
        img = np.zeros((h, w), np.float32) if zero else \
            rng.uniform(0.1, 8.0, (h, w)).astype(np.float32)
    elif encoding == "16UC1":
        img = np.zeros((h, w), np.uint16) if zero else \
            rng.integers(1, 60000, (h, w)).astype(np.uint16)
    else:
        img = np.zeros((h, w), np.uint8) if zero else \
            rng.integers(1, 255, (h, w)).astype(np.uint8)
    return fake_ros2.Image(height=h, width=w, encoding=encoding,
                           data=img.tobytes()), img


def test_constructor_raises_without_ros2():
    fake_ros2.uninstall()
    drop_port_adapter()
    from dgvit_tpu_torch.envs import ros2_adapter
    if ros2_adapter.HAS_ROS2:  # a real ROS 2 install would pass
        pytest.skip("real rclpy present")
    with pytest.raises(ImportError, match="rclpy not available"):
        ros2_adapter.GazeboRos2Env(_cfg(), device="cpu")
    drop_port_adapter()


def test_image_decode_32fc1(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world)
    msg, img = _depth_msg(encoding="32FC1")
    world.deliver(topic, msg)
    np.testing.assert_array_equal(env._last_image, img)
    assert env._last_image.dtype == np.float32


def test_image_decode_16uc1(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world)
    msg, img = _depth_msg(encoding="16UC1")
    world.deliver(topic, msg)
    np.testing.assert_array_equal(env._last_image, img)
    assert env._last_image.dtype == np.uint16


def test_image_decode_mono8(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world, sensor="image")
    msg, img = _depth_msg(encoding="mono8")
    world.deliver(topic, msg)
    np.testing.assert_array_equal(env._last_image, img)
    assert env._last_image.dtype == np.uint8


def test_zero_frame_detection_logs_error(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world)
    msg, _ = _depth_msg(zero=True)
    world.deliver(topic, msg)
    assert ("error", "Image null!") in world.logs  # env_lab.py:435-436


def _prime(world, topic, x=0.0, y=0.0, qz=0.0, qw=1.0, ranges=None,
           msg=None):
    world.deliver(topic, msg or _depth_msg()[0])
    world.deliver("/odom", fake_ros2.Odometry(x=x, y=y, qz=qz, qw=qw))
    world.deliver("/front_laser/scan",
                  fake_ros2.LaserScan(ranges or [5.0] * 36))


def test_reset_teleports_robot_then_target_and_iterates_records(ros2):
    ros2_adapter, world = ros2
    recs = [{"xR": 1.0, "yR": -1.0, "xG": 3.0, "yG": 2.0,
             "quaterZ": 0.0, "quaterW": 1.0},
            {"xR": -2.0, "yR": 0.5, "xG": 0.0, "yG": -3.0}]
    env, topic = _mk_env(ros2_adapter, world, records=recs)
    _prime(world, topic, x=1.0, y=-1.0)

    r = env.reset()
    calls = world.calls("gazebo/set_entity_state")
    assert len(calls) == 2  # robot, then the cone (env_lab.py:320-321)
    assert calls[0].state.name == "scout"
    assert calls[0].state.pose.position.x == 1.0
    assert calls[0].state.pose.position.y == -1.0
    assert calls[1].state.name == "target_cone"
    assert calls[1].state.pose.position.x == 3.0
    assert (env.goalX, env.goalY) == (3.0, 2.0)
    assert env.indice_position == 1
    assert r.state.shape == (128, 160, 1)
    assert r.to_goal.shape == (4,)

    env.reset()  # second record, then wrap
    assert (env.goalX, env.goalY) == (0.0, -3.0)
    assert env.indice_position == 0


def test_reset_state_normalized_and_physics_cycled(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world)
    _prime(world, topic)
    r = env.reset()
    assert r.state.min() >= 0.0 and r.state.max() <= 1.0  # /255 scale
    assert len(world.calls("/unpause_physics")) == 1
    assert len(world.calls("/pause_physics")) == 1


def test_step_publishes_cmd_vel_and_cycles_physics(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world)
    _prime(world, topic, x=0.0, y=0.0)
    env.reset()
    s = env.step([0.3, -0.4], t=1)
    tw = world.twists()
    assert len(tw) == 1
    assert tw[0].linear.x == pytest.approx(0.3)
    assert tw[0].angular.z == pytest.approx(-0.4)
    assert len(world.calls("/unpause_physics")) == 2  # reset + step
    assert s.state.shape == (128, 160, 1)
    assert np.isfinite(s.reward)


def test_service_wait_loop_retries_until_available(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world)
    world.fail_first_wait["/unpause_physics"] = 2  # two failed waits first
    _prime(world, topic)
    env.reset()
    waits = [m for lvl, m in world.logs if "service not available" in m]
    assert len(waits) == 2  # env_lab.py:197-211
    assert len(world.calls("/unpause_physics")) == 1


def test_step_collision_sets_done_and_counts(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world)
    _prime(world, topic, x=0.0, y=0.0)
    env.reset()
    world.deliver("/front_laser/scan",
                  fake_ros2.LaserScan([0.1] + [5.0] * 35))
    s = env.step([0.2, 0.0], t=1)
    assert s.done and not s.target
    assert env.collision == 1
    assert s.reward < 0  # r_collision=-100 dominates (env_lab.py:289)


def test_step_goal_reached_sets_target(ros2):
    ros2_adapter, world = ros2
    recs = [{"xR": 0.0, "yR": 0.0, "xG": 0.2, "yG": 0.0}]
    env, topic = _mk_env(ros2_adapter, world, records=recs)
    _prime(world, topic, x=0.0, y=0.0)
    env.reset()
    _prime(world, topic, x=0.1, y=0.0)  # within goal_radius 0.5
    s = env.step([0.1, 0.0], t=1)
    assert s.target and s.done
    assert s.reward > 100  # r_target=200 (env_lab.py:286)


def test_image_decode_rgb8_and_bgr8_to_mono(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world, sensor="image")
    rng = np.random.default_rng(3)
    rgb = rng.integers(1, 255, (64, 80, 3)).astype(np.uint8)
    want = (rgb.astype(np.float32)
            @ np.array([0.299, 0.587, 0.114], np.float32)).astype(np.uint8)
    world.deliver(topic, fake_ros2.Image(height=64, width=80, encoding="rgb8",
                                         data=rgb.tobytes()))
    np.testing.assert_array_equal(env._last_image, want)
    assert env._last_image.dtype == np.uint8
    world.deliver(topic, fake_ros2.Image(
        height=64, width=80, encoding="bgr8",
        data=rgb[..., ::-1].copy().tobytes()))
    np.testing.assert_array_equal(env._last_image, want)


def test_goal_marker_published_on_reset_and_step(ros2):
    ros2_adapter, world = ros2
    recs = [{"xR": 0.0, "yR": 0.0, "xG": 3.0, "yG": 2.0}]
    env, topic = _mk_env(ros2_adapter, world, records=recs)
    _prime(world, topic)
    env.reset()
    markers = world.published.get("/goal_mark_array", [])
    assert len(markers) == 1
    m = markers[0].markers[0]
    assert m.header.frame_id == "odom"
    assert m.type == fake_ros2.Marker.CYLINDER
    assert (m.pose.position.x, m.pose.position.y) == (3.0, 2.0)
    assert (m.scale.x, m.scale.y, m.scale.z) == (0.3, 0.3, 0.01)
    assert m.color.a == 1.0
    env.step([0.1, 0.0], t=0)
    assert len(world.published["/goal_mark_array"]) == 2


def test_set_entity_does_not_spin_a_second_executor(ros2, monkeypatch):
    ros2_adapter, world = ros2
    import rclpy

    def _boom(node, fut):
        raise AssertionError("spin_until_future_complete must not be called")

    monkeypatch.setattr(rclpy, "spin_until_future_complete", _boom)
    recs = [{"xR": 0.0, "yR": 0.0, "xG": 1.0, "yG": 1.0}]
    env, topic = _mk_env(ros2_adapter, world, records=recs)
    _prime(world, topic)
    env.reset()
    assert len(world.calls("gazebo/set_entity_state")) == 2


def test_sim_clock_mailbox(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world)
    assert env.sim_now() is None
    world.deliver("/clock", fake_ros2.Clock(sec=12, nanosec=500_000_000))
    assert env.sim_now() == pytest.approx(12.5)


def test_step_infinite_ranges_sanitized(ros2):
    ros2_adapter, world = ros2
    env, topic = _mk_env(ros2_adapter, world)
    _prime(world, topic)
    env.reset()
    world.deliver("/front_laser/scan",
                  fake_ros2.LaserScan([float("inf"), float("nan")] + [5.0] * 34))
    s = env.step([0.1, 0.0], t=1)
    assert not s.done  # inf/nan mapped to 10.0, no phantom collision


# -- against the JAX package's adapter ----------------------------------------

def jax_adapter():
    """The JAX package's adapter module over the installed fake."""
    sys.modules.pop("dgvit_tpu.envs.ros2_adapter", None)
    from dgvit_tpu.envs import ros2_adapter
    assert ros2_adapter.HAS_ROS2
    return ros2_adapter


def with_jax_draws(env):
    """The port adapter's noise: the JAX adapter's draws, frame k's from
    PRNGKey(k) as its `_preprocess` keys them."""
    frames = iter(range(1000))
    env._noise = lambda shape: torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(next(frames)), tuple(shape), jnp.float32)))
    return env


@pytest.mark.parametrize("sensor,encoding", [
    ("depth_image", "32FC1"), ("depth_image", "16UC1"),
    ("fish_image", "mono8"), ("image", "mono8")])
def test_states_match_the_jax_adapter(ros2, sensor, encoding):
    ros2_adapter, world = ros2
    jmod = jax_adapter()
    shape = (480, 640) if sensor == "fish_image" else (120, 160)
    port = with_jax_draws(ros2_adapter.GazeboRos2Env(_cfg(sensor),
                                                     device="cpu"))
    ref = jmod.GazeboRos2Env(_cfg(sensor, JaxConfig))
    for seed in (4, 5):      # two frames: the noise key moves per frame
        msg, _ = _depth_msg(*shape, encoding=encoding, seed=seed)
        for env in (port, ref):  # the fake keeps one subscriber a topic
            env._on_image(msg)
        out, want = port._preprocess(port._last_image), \
            np.asarray(ref._preprocess(ref._last_image))
        assert out.shape == want.shape == (128, 160, 1)
        d = np.abs(out - want)
        if encoding == "16UC1":
            # a u8 step flipped by x / hi * 255 (test_normalize_depth_u16)
            assert d.max() <= 1.2 / 255.0 and (d > TOL_UNIT).mean() < 0.01
        else:
            assert d.max() <= TOL_UNIT


def feed(envs, x, y, ranges=None, seed=0):
    """The same frame, pose and scan into each adapter's mailboxes (the
    fake keeps one subscriber a topic)."""
    msg = _depth_msg(120, 160, seed=seed)[0]
    odom = fake_ros2.Odometry(x=x, y=y, qz=0.3, qw=0.95)
    scan = fake_ros2.LaserScan(ranges or [5.0] * 36)
    for env in envs:
        env._on_image(msg)
        env._on_odom(odom)
        env._on_scan(scan)


def test_reset_and_steps_match_the_jax_adapter(ros2):
    ros2_adapter, world = ros2
    jmod = jax_adapter()
    recs = [{"xR": 0.0, "yR": 0.0, "xG": 2.0, "yG": 1.0, "quaterZ": 0.3,
             "quaterW": 0.95}]
    envs = (with_jax_draws(ros2_adapter.GazeboRos2Env(
        _cfg(), position_records=recs, device="cpu")),
        jmod.GazeboRos2Env(_cfg(cls=JaxConfig), position_records=recs))
    feed(envs, x=0.0, y=0.0)
    resets = [env.reset() for env in envs]
    np.testing.assert_allclose(resets[0].to_goal, resets[1].to_goal,
                               rtol=0, atol=TOL_GOAL)
    assert np.abs(resets[0].state - np.asarray(resets[1].state)).max() \
        <= TOL_UNIT
    path = [(0.4, 0.3, [5.0] * 36), (0.9, 0.6, [0.1] + [5.0] * 35),
            (1.95, 1.0, [5.0] * 36)]
    for i, (x, y, ranges) in enumerate(path):
        feed(envs, x, y, ranges, seed=i + 1)
        a, b = (env.step([0.2, -0.1], t=i) for env in envs)
        assert (a.reward, a.done, a.target) == (b.reward, b.done, b.target)
        np.testing.assert_allclose(a.to_goal, b.to_goal, rtol=0,
                                   atol=TOL_GOAL)
        assert np.abs(a.state - np.asarray(b.state)).max() <= TOL_UNIT
    assert envs[0].collision == envs[1].collision == 1


def test_env_config_carries_the_adapters_reward_keys():
    """The port's EnvConfig has the JAX package's env keys, the adapter's
    reward constants among them, with JAX's defaults: a config naming
    env.collision_range loads in both packages alike."""
    import dataclasses

    from dgvit_tpu.config import EnvConfig as JaxEnvConfig
    from dgvit_tpu_torch.config import EnvConfig

    port = {f.name: f.default for f in dataclasses.fields(EnvConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxEnvConfig)}
    assert port == ref
    over = {"env": {"collision_range": 0.3, "goal_radius": 0.4,
                    "reward_clip": [-100.0, 300.0]}}
    assert Config.from_dict(over).to_dict()["env"] == \
        JaxConfig.from_dict(over).to_dict()["env"]
