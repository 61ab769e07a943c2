"""The port's host env (dgvit_tpu_torch/envs) against the JAX package's, on
the CPU.

The reward and polar-goal functions run on golden cases as the host env
calls them (Python floats, which the JAX functions keep in float64 until
an array operation rounds them to fp32) and on fp32 arrays. `done` and
`target` must be identical. Values: 1e-6 abs; the only operations that may
differ are arccos and arctan2 (numpy's against XLA's, an ulp or two of a
heading in [-pi, pi]); everything else is the same IEEE operation on both
sides.

`KinematicNavEnv` of both packages is stepped with the same scripted
actions for at least 200 steps on each world: identical `done` and
`target`, states, goals and rewards within 1e-6. `default_records` is
bit-equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from dgvit_tpu.envs import kinematic as jk
from dgvit_tpu.envs import reward as jr
from dgvit_tpu.envs import worlds as jw
from dgvit_tpu_torch.envs import KinematicNavEnv, ResetResult, StepResult
from dgvit_tpu_torch.envs import kinematic as pk
from dgvit_tpu_torch.envs import reward as pr
from dgvit_tpu_torch.envs import worlds as pw

TOL = 1e-6

POSES = [  # odom_x, odom_y, goal_x, goal_y, angle
    (0.0, 0.0, 2.0, 2.0, 0.0),
    (1.25, -0.75, -3.5, 2.25, 1.1),
    (-4.3, 3.1, 4.9, -2.7, -3.0),
    (0.3, 0.3, 0.3, 0.8, math.pi),
    (2.0, 1.0, 2.0, 1.0, 0.4),            # on the goal: zero-length bearing
    (-1.0, 2.0, -3.0, 2.0, -math.pi),     # goal straight behind
    (0.1, 0.2, 14.0, -9.0, 2.9),          # farther than dist_norm
    (3.14159, 2.71828, 1.41421, 1.73205, 0.57721),
]


def same(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert port.dtype == ref.dtype
    if port.dtype == bool:
        assert np.array_equal(port, ref)
    else:
        assert np.abs(port.astype(np.float64) - ref.astype(np.float64)
                      ).max() <= tol


@pytest.mark.parametrize("pose", POSES)
def test_polar_goal_on_python_floats(pose):
    same(pr.heading_error(*pose), jr.heading_error(*pose))
    same(pr.polar_goal(*pose, 0.21, -0.4), jr.polar_goal(*pose, 0.21, -0.4))
    same(pr.polar_goal(*pose, dist_norm=4.0),
         jr.polar_goal(*pose, dist_norm=4.0))


def test_polar_goal_on_arrays():
    cols = [np.asarray(c, np.float32) for c in zip(*POSES)]
    same(pr.heading_error(*cols),
         jr.heading_error(*[jnp.asarray(c) for c in cols]))
    same(pr.polar_goal(*cols, cols[0] * 0, cols[1] * 0),
         jr.polar_goal(*[jnp.asarray(c) for c in cols],
                       jnp.zeros(len(POSES)), jnp.zeros(len(POSES))))


@pytest.mark.parametrize("quat", [(1.0, 0.0, 0.0, 0.0),
                                  (0.9238795, 0.0, 0.0, 0.3826834),
                                  (0.3, 0.1, -0.2, 0.927),
                                  (0.0, 0.0, 0.0, 1.0),
                                  (0.7071, 0.0, 0.0, -0.7071)])
def test_quaternion_yaw(quat):
    # the yaw is rounded to 4 decimals: an ulp of arctan2 at a rounding
    # boundary would move it by 1e-4, so the cases stay clear of those
    same(pr.quaternion_yaw(*quat), jr.quaternion_yaw(*quat))


REWARD_CASES = [  # dist_old, dist, collided, act0, act1
    (1.0, 0.9, False, 0.3, 0.1),
    (0.6, 0.49999, False, 0.5, -1.0),      # just inside the goal radius
    (0.6, 0.5, False, 0.5, 1.0),           # on it: not a target
    (0.5000001, 0.50000001, False, 0.0, 0.0),
    (2.0, 2.3, True, 0.2, 0.7),
    (0.55, 0.45, True, 0.1, 0.2),          # target and collision together
    (30.0, 1.0, False, 0.0, 0.0),          # clipped at +500
    (1.0, 30.0, True, 0.0, 0.0),           # clipped at -200
    (0.7230000495910645, 0.7170000076293945, False, 0.25, 0.5),
]


@pytest.mark.parametrize("case", REWARD_CASES)
def test_step_reward_on_python_floats(case):
    out, ref = pr.step_reward(*case), jr.step_reward(*case)
    assert bool(out.target) == bool(ref.target)
    assert bool(out.done) == bool(ref.done)
    assert float(out.dist) == float(ref.dist)
    # fp32 sums of the same fp32 terms: no tolerance needed
    assert float(out.reward) == float(ref.reward)
    assert float(out.r_arret) == float(ref.r_arret)
    assert np.asarray(out.reward).dtype == np.float32


def test_step_reward_on_arrays_and_options():
    cols = list(zip(*REWARD_CASES))
    f = lambda c: np.asarray(c, np.float32)
    args = (f(cols[0]), f(cols[1]), np.asarray(cols[2]), f(cols[3]),
            f(cols[4]))
    kw = dict(goal_radius=0.8, r_target=150.0, r_collision=-50.0,
              heuristic_scale=10.0, clip=(-60.0, 160.0))
    for options in ({}, kw):
        out = pr.step_reward(*args, **options)
        ref = jr.step_reward(*[jnp.asarray(a) for a in args], **options)
        for a, b in zip(out, ref):
            same(a, b, 0.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_laser_collision_and_binning(seed):
    rng = np.random.default_rng(seed)
    ranges = rng.uniform(0.0, 3.0, 72).astype(np.float32)
    ranges[rng.integers(0, 72, 5)] = 0.0          # invalid returns
    if seed == 1:
        ranges = np.maximum(ranges, 0.25)         # no collision
    for min_range in (0.2, 0.5):
        col, lo = pr.laser_collision(ranges, min_range)
        jcol, jlo = jr.laser_collision(jnp.asarray(ranges), min_range)
        assert bool(col) == bool(jcol) and float(lo) == float(jlo)
    same(pr.binning(2, ranges, 10), jr.binning(2, jnp.asarray(ranges), 10),
         0.0)


def test_check_pos_and_worlds_are_copies():
    assert pr.CHECK_POS_BOXES == jr.CHECK_POS_BOXES
    rng = np.random.default_rng(0)
    for x, y in rng.uniform(-6, 6, (300, 2)):
        assert pr.check_pos(x, y) == jr.check_pos(x, y)
    for name in ("rrc", "hospital"):
        a, b = pw.get_world(name), jw.get_world(name)
        assert (a.name, a.boxes, a.arena) == (b.name, b.boxes, b.arena)
    a, b = pw.random_ensemble("randm4", 3), jw.random_ensemble("randm4", 3)
    assert [(w.name, w.boxes, w.arena) for w in a] == \
        [(w.name, w.boxes, w.arena) for w in b]
    with pytest.raises(KeyError):
        pw.get_world("nowhere")


@pytest.mark.parametrize("world,seed,n", [(None, 0, 32), (None, 7, 50),
                                          ("hospital", 0, 32),
                                          ("hospital", 3, 40)])
def test_default_records_bit_equal(world, seed, n):
    a = pk.default_records(n, seed, world=world and pw.get_world(world))
    b = jk.default_records(n, seed, world=world and jw.get_world(world))
    assert a == b and len(a) == n


def scripted_actions(rng, t):
    """Env-unit commands: mostly forward with a wandering turn, sometimes a
    hard turn, so runs reach goals, walls and the step limit."""
    v = float(rng.uniform(0.1, 0.5))
    w = float(rng.uniform(-1.0, 1.0)) if t % 7 else float(rng.uniform(-2, 2))
    return [v, w]


@pytest.mark.parametrize("world", ["rrc", "hospital"])
def test_kinematic_env_trajectories(world):
    port = KinematicNavEnv(seed=3, image_hw=(32, 40), world=world)
    # the JAX sampler takes seconds; test_default_records_bit_equal holds
    # the two samplers equal
    ref = jk.KinematicNavEnv(port.records, image_hw=(32, 40), world=world)
    rng = np.random.default_rng(1)
    steps = dones = targets = 0
    for _ in range(30):
        a, b = port.reset(), ref.reset()
        assert isinstance(a, ResetResult)
        assert (a.xR, a.yR) == (b.xR, b.yR)
        same(a.state, b.state)
        same(a.to_goal, b.to_goal)
        for t in range(40):
            act = scripted_actions(rng, t)
            sa, sb = port.step(act, t), ref.step(act, t)
            steps += 1
            assert isinstance(sa, StepResult)
            assert sa.done == sb.done and sa.target == sb.target
            assert type(sa.reward) is float and type(sa.done) is bool
            assert abs(sa.reward - sb.reward) <= TOL
            same(sa.state, sb.state)
            same(sa.to_goal, sb.to_goal)
            dones += sa.done
            targets += sa.target
            if sa.done:
                break
    assert steps >= 200
    assert port.collision == ref.collision
    assert (port.x, port.y, port.theta) == (ref.x, ref.y, ref.theta)
    if world == "rrc":
        assert dones >= 5          # the run does end episodes


def test_kinematic_env_reaches_targets():
    """Driving straight at the goal ends with `target` in both packages at
    the same step."""
    port = KinematicNavEnv(seed=5, image_hw=(16, 20))
    ref = jk.KinematicNavEnv(port.records, image_hw=(16, 20))
    hits = 0
    for _ in range(12):
        a, b = port.reset(), ref.reset()
        for t in range(150):
            turn = float(np.clip(3.0 * a.to_goal[1] * math.pi, -2.0, 2.0))
            a, b = port.step([0.5, turn], t), ref.step([0.5, turn], t)
            assert a.done == b.done and a.target == b.target
            assert abs(a.reward - b.reward) <= TOL
            if a.done:
                hits += a.target
                break
    assert hits >= 1


def test_load_position_records(tmp_path):
    recs = pk.default_records(4, 1)
    np.savez(tmp_path / "pos.npz", **{f"r{i}": np.array(r, dtype=object)
                                      for i, r in enumerate(recs)})
    assert pk.load_position_records(str(tmp_path / "pos.npz")) == recs
    env = KinematicNavEnv(records=recs, image_hw=(16, 20))
    assert env.reset().state.shape == (16, 20, 1)
    env.stop()
