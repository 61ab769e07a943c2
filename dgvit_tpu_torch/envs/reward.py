"""Reward and polar-goal math, numerically the functions of env_lab.py:170-301
(and the yaw extraction of squaternion at :221-227).

Counterpart of `dgvit_tpu/envs/reward.py`, in numpy float32. The JAX
functions run in fp32 with weak typing: an array is fp32, while a Python
number stays a Python number (a float64) until it meets an array
operation, which rounds it to fp32. The host env calls them with Python
floats, so a difference of two positions or the goal-radius comparison is
taken in float64 and only then rounded; a float64 port, or one that
rounds the inputs first, drifts in the last bits and can flip `target` at
the goal radius. These functions keep that behaviour: `_f32` stands where
the JAX code enters an array operation, Python arithmetic is left as it
is, and fp32 arrays go through unchanged.

The `*_lanes` functions are the same math on (B,) fp32 tensors, for the
batched env on the card (`envs/vec_kinematic.py`), where the JAX env
calls the functions above on fp32 arrays: every operand is an fp32
tensor and a Python number is rounded to fp32 where it meets one, as
torch and the JAX package both do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

PI = math.pi


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def quaternion_yaw(w, x, y, z):
    """squaternion Quaternion(w,x,y,z).to_euler()[2], yaw only
    (env_lab.py:221-227; the reference rounds to 4 decimals)."""
    yaw = np.arctan2(_f32(2.0 * (w * z + x * y)),
                     _f32(1.0 - 2.0 * (y * y + z * z)))
    factor = np.float32(10 ** 4)
    return np.rint(yaw * factor) / factor


def heading_error(odom_x, odom_y, goal_x, goal_y, angle):
    """beta2: goal bearing minus robot yaw, wrapped to (-pi, pi]
    (env_lab.py:231-250), by the reference's two-step reflection."""
    skew_x = goal_x - odom_x
    skew_y = goal_y - odom_y
    mag1 = np.sqrt(_f32(skew_x ** 2 + skew_y ** 2))
    dot = skew_x  # dot([skewX, skewY], [1, 0])
    beta = np.arccos(np.clip(_f32(dot) / np.maximum(mag1, _f32(1e-12)),
                             _f32(-1.0), _f32(1.0)))
    beta = np.where(skew_y < 0, -beta, beta)
    beta2 = beta - _f32(angle)
    beta2 = np.where(beta2 > _f32(PI), beta2 - _f32(2.0 * PI), beta2)
    beta2 = np.where(beta2 < _f32(-PI), beta2 + _f32(2.0 * PI), beta2)
    return beta2


def polar_goal(odom_x, odom_y, goal_x, goal_y, angle,
               act0=0.0, act1=0.0, dist_norm: float = 15.0):
    """toGoal = [min(D/15, 1), beta2/pi, act0, act1] (env_lab.py:296-298)."""
    dist = np.sqrt(_f32((odom_x - goal_x) ** 2 + (odom_y - goal_y) ** 2))
    beta2 = heading_error(odom_x, odom_y, goal_x, goal_y, angle)
    return np.stack([
        np.minimum(dist / _f32(dist_norm), _f32(1.0)),
        beta2 / _f32(PI),
        _f32(act0),
        _f32(act1),
    ])


class RewardOut(NamedTuple):
    reward: np.ndarray
    done: np.ndarray
    target: np.ndarray
    dist: np.ndarray      # new distOld
    r_arret: np.ndarray   # computed but EXCLUDED from the sum (env_lab.py:290,294)


def step_reward(dist_old, dist, collided, act0, act1,
                goal_radius: float = 0.5,
                r_target: float = 200.0,
                r_collision: float = -100.0,
                heuristic_scale: float = 20.0,
                clip: Tuple[float, float] = (-200.0, 500.0)) -> RewardOut:
    """env_lab.py:274-301:
      r_heuristic = (distOld - Dist) * 20
      r_target    = 200 at Dist < 0.5 (also done/target)
      r_arret     = 50*(2-|act1|)*(1-act0), computed, NOT added
      r_collision = -100 when laser-min < 0.2
      reward = clip(r_collision + r_target + r_heuristic, -200, 500)
    """
    target = dist < goal_radius
    done = np.logical_or(target, collided)
    r_heur = (dist_old - dist) * heuristic_scale
    r_tgt = np.where(target, _f32(r_target), _f32(0.0))
    r_col = np.where(collided, _f32(r_collision), _f32(0.0))
    r_arret = np.where(
        target, _f32(50.0) * (_f32(2.0) - np.abs(_f32(act1)))
        * _f32(1.0 - act0), _f32(0.0))
    reward = np.clip(r_col + r_tgt + _f32(r_heur), _f32(clip[0]),
                     _f32(clip[1]))
    return RewardOut(reward=reward, done=done, target=target,
                     dist=dist, r_arret=r_arret)


def heading_error_lanes(odom_x, odom_y, goal_x, goal_y, angle):
    """`heading_error` on (B,) fp32 tensors."""
    skew_x = goal_x - odom_x
    skew_y = goal_y - odom_y
    mag1 = torch.sqrt(torch.square(skew_x) + torch.square(skew_y))
    beta = torch.arccos(torch.clamp(skew_x / torch.clamp(mag1, min=1e-12),
                                    -1.0, 1.0))
    beta = torch.where(skew_y < 0, -beta, beta)
    beta2 = beta - angle
    beta2 = torch.where(beta2 > PI, beta2 - 2.0 * PI, beta2)
    return torch.where(beta2 < -PI, beta2 + 2.0 * PI, beta2)


def polar_goal_lanes(odom_x, odom_y, goal_x, goal_y, angle, act0=None,
                     act1=None, dist_norm: float = 15.0) -> torch.Tensor:
    """`polar_goal` on (B,) fp32 tensors: (B, 4) rows [min(D/15, 1),
    beta2/pi, act0, act1]; a missing action is zeros."""
    dist = torch.sqrt(torch.square(odom_x - goal_x)
                      + torch.square(odom_y - goal_y))
    beta2 = heading_error_lanes(odom_x, odom_y, goal_x, goal_y, angle)
    zero = torch.zeros_like(dist)
    return torch.stack([
        torch.clamp(dist / dist_norm, max=1.0), beta2 / PI,
        zero if act0 is None else act0,
        zero if act1 is None else act1], dim=1)


def step_reward_lanes(dist_old, dist, collided, act0, act1,
                      goal_radius: float = 0.5,
                      r_target: float = 200.0,
                      r_collision: float = -100.0,
                      heuristic_scale: float = 20.0,
                      clip: Tuple[float, float] = (-200.0, 500.0)
                      ) -> RewardOut:
    """`step_reward` on (B,) fp32 tensors, summed in the same order."""
    target = dist < goal_radius
    done = target | collided
    zero = torch.zeros_like(dist)
    r_heur = (dist_old - dist) * heuristic_scale
    r_tgt = torch.where(target, r_target, zero)
    r_col = torch.where(collided, r_collision, zero)
    r_arret = torch.where(target, 50.0 * (2.0 - torch.abs(act1))
                          * (1.0 - act0), zero)
    reward = torch.clamp(r_col + r_tgt + r_heur, clip[0], clip[1])
    return RewardOut(reward=reward, done=done, target=target, dist=dist,
                     r_arret=r_arret)


def laser_collision(ranges, min_range: float = 0.2):
    """calculate_observation (env_lab.py:170-181): collision when any
    0 < range < min_range; also returns the min range seen (capped at
    2.0)."""
    ranges = _f32(ranges)
    valid = ranges > 0
    col = np.any(np.logical_and(valid, ranges < _f32(min_range)))
    min_laser = np.minimum(np.min(ranges), _f32(2.0))
    return col, min_laser


def binning(lower_bound: int, data, quantity: int) -> np.ndarray:
    """utils.py:92-98 laser min-pooling into `quantity` bins, returning
    shape (1, quantity) like the reference."""
    data = _f32(data)
    width = int(round(data.shape[0] / quantity))
    return np.stack([np.min(data[lower_bound + i * width:
                                 lower_bound + (i + 1) * width])
                     for i in range(quantity)])[None, :]


# Obstacle boxes of utils.py:77-89 (RRC world), shared with the record
# sampler (kinematic.default_records). The sixth clause `-4.5 < x < -5.5`
# (utils.py:84) has reversed bounds and is always False; it is kept as it
# is for behavioral parity.
CHECK_POS_BOXES = (
    (3.6, 5.5, -3.5, 4), (-4.5, 4, -3.5, -1.8), (-3.5, 3.3, -1.6, 2.5),
    (-5, -4, -3.5, 0.3), (-5.5, -4, 2, 4), (-4.5, -5.5, 0.2, 2.1),
    (-4.1, 0.1, 3, 4), (2.2, 3.8, 2.5, 4), (0, 2.3, 2.5, 4),
)


def check_pos(x: float, y: float) -> bool:
    """Obstacle-box rejection for sampled goals (utils.py:77-89, RRC world)."""
    for x0, x1, y0, y1 in CHECK_POS_BOXES:
        if x0 < x < x1 and y0 < y < y1:
            return False
    if x > 5 or x < -5 or y > 3.7 or y < -3:
        return False
    return True
