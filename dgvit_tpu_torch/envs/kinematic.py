"""Kinematic differential-drive navigation env: the Gazebo-free stand-in
that lets the full RL loop run anywhere. Host numpy code, a copy of
`dgvit_tpu/envs/kinematic.py` over the port's own reward and world modules.

World model: the reference RRC arena approximated by the obstacle boxes of
utils.check_pos (utils.py:77-89) inside the arena bounds. Sensors are
synthesized: a planar laser (ray/AABB intersection, 360 rays over +-120 deg
like robot_w.urdf:1079-1113) and a column-depth camera (depth to nearest
obstacle per bearing, clip 0.03-8 m like robot_w.urdf:751-752).

Dynamics: unicycle integration at the reference's 0.1 s control cadence
(env_lab.py:204). Reward/polar math comes from envs/reward.py, the one
source of truth for the semantics of env_lab.py:274-301."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dgvit_tpu_torch.envs.base import ResetResult, StepResult
from dgvit_tpu_torch.envs import reward as R
from dgvit_tpu_torch.envs.worlds import RRC, WorldPreset, get_world

# Backwards-compatible module constants = the RRC training world
# (utils.py:78-86; the always-False sixth clause is omitted because nothing
# can collide with a zero-area box). Other layouts: envs/worlds.py presets.
BOXES: List[Tuple[float, float, float, float]] = list(RRC.boxes)
ARENA = RRC.arena  # outer walls


_BOXES_ARR = np.asarray(BOXES, np.float64)  # (nb, 4): x0 x1 y0 y1


def _ray_distances(px: float, py: float, bearings: np.ndarray,
                   max_range: float, boxes_arr: np.ndarray = _BOXES_ARR,
                   arena=ARENA) -> np.ndarray:
    """Min distance per bearing to any box or arena wall (vectorized
    slab-method ray/AABB over all rays x boxes at once)."""
    dx = np.cos(bearings)[:, None]          # (nr, 1)
    dy = np.sin(bearings)[:, None]
    eps = 1e-12
    inv_dx = 1.0 / np.where(np.abs(dx) < eps, eps, dx)
    inv_dy = 1.0 / np.where(np.abs(dy) < eps, eps, dy)
    x0, x1 = boxes_arr[None, :, 0], boxes_arr[None, :, 1]
    y0, y1 = boxes_arr[None, :, 2], boxes_arr[None, :, 3]

    tx1 = (x0 - px) * inv_dx
    tx2 = (x1 - px) * inv_dx
    ty1 = (y0 - py) * inv_dy
    ty2 = (y1 - py) * inv_dy
    tmin = np.maximum(np.minimum(tx1, tx2), np.minimum(ty1, ty2))
    tmax = np.minimum(np.maximum(tx1, tx2), np.maximum(ty1, ty2))
    # parallel rays outside the slab never hit
    miss_x = (np.abs(dx) < eps) & ((px < x0) | (px > x1))
    miss_y = (np.abs(dy) < eps) & ((py < y0) | (py > y1))
    hit = (tmax >= np.maximum(tmin, 0.0)) & ~miss_x & ~miss_y
    d_boxes = np.where(hit, np.where(tmin >= 0, tmin, np.inf), np.inf)
    best = np.minimum(d_boxes.min(axis=1), max_range)

    # arena walls (robot is inside; take positive exit distances)
    ax0, ax1, ay0, ay1 = arena
    for bound, p, inv in ((ax0, px, inv_dx), (ax1, px, inv_dx),
                          (ay0, py, inv_dy), (ay1, py, inv_dy)):
        t = ((bound - p) * inv)[:, 0]
        best = np.where((t >= 0) & (t < best), t, best)
    return best


def _box_clearance(x: float, y: float, boxes=None, arena=None) -> float:
    """Distance from (x, y) to the nearest obstacle box or arena wall."""
    boxes = BOXES if boxes is None else boxes
    arena = ARENA if arena is None else arena
    best = min(x - arena[0], arena[1] - x, y - arena[2], arena[3] - y)
    for x0, x1, y0, y1 in boxes:
        dx = max(x0 - x, 0.0, x - x1)
        dy = max(y0 - y, 0.0, y - y1)
        best = min(best, math.hypot(dx, dy))
    return best


def default_records(n: int = 32, seed: int = 0, clearance: float = 0.4,
                    world: Optional[WorldPreset] = None) -> List[dict]:
    """Random valid start/goal records in the reference npz layout
    (env_lab.py:103-105 keys xR,yR,xG,yG,quaterZ,quaterW,distance).
    check_pos's free space includes slivers tighter than the 0.2 m laser
    collision radius, so a clearance margin keeps spawns collision-free.
    With no `world`, uses reward.check_pos (exact utils.py:77-89 semantics);
    other worlds use their own box sets."""
    rng = np.random.default_rng(seed)
    rrc = world is None or world.name == "rrc"
    if rrc:
        boxes, arena = BOXES, ARENA
    else:
        boxes, arena = list(world.boxes), world.arena
    lo_x, hi_x = arena[0] + 0.4, arena[1] - 0.4
    lo_y, hi_y = arena[2] + 0.4, arena[3] - 0.4
    bx = np.asarray(boxes, np.float64)  # (n_boxes, 4) x0 x1 y0 y1

    def free_v(x, y):
        """Vectorized spawn-validity check. RRC replicates check_pos
        (utils.py:77-89, incl. the 5/-5/3.7/-3 bounds clause); other worlds
        simply reject points inside any obstacle box."""
        inside = np.zeros(x.shape, bool)
        strict = rrc  # check_pos uses strict <; other worlds used <=
        for x0, x1, y0, y1 in (R.CHECK_POS_BOXES if rrc else boxes):
            if strict:
                inside |= (x0 < x) & (x < x1) & (y0 < y) & (y < y1)
            else:
                inside |= (x0 <= x) & (x <= x1) & (y0 <= y) & (y <= y1)
        ok = ~inside
        if rrc:
            ok &= ~((x > 5) | (x < -5) | (y > 3.7) | (y < -3))
        return ok

    def clearance_v(x, y):
        """Vectorized _box_clearance: distance to nearest box or wall."""
        best = np.minimum.reduce([x - arena[0], arena[1] - x,
                                  y - arena[2], arena[3] - y])
        dx = np.maximum(np.maximum(bx[:, 0] - x[:, None], 0.0),
                        x[:, None] - bx[:, 1])
        dy = np.maximum(np.maximum(bx[:, 2] - y[:, None], 0.0),
                        y[:, None] - bx[:, 3])
        return np.minimum(best, np.hypot(dx, dy).min(axis=1))

    # Block-rejection sampling. Draw order matches the original scalar loop
    # (xR, yR, xG, yG per iteration, one float64 stream draw each), so the
    # accepted-record sequence is bit-identical to the scalar loop's for
    # any (seed, n), and to the JAX package's records
    # (tests/test_torch_envs.py).
    # The cheap box test runs on every candidate and the clearance (a
    # distance to every box) only on its survivors; the conditions are
    # ANDed, so the accepted records are the same.
    recs: List[dict] = []
    block = 1 << 15
    while len(recs) < n:
        u = rng.random((block, 4))
        xR = lo_x + (hi_x - lo_x) * u[:, 0]
        yR = lo_y + (hi_y - lo_y) * u[:, 1]
        xG = lo_x + (hi_x - lo_x) * u[:, 2]
        yG = lo_y + (hi_y - lo_y) * u[:, 3]
        idx = np.flatnonzero(free_v(xR, yR) & free_v(xG, yG))
        ok = (clearance_v(xR[idx], yR[idx]) >= clearance) & \
             (clearance_v(xG[idx], yG[idx]) >= clearance)
        # np.hypot can differ from math.hypot in the last ULP; prefilter
        # with a small slack, then apply the authoritative scalar predicate
        # (and store the scalar value) so results stay bit-identical.
        ok &= np.hypot(xR[idx] - xG[idx], yR[idx] - yG[idx]) >= 1.0 - 1e-9
        for i in idx[ok]:
            d = math.hypot(xR[i] - xG[i], yR[i] - yG[i])
            if d < 1.0:
                continue
            recs.append({"xR": float(xR[i]), "yR": float(yR[i]),
                         "xG": float(xG[i]), "yG": float(yG[i]),
                         "quaterZ": 0.0, "quaterW": 1.0,
                         "distance": d})
            if len(recs) == n:
                break
    return recs


def load_position_records(npz_path: str) -> List[dict]:
    """Load a reference resource/*.npz position file (env_lab.py:103-105)."""
    data = np.load(npz_path, allow_pickle=True)
    return [data[k].item() for k in data]


class KinematicNavEnv:
    """Env-protocol implementation (reset/step contract of env_lab.py)."""

    DT = 0.1                       # control cadence (env_lab.py:204)
    LASER_RAYS = 72                # decimated from 360 for speed
    LASER_FOV = 2.0 * 2.0944       # +-120 deg (robot_w.urdf:1090)
    LASER_MAX = 10.0
    CAM_FOV = 1.396                # robot_w.urdf:747
    CAM_CLIP = (0.03, 8.0)

    def __init__(self, records: Optional[List[dict]] = None,
                 image_hw: Tuple[int, int] = (128, 160),
                 max_steps: int = 800, seed: int = 0,
                 min_range: float = 0.2,
                 world=None):
        """`world`: None/'rrc' = training arena; a preset name or
        WorldPreset (envs/worlds.py) swaps the layout — the Gazebo-free
        analogue of launching gzserver with hospital.world."""
        if isinstance(world, str):
            world = get_world(world)
        self.world = world or RRC
        self._boxes_arr = np.asarray(self.world.boxes, np.float64)
        self._arena = self.world.arena
        self.records = records or default_records(
            seed=seed, world=None if self.world.name == "rrc" else self.world)
        self.indice_position = 0
        self.image_hw = image_hw
        self.min_range = min_range
        self.collision = 0
        self.x = self.y = self.theta = 0.0
        self.goalX = self.goalY = 2.0
        self.dist_old = 1.0
        self.last_act = (0.0, 0.0)

    # -- sensors -----------------------------------------------------------
    def _laser(self) -> np.ndarray:
        bearings = self.theta + np.linspace(
            -self.LASER_FOV / 2, self.LASER_FOV / 2, self.LASER_RAYS)
        return _ray_distances(self.x, self.y, bearings, self.LASER_MAX,
                              self._boxes_arr, self._arena)

    def _depth_image(self) -> np.ndarray:
        h, w = self.image_hw
        bearings = self.theta + np.linspace(
            self.CAM_FOV / 2, -self.CAM_FOV / 2, w)
        d = _ray_distances(self.x, self.y, bearings, self.CAM_CLIP[1],
                           self._boxes_arr, self._arena)
        d = np.clip(d, *self.CAM_CLIP)
        # column depth replicated over rows with a mild vertical ramp so the
        # image has 2-D structure; normalized to [0,1] like state=img/255
        ramp = np.linspace(1.0, 0.85, h)[:, None]
        img = (d[None, :] / self.CAM_CLIP[1]) * ramp
        return img.astype(np.float32)[..., None]

    def _to_goal(self, act0=0.0, act1=0.0) -> np.ndarray:
        return np.asarray(R.polar_goal(self.x, self.y, self.goalX, self.goalY,
                                       self.theta, act0, act1), np.float32)

    # -- protocol ----------------------------------------------------------
    def reset(self) -> ResetResult:
        rec = self.records[self.indice_position]
        self.indice_position = (self.indice_position + 1) % len(self.records)
        self.x, self.y = float(rec["xR"]), float(rec["yR"])
        self.goalX, self.goalY = float(rec["xG"]), float(rec["yG"])
        self.theta = float(np.asarray(R.quaternion_yaw(
            rec.get("quaterW", 1.0), 0.0, 0.0, rec.get("quaterZ", 0.0))))
        self.dist_old = math.hypot(self.x - self.goalX, self.y - self.goalY)
        self.last_act = (0.0, 0.0)
        return ResetResult(state=self._depth_image(), xR=self.x, yR=self.y,
                           to_goal=self._to_goal())

    def step(self, action: Sequence[float], t: int) -> StepResult:
        v, w = float(action[0]), float(action[1])
        self.theta = math.atan2(math.sin(self.theta + w * self.DT),
                                math.cos(self.theta + w * self.DT))
        self.x += v * math.cos(self.theta) * self.DT
        self.y += v * math.sin(self.theta) * self.DT

        ranges = self._laser()
        col, _ = R.laser_collision(np.asarray(ranges, np.float32),
                                   self.min_range)
        col = bool(col)
        dist = math.hypot(self.x - self.goalX, self.y - self.goalY)
        out = R.step_reward(self.dist_old, dist, col, v, w)
        self.dist_old = float(out.dist)
        if col:
            self.collision += 1
        self.last_act = (v, w)
        return StepResult(state=self._depth_image(),
                          reward=float(out.reward),
                          done=bool(out.done),
                          to_goal=self._to_goal(v, w),
                          target=bool(out.target))

    def stop(self) -> None:
        pass
