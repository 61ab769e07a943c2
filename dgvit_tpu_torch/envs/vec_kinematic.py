"""The kinematic navigation env, batched: B lanes stepped together as
tensors on the card, with no host round trip in a step.

Counterpart of `dgvit_tpu/envs/jax_kinematic.py`: the world model of
`envs/kinematic.py` (`KinematicNavEnv`: ray/AABB sensors over the obstacle
boxes, unicycle dynamics at the 0.1 s cadence, the reward and polar math
of `envs/reward.py`) on (B,) fp32 tensors, the semantics of the JAX env:

  * physics, reward and polar math match the host env step for step (fp32
    here, float64 on the host);
  * auto-reset: a lane that ends (done, or the `max_steps` cap) restarts
    at once from its record index + `stride` (the lane count by default),
    so the lanes cycle the record table without repeats; at B=1 this is
    the host env's `indice_position`;
  * a step returns both the pre-reset observation (a transition's
    next_obs) and the post-reset one (what the policy sees next);
  * `done` is the env's own (target or collision), never the truncation
    cap, as the reference writes it.

World ensembles (`rand<K>`, `randh<K>`, `randm<K>`, or a list of presets)
keep (K, nb, 4) boxes, per-world record tables and, where the arenas
differ, per-world arenas; a lane's world is `_world_of` its episode's
record index ('reset') or its lane index ('lane').

Every tensor lives on the consts' device: the card unless `make_consts`
is given device='cpu'. The camera's and laser's bearing offsets are
linspaces rounded once from float64 (the JAX package's fp32 linspace
differs from it in the last place of some elements).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.envs import reward as R
from dgvit_tpu_torch.envs.kinematic import KinematicNavEnv, default_records
from dgvit_tpu_torch.envs.worlds import (WorldPreset, get_world,
                                         random_ensemble)

WORLD_ASSIGN = ("reset", "lane")


class EnvConsts(NamedTuple):
    """Static env configuration: the sizes stay Python numbers, the world
    and record tables are tensors on `device`."""
    boxes: torch.Tensor       # (nb, 4) or (K, nb, 4): x0 x1 y0 y1
    arena: torch.Tensor       # (4,) or (K, 4): x0 x1 y0 y1
    records: torch.Tensor     # (n_rec, 5) or (K, n_rec, 5): xR yR xG yG theta0
    cam_cols: torch.Tensor    # (image_w,) camera bearing offsets
    laser_rays: torch.Tensor  # (rays,) laser bearing offsets
    ramp: torch.Tensor        # (image_h, 1) vertical shading of the image
    image_h: int
    image_w: int
    laser_max: float
    cam_near: float
    cam_far: float
    min_range: float
    dt: float
    max_steps: int
    world_assign: str = "reset"

    @property
    def device(self) -> torch.device:
        return self.boxes.device


class VecState(NamedTuple):
    """Per-lane dynamic state, each (B,)."""
    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor
    goal_x: torch.Tensor
    goal_y: torch.Tensor
    dist_old: torch.Tensor
    rec_idx: torch.Tensor     # int32: the record of the current episode
    steps: torch.Tensor       # int32: steps taken in the current episode


class VecStepOut(NamedTuple):
    state: VecState           # post-reset state
    obs: torch.Tensor         # (B, h, w) post-reset observation
    to_goal: torch.Tensor     # (B, 4) post-reset polar goal
    next_obs: torch.Tensor    # (B, h, w) pre-reset observation
    next_to_goal: torch.Tensor  # (B, 4) pre-reset polar goal
    reward: torch.Tensor      # (B,)
    done: torch.Tensor        # (B,) bool: target or collision
    target: torch.Tensor      # (B,) bool
    collided: torch.Tensor    # (B,) bool
    truncated: torch.Tensor   # (B,) bool: the max_steps cap (lane reset)


def _records_table(recs) -> np.ndarray:
    table = np.zeros((len(recs), 5), np.float32)
    for i, rec in enumerate(recs):
        table[i, :4] = rec["xR"], rec["yR"], rec["xG"], rec["yG"]
        table[i, 4] = float(np.asarray(R.quaternion_yaw(
            rec.get("quaterW", 1.0), 0.0, 0.0, rec.get("quaterZ", 0.0))))
    return table


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    return np.linspace(start, stop, num).astype(np.float32)


def make_consts(world=None, records: Optional[Sequence[dict]] = None,
                image_hw=(128, 160), max_steps: int = 800, seed: int = 0,
                min_range: float = 0.2, n_records: int = 32,
                world_assign: str = "reset",
                device: Optional[Union[str, torch.device]] = None
                ) -> EnvConsts:
    """EnvConsts with `KinematicNavEnv`'s sensor constants.

    `world`: None or a preset name ('rrc', 'hospital'), a WorldPreset, a
    procedural ensemble spec (`rand<K>`, `randh<K>`, `randm<K>`, drawn by
    `worlds.random_ensemble` from `seed`) or a list of presets. An
    ensemble pads its members' boxes with far-away boxes that no ray
    reaches, and draws `n_records` records per member (member i from seed
    + i) in that member's own layout; explicit `records` need a single
    world. Runs on the card unless device='cpu'."""
    if world_assign not in WORLD_ASSIGN:
        raise ValueError(f"world_assign {world_assign!r} not in "
                         f"{WORLD_ASSIGN}")
    dev = resolve_device(device)
    if isinstance(world, str) and world.startswith("rand"):
        world = random_ensemble(world, seed=seed)
    e = KinematicNavEnv
    ih, iw = int(image_hw[0]), int(image_hw[1])
    if isinstance(world, (list, tuple)):
        if records is not None:
            raise ValueError("an ensemble draws its records per world; "
                             "explicit records need a single world")
        arenas = [tuple(map(float, w.arena)) for w in world]
        arena = np.asarray(arenas[0] if len(set(arenas)) == 1 else arenas,
                           np.float32)
        nb = max(len(w.boxes) for w in world)
        far = (1e4, 1e4, 1e4, 1e4)   # beyond every max range: never hit
        boxes = np.asarray([list(w.boxes) + [far] * (nb - len(w.boxes))
                            for w in world], np.float32)
        table = np.stack([
            _records_table(default_records(n=n_records, seed=seed + i,
                                           world=w))
            for i, w in enumerate(world)])
    else:
        if isinstance(world, str) or world is None:
            world = get_world(world or "rrc")
        if not isinstance(world, WorldPreset):
            raise TypeError(f"not a world: {world!r}")
        boxes = np.asarray(world.boxes, np.float32)
        arena = np.asarray(world.arena, np.float32)
        table = _records_table(records or default_records(
            n=n_records, seed=seed,
            world=None if world.name == "rrc" else world))
        world_assign = "reset"   # one world: nothing to assign
    t = lambda a: torch.as_tensor(a, device=dev)
    return EnvConsts(
        boxes=t(boxes), arena=t(arena), records=t(table),
        cam_cols=t(_linspace(e.CAM_FOV / 2, -e.CAM_FOV / 2, iw)),
        laser_rays=t(_linspace(-e.LASER_FOV / 2, e.LASER_FOV / 2,
                               e.LASER_RAYS)),
        ramp=t(_linspace(1.0, 0.85, ih)[:, None]),
        image_h=ih, image_w=iw, laser_max=e.LASER_MAX,
        cam_near=e.CAM_CLIP[0], cam_far=e.CAM_CLIP[1],
        min_range=float(min_range), dt=e.DT, max_steps=int(max_steps),
        world_assign=world_assign)


def _world_of(c: EnvConsts, rec_idx: torch.Tensor) -> Optional[torch.Tensor]:
    """Each lane's world for the episode of `rec_idx`, None for a single
    world. 'reset': Knuth's multiplicative hash of the record index, its
    high half folded down, taken modulo 2^32 (int64 arithmetic masked to
    32 bits, as uint32 wraps) so the world is drawn anew at every reset;
    'lane': lane i keeps world i % K."""
    if c.boxes.dim() != 3:
        return None
    k = c.boxes.shape[0]
    if c.world_assign == "lane":
        return torch.arange(rec_idx.shape[0], dtype=torch.int32,
                            device=rec_idx.device) % k
    h = (rec_idx.long() * 2654435761) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    return (h % k).int()


def ray_distances(px: torch.Tensor, py: torch.Tensor, bearings: torch.Tensor,
                  c: EnvConsts, max_range: float,
                  world_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Slab-method ray/AABB: px, py (B,), bearings (B, R) -> the distance
    (B, R) to the nearest box or arena wall, capped at `max_range`. With
    an ensemble, lane i casts against world `world_idx[i]` (lane i % K
    without one)."""
    dx = torch.cos(bearings)[..., None]          # (B, R, 1)
    dy = torch.sin(bearings)[..., None]
    eps = 1e-12
    inv_dx = 1.0 / torch.where(dx.abs() < eps, eps, dx)
    inv_dy = 1.0 / torch.where(dy.abs() < eps, eps, dy)
    px = px[:, None, None]
    py = py[:, None, None]
    bx, ar = c.boxes, c.arena
    if bx.dim() == 3:
        lane_world = (world_idx if world_idx is not None else
                      torch.arange(px.shape[0], device=px.device)
                      % bx.shape[0])
        bx = bx[lane_world][:, None]             # (B, 1, nb, 4)
        if ar.dim() == 2:
            ar = ar[lane_world][:, None, None]   # (B, 1, 1, 4)
    x0, x1, y0, y1 = bx[..., 0], bx[..., 1], bx[..., 2], bx[..., 3]

    tx1 = (x0 - px) * inv_dx
    tx2 = (x1 - px) * inv_dx
    ty1 = (y0 - py) * inv_dy
    ty2 = (y1 - py) * inv_dy
    tmin = torch.maximum(torch.minimum(tx1, tx2), torch.minimum(ty1, ty2))
    tmax = torch.minimum(torch.maximum(tx1, tx2), torch.maximum(ty1, ty2))
    miss_x = (dx.abs() < eps) & ((px < x0) | (px > x1))
    miss_y = (dy.abs() < eps) & ((py < y0) | (py > y1))
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & ~miss_x & ~miss_y
    d_boxes = torch.where(hit & (tmin >= 0), tmin, float("inf"))
    best = torch.clamp(d_boxes.amin(dim=-1), max=max_range)

    for j, p, inv in ((0, px, inv_dx), (1, px, inv_dx), (2, py, inv_dy),
                      (3, py, inv_dy)):
        t = ((ar[..., j] - p) * inv)[..., 0]
        best = torch.where((t >= 0) & (t < best), t, best)
    return best


def _depth_image(c: EnvConsts, x, y, theta, world_idx=None) -> torch.Tensor:
    """(B,) poses -> (B, h, w) column-depth images (kinematic.py's
    `_depth_image`)."""
    bearings = theta[:, None] + c.cam_cols[None, :]
    d = ray_distances(x, y, bearings, c, c.cam_far, world_idx)
    d = torch.clamp(d, c.cam_near, c.cam_far)
    return (d[:, None, :] / c.cam_far) * c.ramp[None]


def _laser(c: EnvConsts, x, y, theta, world_idx=None) -> torch.Tensor:
    return ray_distances(x, y, theta[:, None] + c.laser_rays[None, :], c,
                         c.laser_max, world_idx)


def _reset_fields(c: EnvConsts, rec_idx: torch.Tensor):
    """Episode-start fields for (B,) record indices: an ensemble lane
    draws from the record bank of its episode's world."""
    if c.records.dim() == 3:
        rec = c.records[_world_of(c, rec_idx).long(),
                        (rec_idx % c.records.shape[1]).long()]
    else:
        rec = c.records[(rec_idx % c.records.shape[0]).long()]
    x, y, gx, gy, theta = rec.unbind(dim=1)
    dist = torch.sqrt(torch.square(x - gx) + torch.square(y - gy))
    return x, y, theta, gx, gy, dist


def vec_reset(c: EnvConsts, batch: int):
    """A fresh B-lane state: lane i starts on record i. Returns (state,
    obs (B, h, w), to_goal (B, 4))."""
    rec_idx = torch.arange(batch, dtype=torch.int32, device=c.device)
    x, y, theta, gx, gy, dist = _reset_fields(c, rec_idx)
    state = VecState(x=x, y=y, theta=theta, goal_x=gx, goal_y=gy,
                     dist_old=dist, rec_idx=rec_idx,
                     steps=torch.zeros_like(rec_idx))
    obs = _depth_image(c, x, y, theta, _world_of(c, rec_idx))
    return state, obs, R.polar_goal_lanes(x, y, gx, gy, theta)


def vec_step(c: EnvConsts, s: VecState, action: torch.Tensor,
             stride: Optional[int] = None) -> VecStepOut:
    """One step of every lane, with auto-reset. `action` is (B, 2) in
    command units [v, w] (post-scaling, as `KinematicNavEnv.step` takes
    it). `stride`: the record advance on a reset, the lane count by
    default."""
    b = int(stride) if stride is not None else action.shape[0]
    v, w = action[:, 0], action[:, 1]
    cur_world = _world_of(c, s.rec_idx)   # the episode's, fixed at reset
    theta = torch.atan2(torch.sin(s.theta + w * c.dt),
                        torch.cos(s.theta + w * c.dt))
    x = s.x + v * torch.cos(theta) * c.dt
    y = s.y + v * torch.sin(theta) * c.dt

    ranges = _laser(c, x, y, theta, cur_world)
    collided = ((ranges > 0) & (ranges < c.min_range)).any(dim=-1)
    dist = torch.sqrt(torch.square(x - s.goal_x) + torch.square(y - s.goal_y))
    out = R.step_reward_lanes(s.dist_old, dist, collided, v, w)
    next_to_goal = R.polar_goal_lanes(x, y, s.goal_x, s.goal_y, theta, v, w)

    steps = s.steps + 1
    truncated = (steps >= c.max_steps) & ~out.done
    restart = out.done | truncated
    new_idx = torch.where(restart, s.rec_idx + b, s.rec_idx)
    rx, ry, rtheta, rgx, rgy, rdist = _reset_fields(c, new_idx)
    sel = lambda live, fresh: torch.where(restart, fresh, live)
    ns = VecState(
        x=sel(x, rx), y=sel(y, ry), theta=sel(theta, rtheta),
        goal_x=sel(s.goal_x, rgx), goal_y=sel(s.goal_y, rgy),
        dist_old=sel(out.dist, rdist), rec_idx=new_idx,
        steps=torch.where(restart, 0, steps).int())

    # the pre-reset and the reset frame of every lane in one render
    new_world = _world_of(c, new_idx)
    frames = _depth_image(
        c, torch.cat([x, rx]), torch.cat([y, ry]), torch.cat([theta, rtheta]),
        None if cur_world is None else torch.cat([cur_world, new_world]))
    next_obs, reset_obs = frames.split(x.shape[0])
    reset_goal = R.polar_goal_lanes(rx, ry, rgx, rgy, rtheta)
    obs = torch.where(restart[:, None, None], reset_obs, next_obs)
    to_goal = torch.where(restart[:, None], reset_goal, next_to_goal)
    return VecStepOut(state=ns, obs=obs, to_goal=to_goal, next_obs=next_obs,
                      next_to_goal=next_to_goal, reward=out.reward,
                      done=out.done, target=out.target, collided=collided,
                      truncated=truncated)
