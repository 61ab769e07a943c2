"""Multi-robot fleet serving: N live Env clients share ONE actor dispatch.

Counterpart of `dgvit_tpu/serve/fleet.py`. The reference runs one robot
per process (env_lab.py GazeboEnv + main.py:369 choose_action, one policy
call per robot step). A fleet layout instead runs each robot's episodes
on a host thread and sends every action request through one
`BatchingActorServer`, which coalesces the requests that arrive together
into one padded-bucket dispatch (one K1 launch on the card):

    robot_0 ─┐
    robot_1 ─┤  per-robot episode threads  ──►  BatchingActorServer
      ...    │  (host: env I/O, frame stack,    (coalesces concurrent
    robot_N ─┘   action-unit scaling)            requests into one padded
                                                 bucket dispatch)

Each robot runs the reference evaluation protocol (testing.py:103-144:
deterministic action, bad-init exclusion, goal and collision accounting,
durations in simulated seconds). Works with any Env-protocol environment:
KinematicNavEnv lanes, or namespaced GazeboRos2Env adapters
(manage_physics=False) over one live multi-robot Gazebo world.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from dgvit_tpu_torch.serve.server import BatchingActorServer


@dataclass
class RobotReport:
    """Per-robot episode accounting (testing.py:103-150 counters)."""

    robot: int
    episodes: int = 0
    successes: int = 0
    bad_inits: int = 0
    collisions: int = 0
    total_reward: float = 0.0
    durations: List[float] = field(default_factory=list)
    error: Optional[str] = None


def fleet_buckets(n_robots: int,
                  buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64)):
    """The bucket ladder capped at the fleet size, the fleet size itself
    the largest bucket: N robots never make a batch of more than N."""
    cap = max(n_robots, 1)
    out = tuple(b for b in buckets if b <= cap) or (1,)
    return out + (cap,) if out[-1] < cap else out


class FleetRunner:
    """Drive N Env-protocol robots against one shared action service.

    act: a BatchingActorServer (robots coalesce into shared dispatches),
    or any blocking callable act(obs, goal[:2]) -> action (2,) in policy
    units (the deterministic deployment map of
    `serve/export.py::make_action_fn`). The clip and the command map
    a_in = [(a0+1) * L_SCALE, a1 * A_SCALE] (main.py:320,370) are applied
    here, unless `env_units_baked` says the service already emits robot
    velocity commands (an artifact of `export_actor(..., env_units=True)`
    or a `make_action_fn(..., env_units=True)`).

    on_transition(robot, obs, action, goal, reward, next_obs, next_goal,
    done), when given, is called from the robot threads with every
    transition of an accounted episode (the demo-npz row layout,
    demonstration.py:237-245); consumers must be thread-safe.
    `train/train_fleet.py` streams it into the shared replay buffer under
    a concurrent learner. A bad-init episode streams nothing.
    """

    def __init__(self, envs: Sequence, act, cfg,
                 env_units_baked: bool = False,
                 on_transition: Optional[Callable] = None):
        self.envs = list(envs)
        self._act = act.act if isinstance(act, BatchingActorServer) else act
        self.cfg = cfg
        self.env_units_baked = env_units_baked
        self.on_transition = on_transition

    # -- one robot ----------------------------------------------------------
    def _stacker(self):
        if self.cfg.model.patch_mode == "channels":
            from dgvit_tpu_torch.train.train_rl import FrameStacker
            return FrameStacker(self.cfg.env.frame_stack)
        return None

    @staticmethod
    def _squeeze(state: np.ndarray) -> np.ndarray:
        return np.squeeze(state, -1) if state.ndim == 3 else state

    def _run_robot(self, i: int, episodes: int, rep: RobotReport):
        env = self.envs[i]
        e = self.cfg.env
        dt = float(getattr(env, "DT", 0.1))
        stacker = self._stacker()
        if hasattr(env, "collision"):
            env.collision = 0
        # free-running Gazebo advances sim time by wall-clock x RTF, so
        # (t+1)*DT durations hold at RTF 1 only; an env that publishes
        # /clock (GazeboRos2Env.sim_now) times episodes by the sim clock
        sim_now = getattr(env, "sim_now", lambda: None)
        for _ in range(episodes):
            r = env.reset()
            obs = self._squeeze(r.state)
            if stacker:
                obs = stacker.reset(obs)
            goal = r.to_goal
            rep.episodes += 1
            ep_t0 = sim_now()
            for t in range(e.max_steps):
                a = np.asarray(self._act(obs, goal[:2]), np.float32)
                if self.env_units_baked:
                    a_in = [float(a[0]), float(a[1])]
                else:
                    a = a.clip(-e.max_action, e.max_action)
                    a_in = [(a[0] + 1.0) * e.linear_cmd_scale,
                            a[1] * e.angular_cmd_scale]
                s = env.step(a_in, t)
                prev_obs, prev_goal = obs, goal
                obs = self._squeeze(s.state)
                if stacker:
                    obs = stacker.push(obs)
                goal = s.to_goal
                if t == 0 and s.done:
                    # bad initialization (testing.py:117-121): the
                    # excluded episode adds nothing, not to the stream,
                    # not to total_reward
                    rep.bad_inits += 1
                    rep.episodes -= 1
                    break
                if self.on_transition is not None:
                    self.on_transition(i, prev_obs, a, prev_goal,
                                       float(s.reward), obs, goal,
                                       bool(s.done))
                rep.total_reward += float(s.reward)
                if s.target:
                    rep.successes += 1
                    now = sim_now()
                    rep.durations.append(now - ep_t0
                                         if now is not None and
                                         ep_t0 is not None
                                         else (t + 1) * dt)
                if s.done or t == e.max_steps - 1:
                    break
        rep.collisions = int(getattr(env, "collision", 0))
        if hasattr(env, "stop"):
            env.stop()

    # -- the fleet ----------------------------------------------------------
    def run(self, episodes_per_robot: int = 1) -> dict:
        """Run every robot concurrently; aggregate and per-robot stats.

        A robot that raises gets its exception on its RobotReport.error
        (the episodes it finished still count) and in the aggregate's
        `errors` map; the other robots' campaigns go on. The caller
        decides whether that fails the run."""
        reports = [RobotReport(robot=i) for i in range(len(self.envs))]

        def guarded(i):
            try:
                self._run_robot(i, episodes_per_robot, reports[i])
            except Exception as exc:  # a dead robot must not hang the fleet
                reports[i].error = f"{type(exc).__name__}: {exc}"

        threads = [threading.Thread(target=guarded, args=(i,), daemon=True)
                   for i in range(len(self.envs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        episodes = sum(r.episodes for r in reports)
        successes = sum(r.successes for r in reports)
        return {
            "robots": len(self.envs),
            "episodes": episodes,
            "successes": successes,
            "success_rate": successes / max(episodes, 1),
            "collisions": sum(r.collisions for r in reports),
            "bad_inits": sum(r.bad_inits for r in reports),
            "total_reward": sum(r.total_reward for r in reports),
            "durations": sorted(d for r in reports for d in r.durations),
            "per_robot": reports,
            "errors": {r.robot: r.error for r in reports if r.error},
        }


def make_ros2_fleet(cfg, n: int,
                    records_per_robot: Optional[List[list]] = None,
                    **adapter_kw) -> list:
    """n namespaced GazeboRos2Env adapters over one live Gazebo world.

    Robot i drives entity '<robot>i' through topics under /roboti/..., so
    a multi-robot world spawns scout0..scoutN-1 and target_cone0..N-1.
    Physics runs free (manage_physics=False for all): N robots cannot
    share the reference's global pause/unpause step gate. Other keywords
    (`device`, ...) go to every adapter."""
    from dgvit_tpu_torch.envs.ros2_adapter import GazeboRos2Env

    base = adapter_kw.pop("robot_base_name",
                          getattr(cfg.train, "robot", "scout"))
    envs = []
    for i in range(n):
        recs = records_per_robot[i] if records_per_robot else None
        envs.append(GazeboRos2Env(
            cfg, position_records=recs, namespace=f"/robot{i}",
            robot_name=f"{base}{i}", target_name=f"target_cone{i}",
            manage_physics=False, **adapter_kw))
    return envs


def serve_fleet(cfg, envs: Sequence, act_fn: Callable,
                episodes_per_robot: int = 1, max_wait_ms: float = 4.0,
                buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                env_units_baked: bool = False) -> dict:
    """A BatchingActorServer around `act_fn` (the numpy-in/numpy-out act
    of `make_action_fn`, or a loaded artifact's act) over
    `fleet_buckets(len(envs), buckets)`, the fleet run through it
    (`env_units_baked` as FleetRunner takes it), and the server's batching
    stats folded into the result under 'serving'."""
    with BatchingActorServer(act_fn, max_wait_ms=max_wait_ms,
                             buckets=fleet_buckets(len(envs),
                                                   buckets)) as srv:
        out = FleetRunner(envs, srv, cfg, env_units_baked=env_units_baked
                          ).run(episodes_per_robot)
    # stats after the worker has joined (the with-exit closes the server):
    # the worker bumps its counters after fut.set_result, so reading inside
    # the block can under-count the final batch
    out["serving"] = srv.stats()
    return out
